// The forward-attention core for Hopper (sm_90a) that the bf16 flash
// forwards (flash_attention.cu, flash_fwd_wgmma; flash_varlen.cu,
// varlen_fwd_wgmma) and the tensor-core route of the ragged paged kernel
// (paged_attention.cu, ragged_kernel_wgmma) share: one consumer
// warpgroup's online-softmax loop over a ring of K/V stages, on wgmma
// (hopper_tiles.cuh), and the flash forwards' shared-memory layout (Fwd).
//
// Operands. A warpgroup owns one M tile of 64 rows: Q in shared memory,
// [D / 64 column tiles][64 rows][128 bytes], 128-byte swizzled (the
// layout a TMA box with CU_TENSOR_MAP_SWIZZLE_128B writes, and
// sw128_offset below for stores by threads). A ring stage holds one tile
// of 64 keys: K, then V, in the same layout. Per key tile:
//   * S = Q K^T: wgmma m64n64k16, A = Q and B = K both K-major in shared
//     memory, float32 accumulators (sacc[4 j + i]: row 16 w + g + 8 (i / 2),
//     key 8 j + 2 t + i % 2 for warp w, lane 4 g + t);
//   * the hook turns S into log2-domain scores (scale * log2 e, masked
//     keys -inf, int8 K: times each key's K scale);
//   * online softmax in float32 registers: m (running max, log2 domain)
//     and l (running sum of the float32 p), quad-reduced by shuffles;
//   * the hook scales P's columns (int8 V: each key's V scale), then P is
//     rounded to bf16 into the A fragments in registers (the accumulator
//     layout is the A layout of the next product, so P never touches shared
//     memory): the Pallas float branch's pvals.astype(v.dtype);
//   * O += P V: wgmma m64n{D}k16, A from registers, B = V MN-major.
// Overlap: tile j's S = Q K_j^T is issued together with tile j - 1's
// O += P V; the softmax of S_j runs while P V of j - 1 is still in flight,
// and O is rescaled only once that product is done. The loop is unrolled
// by two so that the P fragments alternate between two register sets. A
// stage is released to the producer (its `empty` barrier, one arrival per
// consumer thread) once both products that read it have completed.
//
// What the producer does (TMA boxes for dense tensors, thread copies for
// pages) is the caller's; it completes each stage on `full[stage]` and
// waits on `empty[stage]` before refilling it.
#pragma once

#include "hopper_tiles.cuh"

namespace ptt {
namespace attn {

constexpr int kTile = 64 * 128;  // one 64-row x 64-column bf16 tile (bytes)
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of a flash forward block (bytes, from a 1024-aligned
// base): the consumer warpgroups' Q tiles, the ring of K/V stages, the
// barriers (full and empty a stage, then one for Q) and each stage's
// first key (step_k0, for a walk whose tiles do not follow from their
// index). kNWG consumer warpgroups of one M tile each (up to 3 at D = 64,
// 2 at D = 128, where O takes twice the registers) and one producer warp.
template <int D, int NWG>
struct Fwd {
  static constexpr int kNWG = NWG;
  static constexpr int kSub = D / 64;
  static constexpr int kStages = D == 64 ? 5 : 3;  // K/V ring depth
  static constexpr int kThreads = kNWG * 128 + 32;
  static constexpr int kQ = kSub * kTile;          // a Q tile
  static constexpr int kStage = 2 * kSub * kTile;  // K and V
  static constexpr int kBars = kNWG * kQ + kStages * kStage;
  static constexpr int kSmem =
      1024 + kBars + 8 * (2 * kStages + 1) + 4 * kStages;
};

// byte offset of 16-byte chunk c (of the D / 8 of a row) of row r in a
// [D / 64][64][128 B] 128-byte-swizzled tile (1024-byte aligned)
__device__ __forceinline__ int sw128_offset(int r, int c) {
  return (c >> 3) * kTile + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// make this thread's st.shared writes visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` among `count` threads (a warpgroup: 128)
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// 2^x by the SFU (ex2.approx: ~2 ulp; 2^-inf = 0; denormals flush to 0)
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// P (a 64 x 64 accumulator) as the four bf16 A fragments of P V
__device__ __forceinline__ void p_to_a(const float (&p)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(p[8 * kk + 2 * i], p[8 * kk + 2 * i + 1]);
}

// s = Q K^T over D (K-major A and B, 128-byte swizzle)
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[32],
                                         const unsigned char* q,
                                         const unsigned char* k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * kTile + (kk % 4) * 32;
    wgmma_m64n64k16_ss(s, desc_sw128(q + off, 16, 1024),
                       desc_sw128(k + off, 16, 1024), kk);
  }
}

// o += P V over 64 keys (A from registers, V MN-major)
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4][4],
                                         const unsigned char* v) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc = desc_sw128(v + kk * 2048, kTile, 1024);
    if constexpr (D == 64)
      wgmma_m64n64k16_rs(o, a[kk], desc, 1);
    else
      wgmma_m64n128k16_rs(o, a[kk], desc, 1);
  }
}

// one online-softmax step over this thread's two rows: s (log2-domain
// scores, masked -inf) becomes p = 2^(s - m_new); m and l are updated and
// corr[r] = 2^(m_old - m_new) is what O still has to be multiplied by
__device__ __forceinline__ void online_softmax(float (&s)[32], float (&m)[2],
                                               float (&l)[2],
                                               float (&corr)[2]) {
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mu[r] = mx == -INFINITY ? 0.f : mx;  // a row with no key so far
    corr[r] = exp2_sfu(m[r] - mu[r]);
    m[r] = mx;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const float p = exp2_sfu(s[e] - mu[(e >> 1) & 1]);
    s[e] = p;
    l[(e >> 1) & 1] += p;  // this thread's share; quad-summed at the end
  }
}

// The consumer loop of one warpgroup over the n key tiles of a ring of
// kStages stages (tile j in stage j % kStages). sQ: its Q tile. The hook:
//   const unsigned char* k(int stage), v(int stage): the stage's tiles;
//   void score(int j, int stage, float (&s)[32]): raw q.k -> log2-domain
//     scores, masked keys -inf;
//   void prob(int j, int stage, float (&p)[32]): P's columns scaled
//     before the bf16 cast (identity for bf16 V).
// Out: o (unnormalised, float32 accumulator layout), m (log2 domain) and
// l (quad-summed) of the thread's two rows. n = 0 leaves o = 0, m = -inf,
// l = 0 and touches no barrier.
template <int D, int kStages, class Hook>
__device__ __forceinline__ void consume(const unsigned char* sQ,
                                        uint64_t* full, uint64_t* empty,
                                        int n, Hook& h, float (&o)[D / 2],
                                        float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
  if (n <= 0) return;
  float s[32], corr[2];
  // P's A fragments, two sets: one is read by the P V in flight while the
  // next tile's P is written to the other (a copy from one to the other
  // would make the two one register set, and ptxas would then serialise
  // every wgmma)
  uint32_t pa[4][4], pb[4][4];
  mbar_wait(&full[0], 0);
  fence_regs(s);
  wgmma_fence();
  issue_qk<D>(s, sQ, h.k(0));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  h.score(0, 0, s);
  online_softmax(s, m, l, corr);
  h.prob(0, 0, s);
  p_to_a(s, pa);
  // S_j = Q K_j^T beside O += P_{j-1} V_{j-1} (A fragments `cur`); P_j
  // into `nxt`
  auto step = [&](int j, uint32_t (&cur)[4][4], uint32_t (&nxt)[4][4]) {
    const int st = j % kStages, prev = (j - 1) % kStages;
    mbar_wait(&full[st], (j / kStages) & 1);
    fence_regs(s);
    fence_regs(o);
    fence_regs(cur);
    wgmma_fence();
    issue_qk<D>(s, sQ, h.k(st));
    wgmma_commit();
    issue_pv<D>(o, cur, h.v(prev));
    wgmma_commit();
    wgmma_wait<1>();  // S_j is done; P V of j - 1 may still run
    fence_regs(s);
    h.score(j, st, s);
    online_softmax(s, m, l, corr);
    h.prob(j, st, s);
    p_to_a(s, nxt);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(cur);
    mbar_arrive(&empty[prev]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
  };
  // the last tile's P V
  auto finish = [&](uint32_t (&cur)[4][4]) {
    const int last = (n - 1) % kStages;
    fence_regs(o);
    fence_regs(cur);
    wgmma_fence();
    issue_pv<D>(o, cur, h.v(last));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(cur);
    mbar_arrive(&empty[last]);
  };
  int j = 1;
  for (; j + 1 < n; j += 2) {
    step(j, pa, pb);
    step(j + 1, pb, pa);
  }
  if (j < n) {
    step(j, pa, pb);
    finish(pb);
  } else {
    finish(pa);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
}

}  // namespace attn
}  // namespace ptt
