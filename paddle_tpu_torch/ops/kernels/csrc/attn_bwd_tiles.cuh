// The attention-backward steps for Hopper (sm_90a) that the bf16 dK/dV
// kernels (flash_attention.cu, flash_bwd_dkdv_wgmma; flash_varlen.cu,
// varlen_bwd_dkdv_wgmma) and the bf16 dQ kernels (flash_attention.cu,
// flash_bwd_dq_wgmma; flash_varlen.cu, varlen_bwd_dq_wgmma) share: one
// consumer warpgroup's products and softmax for one staged tile, on wgmma
// (hopper_tiles.cuh) with float32 accumulators. The caller's producer
// warp fills a ring of stages by TMA; its consumer loop waits for a
// stage, runs the step and releases it. Backward math, for
// p = exp(s * scale - lse) and ds = p * (dp - delta) * scale: dv = p^T dout,
// dk = ds^T q, dq = ds k. Rounding follows the TPU kernels: p is cast to
// bf16 before p^T dout and ds before ds^T q and ds k (both become the A
// operand of the next product from registers, the accumulator layout
// being the A layout, so neither touches shared memory); the softmax is
// float32, 2^x by the SFU.
//
// Both take a hook for what differs between the kernels:
//   bool live(int x0): some (row, key) pair of the tile is kept: a step
//     that is not live runs no product (the caller still releases its
//     stage);
//   bool full(int x0): every pair of the tile is kept: no mask;
//   bool kept(int x0, int r, int c): the pair of this thread's r-th
//     accumulator row (0: row 16 w + g, 1: that + 8, for warp w of the
//     warpgroup and lane 4 g + t) and column c of the tile is kept.
// x0 is the step's first q row (dK/dV) or key (dQ), as the hook counts
// it: the dense causal/window band, or the varlen segments' intervals.
//
// dK/dV (dkdv_step). The warpgroup owns 64 keys: K and V in shared
// memory, [D / 64 column tiles][rows][128 bytes] with `kv_sub` bytes from
// one column tile to the next, 128-byte swizzled. A stage holds 64 q rows
// of one head: Q and dO tiles [D / 64][64][128 B], then the rows' lse and
// delta (kRowBox float32 each, delta 512 bytes after lse; the rows' values
// start `row_off` values in, see kRowBox). Per step:
//   * S^T = K Q^T and dP^T = V dO^T (M = keys, N = rows), both operands
//     K-major in shared memory;
//   * P^T = 2^(S^T scale log2 e - lse log2 e), masked where the tile needs
//     it; rounded to bf16 it is the A operand of dV += P^T dO (B = dO,
//     MN-major), issued before dS^T is computed so that the two overlap;
//   * dS^T = P^T (dP^T - delta) scale, then dK += dS^T Q (B = Q, MN-major).
// dK/dV layout: accumulator element 4 j + i is key 8 (i / 2) of the
// thread's row pair, column 8 j + 2 t + i % 2.
//
// dQ (dq_consume). The warpgroup owns one M tile of 64 rows (or (row,
// q head) pairs): Q and dO [D / 64][64][128 B] in shared memory. A stage
// holds 64 keys: K, then V, [D / 64][64][128 B]. Per step:
//   * S = Q K^T and dP = dO V^T on wgmma with both operands K-major;
//   * P = 2^(S scale log2 e - lse log2 e), masked where needed;
//     dS = P (dP - delta) scale;
//   * dQ += dS K, A = dS from registers, B = K MN-major: the forms of
//     dK += dS^T Q above.
// The thread's two rows' lse (times log2 e) and delta come in registers:
// a row's values are fixed for the whole block.
#pragma once

#include "attn_fwd_tiles.cuh"

namespace ptt {
namespace attn {

// A 1-D TMA box must start 16-byte aligned, so a stage's lse (and delta)
// box starts at the aligned-down flat index of the tile's first row and
// holds 64 + 4 values: the rows' values begin row_off = index % 4 in.
constexpr int kRowBox = 68;

// Shared memory of a dK/dV block (bytes, from a 1024-aligned base): the
// block's K and V, then the ring of Q/dO/lse/delta stages, then the
// barriers. kNWG consumer warpgroups of 64 keys each (2 at D = 64, 1 at
// D = 128, where the four products' float32 accumulators take ~240
// registers a thread) and one producer warp.

template <int D>
struct Dkdv {
  static constexpr int kStages = D == 64 ? 6 : 5;  // Q/dO ring depth
  static constexpr int kNWG = D == 64 ? 2 : 1;  // consumer warpgroups
  static constexpr int kBK = 64 * kNWG;         // keys a block
  static constexpr int kSub = D / 64;           // 64-column tiles a row
  static constexpr int kThreads = kNWG * 128 + 32;
  static constexpr int kKV = kSub * kBK * 128;  // K or V
  static constexpr int kQO = kSub * kTile;      // a Q or dO tile
  static constexpr int kStage = 2 * kQO + 1024;  // Q, dO, lse, delta
  static constexpr int kBars = 2 * kKV + kStages * kStage;
  static constexpr int kSmem = 1024 + kBars + 8 * (2 * kStages + 1);
  static constexpr uint32_t kStageTx = 2 * kQO + 2 * kRowBox * 4;
};

// Shared memory of a dQ block (bytes, from a 1024-aligned base): the
// consumer warpgroups' Q and dO tiles, the ring of K/V stages, the
// barriers (full and empty a stage, then one for Q and dO) and each
// stage's first key (step_k0). kNWG consumer warpgroups of one M tile each
// (up to 3 at D = 64, 2 at D = 128, where dQ takes twice the registers)
// and one producer warp.
template <int D, int NWG>
struct Dq {
  static constexpr int kNWG = NWG;
  static constexpr int kSub = D / 64;
  static constexpr int kStages = D == 64 ? 5 : 4;  // K/V ring depth
  static constexpr int kThreads = kNWG * 128 + 32;
  static constexpr int kQdO = 2 * kSub * kTile;    // Q and dO
  static constexpr int kStage = 2 * kSub * kTile;  // K and V
  static constexpr int kBars = kNWG * kQdO + kStages * kStage;
  static constexpr int kSmem =
      1024 + kBars + 8 * (2 * kStages + 1) + 4 * kStages;
};

// d (+)= A B for one k-step of a product with N = D (A from registers,
// B MN-major)
template <int D>
__device__ __forceinline__ void rs_step(float (&d)[D / 2],
                                        const uint32_t (&a)[4],
                                        uint64_t desc_b) {
  if constexpr (D == 64)
    wgmma_m64n64k16_rs(d, a, desc_b, 1);
  else
    wgmma_m64n128k16_rs(d, a, desc_b, 1);
}

// One dK/dV step: this warpgroup's 64 keys (k, v) against the 64 rows
// staged at `stage` from row q0.
template <int D, class Hook>
__device__ __forceinline__ void dkdv_step(const unsigned char* k,
                                          const unsigned char* v, int kv_sub,
                                          const unsigned char* stage,
                                          int row_off, float sl2,
                                          float scale, const Hook& h, int q0,
                                          float (&dk)[D / 2],
                                          float (&dv)[D / 2]) {
  if (!h.live(q0)) return;
  const int t = threadIdx.x % 4;
  const unsigned char* q = stage;
  const unsigned char* o = stage + (D / 64) * kTile;
  const float* lse =
      reinterpret_cast<const float*>(stage + 2 * (D / 64) * kTile) + row_off;
  const float* delta = lse + 128;
  float sacc[32], dpacc[32];
  // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 rows each
  fence_regs(sacc);
  fence_regs(dpacc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * kv_sub + kk % 4 * 32;
    const int qoff = (kk / 4) * kTile + kk % 4 * 32;
    wgmma_m64n64k16_ss(sacc, desc_sw128(k + off, 16, 1024),
                       desc_sw128(q + qoff, 16, 1024), kk);
  }
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * kv_sub + kk % 4 * 32;
    const int qoff = (kk / 4) * kTile + kk % 4 * 32;
    wgmma_m64n64k16_ss(dpacc, desc_sw128(v + off, 16, 1024),
                       desc_sw128(o + qoff, 16, 1024), kk);
  }
  wgmma_commit();
  // p = exp(s * scale - lse); sacc[4 j + i] is the thread's key
  // 8 (i / 2), row q0 + 8 j + 2 t + i % 2. Only a tile that is not full
  // is masked.
  const bool full = h.full(q0);
  wgmma_wait<1>();
  fence_regs(sacc);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      sacc[4 * j + i] = exp2_sfu(sacc[4 * j + i] * sl2 -
                                 lse[8 * j + 2 * t + (i & 1)] * kLog2e);
  if (!full) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (!h.kept(q0, i >> 1, 8 * j + 2 * t + (i & 1)))
          sacc[4 * j + i] = 0.f;
  }
  // dV += P^T dO (K = the tile's rows), running while dS is computed
  uint32_t pa[4][4], da[4][4];
  p_to_a(sacc, pa);
  fence_regs(dv);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    rs_step<D>(dv, pa[kk], desc_sw128(o + kk * 2048, kTile, 1024));
  wgmma_commit();
  // ds = p * (dp - delta) * scale, then dK += dS^T Q
  wgmma_wait<1>();
  fence_regs(dpacc);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dpacc[4 * j + i] =
          sacc[4 * j + i] *
          (dpacc[4 * j + i] - delta[8 * j + 2 * t + (i & 1)]) * scale;
  p_to_a(dpacc, da);
  fence_regs(dk);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    rs_step<D>(dk, da[kk], desc_sw128(q + kk * 2048, kTile, 1024));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dv);
  fence_regs(dk);
  fence_regs(pa);
  fence_regs(da);
}

// The dQ steps of one warpgroup: its M tile (q, o) against the n key
// tiles of a ring of kStages stages (tile j in stage j % kStages, K then
// V, `stage_bytes` apart, its first key in step_k0[stage]), waiting on
// `full` and releasing on `empty` (one arrival per thread) as
// attn_fwd_tiles.cuh's consume does. lse2: the thread's two rows' lse
// times log2 e; dl: their delta. A stage is released once its dQ
// product is done. (Leaving that product in flight while the next tile's
// S and dP were issued, the stage released a step later, read 0.2198 ms
// against 0.2062 at varlen_train on an H100 80GB HBM3 at 700 W.)
template <int D, int kStages, class Hook>
__device__ __forceinline__ void dq_consume(
    const unsigned char* q, const unsigned char* o, const unsigned char* ring,
    int stage_bytes, const int* step_k0, uint64_t* full, uint64_t* empty,
    int n, const float (&lse2)[2], const float (&dl)[2], float sl2,
    float scale, const Hook& h, float (&dq)[D / 2]) {
  const int t = threadIdx.x % 4;
  for (int j = 0; j < n; ++j) {
    const int st = j % kStages;
    mbar_wait(&full[st], (j / kStages) & 1);
    const int k0 = step_k0[st];
    if (!h.live(k0)) {
      mbar_arrive(&empty[st]);
      continue;
    }
    const unsigned char* k = ring + st * stage_bytes;
    const unsigned char* v = k + (D / 64) * kTile;
    float s[32], dp[32];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    issue_qk<D>(s, q, k);
    wgmma_commit();
    issue_qk<D>(dp, o, v);
    wgmma_commit();
    // p = exp(s * scale - lse); s[4 j + i] is the thread's row 8 (i / 2),
    // key k0 + 8 j + 2 t + i % 2
    const bool full_tile = h.full(k0);
    wgmma_wait<1>();
    fence_regs(s);
#pragma unroll
    for (int e = 0; e < 32; ++e)
      s[e] = exp2_sfu(s[e] * sl2 - lse2[(e >> 1) & 1]);
    if (!full_tile) {
#pragma unroll
      for (int e = 0; e < 32; ++e)
        if (!h.kept(k0, (e >> 1) & 1, 8 * (e >> 2) + 2 * t + (e & 1)))
          s[e] = 0.f;
    }
    // ds = p * (dp - delta) * scale, then dQ += dS K
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int e = 0; e < 32; ++e)
      dp[e] = s[e] * (dp[e] - dl[(e >> 1) & 1]) * scale;
    uint32_t a[4][4];
    p_to_a(dp, a);
    fence_regs(dq);
    wgmma_fence();
    issue_pv<D>(dq, a, k);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(a);
    mbar_arrive(&empty[st]);
  }
}

}  // namespace attn
}  // namespace ptt
