// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces three Pallas kernels of paddle_tpu/ops/kernels/flash_attention.py:
//   * _flash_fwd_kernel      -> flash_fwd_wgmma / flash_fwd_f32
//   * _flash_bwd_dkdv_kernel -> flash_bwd_dkdv_wgmma / flash_bwd_dkdv_f32
//   * _flash_bwd_dq_kernel   -> flash_bwd_dq_wgmma / flash_bwd_dq_f32
//
// Computes, for q [B, Sq, H, D], k/v [B, Sk, KVH, D] (the reference's
// public layout, read in place: no transpose, no KV repetition), q head h
// reading kv head h / (H / KVH):
//   * the key k is kept for the row q iff, with causal, 0 <= q + Sk - Sq - k
//     and, with window > 0, q + Sk - Sq - k < window (no mask otherwise);
//   * forward: out = softmax(q k^T * scale) v, and lse = m + log(l) in
//     float32 ([B, H, Sq]); a row that sees no key gets out = 0 and
//     lse = -1e30;
//   * backward, given dout and delta = rowsum(dout * out) - dlse (float32,
//     [B, H, Sq], computed by the caller): p = exp(s * scale - lse),
//     dv = p^T dout, ds = p * (dout v^T - delta) * scale, dk = ds^T q,
//     dq = ds k, each summed in float32 and cast once to the input type.
// Rounding follows the TPU kernel: the products take bf16 operands and
// accumulate in float32; p is cast to v's type before p v, p and ds are
// cast to the input type before their products; the softmax math is
// float32. Float32 inputs take the *_f32 kernels, which do all of it in
// float32 on the CUDA cores (small shapes only: the training path is bf16).
//
// What bounds it on the H100: operations. At the training shape (S = 2048,
// D = 64 or 128) each K/V byte is used by 64-row q tiles for ~2*64 flops,
// far above the ~295 flops per byte where the tensor cores become the
// limit. The three bf16 kernels run their products on wgmma, the
// warpgroup products that reach that rate, fed by TMA through a ring of
// stages that a producer warp keeps full (hopper_tiles.cuh). The
// forward's consumer loop is attn_fwd_tiles.cuh's, shared with the varlen
// forward and the ragged paged kernel; the dK/dV and dQ steps are
// attn_bwd_tiles.cuh's, shared with the varlen backward.
//
// Design. The Pallas grids carry their accumulators across an innermost
// sequential ("arbitrary") grid axis; CUDA blocks run in no order, so that
// axis becomes a loop inside the block:
//   * forward and dQ: one block per (kv head, batch, NWG M tiles of 64
//     (q row, q head) pairs of the kv head's group), looping over the
//     64-key tiles of the block rows' causal/window band, bounds computed
//     from offset = Sk - Sq and window (never by testing every tile);
//     every K/V tile the block stages serves the whole group. See
//     flash_fwd_wgmma and flash_bwd_dq_wgmma;
//   * dK/dV: one block per (key tile, kv head, batch), the key tile the
//     slowest grid axis so the longest causal keys start first. The
//     block loops over the group's q heads and, for each, over the q
//     tiles in the band (the reference grid (bhkv, nk, group, nq) as a
//     loop), accumulating dK and dV in float32 registers and writing them
//     once. See flash_bwd_dkdv_wgmma;
//   * no atomics: two runs give equal gradients; tiles wholly inside the
//     band skip the mask.
// Only D = 64 and D = 128 are instantiated (Qwen2-0.5B, Llama-3-8B,
// Mistral); the wrapper refuses other head dims on the card.

#include "attn_bwd_tiles.cuh"
#include "attn_fwd_tiles.cuh"
#include "flash_tiles.cuh"
#include "hopper_tiles.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* out;
  float* lse;
  void* dq;
  void* dk;
  void* dv;
  int B, H, KVH, Sq, Sk;
  float scale;
  int causal, window;
};

// ------------------------------------------------------------ the band
// keys [lo, hi] that some row of [q_first, q_last] keeps (empty: hi < lo)
__device__ __forceinline__ void key_band(const Params& p, int q_first,
                                         int q_last, int& lo, int& hi) {
  const int off = p.Sk - p.Sq;
  lo = 0;
  hi = p.Sk - 1;
  if (p.causal) {
    hi = min(hi, q_last + off);
    if (p.window > 0) lo = max(lo, q_first + off - p.window + 1);
  }
}

// q rows [lo, hi] that keep some key of [k_first, k_last]
__device__ __forceinline__ void query_band(const Params& p, int k_first,
                                           int k_last, int& lo, int& hi) {
  const int off = p.Sk - p.Sq;
  lo = 0;
  hi = p.Sq - 1;
  if (p.causal) {
    lo = max(lo, k_first - off);
    if (p.window > 0) hi = min(hi, k_last - off + p.window - 1);
  }
}

__device__ __forceinline__ bool keep(const Params& p, int qi, int ki) {
  if (!p.causal) return true;
  const int d = qi + p.Sk - p.Sq - ki;
  return d >= 0 && (p.window <= 0 || d < p.window);
}

// every (q, k) pair of rows [q0, q1] x keys [k0, k1] is kept
__device__ __forceinline__ bool tile_full(const Params& p, int q0, int q1,
                                          int k0, int k1) {
  return keep(p, q0, k1) && keep(p, q1, k0);
}

// --------------------------------------------------------- bf16 forward
// flash_fwd_wgmma: the forward on the core of attn_fwd_tiles.cuh. One
// block per (kv head, batch, NWG M tiles), the M tiles the slowest grid
// axis and walked last to first, so the blocks with the longest causal
// key bands start first. NWG consumer warpgroups (3 at D = 64, 2 at
// D = 128, fewer where that would leave SMs without a block) and one
// producer warp:
//   * M packing (GQA): an M tile is 64 (q row, q head) pairs of one kv
//     head's group, 64 / group consecutive rows x the group's heads (16 x 4
//     at Llama-3's group 4, 9 x 7 at Qwen2's group 7, 64 x 1 without GQA).
//     Q [B, Sq, H, D] holds a row's heads side by side, so one TMA box
//     {64 columns, group heads, rows} is the tile, and every K/V tile the
//     block stages serves all group heads of its 2 x 64 / group rows;
//   * the producer's lane 0 loads both warpgroups' Q tiles once, then the
//     band's 64-key K and V tiles (TMA, 128-byte swizzle, rows past Sk read
//     as zeros) into a ring of kStages stages (5 at D = 64, 3 at D = 128);
//   * each consumer warpgroup runs attn::consume over the block's key band;
//     the mask (causal offset Sk - Sq, window, keys past Sk) runs only on
//     tiles that cross the band's edge for its own rows;
//   * out = o / l and lse = m ln 2 + log l are written from registers; a row
//     that sees no key gets out = 0 and lse = -1e30.
// Its shared memory is attn::Fwd's (Q tiles, ring, barriers).
using ptt::attn::Fwd;

// the dense band mask of one warpgroup (its rows [w0, w1]; this thread's
// two rows rA, rB)
template <int D>
struct FwdHook {
  const Params p;
  const unsigned char* ring;
  int t_lo, rA, rB, w0, w1, col0;
  float sl2;
  __device__ const unsigned char* k(int st) const {
    return ring + st * Fwd<D, 1>::kStage;
  }
  __device__ const unsigned char* v(int st) const {
    return k(st) + Fwd<D, 1>::kSub * ptt::attn::kTile;
  }
  __device__ void score(int j, int, float (&s)[32]) const {
    const int k0 = (t_lo + j) * 64;
    if (tile_full(p, w0, w1, k0, k0 + 63) && k0 + 64 <= p.Sk) {
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] *= sl2;
      return;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      float x = s[e] * sl2;
      const int r = (e >> 1) & 1 ? rB : rA;
      const int c = k0 + 8 * (e >> 2) + col0 + (e & 1);
      if (c >= p.Sk || !keep(p, r, c)) x = -INFINITY;
      s[e] = x;
    }
  }
  __device__ void prob(int, int, float (&)[32]) const {}
};

template <int D, int NWG>
__global__ void __launch_bounds__(Fwd<D, NWG>::kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tmQ,
                    const __grid_constant__ CUtensorMap tmK,
                    const __grid_constant__ CUtensorMap tmV,
                    const Params p) {
  using L = Fwd<D, NWG>;
  using ptt::attn::kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* base =
      smem + ((1024 - (ptt::smem_addr(smem) & 1023)) & 1023);
  unsigned char* ring = base + L::kNWG * L::kQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* qbar = empty + L::kStages;

  const int group = p.H / p.KVH, rows = 64 / group;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int mt = gridDim.z - 1 - blockIdx.z;  // longest causal rows first
  const int r0 = mt * L::kNWG * rows;
  const int r_last = min(r0 + L::kNWG * rows, p.Sq) - 1;
  int klo, khi;
  key_band(p, r0, r_last, klo, khi);
  const int t_lo = klo / 64;
  const int n = khi >= klo ? khi / 64 - t_lo + 1 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      ptt::mbar_init(&full[s], 1);
      ptt::mbar_init(&empty[s], L::kNWG * 128);
    }
    ptt::mbar_init(qbar, 1);
    ptt::mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == L::kNWG * 4) {  // ------------------------------- producer
    if (lane == 0 && n > 0) {
      ptt::mbar_arrive_expect_tx(qbar, L::kNWG * L::kSub * group * rows * 128);
      for (int wg = 0; wg < L::kNWG; ++wg)
        for (int sub = 0; sub < L::kSub; ++sub)
          ptt::tma_load_4d(base + wg * L::kQ + sub * kTile, &tmQ, qbar,
                           sub * 64, kvh * group, r0 + wg * rows, b);
      for (int j = 0; j < n; ++j) {
        const int s = j % L::kStages;
        if (j >= L::kStages)  // the consumers released this stage
          ptt::mbar_wait(&empty[s], (j / L::kStages - 1) & 1);
        unsigned char* st = ring + s * L::kStage;
        const int k0 = (t_lo + j) * 64;
        ptt::mbar_arrive_expect_tx(&full[s], L::kStage);
        for (int sub = 0; sub < L::kSub; ++sub) {
          ptt::tma_load_4d(st + sub * kTile, &tmK, &full[s], sub * 64, kvh,
                           k0, b);
          ptt::tma_load_4d(st + (L::kSub + sub) * kTile, &tmV, &full[s],
                           sub * 64, kvh, k0, b);
        }
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, t = lane % 4;
  const int wr0 = r0 + wg * rows;
  const int pa0 = 16 * wq + g;  // this thread's pairs: pa0, pa0 + 8
  const FwdHook<D> hook{p,  ring, t_lo, wr0 + pa0 / group,
                        wr0 + (pa0 + 8) / group, wr0,
                        min(wr0 + rows, p.Sq) - 1, 2 * t,
                        p.scale * kLog2e};
  if (n > 0) ptt::mbar_wait(qbar, 0);
  float o[D / 2], m[2], l[2];
  ptt::attn::consume<D, L::kStages>(base + wg * L::kQ, full, empty, n, hook,
                                    o, m, l);

  // out = o / l; accumulator element 4 j + i is pair pa0 + 8 (i / 2),
  // column 8 j + 2 t + i % 2
  const int64_t qs = (int64_t)p.H * D;
  bf16* og = static_cast<bf16*>(p.out) + (int64_t)b * p.Sq * qs;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pair = pa0 + 8 * r;
    const int row = wr0 + pair / group, h = kvh * group + pair % group;
    if (pair >= rows * group || row >= p.Sq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    bf16* dst = og + row * qs + h * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack2(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    if (t == 0)
      p.lse[((int64_t)b * p.H + h) * p.Sq + row] =
          l[r] > 0.f ? m[r] * kLn2 + logf(l[r]) : kNoKeyLse;
  }
}

// ---------------------------------------------------------- bf16 dK/dV
// flash_bwd_dkdv_wgmma: one block per (key tile of BK = 64 * NWG keys, kv
// head, batch), on the dK/dV step of attn_bwd_tiles.cuh (its layout
// ptt::attn::Dkdv: NWG consumer warpgroups of 64 keys each, 2 at D = 64
// and 1 at D = 128, and one producer warp):
//   * the producer's lane 0 loads the block's K and V once by TMA, then for
//     each step (q head of the group, q tile of 64 rows in the band) the Q
//     and dO tiles (128-byte swizzle) and the rows' lse and delta (1-D
//     TMA) into a ring of kStages stages (6 at D = 64, 5 at D = 128), each
//     completing on one mbarrier (`full`); it refills a stage once every
//     consumer thread has arrived on its `empty`. On the H100, a ring of
//     2 with the key tile the fastest grid axis took 0.92 ms at the
//     training shape, 0.60 with both changed: causal Q/dO tiles miss L2,
//     and one step's products do not cover the load;
//   * each consumer warpgroup runs attn::dkdv_step on each staged tile
//     (S^T, dP^T, then dV += P^T dO issued before dS^T is computed, then
//     dK += dS^T Q). The softmax takes one FFMA and one SFU ex2 an
//     element, and the mask runs only on tiles that need it: with a branch
//     and a denormal-safe exp2f on every element (and dV issued after dS)
//     the kernel took 0.60 ms at the training shape, 0.39 then, the
//     CUDA-core work between the products being what held the warpgroups
//     back. A warpgroup skips the products of a tile its keys do not see.
// Rows past Sq arrive as zeros (TMA fills out-of-bounds rows) and are
// masked. dK and dV stay in registers and are written once.
using ptt::attn::Dkdv;

// some (q, k) pair of rows [q0, q0 + 63] x keys [k0, k0 + 63] is kept
__device__ __forceinline__ bool tile_live(const Params& p, int q0, int k0) {
  if (q0 >= p.Sq || k0 >= p.Sk) return false;
  int lo, hi;
  key_band(p, q0, min(q0 + 63, p.Sq - 1), lo, hi);
  return max(lo, k0) <= min(hi, k0 + 63);
}

// the dense band for one warpgroup's keys [kw0, kw0 + 63] (this thread's
// kr0 and kr0 + 8) against the 64 rows from q0
struct DkdvBand {
  const Params p;
  int kw0, kr0;
  __device__ bool live(int q0) const { return tile_live(p, q0, kw0); }
  __device__ bool full(int q0) const {
    return tile_full(p, q0, q0 + 63, kw0, kw0 + 63) && q0 + 64 <= p.Sq;
  }
  __device__ bool kept(int q0, int r, int c) const {
    return q0 + c < p.Sq && keep(p, q0 + c, kr0 + 8 * r);
  }
};

template <int D>
__global__ void __launch_bounds__(Dkdv<D>::kThreads, 1)
    flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tmQ,
                         const __grid_constant__ CUtensorMap tmO,
                         const __grid_constant__ CUtensorMap tmK,
                         const __grid_constant__ CUtensorMap tmV,
                         const __grid_constant__ CUtensorMap tmL,
                         const __grid_constant__ CUtensorMap tmDelta,
                         const Params p) {
  using L = Dkdv<D>;
  constexpr int BQ = 64;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* base =
      smem + ((1024 - (ptt::smem_addr(smem) & 1023)) & 1023);
  unsigned char* sK = base;
  unsigned char* sV = base + L::kKV;
  auto stage = [&](int s) { return base + 2 * L::kKV + s * L::kStage; };
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* kvbar = empty + L::kStages;

  // the key tile is the slowest grid axis, so blocks start longest first
  // (under causal the first keys see the most rows)
  const int kvh = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
  const int group = p.H / p.KVH;
  const int k0 = kt * L::kBK, k_last = min(k0 + L::kBK, p.Sk) - 1;
  int qlo, qhi;
  query_band(p, k0, k_last, qlo, qhi);
  const int t_lo = qlo / BQ;
  const int nqt = qhi >= qlo ? qhi / BQ - t_lo + 1 : 0;
  const int n_steps = group * nqt;  // (q head of the group, q tile)

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      ptt::mbar_init(&full[s], 1);
      ptt::mbar_init(&empty[s], L::kNWG * 128);
    }
    ptt::mbar_init(kvbar, 1);
    ptt::mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == L::kNWG * 4) {  // ------------------------------- producer
    if (lane == 0 && n_steps > 0) {
      ptt::mbar_arrive_expect_tx(kvbar, 2 * L::kKV);
      for (int sub = 0; sub < L::kSub; ++sub) {
        ptt::tma_load_4d(sK + sub * L::kBK * 128, &tmK, kvbar, sub * 64, kvh,
                         k0, b);
        ptt::tma_load_4d(sV + sub * L::kBK * 128, &tmV, kvbar, sub * 64, kvh,
                         k0, b);
      }
      for (int it = 0; it < n_steps; ++it) {
        const int s = it % L::kStages;
        if (it >= L::kStages)  // the consumers released this stage
          ptt::mbar_wait(&empty[s], (it / L::kStages - 1) & 1);
        const int h = kvh * group + it / nqt;
        const int q0 = (t_lo + it % nqt) * BQ;
        unsigned char* st = stage(s);
        ptt::mbar_arrive_expect_tx(&full[s], L::kStageTx);
        for (int sub = 0; sub < L::kSub; ++sub) {
          ptt::tma_load_4d(st + sub * 64 * 128, &tmQ, &full[s], sub * 64, h,
                           q0, b);
          ptt::tma_load_4d(st + L::kQO + sub * 64 * 128, &tmO, &full[s],
                           sub * 64, h, q0, b);
        }
        const int row = (b * p.H + h) * p.Sq + q0;  // from 16 bytes
        ptt::tma_load_1d(st + 2 * L::kQO, &tmL, &full[s], row & ~3);
        ptt::tma_load_1d(st + 2 * L::kQO + 512, &tmDelta, &full[s],
                         row & ~3);
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, t = lane % 4;
  const int kw0 = k0 + 64 * wg;  // this warpgroup's 64 keys
  const int kr0 = kw0 + 16 * wq + g;  // this thread's keys: kr0, kr0 + 8
  const DkdvBand band{p, kw0, kr0};
  float dk[D / 2] = {}, dv[D / 2] = {};
  if (n_steps > 0) ptt::mbar_wait(kvbar, 0);
  for (int it = 0; it < n_steps; ++it) {
    const int s = it % L::kStages;
    ptt::mbar_wait(&full[s], (it / L::kStages) & 1);
    const int q0 = (t_lo + it % nqt) * BQ;
    const int row = (b * p.H + kvh * group + it / nqt) * p.Sq + q0;
    ptt::attn::dkdv_step<D>(sK + wg * 64 * 128, sV + wg * 64 * 128,
                            L::kBK * 128, stage(s), row & 3,
                            p.scale * kLog2e, p.scale, band, q0, dk, dv);
    ptt::mbar_arrive(&empty[s]);
  }

  // dK, dV: accumulator element 4 j + i is key kr0 + 8 (i / 2), column
  // 8 j + 2 t + i % 2
  const int64_t ks = (int64_t)p.KVH * D;
  bf16* dkg = static_cast<bf16*>(p.dk) + (int64_t)b * p.Sk * ks + kvh * D;
  bf16* dvg = static_cast<bf16*>(p.dv) + (int64_t)b * p.Sk * ks + kvh * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kr = kr0 + 8 * r;
    if (kr >= p.Sk) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int64_t o = kr * ks + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(dkg + o) =
          pack2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dvg + o) =
          pack2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------ bf16 dQ
// flash_bwd_dq_wgmma: the dQ loop of attn_bwd_tiles.cuh (attn::dq_consume,
// shared with the varlen dQ kernel) on flash_fwd_wgmma's blocks: one per
// (kv head, batch, NWG M tiles), the M tiles the slowest grid axis and
// walked last to first, so the blocks with the longest causal key bands
// start first. NWG consumer warpgroups (3 at D = 64, 2 at D = 128, fewer
// where that would leave SMs without a block) and one producer warp:
//   * M packing (GQA): an M tile is 64 (q row, q head) pairs of one kv
//     head's group, 64 / group consecutive rows x the group's heads, one TMA
//     box {64 columns, group heads, rows} of Q and the same of dO, so every
//     K/V tile the block stages serves all the group's heads of its rows
//     (one block per (q tile, q head) stages it once per q head: 7 times at
//     Qwen2's group of 7);
//   * a pair's lse (times log2 e) and delta are fixed for the block: each
//     thread reads its two pairs' values once into registers;
//   * the producer's lane 0 loads the warpgroups' Q and dO tiles once, then
//     the 64-key K and V tiles of the block rows' band (key_band: causal
//     offset Sk - Sq, window; keys past Sk read as zeros) into a ring of
//     kStages stages (5 at D = 64, 4 at D = 128), each tile's first key in
//     step_k0;
//   * the mask (DqBand) runs only on tiles that cross the band's edge for
//     the warpgroup's rows; a warpgroup skips a tile that none of its rows
//     sees.
// A pair past the tile's rows x heads, or a row past Sq (read as zeros),
// is computed on what its rows of Q and dO hold and never written. dQ
// stays in float32 registers and is written once. Its shared memory is
// attn::Dq's.
using ptt::attn::Dq;

// the dense band for one warpgroup's M tile: its rows [w0, w1] (clipped to
// Sq; none when w1 < w0) keep keys [lo, hi] between them; this thread's
// two pairs lie in rows row[0] and row[1] (Sq for a pair past the tile's
// rows x heads)
struct DqBand {
  const Params p;
  int w0, w1, lo, hi, row[2];
  __device__ bool live(int k0) const {
    return w0 <= w1 && max(lo, k0) <= min(hi, k0 + 63);
  }
  __device__ bool full(int k0) const {
    return tile_full(p, w0, w1, k0, k0 + 63) && k0 + 64 <= p.Sk;
  }
  __device__ bool kept(int k0, int r, int c) const {
    return row[r] < p.Sq && k0 + c < p.Sk && keep(p, row[r], k0 + c);
  }
};

template <int D, int NWG>
__global__ void __launch_bounds__(Dq<D, NWG>::kThreads, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tmQ,
                       const __grid_constant__ CUtensorMap tmO,
                       const __grid_constant__ CUtensorMap tmK,
                       const __grid_constant__ CUtensorMap tmV,
                       const Params p) {
  using L = Dq<D, NWG>;
  using ptt::attn::kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* base =
      smem + ((1024 - (ptt::smem_addr(smem) & 1023)) & 1023);
  unsigned char* ring = base + L::kNWG * L::kQdO;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* qbar = empty + L::kStages;
  int* step_k0 = reinterpret_cast<int*>(qbar + 1);  // [kStages]

  const int group = p.H / p.KVH, rows = 64 / group;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int mt = gridDim.z - 1 - blockIdx.z;  // longest causal rows first
  const int r0 = mt * L::kNWG * rows;
  const int r_last = min(r0 + L::kNWG * rows, p.Sq) - 1;
  int klo, khi;
  key_band(p, r0, r_last, klo, khi);
  const int t_lo = klo / 64;
  const int n_tiles = khi >= klo ? khi / 64 - t_lo + 1 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      ptt::mbar_init(&full[s], 1);
      ptt::mbar_init(&empty[s], L::kNWG * 128);
    }
    ptt::mbar_init(qbar, 1);
    ptt::mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == L::kNWG * 4) {  // ------------------------------- producer
    if (lane == 0 && n_tiles > 0) {
      ptt::mbar_arrive_expect_tx(qbar,
                                 L::kNWG * 2 * L::kSub * group * rows * 128);
      for (int wg = 0; wg < L::kNWG; ++wg)
        for (int sub = 0; sub < L::kSub; ++sub) {
          unsigned char* q = base + wg * L::kQdO + sub * kTile;
          ptt::tma_load_4d(q, &tmQ, qbar, sub * 64, kvh * group,
                           r0 + wg * rows, b);
          ptt::tma_load_4d(q + L::kSub * kTile, &tmO, qbar, sub * 64,
                           kvh * group, r0 + wg * rows, b);
        }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % L::kStages;
        if (j >= L::kStages)  // the consumers released this stage
          ptt::mbar_wait(&empty[s], (j / L::kStages - 1) & 1);
        const int k0 = (t_lo + j) * 64;
        step_k0[s] = k0;  // published by the arrive below
        unsigned char* st = ring + s * L::kStage;
        ptt::mbar_arrive_expect_tx(&full[s], L::kStage);
        for (int sub = 0; sub < L::kSub; ++sub) {
          ptt::tma_load_4d(st + sub * kTile, &tmK, &full[s], sub * 64, kvh,
                           k0, b);
          ptt::tma_load_4d(st + (L::kSub + sub) * kTile, &tmV, &full[s],
                           sub * 64, kvh, k0, b);
        }
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, t = lane % 4;
  const int w0 = r0 + wg * rows;  // this warpgroup's rows w0..
  const int pa0 = 16 * wq + g;    // this thread's pairs: pa0, pa0 + 8
  DqBand band{p, w0, min(w0 + rows, p.Sq) - 1, 0, -1, {p.Sq, p.Sq}};
  key_band(p, band.w0, band.w1, band.lo, band.hi);
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pair = pa0 + 8 * r, row = w0 + pair / group;
    const int64_t i =
        ((int64_t)b * p.H + kvh * group + pair % group) * p.Sq + row;
    if (pair < rows * group && row < p.Sq) band.row[r] = row;
    lse2[r] = band.row[r] < p.Sq ? p.lse_in[i] * kLog2e : 0.f;
    dl[r] = band.row[r] < p.Sq ? p.delta[i] : 0.f;
  }
  const unsigned char* sQ = base + wg * L::kQdO;
  float dq[D / 2] = {};
  if (n_tiles > 0) {
    ptt::mbar_wait(qbar, 0);
    ptt::attn::dq_consume<D, L::kStages>(
        sQ, sQ + L::kSub * kTile, ring, L::kStage, step_k0, full, empty,
        n_tiles, lse2, dl, p.scale * kLog2e, p.scale, band, dq);
  }

  // dq: accumulator element 4 j + i is pair pa0 + 8 (i / 2), column
  // 8 j + 2 t + i % 2
  const int64_t qs = (int64_t)p.H * D;
  bf16* dqg = static_cast<bf16*>(p.dq) + (int64_t)b * p.Sq * qs;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (band.row[r] >= p.Sq) continue;
    bf16* dst = dqg + band.row[r] * qs +
                (kvh * group + (pa0 + 8 * r) % group) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
  }
}

// ------------------------------------------------------- float32 kernels
// One warp per row (forward, dQ) or per key (dK/dV); each lane owns D/32
// elements of the row. Float32 throughout on the CUDA cores.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(const Params p) {
  constexpr int E = D / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (p.H / p.KVH);
  if (row >= p.Sq) return;
  const int64_t qs = (int64_t)p.H * D, ks = (int64_t)p.KVH * D;
  const float* q = static_cast<const float*>(p.q) +
                   ((int64_t)b * p.Sq + row) * qs + h * D;
  const float* kg =
      static_cast<const float*>(p.k) + (int64_t)b * p.Sk * ks + kvh * D;
  const float* vg =
      static_cast<const float*>(p.v) + (int64_t)b * p.Sk * ks + kvh * D;
  float qv[E], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    qv[e] = q[lane + 32 * e];
    acc[e] = 0.f;
  }
  int lo, hi;
  key_band(p, row, row, lo, hi);
  float m = -INFINITY, l = 0.f;
  for (int j = lo; j <= hi; ++j) {
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) d += qv[e] * kg[j * ks + lane + 32 * e];
    const float x = ptt::warp_sum(d) * p.scale;
    const float mn = fmaxf(m, x);
    const float corr = expf(m - mn), pe = expf(x - mn);
    l = l * corr + pe;
#pragma unroll
    for (int e = 0; e < E; ++e)
      acc[e] = acc[e] * corr + pe * vg[j * ks + lane + 32 * e];
    m = mn;
  }
  float* o = static_cast<float*>(p.out) + ((int64_t)b * p.Sq + row) * qs +
             h * D;
#pragma unroll
  for (int e = 0; e < E; ++e) o[lane + 32 * e] = l > 0.f ? acc[e] / l : 0.f;
  if (lane == 0)
    p.lse[((int64_t)b * p.H + h) * p.Sq + row] =
        l > 0.f ? m + logf(l) : kNoKeyLse;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_f32(const Params p) {
  constexpr int E = D / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (p.H / p.KVH);
  if (row >= p.Sq) return;
  const int64_t qs = (int64_t)p.H * D, ks = (int64_t)p.KVH * D;
  const int64_t qoff = ((int64_t)b * p.Sq + row) * qs + h * D;
  const float* q = static_cast<const float*>(p.q) + qoff;
  const float* dout = static_cast<const float*>(p.dout) + qoff;
  const float* kg =
      static_cast<const float*>(p.k) + (int64_t)b * p.Sk * ks + kvh * D;
  const float* vg =
      static_cast<const float*>(p.v) + (int64_t)b * p.Sk * ks + kvh * D;
  const int64_t li = ((int64_t)b * p.H + h) * p.Sq + row;
  const float lse = p.lse_in[li], delta = p.delta[li];
  float qv[E], dov[E], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    qv[e] = q[lane + 32 * e];
    dov[e] = dout[lane + 32 * e];
    acc[e] = 0.f;
  }
  int lo, hi;
  key_band(p, row, row, lo, hi);
  for (int j = lo; j <= hi; ++j) {
    float d = 0.f, dd = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      d += qv[e] * kg[j * ks + lane + 32 * e];
      dd += dov[e] * vg[j * ks + lane + 32 * e];
    }
    const float pe = expf(ptt::warp_sum(d) * p.scale - lse);
    const float ds = pe * (ptt::warp_sum(dd) - delta) * p.scale;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += ds * kg[j * ks + lane + 32 * e];
  }
  float* dq = static_cast<float*>(p.dq) + qoff;
#pragma unroll
  for (int e = 0; e < E; ++e) dq[lane + 32 * e] = acc[e];
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_f32(const Params p) {
  constexpr int E = D / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key = blockIdx.x * kWarps + warp;
  const int kvh = blockIdx.y, b = blockIdx.z, group = p.H / p.KVH;
  if (key >= p.Sk) return;
  const int64_t qs = (int64_t)p.H * D, ks = (int64_t)p.KVH * D;
  const int64_t koff = ((int64_t)b * p.Sk + key) * ks + kvh * D;
  float kv[E], vv[E], dk[E], dv[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    kv[e] = static_cast<const float*>(p.k)[koff + lane + 32 * e];
    vv[e] = static_cast<const float*>(p.v)[koff + lane + 32 * e];
    dk[e] = dv[e] = 0.f;
  }
  int lo, hi;
  query_band(p, key, key, lo, hi);
  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const float* qg = static_cast<const float*>(p.q) +
                      (int64_t)b * p.Sq * qs + h * D;
    const float* og = static_cast<const float*>(p.dout) +
                      (int64_t)b * p.Sq * qs + h * D;
    const int64_t lrow = ((int64_t)b * p.H + h) * p.Sq;
    for (int i = lo; i <= hi; ++i) {
      float d = 0.f, dd = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        d += qg[i * qs + lane + 32 * e] * kv[e];
        dd += og[i * qs + lane + 32 * e] * vv[e];
      }
      const float pe = expf(ptt::warp_sum(d) * p.scale - p.lse_in[lrow + i]);
      const float ds =
          pe * (ptt::warp_sum(dd) - p.delta[lrow + i]) * p.scale;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        dv[e] += pe * og[i * qs + lane + 32 * e];
        dk[e] += ds * qg[i * qs + lane + 32 * e];
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    static_cast<float*>(p.dk)[koff + lane + 32 * e] = dk[e];
    static_cast<float*>(p.dv)[koff + lane + 32 * e] = dv[e];
  }
}

// ---------------------------------------------------------------- launch
// the tensor maps (built here, on the host, for each call), then the launch
template <int D>
int launch_dkdv_wgmma(const Params& p, cudaStream_t stream) {
  using L = Dkdv<D>;
  const ptt::EncodeTiled enc = ptt::tensor_map_encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mo, mk, mv, ml, md;
  const int64_t rows = (int64_t)p.B * p.H * p.Sq;
  if (!ptt::map_rows(enc, &mq, p.q, D, p.H, p.Sq, p.B, 64) ||
      !ptt::map_rows(enc, &mo, p.dout, D, p.H, p.Sq, p.B, 64) ||
      !ptt::map_rows(enc, &mk, p.k, D, p.KVH, p.Sk, p.B, L::kBK) ||
      !ptt::map_rows(enc, &mv, p.v, D, p.KVH, p.Sk, p.B, L::kBK) ||
      !ptt::map_flat(enc, &ml, p.lse_in, rows, ptt::attn::kRowBox) ||
      !ptt::map_flat(enc, &md, p.delta, rows, ptt::attn::kRowBox))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kSmem);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv_wgmma<D>
      <<<dim3(p.KVH, p.B, blocks(p.Sk, L::kBK)), L::kThreads, L::kSmem,
         stream>>>(mq, mo, mk, mv, ml, md, p);
  return (int)cudaGetLastError();
}

template <int D, int NWG>
int launch_fwd_wgmma(const Params& p, unsigned mtiles, const CUtensorMap& mq,
                     const CUtensorMap& mk, const CUtensorMap& mv,
                     cudaStream_t stream) {
  using L = Fwd<D, NWG>;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma<D, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kSmem);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_wgmma<D, NWG><<<dim3(p.KVH, p.B, mtiles), L::kThreads, L::kSmem,
                            stream>>>(mq, mk, mv, p);
  return (int)cudaGetLastError();
}

// the tensor maps, then the launch
template <int D>
int launch_fwd(const Params& p, cudaStream_t stream) {
  const ptt::EncodeTiled enc = ptt::tensor_map_encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const int group = p.H / p.KVH;
  if (group > 64) return (int)cudaErrorInvalidValue;  // an M tile's pairs
  const int rows = 64 / group;
  const int nwg = consumer_warpgroups<D>(p.Sq, rows, (int64_t)p.KVH * p.B);
  const unsigned mtiles = blocks(p.Sq, nwg * rows);
  if (mtiles > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!ptt::map_heads_rows(enc, &mq, p.q, D, p.H, p.Sq, p.B, group, rows) ||
      !ptt::map_rows(enc, &mk, p.k, D, p.KVH, p.Sk, p.B, 64) ||
      !ptt::map_rows(enc, &mv, p.v, D, p.KVH, p.Sk, p.B, 64))
    return (int)cudaErrorInvalidValue;
  if constexpr (D == 64)
    if (nwg == 3) return launch_fwd_wgmma<D, 3>(p, mtiles, mq, mk, mv, stream);
  return nwg == 2 ? launch_fwd_wgmma<D, 2>(p, mtiles, mq, mk, mv, stream)
                  : launch_fwd_wgmma<D, 1>(p, mtiles, mq, mk, mv, stream);
}

template <int D, int NWG>
int launch_dq_wgmma(const Params& p, const CUtensorMap& mq,
                    const CUtensorMap& mo, const CUtensorMap& mk,
                    const CUtensorMap& mv, cudaStream_t stream) {
  using L = Dq<D, NWG>;
  const unsigned mtiles = blocks(p.Sq, NWG * (64 / (p.H / p.KVH)));
  if (mtiles > 65535) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma<D, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kSmem);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_wgmma<D, NWG><<<dim3(p.KVH, p.B, mtiles), L::kThreads,
                               L::kSmem, stream>>>(mq, mo, mk, mv, p);
  return (int)cudaGetLastError();
}

// the tensor maps (Q and dO in M tiles, as the forward's Q), then the
// launch
template <int D>
int launch_dq(const Params& p, cudaStream_t stream) {
  const ptt::EncodeTiled enc = ptt::tensor_map_encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const int group = p.H / p.KVH;
  if (group > 64) return (int)cudaErrorInvalidValue;  // an M tile's pairs
  const int rows = 64 / group;
  CUtensorMap mq, mo, mk, mv;
  if (!ptt::map_heads_rows(enc, &mq, p.q, D, p.H, p.Sq, p.B, group, rows) ||
      !ptt::map_heads_rows(enc, &mo, p.dout, D, p.H, p.Sq, p.B, group,
                           rows) ||
      !ptt::map_rows(enc, &mk, p.k, D, p.KVH, p.Sk, p.B, 64) ||
      !ptt::map_rows(enc, &mv, p.v, D, p.KVH, p.Sk, p.B, 64))
    return (int)cudaErrorInvalidValue;
  const int nwg = consumer_warpgroups<D>(p.Sq, rows, (int64_t)p.KVH * p.B);
  if constexpr (D == 64)
    if (nwg == 3) return launch_dq_wgmma<D, 3>(p, mq, mo, mk, mv, stream);
  return nwg == 2 ? launch_dq_wgmma<D, 2>(p, mq, mo, mk, mv, stream)
                  : launch_dq_wgmma<D, 1>(p, mq, mo, mk, mv, stream);
}

int check(const Params& p, int64_t D, int dtype) {
  if (p.B <= 0 || p.H <= 0 || p.KVH <= 0 || p.Sq <= 0 || p.Sk <= 0 ||
      p.H % p.KVH != 0 || p.B > 65535 || p.H > 65535 ||
      (D != 64 && D != 128) ||
      (dtype != ptt::kFloat32 && dtype != ptt::kBFloat16))
    return (int)cudaErrorInvalidValue;
  return 0;
}

Params make(int64_t B, int64_t H, int64_t KVH, int64_t Sq, int64_t Sk,
            float scale, int causal, int64_t window) {
  Params p{};
  p.B = (int)B;
  p.H = (int)H;
  p.KVH = (int)KVH;
  p.Sq = (int)Sq;
  p.Sk = (int)Sk;
  p.scale = scale;
  p.causal = causal;
  p.window = causal ? (int)window : 0;
  return p;
}

}  // namespace

// q [B, Sq, H, D], k/v [B, Sk, KVH, D] contiguous -> out [B, Sq, H, D],
// lse [B, H, Sq] float32. Returns the launch's cudaGetLastError().
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int64_t B, int64_t H,
                             int64_t KVH, int64_t Sq, int64_t Sk, int64_t D,
                             float scale, int causal, int64_t window,
                             int dtype, void* stream) {
  Params p = make(B, H, KVH, Sq, Sk, scale, causal, window);
  if (int e = check(p, D, dtype)) return e;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBFloat16)
    return D == 64 ? launch_fwd<64>(p, s) : launch_fwd<128>(p, s);
  const dim3 gf(blocks(p.Sq, kWarps), p.H, p.B);
  return D == 64 ? launch(flash_fwd_f32<64>, gf, 0, s, p)
                 : launch(flash_fwd_f32<128>, gf, 0, s, p);
}

// q, dout [B, Sq, H, D], k, v [B, Sk, KVH, D], lse, delta [B, H, Sq]
// float32 -> dk, dv [B, Sk, KVH, D].
extern "C" int ptt_flash_bwd_dkdv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int64_t B, int64_t H,
                                  int64_t KVH, int64_t Sq, int64_t Sk,
                                  int64_t D, float scale, int causal,
                                  int64_t window, int dtype, void* stream) {
  Params p = make(B, H, KVH, Sq, Sk, scale, causal, window);
  if (int e = check(p, D, dtype)) return e;
  if (p.KVH > 65535 || blocks(p.Sk, 64) > 65535)
    return (int)cudaErrorInvalidValue;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = dk;
  p.dv = dv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBFloat16)
    return D == 64 ? launch_dkdv_wgmma<64>(p, s) : launch_dkdv_wgmma<128>(p, s);
  const dim3 gf(blocks(p.Sk, kWarps), p.KVH, p.B);
  return D == 64 ? launch(flash_bwd_dkdv_f32<64>, gf, 0, s, p)
                 : launch(flash_bwd_dkdv_f32<128>, gf, 0, s, p);
}

// as ptt_flash_bwd_dkdv -> dq [B, Sq, H, D].
extern "C" int ptt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int64_t B,
                                int64_t H, int64_t KVH, int64_t Sq,
                                int64_t Sk, int64_t D, float scale,
                                int causal, int64_t window, int dtype,
                                void* stream) {
  Params p = make(B, H, KVH, Sq, Sk, scale, causal, window);
  if (int e = check(p, D, dtype)) return e;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBFloat16)
    return D == 64 ? launch_dq<64>(p, s) : launch_dq<128>(p, s);
  const dim3 gf(blocks(p.Sq, kWarps), p.H, p.B);
  return D == 64 ? launch(flash_bwd_dq_f32<64>, gf, 0, s, p)
                 : launch(flash_bwd_dq_f32<128>, gf, 0, s, p);
}
