// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces three Pallas kernels of paddle_tpu/ops/kernels/flash_attention.py:
//   * _flash_fwd_kernel      -> flash_fwd_bf16 / flash_fwd_f32
//   * _flash_bwd_dkdv_kernel -> flash_bwd_dkdv_bf16 / flash_bwd_dkdv_f32
//   * _flash_bwd_dq_kernel   -> flash_bwd_dq_bf16 / flash_bwd_dq_f32
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
// limit. The bf16 kernels therefore run their products on the tensor
// cores with mma.sync m16n8k16 (bf16 in, float32 accumulate). wgmma, TMA
// and warp specialisation, which the card's full rate needs, come later.
//
// Design. The Pallas grids carry their accumulators across an innermost
// sequential ("arbitrary") grid axis; CUDA blocks run in no order, so that
// axis becomes a loop inside the block:
//   * forward and dQ: one block per (q tile of 64 rows, q head, batch),
//     4 warps of 16 rows each. The block loops over the 64-key tiles that
//     the causal/window band lets through, bounds computed from
//     offset = Sk - Sq and window (never by testing every tile). m, l and
//     the output (or dQ) accumulator stay in registers in the mma
//     accumulator layout, so the online softmax needs no shared memory.
//   * dK/dV: one block per (64-key tile, kv head, batch), 4 warps of 16
//     keys. The block loops over the group's q heads and, for each, over
//     the q tiles in the band (the reference grid (bhkv, nk, group, nq) as
//     a loop), accumulating dK and dV in float32 registers and writing
//     them once. No atomics: two runs give equal gradients.
//   * K/V (forward, dQ) or Q/dO (dK/dV) tiles are double-buffered in shared
//     memory with cp.async, so the next tile loads while this one computes.
//     Rows are padded by 8 elements so the ldmatrix row reads are free of
//     bank conflicts. Ragged tails are zero-filled and masked.
//   * Tiles wholly inside the band skip the mask; blocks are ordered so the
//     longest causal rows (forward, dQ) or keys (dK/dV) start first.
// Only D = 64 and D = 128 are instantiated (Qwen2-0.5B, Llama-3-8B,
// Mistral); the wrapper refuses other head dims on the card.

#include "flash_tiles.cuh"

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
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(const Params p) {
  constexpr int SD = D + 8, NO = D / 8, NS = kBK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kBQ * SD;      // [2][kBK][SD]
  bf16* sV = sK + 2 * kBK * SD;  // [2][kBK][SD]

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (p.H / p.KVH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kBQ, q_last = min(q0 + kBQ, p.Sq) - 1;
  const int64_t qs = (int64_t)p.H * D, ks = (int64_t)p.KVH * D;
  const bf16* qg = static_cast<const bf16*>(p.q) +
                   ((int64_t)b * p.Sq + q0) * qs + h * D;
  const bf16* kg =
      static_cast<const bf16*>(p.k) + (int64_t)b * p.Sk * ks + kvh * D;
  const bf16* vg =
      static_cast<const bf16*>(p.v) + (int64_t)b * p.Sk * ks + kvh * D;

  int klo, khi;
  key_band(p, q0, q_last, klo, khi);
  const int t_lo = klo / kBK;
  const int t_hi = khi >= klo ? khi / kBK : t_lo - 1;

  load_rows<kBQ, D>(sQ, qg, qs, p.Sq - q0);
  if (t_lo <= t_hi) {
    const int k0 = t_lo * kBK;
    load_rows<kBK, D>(sK, kg + k0 * ks, ks, p.Sk - k0);
    load_rows<kBK, D>(sV, vg + k0 * ks, ks, p.Sk - k0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 16)
    ldsm4(qf[k0 / 16], a_addr<SD>(sQ, warp * 16, k0, lane));

  float o[NO][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl2 = p.scale * kLog2e;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  for (int kt = t_lo; kt <= t_hi; ++kt) {
    const int buf = (kt - t_lo) & 1;
    if (kt < t_hi) {
      const int k1 = (kt + 1) * kBK;
      load_rows<kBK, D>(sK + (buf ^ 1) * kBK * SD, kg + k1 * ks, ks,
                        p.Sk - k1);
      load_rows<kBK, D>(sV + (buf ^ 1) * kBK * SD, vg + k1 * ks, ks,
                        p.Sk - k1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cK = sK + buf * kBK * SD;
    const bf16* cV = sV + buf * kBK * SD;
    const int k0 = kt * kBK;

    // s = q k^T
    float s[NS][4] = {};
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bb[4];
        ldsm4(bb, bn_addr<SD>(cK, np * 16, kd * 16, lane));
        mma16816(s[2 * np], qf[kd], bb[0], bb[1]);
        mma16816(s[2 * np + 1], qf[kd], bb[2], bb[3]);
      }
    }
    // scale into the log2 domain; mask where the tile crosses the band
    // or the end of the keys
    const bool full = tile_full(p, q0, q0 + kBQ - 1, k0, k0 + kBK - 1) &&
                      k0 + kBK <= p.Sk;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[nt][i] * sl2;
        if (!full) {
          const int r = row0 + (i >> 1) * 8, c = k0 + nt * 8 + 2 * t + (i & 1);
          if (c >= p.Sk || !keep(p, r, c)) x = -INFINITY;
        }
        s[nt][i] = x;
      }
    // online softmax: row max over the quad of threads sharing a row
    float mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mu[r] = mx == -INFINITY ? 0.f : mx;  // a row with no key so far
      const float corr = exp2f(m[r] - mu[r]);
      m[r] = mx;
      l[r] *= corr;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * r] *= corr;
        o[n][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = exp2f(s[nt][i] - mu[i >> 1]);
        s[nt][i] = e;
        l[i >> 1] += e;  // this thread's share; the quad sums at the end
      }
    // o += p v, with p rounded to bf16 (the reference casts p to v's type)
    gemm_pb<D, kBK / 16>(o, s, cV, lane);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // out = acc / l (0 for a row that sees no key)
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][2 * r] = l[r] > 0.f ? o[n][2 * r] / l[r] : 0.f;
      o[n][2 * r + 1] = l[r] > 0.f ? o[n][2 * r + 1] / l[r] : 0.f;
    }
  bf16* og = static_cast<bf16*>(p.out) + (int64_t)b * p.Sq * qs + h * D;
  store_rows<D>(og, qs, q0 + warp * 16, p.Sq, o, lane);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;
      if (row < p.Sq)
        p.lse[((int64_t)b * p.H + h) * p.Sq + row] =
            l[r] > 0.f ? m[r] * kLn2 + logf(l[r]) : kNoKeyLse;
    }
  }
}

// ------------------------------------------------------------ bf16 dQ
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_bf16(const Params p) {
  constexpr int SD = D + 8, NO = D / 8, NS = kBK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + kBQ * SD;      // dout
  bf16* sK = sO + kBQ * SD;      // [2][kBK][SD]
  bf16* sV = sK + 2 * kBK * SD;  // [2][kBK][SD]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (p.H / p.KVH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kBQ, q_last = min(q0 + kBQ, p.Sq) - 1;
  const int64_t qs = (int64_t)p.H * D, ks = (int64_t)p.KVH * D;
  const int64_t qoff = ((int64_t)b * p.Sq + q0) * qs + h * D;
  const bf16* kg =
      static_cast<const bf16*>(p.k) + (int64_t)b * p.Sk * ks + kvh * D;
  const bf16* vg =
      static_cast<const bf16*>(p.v) + (int64_t)b * p.Sk * ks + kvh * D;

  int klo, khi;
  key_band(p, q0, q_last, klo, khi);
  const int t_lo = klo / kBK;
  const int t_hi = khi >= klo ? khi / kBK : t_lo - 1;

  load_rows<kBQ, D>(sQ, static_cast<const bf16*>(p.q) + qoff, qs,
                    p.Sq - q0);
  load_rows<kBQ, D>(sO, static_cast<const bf16*>(p.dout) + qoff, qs,
                    p.Sq - q0);
  if (t_lo <= t_hi) {
    const int k0 = t_lo * kBK;
    load_rows<kBK, D>(sK, kg + k0 * ks, ks, p.Sk - k0);
    load_rows<kBK, D>(sV, vg + k0 * ks, ks, p.Sk - k0);
  }
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    const int64_t i = ((int64_t)b * p.H + h) * p.Sq + row;
    lse2[r] = row < p.Sq ? p.lse_in[i] * kLog2e : 0.f;
    dl[r] = row < p.Sq ? p.delta[i] : 0.f;
  }
  const float sl2 = p.scale * kLog2e;
  float dq[NO][4] = {};
  cp_async_wait<0>();
  __syncthreads();

  for (int kt = t_lo; kt <= t_hi; ++kt) {
    const int buf = (kt - t_lo) & 1;
    if (kt < t_hi) {
      const int k1 = (kt + 1) * kBK;
      load_rows<kBK, D>(sK + (buf ^ 1) * kBK * SD, kg + k1 * ks, ks,
                        p.Sk - k1);
      load_rows<kBK, D>(sV + (buf ^ 1) * kBK * SD, vg + k1 * ks, ks,
                        p.Sk - k1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cK = sK + buf * kBK * SD;
    const bf16* cV = sV + buf * kBK * SD;
    const int k0 = kt * kBK;

    float s[NS][4] = {};
    gemm_abt<D, NS>(s, sQ, warp * 16, cK, lane);  // q k^T
    const bool full = tile_full(p, q0, q0 + kBQ - 1, k0, k0 + kBK - 1) &&
                      k0 + kBK <= p.Sk;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float e = exp2f(s[nt][i] * sl2 - lse2[i >> 1]);
        if (!full) {
          const int r = row0 + (i >> 1) * 8, c = k0 + nt * 8 + 2 * t + (i & 1);
          if (c >= p.Sk || !keep(p, r, c)) e = 0.f;
        }
        s[nt][i] = e;
      }
    float dp[NS][4] = {};
    gemm_abt<D, NS>(dp, sO, warp * 16, cV, lane);  // dout v^T
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dp[nt][i] = s[nt][i] * (dp[nt][i] - dl[i >> 1]) * p.scale;
    gemm_pb<D, kBK / 16>(dq, dp, cK, lane);  // dq += ds k
    __syncthreads();
  }
  store_rows<D>(static_cast<bf16*>(p.dq) + (int64_t)b * p.Sq * qs + h * D,
                qs, q0 + warp * 16, p.Sq, dq, lane);
}

// ---------------------------------------------------------- bf16 dK/dV
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_bf16(const Params p) {
  constexpr int BQ = dkdv_bq<D>();
  constexpr int SD = D + 8, NO = D / 8, NS = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kBK * SD;
  bf16* sQ = sV + kBK * SD;     // [2][BQ][SD]
  bf16* sO = sQ + 2 * BQ * SD;  // [2][BQ][SD] dout
  float* sL = reinterpret_cast<float*>(sO + 2 * BQ * SD);  // [2][BQ]
  float* sD = sL + 2 * BQ;                                 // [2][BQ]

  const int kt = blockIdx.x;  // the first keys see the most rows
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = p.H / p.KVH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kt * kBK, k_last = min(k0 + kBK, p.Sk) - 1;
  const int64_t qs = (int64_t)p.H * D, ks = (int64_t)p.KVH * D;
  const int64_t koff = ((int64_t)b * p.Sk + k0) * ks + kvh * D;

  int qlo, qhi;
  query_band(p, k0, k_last, qlo, qhi);
  const int t_lo = qlo / BQ;
  const int nqt = qhi >= qlo ? qhi / BQ - t_lo + 1 : 0;
  const int n_steps = group * nqt;  // (q head of the group, q tile)

  // stage step `it` (its q tile, dout tile, lse and delta) into buffer buf
  auto stage = [&](int it, int buf) {
    const int h = kvh * group + it / nqt;
    const int q0 = (t_lo + it % nqt) * BQ;
    const int64_t off = ((int64_t)b * p.Sq + q0) * qs + h * D;
    load_rows<BQ, D>(sQ + buf * BQ * SD, static_cast<const bf16*>(p.q) + off,
                     qs, p.Sq - q0);
    load_rows<BQ, D>(sO + buf * BQ * SD,
                     static_cast<const bf16*>(p.dout) + off, qs, p.Sq - q0);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const int row = q0 + i;
      const int64_t j = ((int64_t)b * p.H + h) * p.Sq + row;
      // rows past the end: lse = +inf makes p = 0
      sL[buf * BQ + i] = row < p.Sq ? p.lse_in[j] * kLog2e : INFINITY;
      sD[buf * BQ + i] = row < p.Sq ? p.delta[j] : 0.f;
    }
  };

  load_rows<kBK, D>(sK, static_cast<const bf16*>(p.k) + koff, ks, p.Sk - k0);
  load_rows<kBK, D>(sV, static_cast<const bf16*>(p.v) + koff, ks, p.Sk - k0);
  if (n_steps > 0) stage(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const float sl2 = p.scale * kLog2e;
  const int krow0 = k0 + warp * 16 + g;  // this thread's keys: krow0, +8
  float dk[NO][4] = {}, dv[NO][4] = {};

  for (int it = 0; it < n_steps; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_steps) {
      stage(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cQ = sQ + buf * BQ * SD;
    const bf16* cO = sO + buf * BQ * SD;
    const float* cL = sL + buf * BQ;
    const float* cD = sD + buf * BQ;
    const int q0 = (t_lo + it % nqt) * BQ;

    // s^T = k q^T: this warp's 16 keys against the BQ rows
    float s[NS][4] = {};
    gemm_abt<D, NS>(s, sK, warp * 16, cQ, lane);
    const bool full = tile_full(p, q0, q0 + BQ - 1, k0, k0 + kBK - 1);
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = nt * 8 + 2 * t + (i & 1);
        float e = exp2f(s[nt][i] * sl2 - cL[c]);
        if (!full && !keep(p, q0 + c, krow0 + (i >> 1) * 8)) e = 0.f;
        s[nt][i] = e;
      }
    gemm_pb<D, BQ / 16>(dv, s, cO, lane);  // dv += p^T dout
    float dp[NS][4] = {};
    gemm_abt<D, NS>(dp, sV, warp * 16, cO, lane);  // (dout v^T)^T
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dp[nt][i] =
            s[nt][i] * (dp[nt][i] - cD[nt * 8 + 2 * t + (i & 1)]) * p.scale;
    gemm_pb<D, BQ / 16>(dk, dp, cQ, lane);  // dk += ds^T q
    __syncthreads();
  }
  store_rows<D>(static_cast<bf16*>(p.dk) + (int64_t)b * p.Sk * ks + kvh * D,
                ks, k0 + warp * 16, p.Sk, dk, lane);
  store_rows<D>(static_cast<bf16*>(p.dv) + (int64_t)b * p.Sk * ks + kvh * D,
                ks, k0 + warp * 16, p.Sk, dv, lane);
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
  const dim3 gb(blocks(p.Sq, kBQ), p.H, p.B), gf(blocks(p.Sq, kWarps), p.H, p.B);
  if (dtype == ptt::kBFloat16)
    return D == 64 ? launch(flash_fwd_bf16<64>, gb, fwd_smem<64>(), s, p)
                   : launch(flash_fwd_bf16<128>, gb, fwd_smem<128>(), s, p);
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
  if (p.KVH > 65535) return (int)cudaErrorInvalidValue;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = dk;
  p.dv = dv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 gb(blocks(p.Sk, kBK), p.KVH, p.B),
      gf(blocks(p.Sk, kWarps), p.KVH, p.B);
  if (dtype == ptt::kBFloat16)
    return D == 64
               ? launch(flash_bwd_dkdv_bf16<64>, gb, dkdv_smem<64>(), s, p)
               : launch(flash_bwd_dkdv_bf16<128>, gb, dkdv_smem<128>(), s, p);
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
  const dim3 gb(blocks(p.Sq, kBQ), p.H, p.B), gf(blocks(p.Sq, kWarps), p.H, p.B);
  if (dtype == ptt::kBFloat16)
    return D == 64 ? launch(flash_bwd_dq_bf16<64>, gb, dq_smem<64>(), s, p)
                   : launch(flash_bwd_dq_bf16<128>, gb, dq_smem<128>(), s, p);
  return D == 64 ? launch(flash_bwd_dq_f32<64>, gf, 0, s, p)
                 : launch(flash_bwd_dq_f32<128>, gf, 0, s, p);
}
