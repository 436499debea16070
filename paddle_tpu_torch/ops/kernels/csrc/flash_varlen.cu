// Packed (varlen) flash attention forward and backward for Hopper
// (sm_90a).
//
// Replaces three Pallas kernels of paddle_tpu/ops/kernels/flash_varlen.py:
//   * _varlen_fwd_kernel      -> varlen_fwd_bf16 / varlen_fwd_f32
//   * _varlen_bwd_dkdv_kernel -> varlen_bwd_dkdv_bf16 / varlen_bwd_dkdv_f32
//   * _varlen_bwd_dq_kernel   -> varlen_bwd_dq_bf16 / varlen_bwd_dq_f32
//
// Computes, for q [Tq, H, D] and k/v [Tk, KVH, D] packed along the token
// axis (read in place), with segment boundaries cu_q and cu_k (int32
// [B + 1], nondecreasing, on the card), q head h reading kv head
// h / (H / KVH):
//   * token t lies in segment s = the number of j in 1..B with
//     cu[j] <= t (the reference's searchsorted(cu[1:], t, "right")), at
//     local position t - cu[s]; tokens past cu[B] form segment B;
//   * the key k is kept for the row q iff seg_q == seg_k and, with causal,
//     loc_q >= loc_k: causal is top-left aligned inside each segment;
//   * forward: out = softmax(q k^T * scale) v and lse [H, Tq] float32;
//     backward, given dout and delta = rowsum(dout * out) [H, Tq]: dq, dk,
//     dv as in flash_attention.cu. A row that sees no key (an empty k
//     segment) gets out = 0, lse = -1e30 and zero gradients.
// Rounding follows the TPU kernel: p is cast to v's type before p v, ds
// to q's type before ds k and ds^T q; the softmax math is float32. Float32
// inputs take the *_f32 kernels (CUDA cores, small shapes only).
//
// What bounds it on the H100: operations, as for the dense kernels, but
// counted over the kept pairs alone: about sum_i s_i^2 (half of it with
// causal) per head, not Tq * Tk.
//
// Design: the dense kernels' tiles (flash_tiles.cuh: mma.sync bf16,
// cp.async double buffers, 64-row blocks of 4 warps), with the causal
// band replaced by segments.
//   * Every kept set is an interval. Row q keeps keys [klo, khi]: klo is
//     the first key of its segment, khi its last, or with causal
//     cu_k[s] + loc_q if that is smaller. Key k is kept by rows [qlo, qhi]
//     in the mirror image. Both ends never decrease along the rows (keys),
//     so a thread finds its two rows' (keys') intervals once by binary
//     search over cu and masks with two compares, and a tile is full when
//     its last row's klo and its first row's khi enclose it.
//   * A block walks only the key tiles (q tiles for dK/dV) that the
//     segments of its rows (keys) reach, segment by segment, each tile
//     once, found from cu and never by testing every tile: the work is
//     ~O(sum_i s_i^2). A q tile that spans several segments walks the key
//     tiles of each.
//   * Forward and dQ: one block per (64-row q tile, q head). dK/dV: one
//     block per (64-key tile, kv head), walking the group's q heads and,
//     for each, its q tiles, with dK and dV in float32 registers written
//     once. No atomics: two runs give equal gradients.
// Only D = 64 and D = 128 are instantiated; the wrapper refuses others.

#include "flash_tiles.cuh"

namespace {

struct VParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  const int* cu_q;
  const int* cu_k;
  void* out;
  float* lse;
  void* dq;
  void* dk;
  void* dv;
  int B, H, KVH, Tq, Tk;
  float scale;
  int causal;
};

// ------------------------------------------------------------ segments
// the segment of token t: the number of j in 1..B with cu[j] <= t
__device__ __forceinline__ int seg_of(const int* cu, int B, int t) {
  int lo = 1, hi = B + 1;  // the first j in [1, B] with cu[j] > t, or B + 1
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(cu + mid) <= t) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo - 1;
}

// tokens [seg_beg, seg_end) of segment s among T tokens, clamped to
// [0, T]: boundaries that break the contract give wrong answers, never a
// read or write outside the tensors
__device__ __forceinline__ int seg_beg(const int* cu, int s, int T) {
  return s == 0 ? 0 : min(max(__ldg(cu + s), 0), T);
}
__device__ __forceinline__ int seg_end(const int* cu, int B, int s, int T) {
  return s == B ? T : min(max(__ldg(cu + s + 1), 0), T);
}

// keys [lo, hi] that row q of segment s keeps (empty: hi < lo)
__device__ __forceinline__ void row_keys(const VParams& p, int s, int q,
                                         int& lo, int& hi) {
  lo = seg_beg(p.cu_k, s, p.Tk);
  hi = seg_end(p.cu_k, p.B, s, p.Tk) - 1;
  if (p.causal) hi = min(hi, __ldg(p.cu_k + s) + q - __ldg(p.cu_q + s));
}

// rows [lo, hi] that keep key k of segment s (empty: hi < lo)
__device__ __forceinline__ void key_rows(const VParams& p, int s, int k,
                                         int& lo, int& hi) {
  lo = seg_beg(p.cu_q, s, p.Tq);
  hi = seg_end(p.cu_q, p.B, s, p.Tq) - 1;
  if (p.causal) lo = max(lo, __ldg(p.cu_q + s) + k - __ldg(p.cu_k + s));
}

// the keys a row < Tq keeps; nothing for the zero-filled rows past Tq
__device__ __forceinline__ void row_interval(const VParams& p, int q,
                                             int& lo, int& hi) {
  lo = 0;
  hi = -1;
  if (q < p.Tq) row_keys(p, seg_of(p.cu_q, p.B, q), q, lo, hi);
}

// the rows a key < Tk is kept by; nothing for the keys past Tk
__device__ __forceinline__ void key_interval(const VParams& p, int k,
                                             int& lo, int& hi) {
  lo = 0;
  hi = -1;
  if (k < p.Tk) key_rows(p, seg_of(p.cu_k, p.B, k), k, lo, hi);
}

// The key tiles (kBK keys) that rows [q0, q1] keep, in order, each once:
// for each segment of the rows, the tiles from its first key to the last
// key that its last row in [q0, q1] keeps.
struct KeyTiles {
  int q0, q1, s, s_last, kt, t_hi;
  __device__ KeyTiles(const VParams& p, int q0_, int q1_)
      : q0(q0_), q1(q1_), kt(-1), t_hi(-1) {
    s = seg_of(p.cu_q, p.B, q0) - 1;
    s_last = seg_of(p.cu_q, p.B, q1);
  }
  // the next tile, or -1 when the walk is over (then not called again)
  __device__ int next(const VParams& p) {
    int nk = kt + 1;
    while (nk > t_hi) {
      if (s >= s_last) return -1;
      ++s;
      const int r_last = min(q1, seg_end(p.cu_q, p.B, s, p.Tq) - 1);
      if (r_last < max(q0, seg_beg(p.cu_q, s, p.Tq))) continue;
      int lo, hi;
      row_keys(p, s, r_last, lo, hi);
      if (hi < lo) continue;
      t_hi = hi / kBK;
      nk = max(nk, lo / kBK);
    }
    return kt = nk;
  }
};

// The q tiles (BQ rows) that keep some key of [k0, k1], in order, each
// once: for each segment of the keys, the tiles from the first row that
// keeps its first key in [k0, k1] to the segment's last row.
template <int BQ>
struct QueryTiles {
  int k0, k1, s, s_last, qt, t_hi;
  __device__ QueryTiles(const VParams& p, int k0_, int k1_)
      : k0(k0_), k1(k1_), qt(-1), t_hi(-1) {
    s = seg_of(p.cu_k, p.B, k0) - 1;
    s_last = seg_of(p.cu_k, p.B, k1);
  }
  __device__ int next(const VParams& p) {
    int nq = qt + 1;
    while (nq > t_hi) {
      if (s >= s_last) return -1;
      ++s;
      const int k_first = max(k0, seg_beg(p.cu_k, s, p.Tk));
      if (min(k1, seg_end(p.cu_k, p.B, s, p.Tk) - 1) < k_first) continue;
      int lo, hi;
      key_rows(p, s, k_first, lo, hi);
      if (hi < lo) continue;
      t_hi = hi / BQ;
      nq = max(nq, lo / BQ);
    }
    return qt = nq;
  }
};

// --------------------------------------------------------- bf16 forward
template <int D>
__global__ void __launch_bounds__(kThreads) varlen_fwd_bf16(const VParams p) {
  constexpr int SD = D + 8, NO = D / 8, NS = kBK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kBQ * SD;      // [2][kBK][SD]
  bf16* sV = sK + 2 * kBK * SD;  // [2][kBK][SD]

  const int h = blockIdx.y, kvh = h / (p.H / p.KVH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBQ, q1 = min(q0 + kBQ, p.Tq) - 1;
  const int64_t qs = (int64_t)p.H * D, ks = (int64_t)p.KVH * D;
  const bf16* qg = static_cast<const bf16*>(p.q) + (int64_t)q0 * qs + h * D;
  const bf16* kg = static_cast<const bf16*>(p.k) + kvh * D;
  const bf16* vg = static_cast<const bf16*>(p.v) + kvh * D;

  // this thread's rows row0 and row0 + 8 keep keys [klo, khi]; a tile is
  // full when the last row's klo and the first row's khi enclose it
  const int row0 = q0 + warp * 16 + g;
  int klo[2], khi[2], f_lo, f_hi, unused;
  row_interval(p, row0, klo[0], khi[0]);
  row_interval(p, row0 + 8, klo[1], khi[1]);
  row_interval(p, q1, f_lo, unused);
  row_interval(p, q0, unused, f_hi);

  KeyTiles walk(p, q0, q1);
  int kt = walk.next(p);
  load_rows<kBQ, D>(sQ, qg, qs, p.Tq - q0);
  if (kt >= 0) {
    const int k0 = kt * kBK;
    load_rows<kBK, D>(sK, kg + k0 * ks, ks, p.Tk - k0);
    load_rows<kBK, D>(sV, vg + k0 * ks, ks, p.Tk - k0);
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

  for (int buf = 0; kt >= 0; buf ^= 1) {
    const int nxt = walk.next(p);
    if (nxt >= 0) {
      const int k1 = nxt * kBK;
      load_rows<kBK, D>(sK + (buf ^ 1) * kBK * SD, kg + k1 * ks, ks,
                        p.Tk - k1);
      load_rows<kBK, D>(sV + (buf ^ 1) * kBK * SD, vg + k1 * ks, ks,
                        p.Tk - k1);
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
    // scale into the log2 domain; mask unless every row keeps every key
    const bool full = f_lo <= k0 && k0 + kBK - 1 <= f_hi;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[nt][i] * sl2;
        if (!full) {
          const int r = i >> 1, c = k0 + nt * 8 + 2 * t + (i & 1);
          if (c < klo[r] || c > khi[r]) x = -INFINITY;
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
    kt = nxt;
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
  store_rows<D>(static_cast<bf16*>(p.out) + h * D, qs, q0 + warp * 16, p.Tq,
                o, lane);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;
      if (row < p.Tq)
        p.lse[(int64_t)h * p.Tq + row] =
            l[r] > 0.f ? m[r] * kLn2 + logf(l[r]) : kNoKeyLse;
    }
  }
}

// ------------------------------------------------------------ bf16 dQ
template <int D>
__global__ void __launch_bounds__(kThreads)
    varlen_bwd_dq_bf16(const VParams p) {
  constexpr int SD = D + 8, NO = D / 8, NS = kBK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + kBQ * SD;      // dout
  bf16* sK = sO + kBQ * SD;      // [2][kBK][SD]
  bf16* sV = sK + 2 * kBK * SD;  // [2][kBK][SD]

  const int h = blockIdx.y, kvh = h / (p.H / p.KVH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBQ, q1 = min(q0 + kBQ, p.Tq) - 1;
  const int64_t qs = (int64_t)p.H * D, ks = (int64_t)p.KVH * D;
  const int64_t qoff = (int64_t)q0 * qs + h * D;
  const bf16* kg = static_cast<const bf16*>(p.k) + kvh * D;
  const bf16* vg = static_cast<const bf16*>(p.v) + kvh * D;

  const int row0 = q0 + warp * 16 + g;
  int klo[2], khi[2], f_lo, f_hi, unused;
  row_interval(p, row0, klo[0], khi[0]);
  row_interval(p, row0 + 8, klo[1], khi[1]);
  row_interval(p, q1, f_lo, unused);
  row_interval(p, q0, unused, f_hi);

  KeyTiles walk(p, q0, q1);
  int kt = walk.next(p);
  load_rows<kBQ, D>(sQ, static_cast<const bf16*>(p.q) + qoff, qs,
                    p.Tq - q0);
  load_rows<kBQ, D>(sO, static_cast<const bf16*>(p.dout) + qoff, qs,
                    p.Tq - q0);
  if (kt >= 0) {
    const int k0 = kt * kBK;
    load_rows<kBK, D>(sK, kg + k0 * ks, ks, p.Tk - k0);
    load_rows<kBK, D>(sV, vg + k0 * ks, ks, p.Tk - k0);
  }
  cp_async_commit();

  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    const int64_t i = (int64_t)h * p.Tq + row;
    lse2[r] = row < p.Tq ? p.lse_in[i] * kLog2e : 0.f;
    dl[r] = row < p.Tq ? p.delta[i] : 0.f;
  }
  const float sl2 = p.scale * kLog2e;
  float dq[NO][4] = {};
  cp_async_wait<0>();
  __syncthreads();

  for (int buf = 0; kt >= 0; buf ^= 1) {
    const int nxt = walk.next(p);
    if (nxt >= 0) {
      const int k1 = nxt * kBK;
      load_rows<kBK, D>(sK + (buf ^ 1) * kBK * SD, kg + k1 * ks, ks,
                        p.Tk - k1);
      load_rows<kBK, D>(sV + (buf ^ 1) * kBK * SD, vg + k1 * ks, ks,
                        p.Tk - k1);
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
    const bool full = f_lo <= k0 && k0 + kBK - 1 <= f_hi;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float e = exp2f(s[nt][i] * sl2 - lse2[i >> 1]);
        if (!full) {
          const int r = i >> 1, c = k0 + nt * 8 + 2 * t + (i & 1);
          if (c < klo[r] || c > khi[r]) e = 0.f;
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
    kt = nxt;
  }
  store_rows<D>(static_cast<bf16*>(p.dq) + h * D, qs, q0 + warp * 16, p.Tq,
                dq, lane);
}

// ---------------------------------------------------------- bf16 dK/dV
template <int D>
__global__ void __launch_bounds__(kThreads)
    varlen_bwd_dkdv_bf16(const VParams p) {
  constexpr int BQ = dkdv_bq<D>();
  constexpr int SD = D + 8, NO = D / 8, NS = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kBK * SD;
  bf16* sQ = sV + kBK * SD;     // [2][BQ][SD]
  bf16* sO = sQ + 2 * BQ * SD;  // [2][BQ][SD] dout
  float* sL = reinterpret_cast<float*>(sO + 2 * BQ * SD);  // [2][BQ]
  float* sD = sL + 2 * BQ;                                 // [2][BQ]

  const int kvh = blockIdx.y, group = p.H / p.KVH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kBK, k1 = min(k0 + kBK, p.Tk) - 1;
  const int64_t qs = (int64_t)p.H * D, ks = (int64_t)p.KVH * D;
  const int64_t koff = (int64_t)k0 * ks + kvh * D;

  // this thread's keys krow0 and krow0 + 8 are kept by rows [qlo, qhi];
  // a q tile is full when the last key's qlo and the first key's qhi
  // enclose it
  const int krow0 = k0 + warp * 16 + g;
  int qlo[2], qhi[2], f_lo, f_hi, unused;
  key_interval(p, krow0, qlo[0], qhi[0]);
  key_interval(p, krow0 + 8, qlo[1], qhi[1]);
  key_interval(p, k1, f_lo, unused);
  key_interval(p, k0, unused, f_hi);

  // stage step (q head gi of the group, q tile qt) into buffer buf
  auto stage = [&](int gi, int qt, int buf) {
    const int h = kvh * group + gi;
    const int q0 = qt * BQ;
    const int64_t off = (int64_t)q0 * qs + h * D;
    load_rows<BQ, D>(sQ + buf * BQ * SD, static_cast<const bf16*>(p.q) + off,
                     qs, p.Tq - q0);
    load_rows<BQ, D>(sO + buf * BQ * SD,
                     static_cast<const bf16*>(p.dout) + off, qs, p.Tq - q0);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const int row = q0 + i;
      const int64_t j = (int64_t)h * p.Tq + row;
      // rows past the end: lse = +inf makes p = 0
      sL[buf * BQ + i] = row < p.Tq ? p.lse_in[j] * kLog2e : INFINITY;
      sD[buf * BQ + i] = row < p.Tq ? p.delta[j] : 0.f;
    }
  };

  // the steps: for each q head of the group, the q tiles of the walk
  QueryTiles<BQ> walk(p, k0, k1);
  int gi = 0, qt = walk.next(p);
  load_rows<kBK, D>(sK, static_cast<const bf16*>(p.k) + koff, ks, p.Tk - k0);
  load_rows<kBK, D>(sV, static_cast<const bf16*>(p.v) + koff, ks, p.Tk - k0);
  if (qt >= 0) stage(gi, qt, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const float sl2 = p.scale * kLog2e;
  float dk[NO][4] = {}, dv[NO][4] = {};

  for (int buf = 0; qt >= 0; buf ^= 1) {
    int ngi = gi, nqt = walk.next(p);
    if (nqt < 0 && ++ngi < group) {
      walk = QueryTiles<BQ>(p, k0, k1);
      nqt = walk.next(p);
    }
    if (nqt >= 0) {
      stage(ngi, nqt, buf ^ 1);
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
    const int q0 = qt * BQ;

    // s^T = k q^T: this warp's 16 keys against the BQ rows
    float s[NS][4] = {};
    gemm_abt<D, NS>(s, sK, warp * 16, cQ, lane);
    const bool full = f_lo <= q0 && q0 + BQ - 1 <= f_hi;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = nt * 8 + 2 * t + (i & 1);
        float e = exp2f(s[nt][i] * sl2 - cL[c]);
        if (!full && (q0 + c < qlo[i >> 1] || q0 + c > qhi[i >> 1])) e = 0.f;
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
    gi = ngi;
    qt = nqt;
  }
  store_rows<D>(static_cast<bf16*>(p.dk) + kvh * D, ks, k0 + warp * 16, p.Tk,
                dk, lane);
  store_rows<D>(static_cast<bf16*>(p.dv) + kvh * D, ks, k0 + warp * 16, p.Tk,
                dv, lane);
}

// ------------------------------------------------------- float32 kernels
// One warp per row (forward, dQ) or per key (dK/dV), walking the row's
// (key's) interval; each lane owns D/32 elements. Float32 throughout on
// the CUDA cores.
template <int D>
__global__ void __launch_bounds__(kThreads) varlen_fwd_f32(const VParams p) {
  constexpr int E = D / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  const int h = blockIdx.y, kvh = h / (p.H / p.KVH);
  if (row >= p.Tq) return;
  const int64_t qs = (int64_t)p.H * D, ks = (int64_t)p.KVH * D;
  const float* q = static_cast<const float*>(p.q) + row * qs + h * D;
  const float* kg = static_cast<const float*>(p.k) + kvh * D;
  const float* vg = static_cast<const float*>(p.v) + kvh * D;
  float qv[E], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    qv[e] = q[lane + 32 * e];
    acc[e] = 0.f;
  }
  int lo, hi;
  row_interval(p, row, lo, hi);
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
  float* o = static_cast<float*>(p.out) + row * qs + h * D;
#pragma unroll
  for (int e = 0; e < E; ++e) o[lane + 32 * e] = l > 0.f ? acc[e] / l : 0.f;
  if (lane == 0)
    p.lse[(int64_t)h * p.Tq + row] = l > 0.f ? m + logf(l) : kNoKeyLse;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    varlen_bwd_dq_f32(const VParams p) {
  constexpr int E = D / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  const int h = blockIdx.y, kvh = h / (p.H / p.KVH);
  if (row >= p.Tq) return;
  const int64_t qs = (int64_t)p.H * D, ks = (int64_t)p.KVH * D;
  const int64_t qoff = row * qs + h * D;
  const float* q = static_cast<const float*>(p.q) + qoff;
  const float* dout = static_cast<const float*>(p.dout) + qoff;
  const float* kg = static_cast<const float*>(p.k) + kvh * D;
  const float* vg = static_cast<const float*>(p.v) + kvh * D;
  const int64_t li = (int64_t)h * p.Tq + row;
  const float lse = p.lse_in[li], delta = p.delta[li];
  float qv[E], dov[E], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    qv[e] = q[lane + 32 * e];
    dov[e] = dout[lane + 32 * e];
    acc[e] = 0.f;
  }
  int lo, hi;
  row_interval(p, row, lo, hi);
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
    varlen_bwd_dkdv_f32(const VParams p) {
  constexpr int E = D / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int key = blockIdx.x * kWarps + warp;
  const int kvh = blockIdx.y, group = p.H / p.KVH;
  if (key >= p.Tk) return;
  const int64_t qs = (int64_t)p.H * D, ks = (int64_t)p.KVH * D;
  const int64_t koff = key * ks + kvh * D;
  float kv[E], vv[E], dk[E], dv[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    kv[e] = static_cast<const float*>(p.k)[koff + lane + 32 * e];
    vv[e] = static_cast<const float*>(p.v)[koff + lane + 32 * e];
    dk[e] = dv[e] = 0.f;
  }
  int lo, hi;
  key_interval(p, key, lo, hi);
  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const float* qg = static_cast<const float*>(p.q) + h * D;
    const float* og = static_cast<const float*>(p.dout) + h * D;
    const int64_t lrow = (int64_t)h * p.Tq;
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
int vcheck(const VParams& p, int64_t D, int dtype) {
  if (p.B < 0 || p.H <= 0 || p.KVH <= 0 || p.Tq <= 0 || p.Tk <= 0 ||
      p.H % p.KVH != 0 || p.H > 65535 || (D != 64 && D != 128) ||
      (dtype != ptt::kFloat32 && dtype != ptt::kBFloat16))
    return (int)cudaErrorInvalidValue;
  return 0;
}

VParams vmake(const void* cu_q, const void* cu_k, int64_t B, int64_t H,
              int64_t KVH, int64_t Tq, int64_t Tk, float scale, int causal) {
  VParams p{};
  p.cu_q = static_cast<const int*>(cu_q);
  p.cu_k = static_cast<const int*>(cu_k);
  p.B = (int)B;
  p.H = (int)H;
  p.KVH = (int)KVH;
  p.Tq = (int)Tq;
  p.Tk = (int)Tk;
  p.scale = scale;
  p.causal = causal;
  return p;
}

}  // namespace

// q [Tq, H, D], k/v [Tk, KVH, D] contiguous, cu_q/cu_k int32 [B + 1] on
// the card -> out [Tq, H, D], lse [H, Tq] float32. Returns the launch's
// cudaGetLastError().
extern "C" int ptt_flash_varlen_fwd(const void* q, const void* k,
                                    const void* v, const void* cu_q,
                                    const void* cu_k, void* out, void* lse,
                                    int64_t B, int64_t H, int64_t KVH,
                                    int64_t Tq, int64_t Tk, int64_t D,
                                    float scale, int causal, int dtype,
                                    void* stream) {
  VParams p = vmake(cu_q, cu_k, B, H, KVH, Tq, Tk, scale, causal);
  if (int e = vcheck(p, D, dtype)) return e;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 gb(blocks(p.Tq, kBQ), p.H), gf(blocks(p.Tq, kWarps), p.H);
  if (dtype == ptt::kBFloat16)
    return D == 64 ? launch(varlen_fwd_bf16<64>, gb, fwd_smem<64>(), s, p)
                   : launch(varlen_fwd_bf16<128>, gb, fwd_smem<128>(), s, p);
  return D == 64 ? launch(varlen_fwd_f32<64>, gf, 0, s, p)
                 : launch(varlen_fwd_f32<128>, gf, 0, s, p);
}

// q, dout [Tq, H, D], k, v [Tk, KVH, D], lse, delta [H, Tq] float32,
// cu_q/cu_k int32 [B + 1] -> dk, dv [Tk, KVH, D].
extern "C" int ptt_flash_varlen_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* cu_q, const void* cu_k,
    void* dk, void* dv, int64_t B, int64_t H, int64_t KVH, int64_t Tq,
    int64_t Tk, int64_t D, float scale, int causal, int dtype,
    void* stream) {
  VParams p = vmake(cu_q, cu_k, B, H, KVH, Tq, Tk, scale, causal);
  if (int e = vcheck(p, D, dtype)) return e;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = dk;
  p.dv = dv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 gb(blocks(p.Tk, kBK), p.KVH), gf(blocks(p.Tk, kWarps), p.KVH);
  if (dtype == ptt::kBFloat16)
    return D == 64
               ? launch(varlen_bwd_dkdv_bf16<64>, gb, dkdv_smem<64>(), s, p)
               : launch(varlen_bwd_dkdv_bf16<128>, gb, dkdv_smem<128>(), s,
                        p);
  return D == 64 ? launch(varlen_bwd_dkdv_f32<64>, gf, 0, s, p)
                 : launch(varlen_bwd_dkdv_f32<128>, gf, 0, s, p);
}

// as ptt_flash_varlen_bwd_dkdv -> dq [Tq, H, D].
extern "C" int ptt_flash_varlen_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* cu_q, const void* cu_k,
    void* dq, int64_t B, int64_t H, int64_t KVH, int64_t Tq, int64_t Tk,
    int64_t D, float scale, int causal, int dtype, void* stream) {
  VParams p = vmake(cu_q, cu_k, B, H, KVH, Tq, Tk, scale, causal);
  if (int e = vcheck(p, D, dtype)) return e;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 gb(blocks(p.Tq, kBQ), p.H), gf(blocks(p.Tq, kWarps), p.H);
  if (dtype == ptt::kBFloat16)
    return D == 64 ? launch(varlen_bwd_dq_bf16<64>, gb, dq_smem<64>(), s, p)
                   : launch(varlen_bwd_dq_bf16<128>, gb, dq_smem<128>(), s, p);
  return D == 64 ? launch(varlen_bwd_dq_f32<64>, gf, 0, s, p)
                 : launch(varlen_bwd_dq_f32<128>, gf, 0, s, p);
}
