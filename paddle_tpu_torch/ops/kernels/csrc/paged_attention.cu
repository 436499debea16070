// Unified ragged paged attention for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/kernels/paged_attention.py::_ragged_kernel
// (the Pallas kernel behind paged_ragged_attention() and the attention
// core of paged_ragged_fused_step()).
//
// Computes, for q [B, T, H, D] whose rows are right-aligned new tokens,
// K/V pages [NP, P, KVH, D], page_table [B, MP] int32, seq_lens [B] and
// q_lens [B] (or none: every row real):
//   * row r of sequence b sits at qpos = seq_lens[b] - T + r;
//   * the key at kpos is kept iff kpos <= qpos and kpos < seq_len, and,
//     with window > 0, qpos - kpos < window;
//   * rows r < T - q_lens[b] are padding and return exactly 0, as do
//     rows of a sequence with seq_len 0 (the page-table padding rows);
//   * q head h reads kv head h / (H / KVH); K/V are never repeated;
//   * softmax statistics and the output accumulate in float32; masked
//     scores are NEG_INF = -1e30, and the output is divided by
//     safe_l = max(l, 1e-30), then cast to q's dtype.
// Keys outside [window floor of the lowest real row, seq_len) are never
// loaded: the loop over keys is bounded by seq_len, not by the table
// width, and skips pages wholly below every row's window.
// A real row that sees no key (qpos < 0: with q_lens absent, the rows
// r < T - seq_len; with q_lens given, none, since q_lens[b] <= seq_lens[b]
// by contract) returns what the Pallas kernel's online softmax over
// all-NEG_INF scores gives: the mean of V over every slot of the pages it
// visits, pages [0, ceil(seq_len / P)) (no window floor excludes one of
// them, since the lowest row's floor is then below 0). A second small
// kernel writes those rows, launched only when q_lens is absent, so the
// main kernel's serving path carries none of that code.
//
// What bounds it on the H100: at the serving shapes, bytes for decode
// rows (each KV byte is used by the 4 q heads of its group for one row:
// ~2 flops per byte read) and, for a 248-token prefill chunk, arithmetic
// (~1000 flops per KV byte). This first version runs the products on
// the CUDA cores in float32, not on the tensor cores, so the prefill
// case sits far from its tensor-core floor; wgmma/TMA come later.
//
// Design: grid (ceil(T / TQ), KVH, B). A block serves TQ query rows for
// all `group` q heads of one kv head, so every K/V tile it stages is
// used by the whole group (R = TQ * group <= 32 row-heads, 8 per warp).
// Keys are staged 32 at a time into shared memory, widened to float32
// with 16-byte loads (K rows padded by one float so that lane j reading
// key j is free of bank conflicts). For QK^T each lane owns one key of
// the tile and dots it with the (pre-scaled) query row; for PV each
// lane owns D/32 output columns. The online-softmax state (m, l, acc)
// of each of a warp's row-heads lives in registers.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKT = 32;              // keys per staged tile
constexpr int kMaxRH = 32;           // row-heads per block
constexpr int kRW = kMaxRH / kWarps; // row-heads per warp
constexpr float kNegInf = -1e30f;    // masked score, the reference's NEG_INF

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kMaxRH * D + kKT * (D + 1) + kKT * D + kWarps * kKT);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) ragged_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ tbl,
    const int* __restrict__ lens, const int* __restrict__ qlens,
    T* __restrict__ out, int t, int h_total, int kvh_total, int np,
    int page, int mp, int tq, float scale, int window) {
  constexpr int DPL = D / 32;  // output columns per lane
  constexpr int VN = ptt::Vec16<T>::N;
  constexpr int VPR = D / VN;  // 16-byte vectors per key row
  extern __shared__ float smem[];
  float* qs = smem;                  // [kMaxRH][D], pre-scaled
  float* ks = qs + kMaxRH * D;       // [kKT][D + 1]
  float* vs = ks + kKT * (D + 1);    // [kKT][D]
  float* ps = vs + kKT * D;          // [kWarps][kKT]

  const int group = h_total / kvh_total;
  const int rh_count = tq * group;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int r0 = blockIdx.x * tq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int seq_len = lens[b];
  const int q_len = qlens != nullptr ? qlens[b] : t;
  // real rows of this block: [row_lo, row_hi)
  const int row_lo = max(r0, t - q_len);
  const int row_hi = min(r0 + tq, t);
  int kstart = 0, kend = 0;
  if (row_lo < row_hi && seq_len > 0) {
    const int qpos_lo = seq_len - t + row_lo;
    const int qpos_hi = seq_len - t + row_hi - 1;
    kend = min(min(qpos_hi + 1, seq_len), mp * page);
    kstart = window > 0 ? max(0, qpos_lo - window + 1) : 0;
  }

  for (int i = threadIdx.x; i < rh_count * D; i += kThreads) {
    const int rh = i / D, d = i % D;
    const int row = r0 + rh / group;
    const int h = kvh * group + rh % group;
    float v = 0.f;
    if (row < t)
      v = ptt::to_f32(q[(((int64_t)b * t + row) * h_total + h) * D + d]) *
          scale;
    qs[rh * D + d] = v;
  }

  float m[kRW], l[kRW], acc[kRW][DPL];
#pragma unroll
  for (int i = 0; i < kRW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int k = 0; k < DPL; ++k) acc[i][k] = 0.f;
  }
  __syncthreads();

  for (int kb = kstart; kb < kend; kb += kKT) {
    // stage keys [kb, kb + kKT) of this kv head, zero past kend
    for (int i = threadIdx.x; i < kKT * VPR; i += kThreads) {
      const int j = i / VPR, c = (i % VPR) * VN;
      const int kpos = kb + j;
      float fk[VN], fv[VN];
      bool ok = kpos < kend;
      int64_t off = 0;
      if (ok) {
        const int pg = tbl[(int64_t)b * mp + kpos / page];
        ok = pg >= 0 && pg < np;
        off = (((int64_t)pg * page + kpos % page) * kvh_total + kvh) * D + c;
      }
      if (ok) {
        ptt::load16(kp + off, fk);
        ptt::load16(vp + off, fv);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) fk[e] = fv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        ks[j * (D + 1) + c + e] = fk[e];
        vs[j * D + c + e] = fv[e];
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRW; ++i) {
      const int rh = warp + kWarps * i;
      const int row = r0 + rh / group;
      // warp-uniform: the whole warp serves this row-head
      if (rh < rh_count && row >= row_lo && row < row_hi) {
        const int qpos = seq_len - t + row;
        const int kpos = kb + lane;
        const bool keep = kpos < kend && kpos <= qpos &&
                          (window <= 0 || qpos - kpos < window);
        float s = kNegInf;
        if (keep) {
          const float* qr = qs + rh * D;
          const float* kr = ks + lane * (D + 1);
          float dot = 0.f;
#pragma unroll 16
          for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
          s = dot;
        }
        const float tmax = ptt::warp_max(s);
        if (tmax != kNegInf) {  // the row sees a key in this tile
          const float m_new = fmaxf(m[i], tmax);
          const float corr = expf(m[i] - m_new);
          const float p = keep ? expf(s - m_new) : 0.f;
          l[i] = l[i] * corr + ptt::warp_sum(p);
          ps[warp * kKT + lane] = p;
          __syncwarp();
#pragma unroll
          for (int k = 0; k < DPL; ++k) {
            float a = acc[i][k] * corr;
#pragma unroll 8
            for (int j = 0; j < kKT; ++j)
              a += ps[warp * kKT + j] * vs[j * D + lane + 32 * k];
            acc[i][k] = a;
          }
          __syncwarp();
          m[i] = m_new;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRW; ++i) {
    const int rh = warp + kWarps * i;
    const int row = r0 + rh / group;
    if (rh < rh_count && row < t) {
      const int h = kvh * group + rh % group;
      const bool real = row >= row_lo && row < row_hi;
      const float safe_l = fmaxf(l[i], 1e-30f);
      T* o = out + (((int64_t)b * t + row) * h_total + h) * D;
#pragma unroll
      for (int k = 0; k < DPL; ++k)
        o[lane + 32 * k] = ptt::from_f32<T>(real ? acc[i][k] / safe_l : 0.f);
    }
  }
}

// Rows that see no key (qpos < 0; with q_lens absent, the rows r < T -
// seq_len) get the mean of V over every slot of the pages below seq_len.
// ragged_kernel leaves them 0; this kernel, launched after it on the
// same stream and only when q_lens is absent, writes them. Grid (B, H),
// one thread per output column.
template <typename T, int D>
__global__ void __launch_bounds__(D) no_key_rows_kernel(
    const T* __restrict__ vp, const int* __restrict__ tbl,
    const int* __restrict__ lens, T* __restrict__ out, int t, int h_total,
    int kvh_total, int np, int page, int mp) {
  const int b = blockIdx.x, h = blockIdx.y, d = threadIdx.x;
  const int seq_len = lens[b];
  const int rows = t - seq_len;
  if (seq_len <= 0 || rows <= 0) return;
  const int kvh = h / (h_total / kvh_total);
  const int slots = min((seq_len + page - 1) / page, mp) * page;
  float a = 0.f;
  for (int j = 0; j < slots; ++j) {
    const int pg = tbl[(int64_t)b * mp + j / page];
    if (pg >= 0 && pg < np)
      a += ptt::to_f32(
          vp[(((int64_t)pg * page + j % page) * kvh_total + kvh) * D + d]);
  }
  const T mean = ptt::from_f32<T>(a / (float)slots);
  for (int r = 0; r < rows; ++r)
    out[(((int64_t)b * t + r) * h_total + h) * D + d] = mean;
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const void* tbl,
           const void* lens, const void* qlens, void* out, int64_t b,
           int64_t t, int64_t h, int64_t kvh, int64_t np, int64_t page,
           int64_t mp, float scale, int64_t window, cudaStream_t stream) {
  const int group = (int)(h / kvh);
  int tq = kMaxRH / group;
  if (tq > t) tq = (int)t;
  const dim3 grid((unsigned)((t + tq - 1) / tq), (unsigned)kvh,
                  (unsigned)b);
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      ragged_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ragged_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(tbl),
      static_cast<const int*>(lens), static_cast<const int*>(qlens),
      static_cast<T*>(out), (int)t, (int)h, (int)kvh, (int)np, (int)page,
      (int)mp, tq, scale, (int)window);
  if (qlens == nullptr && t > 1) {
    no_key_rows_kernel<T, D><<<dim3((unsigned)b, (unsigned)h), D, 0,
                                 stream>>>(
        static_cast<const T*>(vp), static_cast<const int*>(tbl),
        static_cast<const int*>(lens), static_cast<T*>(out), (int)t, (int)h,
        (int)kvh, (int)np, (int)page, (int)mp);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int64_t d, const void* q, const void* kp, const void* vp,
               const void* tbl, const void* lens, const void* qlens,
               void* out, int64_t b, int64_t t, int64_t h, int64_t kvh,
               int64_t np, int64_t page, int64_t mp, float scale,
               int64_t window, cudaStream_t s) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, kp, vp, tbl, lens, qlens, out, b, t, h, kvh,
                           np, page, mp, scale, window, s);
    case 128:
      return launch<T, 128>(q, kp, vp, tbl, lens, qlens, out, b, t, h,
                            kvh, np, page, mp, scale, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: [B, T, H, D]; k_pages, v_pages: [NP, P, KVH, D]; page_table:
// [B, MP] int32; seq_lens: [B] int32; q_lens: [B] int32 or null. All
// contiguous, q/pages/out 16-byte aligned. Returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int ptt_paged_ragged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* seq_lens, const void* q_lens,
    void* out, int64_t b, int64_t t, int64_t h, int64_t kvh, int64_t d,
    int64_t np, int64_t page, int64_t mp, float scale, int64_t window,
    int dtype, void* stream) {
  if (b <= 0 || t <= 0) return 0;
  if (kvh <= 0 || h % kvh != 0 || h / kvh > kMaxRH || b > 65535 ||
      kvh > 65535 || page <= 0 || mp <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kFloat32:
      return dispatch_d<float>(d, q, k_pages, v_pages, page_table, seq_lens,
                               q_lens, out, b, t, h, kvh, np, page, mp,
                               scale, window, s);
    case ptt::kBFloat16:
      return dispatch_d<__nv_bfloat16>(d, q, k_pages, v_pages, page_table,
                                       seq_lens, q_lens, out, b, t, h, kvh,
                                       np, page, mp, scale, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
