// Paged attention for Hopper (sm_90a): the unified ragged kernel and the
// dedicated decode kernel.
//
// ragged_kernel replaces paddle_tpu/ops/kernels/paged_attention.py::
// _ragged_kernel (the Pallas kernel behind paged_ragged_attention() and
// the attention core of paged_ragged_fused_step()); decode_kernel, at the
// end of this file, replaces its _decode_kernel.
//
// Both take K/V pages of q's type (float32, bfloat16) or int8 codes with
// per-page, per-kv-head float32 scales k_scales/v_scales [NP, KVH]: a
// staged int8 row is widened and multiplied by the scale of the PHYSICAL
// page it came from (page_table[b, kpos / P]) and its kv head, so
// everything after staging is the float path.
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
// with 16-byte loads (8 bf16, 4 float or 16 int8 codes; K rows padded
// by one float so that lane j reading key j is free of bank conflicts);
// a 32-key tile spans two 16-slot pages, so an int8 row takes the scale
// of its own page. For QK^T each lane owns one key of
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

// T: q and out; KT: the pages (T, or int8 with kscale/vscale)
template <typename T, typename KT, int D>
__global__ void __launch_bounds__(kThreads) ragged_kernel(
    const T* __restrict__ q, const KT* __restrict__ kp,
    const KT* __restrict__ vp, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ tbl,
    const int* __restrict__ lens, const int* __restrict__ qlens,
    T* __restrict__ out, int t, int h_total, int kvh_total, int np,
    int page, int mp, int tq, float scale, int window) {
  constexpr int DPL = D / 32;  // output columns per lane
  constexpr int VN = ptt::Vec16<KT>::N;
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
      int pg = 0;
      int64_t off = 0;
      if (ok) {
        pg = tbl[(int64_t)b * mp + kpos / page];
        ok = pg >= 0 && pg < np;
        off = (((int64_t)pg * page + kpos % page) * kvh_total + kvh) * D + c;
      }
      if (ok) {
        ptt::load16(kp + off, fk);
        ptt::load16(vp + off, fv);
        if (kscale != nullptr) {  // int8 codes: this key's page, kv head
          const int64_t scale_row = (int64_t)pg * kvh_total + kvh;
          const float k_sc = kscale[scale_row], v_sc = vscale[scale_row];
#pragma unroll
          for (int e = 0; e < VN; ++e) {
            fk[e] *= k_sc;
            fv[e] *= v_sc;
          }
        }
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
// same stream and only when q_lens is absent, writes them (int8 V
// dequantized by its page's scale first). Grid (B, H), one thread per
// output column.
template <typename T, typename KT, int D>
__global__ void __launch_bounds__(D) no_key_rows_kernel(
    const KT* __restrict__ vp, const float* __restrict__ vscale,
    const int* __restrict__ tbl,
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
               vp[(((int64_t)pg * page + j % page) * kvh_total + kvh) * D +
                  d]) *
           (vscale != nullptr ? vscale[(int64_t)pg * kvh_total + kvh] : 1.f);
  }
  const T mean = ptt::from_f32<T>(a / (float)slots);
  for (int r = 0; r < rows; ++r)
    out[(((int64_t)b * t + r) * h_total + h) * D + d] = mean;
}

// ---------------------------------------------------------------- decode
//
// decode_kernel replaces paddle_tpu/ops/kernels/paged_attention.py::
// _decode_kernel, the FLAGS_ragged_attention=off lowering of
// paged_attention(): one query token per sequence, q [B, H, D], out
// [B, H, D], over the pages of page_table[b, :] (same page layout and
// int8 scales as above). For each sequence b and q head h:
//   * keys at pos < seq_lens[b] are kept, and with window > 0 only
//     pos >= seq_len - window; the loop runs over [max(0, seq_len -
//     window), seq_len), so no page wholly outside is ever loaded;
//   * q head h reads kv head h / (H / KVH);
//   * softmax statistics and the output accumulate in float32; the
//     output is divided by max(l, 1e-30), so a row with seq_len 0 (a
//     page-table padding row) returns exactly 0.
// Rounding: the Pallas float branch rounds p to the page type before PV
// (pvals.astype(v.dtype)), its int8 branch does not (v is float32 there).
// This kernel keeps p in float32 on both branches, as ragged_kernel does.
//
// What bounds it: bytes. Each K/V byte serves the `group` q heads of its
// kv head once (~2 * group flops per byte loaded), far below the card's
// ~295 flops per byte. The Pallas grid (B, H, pages) reads every page
// once per q head; here one block per (kv head, sequence) serves the
// whole group, so each K/V byte is read once. Each thread keeps its
// share of the NEXT 32-key tile in flight in registers while the block
// computes on the current one from shared memory. At the serving batch
// this makes B * KVH blocks (64 on 132 SMs); splitting a row's keys
// over several blocks comes later.

template <typename T, typename KT, int D>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const T* __restrict__ q, const KT* __restrict__ kp,
    const KT* __restrict__ vp, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ tbl,
    const int* __restrict__ lens, T* __restrict__ out, int h_total,
    int kvh_total, int np, int page, int mp, float scale, int window) {
  constexpr int DPL = D / 32;
  constexpr int VN = ptt::Vec16<KT>::N;
  constexpr int VPR = D / VN;
  constexpr int NV = kKT * VPR / kThreads;  // 16-byte vectors a thread stages
  static_assert(kKT * VPR % kThreads == 0, "tile does not split evenly");
  extern __shared__ float smem[];
  float* qs = smem;                  // [group][D], pre-scaled
  float* kst = qs + kMaxRH * D;      // [kKT][D + 1]
  float* vst = kst + kKT * (D + 1);  // [kKT][D]
  float* ps = vst + kKT * D;         // [kWarps][kKT]

  const int group = h_total / kvh_total;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int seq_len = lens[b];
  const int kend = min(seq_len, mp * page);
  const int kstart = window > 0 ? max(0, seq_len - window) : 0;

  for (int i = threadIdx.x; i < group * D; i += kThreads)
    qs[i] = ptt::to_f32(q[((int64_t)b * h_total + kvh * group) * D + i]) *
            scale;

  // one tile's raw vectors, their keys' scales, and whether they exist
  uint4 rk[NV], rv[NV];
  float sk[NV], sv[NV];
  bool ok[NV];
  auto load_tile = [&](int kb) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int idx = threadIdx.x + v * kThreads;
      const int kpos = kb + idx / VPR, c = (idx % VPR) * VN;
      ok[v] = kpos < kend;
      sk[v] = sv[v] = 1.f;
      if (ok[v]) {
        const int pg = tbl[(int64_t)b * mp + kpos / page];
        ok[v] = pg >= 0 && pg < np;
        if (ok[v]) {
          const int64_t off =
              (((int64_t)pg * page + kpos % page) * kvh_total + kvh) * D + c;
          rk[v] = *reinterpret_cast<const uint4*>(kp + off);
          rv[v] = *reinterpret_cast<const uint4*>(vp + off);
          if (kscale != nullptr) {
            const int64_t srow = (int64_t)pg * kvh_total + kvh;
            sk[v] = kscale[srow];
            sv[v] = vscale[srow];
          }
        }
      }
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int idx = threadIdx.x + v * kThreads;
      const int j = idx / VPR, c = (idx % VPR) * VN;
      const KT* ek = reinterpret_cast<const KT*>(&rk[v]);
      const KT* ev = reinterpret_cast<const KT*>(&rv[v]);
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        kst[j * (D + 1) + c + e] = ok[v] ? ptt::to_f32(ek[e]) * sk[v] : 0.f;
        vst[j * D + c + e] = ok[v] ? ptt::to_f32(ev[e]) * sv[v] : 0.f;
      }
    }
  };

  float m[kRW], l[kRW], acc[kRW][DPL];
#pragma unroll
  for (int i = 0; i < kRW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int k = 0; k < DPL; ++k) acc[i][k] = 0.f;
  }

  if (kstart < kend) load_tile(kstart);
  for (int kb = kstart; kb < kend; kb += kKT) {
    store_tile();
    __syncthreads();
    if (kb + kKT < kend) load_tile(kb + kKT);  // in flight during compute

#pragma unroll
    for (int i = 0; i < kRW; ++i) {
      const int hh = warp + kWarps * i;  // warp-uniform
      if (hh < group) {
        const bool keep = kb + lane < kend;
        float s = kNegInf;
        if (keep) {
          const float* qr = qs + hh * D;
          const float* kr = kst + lane * (D + 1);
          float dot = 0.f;
#pragma unroll 16
          for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
          s = dot;
        }
        // key kb < kend is kept, so the tile's max is a real score
        const float m_new = fmaxf(m[i], ptt::warp_max(s));
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
            a += ps[warp * kKT + j] * vst[j * D + lane + 32 * k];
          acc[i][k] = a;
        }
        __syncwarp();
        m[i] = m_new;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRW; ++i) {
    const int hh = warp + kWarps * i;
    if (hh < group) {
      const float safe_l = fmaxf(l[i], 1e-30f);
      T* o = out + ((int64_t)b * h_total + kvh * group + hh) * D;
#pragma unroll
      for (int k = 0; k < DPL; ++k)
        o[lane + 32 * k] = ptt::from_f32<T>(acc[i][k] / safe_l);
    }
  }
}

// ---------------------------------------------------------------- host
struct Args {
  const void *q, *kp, *vp, *ks, *vs, *tbl, *lens, *qlens;
  void* out;
  int64_t b, t, h, kvh, np, page, mp, window;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename KT, int D>
int launch_ragged(const Args& a) {
  const int group = (int)(a.h / a.kvh);
  int tq = kMaxRH / group;
  if (tq > a.t) tq = (int)a.t;
  const dim3 grid((unsigned)((a.t + tq - 1) / tq), (unsigned)a.kvh,
                  (unsigned)a.b);
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      ragged_kernel<T, KT, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ragged_kernel<T, KT, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KT*>(a.kp),
      static_cast<const KT*>(a.vp), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.tbl),
      static_cast<const int*>(a.lens), static_cast<const int*>(a.qlens),
      static_cast<T*>(a.out), (int)a.t, (int)a.h, (int)a.kvh, (int)a.np,
      (int)a.page, (int)a.mp, tq, a.scale, (int)a.window);
  if (a.qlens == nullptr && a.t > 1) {
    no_key_rows_kernel<T, KT, D>
        <<<dim3((unsigned)a.b, (unsigned)a.h), D, 0, a.stream>>>(
            static_cast<const KT*>(a.vp), static_cast<const float*>(a.vs),
            static_cast<const int*>(a.tbl), static_cast<const int*>(a.lens),
            static_cast<T*>(a.out), (int)a.t, (int)a.h, (int)a.kvh,
            (int)a.np, (int)a.page, (int)a.mp);
  }
  return (int)cudaGetLastError();
}

template <typename T, typename KT, int D>
int launch_decode(const Args& a) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, KT, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_kernel<T, KT, D>
      <<<dim3((unsigned)a.kvh, (unsigned)a.b), kThreads, smem, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const KT*>(a.kp),
          static_cast<const KT*>(a.vp), static_cast<const float*>(a.ks),
          static_cast<const float*>(a.vs), static_cast<const int*>(a.tbl),
          static_cast<const int*>(a.lens), static_cast<T*>(a.out), (int)a.h,
          (int)a.kvh, (int)a.np, (int)a.page, (int)a.mp, a.scale,
          (int)a.window);
  return (int)cudaGetLastError();
}

// the instantiations: q/out type x page type (q's own, or int8) x D
template <bool Decode, typename T, typename KT>
int dispatch_d(int64_t d, const Args& a) {
  switch (d) {
    case 64:
      return Decode ? launch_decode<T, KT, 64>(a) : launch_ragged<T, KT, 64>(a);
    case 128:
      return Decode ? launch_decode<T, KT, 128>(a)
                    : launch_ragged<T, KT, 128>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <bool Decode>
int dispatch(int64_t d, int dtype, int kv_dtype, const Args& a) {
  if (a.kvh <= 0 || a.h % a.kvh != 0 || a.h / a.kvh > kMaxRH ||
      a.b > 65535 || a.kvh > 65535 || a.page <= 0 || a.mp <= 0)
    return (int)cudaErrorInvalidValue;
  // int8 pages come with both scale sidecars, float pages with none
  if ((kv_dtype == ptt::kInt8) != (a.ks != nullptr && a.vs != nullptr) ||
      (a.ks == nullptr) != (a.vs == nullptr))
    return (int)cudaErrorInvalidValue;
  if (kv_dtype != dtype && kv_dtype != ptt::kInt8)
    return (int)cudaErrorInvalidValue;
  const bool quant = kv_dtype == ptt::kInt8;
  switch (dtype) {
    case ptt::kFloat32:
      return quant ? dispatch_d<Decode, float, int8_t>(d, a)
                   : dispatch_d<Decode, float, float>(d, a);
    case ptt::kBFloat16:
      return quant ? dispatch_d<Decode, __nv_bfloat16, int8_t>(d, a)
                   : dispatch_d<Decode, __nv_bfloat16, __nv_bfloat16>(d, a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: [B, T, H, D] (dtype); k_pages, v_pages: [NP, P, KVH, D]
// (kv_dtype: dtype's own, or int8 with k_scales, v_scales [NP, KVH]
// float32; null for float pages); page_table: [B, MP] int32; seq_lens:
// [B] int32; q_lens: [B] int32 or null. All contiguous, q/pages/out
// 16-byte aligned. Returns the launch's cudaGetLastError() (0 on success).
extern "C" int ptt_paged_ragged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* page_table,
    const void* seq_lens, const void* q_lens, void* out, int64_t b,
    int64_t t, int64_t h, int64_t kvh, int64_t d, int64_t np, int64_t page,
    int64_t mp, float scale, int64_t window, int dtype, int kv_dtype,
    void* stream) {
  if (b <= 0 || t <= 0) return 0;
  const Args a{q,   k_pages, v_pages, k_scales, v_scales, page_table,
               seq_lens, q_lens, out, b, t, h, kvh, np, page, mp, window,
               scale, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(d, dtype, kv_dtype, a);
}

// q, out: [B, H, D] (dtype), one decode token per sequence; the pages,
// scales, page_table and seq_lens as above. Returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int ptt_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* page_table,
    const void* seq_lens, void* out, int64_t b, int64_t h, int64_t kvh,
    int64_t d, int64_t np, int64_t page, int64_t mp, float scale,
    int64_t window, int dtype, int kv_dtype, void* stream) {
  if (b <= 0) return 0;
  const Args a{q,   k_pages, v_pages, k_scales, v_scales, page_table,
               seq_lens, nullptr, out, b, 1, h, kvh, np, page, mp, window,
               scale, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(d, dtype, kv_dtype, a);
}
