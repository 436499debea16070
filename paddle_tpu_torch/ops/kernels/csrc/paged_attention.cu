// Paged attention for Hopper (sm_90a): the unified ragged kernel and the
// dedicated decode kernel.
//
// ptt_paged_ragged_attention replaces paddle_tpu/ops/kernels/
// paged_attention.py::_ragged_kernel (the Pallas kernel behind
// paged_ragged_attention() and the attention core of
// paged_ragged_fused_step()); decode_kernel_split and decode_kernel_merge,
// further down, replace its _decode_kernel. One call of the ragged entry
// takes one of three routes, chosen on the host from the shapes alone
// (never from seq_lens or q_lens, which live on the device):
//   * T = 1 (every decode-only serving step): the decode kernel's split
//     over whole-page chunks and its ordered merge, with q_lens (a row of
//     q_len 0 returns exactly 0);
//   * T > 1, bf16 q (bf16 or int8 pages): ragged_kernel_wgmma, on the
//     tensor cores (the forward-attention core of attn_fwd_tiles.cuh), its
//     keys split over chunks of whole pages, then ragged_kernel_merge;
//   * T > 1, float32 q: ragged_kernel, float32 on the CUDA cores.
//
// All take K/V pages of q's type (float32, bfloat16) or int8 codes with
// per-page, per-kv-head float32 scales k_scales/v_scales [NP, KVH]: a
// key's int8 codes count with the scale of the PHYSICAL page it came from
// (page_table[b, kpos / P]) and its kv head.
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
//   * page ids outside [0, NP) read as zero keys;
//   * softmax statistics and the output accumulate in float32, and the
//     output is divided by safe_l = max(l, 1e-30), then cast to q's dtype.
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
// main kernels' serving path carries none of that code.
//
// Rounding. The tensor-core route follows the Pallas float branch: bf16
// operands (int8 codes widened to bf16, exact for |code| <= 127), float32
// accumulation, p rounded to bf16 before P V (pvals.astype(v.dtype)), the
// int8 K scale applied to S's columns and the V scale to P's columns
// before that rounding. The decode route and the float32 route keep p in
// float32.
//
// ragged_kernel (float32 q). Grid (ceil(T / TQ), KVH, B). A block serves
// TQ query rows for all `group` q heads of one kv head, so every K/V tile
// it stages is used by the whole group (R = TQ * group <= 32 row-heads, 8
// per warp). Keys are staged 32 at a time into shared memory, widened to
// float32 with 16-byte loads (4 float or 16 int8 codes; K rows padded by
// one float so that lane j reading key j is free of bank conflicts). For
// QK^T each lane owns one key of the tile and dots it with the
// (pre-scaled) query row; for PV each lane owns D/32 output columns. The
// online-softmax state (m, l, acc) of each of a warp's row-heads lives in
// registers.

#include <type_traits>

#include "attn_fwd_tiles.cuh"
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKT = 32;              // keys per staged tile
constexpr int kMaxRH = 32;           // row-heads per block
constexpr int kRW = kMaxRH / kWarps; // row-heads per warp
constexpr float kNegInf = -1e30f;    // masked score, the reference's NEG_INF

// The real rows [row_lo, row_hi) of the block of rows [r0, r0 + rows) of a
// sequence with seq_len keys and q_len real rows, and the keys
// [kstart, kend) they see
__device__ __forceinline__ void ragged_rows_range(int seq_len, int q_len,
                                                  int t, int r0, int rows,
                                                  int window, int mp,
                                                  int page, int& row_lo,
                                                  int& row_hi, int& kstart,
                                                  int& kend) {
  row_lo = max(r0, t - q_len);
  row_hi = min(r0 + rows, t);
  kstart = kend = 0;
  if (row_lo < row_hi && seq_len > 0) {
    const int qpos_lo = seq_len - t + row_lo;
    const int qpos_hi = seq_len - t + row_hi - 1;
    kend = min(min(qpos_hi + 1, seq_len), mp * page);
    kstart = window > 0 ? max(0, qpos_lo - window + 1) : 0;
  }
}

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
  int row_lo, row_hi, kstart, kend;
  ragged_rows_range(seq_len, qlens != nullptr ? qlens[b] : t, t, r0, tq,
                    window, mp, page, row_lo, row_hi, kstart, kend);

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
          const int64_t sc_row = (int64_t)pg * kvh_total + kvh;
          const float k_sc = kscale[sc_row], v_sc = vscale[sc_row];
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

// ------------------------------------------------- ragged, tensor cores
//
// ragged_kernel_wgmma: the route for T > 1 with bf16 q (a prefill chunk,
// alone or beside decode rows). What bounds it on the H100: operations for
// a chunk (a 248-row chunk uses each K/V byte for ~1000 flops), bytes for
// the decode rows beside it. Design, on the core of attn_fwd_tiles.cuh:
//   * M packing: a block's M tile is 64 (row, q head) pairs of one kv
//     head's group over consecutive rows, 64 / group rows x the group's
//     heads (16 x 4 at Llama-3's group 4, 9 x 7 at Qwen2's group 7), so
//     each staged K/V byte serves the whole group. Grid (splits, B * KVH,
//     tiles); a tile with no real row, or a split whose keys its rows do
//     not see, exits at once.
//   * split over keys: a block takes the keys of one chunk of chunk_pages
//     whole pages (splits = ceil(MP / chunk_pages), sized on the host from
//     the shapes: paged_attention.ragged_split_plan). With one split the
//     block writes its rows itself; with more, each block writes float32
//     partials (acc[D], m, l per pair) to a workspace
//     [B, KVH, tiles, splits, 64, D + 2] and ragged_kernel_merge combines a
//     row's non-empty chunks in order, without atomics (two runs give the
//     same bits).
//   * one consumer warpgroup runs attn::consume over the block's 64-key
//     tiles; one producer warpgroup stages them into a ring of kStages
//     stages: for each key, its page id (the block's slice of the page
//     table is read into shared memory first), then 16-byte cp.async
//     copies of its K and V rows of this kv head (zeros for keys outside
//     the block's range and for page ids outside [0, NP)), 128-byte
//     swizzled, kStages - 1 tiles in flight. Int8 codes land in a raw
//     slot and are widened to bf16 into the stage (exact); each key's K
//     and V scales, of its physical page, go beside the stage and are
//     applied to S's and P's columns.
//   * the mask (causal, window, the block's key range) runs only on tiles
//     that cross an edge for the tile's real rows. Rows that are not real
//     are neither masked nor written (exact zeros come from the epilogue
//     or the merge).
// On the H100 (PERF.md) two consumer warpgroups a block with setmaxnreg
// measured slower at the mixed bucket, and the split pays only where a
// split gives SMs without a block one (ragged_split_plan).

// pages a block of the tensor-core route takes at most (its page table
// slice is staged in shared memory)
constexpr int kRagMaxChunkPages = 1024;

template <typename KT, int D>
struct RaggedTc {
  static constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  static constexpr int kSub = D / 64;
  // D = 64: two blocks an SM (registers <= 128 a thread); D = 128: the
  // consumer's O, S and P fragments take ~170 registers, one block an SM
  static constexpr int kMinBlocks = D == 64 ? 2 : 1;
  static constexpr int kStages = 4;
  static constexpr int kAhead = kStages - 1;  // tiles a producer has in flight
  static constexpr int kThreads = 256;  // consumer and producer warpgroups
  static constexpr int kQ = kSub * ptt::attn::kTile;   // the M tile's q
  static constexpr int kKV = kSub * ptt::attn::kTile;  // a K or V tile
  static constexpr int kStage = 2 * kKV;
  static constexpr int kScales = kStages * 2 * 64 * 4;  // [stage][K, V][64]
  // int8: a slot of raw codes a stage, [K, V][64 keys][D], then their
  // scales [K, V][64]
  static constexpr int kRaw = kQuant ? 2 * 64 * D + 2 * 64 * 4 : 0;
  // the block's slice of the page table (its keys lie in one chunk)
  static constexpr int kTab = kRagMaxChunkPages * 4;
  static constexpr int kBars =
      kQ + kStages * (kStage + kRaw) + kScales + kTab;
  static constexpr int kSmem = 1024 + kBars + 8 * 2 * kStages;
};

// 4 bytes global -> shared by cp.async; bytes = 0 writes zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   ptt::smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// the paged band mask and the int8 scales of one M tile
template <typename KT, int D>
struct RaggedHook {
  const unsigned char* ring;
  const float* scales;
  int kt0, lo, hi, q_lo, q_hi, window, qA, qB, col0;
  float sl2;
  __device__ const unsigned char* k(int st) const {
    return ring + st * RaggedTc<KT, D>::kStage;
  }
  __device__ const unsigned char* v(int st) const {
    return k(st) + RaggedTc<KT, D>::kKV;
  }
  __device__ void score(int j, int st, float (&s)[32]) const {
    const int k0 = (kt0 + j) * 64;
    const float* ksc = scales + st * 128;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      s[e] *= sl2;
      if constexpr (std::is_same<KT, int8_t>::value)
        s[e] *= ksc[8 * (e >> 2) + col0 + (e & 1)];
    }
    if (k0 >= lo && k0 + 64 <= hi && k0 + 63 <= q_lo &&
        (window <= 0 || q_hi - k0 < window))
      return;  // every key of the tile is kept for every real row
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int qpos = (e >> 1) & 1 ? qB : qA;
      const int kpos = k0 + 8 * (e >> 2) + col0 + (e & 1);
      const bool kept = (kpos >= lo) & (kpos < hi) & (kpos <= qpos) &
                        ((window <= 0) | (qpos - kpos < window));
      s[e] = kept ? s[e] : -INFINITY;
    }
  }
  __device__ void prob(int, int st, float (&p)[32]) const {
    if constexpr (std::is_same<KT, int8_t>::value) {
      const float* vsc = scales + st * 128 + 64;
#pragma unroll
      for (int e = 0; e < 32; ++e) p[e] *= vsc[8 * (e >> 2) + col0 + (e & 1)];
    }
  }
};

// 16 int8 codes as two 16-byte chunks of bf16 (exact)
__device__ __forceinline__ void widen_codes(const uint4& raw, uint4& lo,
                                            uint4& hi) {
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = ptt::attn::pack_bf16((float)e[2 * i], (float)e[2 * i + 1]);
  lo = make_uint4(w[0], w[1], w[2], w[3]);
  hi = make_uint4(w[4], w[5], w[6], w[7]);
}

template <typename KT, int D>
__global__ void __launch_bounds__(RaggedTc<KT, D>::kThreads,
                                  RaggedTc<KT, D>::kMinBlocks)
    ragged_kernel_wgmma(const __nv_bfloat16* __restrict__ q,
                        const KT* __restrict__ kp, const KT* __restrict__ vp,
                        const float* __restrict__ kscale,
                        const float* __restrict__ vscale,
                        const int* __restrict__ tbl,
                        const int* __restrict__ lens,
                        const int* __restrict__ qlens,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ part, int t, int h_total,
                        int kvh_total, int np, int page, int mp,
                        int chunk_pages, float scale, int window) {
  using L = RaggedTc<KT, D>;
  using ptt::attn::sw128_offset;
  constexpr bool kQuant = L::kQuant;
  extern __shared__ __align__(16) unsigned char dsmem[];
  unsigned char* base =
      dsmem + ((1024 - (ptt::smem_addr(dsmem) & 1023)) & 1023);
  unsigned char* sQ = base;
  unsigned char* ring = base + L::kQ;
  float* scales = reinterpret_cast<float*>(ring + L::kStages * L::kStage);
  unsigned char* raw = reinterpret_cast<unsigned char*>(scales) + L::kScales;
  int* stab = reinterpret_cast<int*>(raw + L::kStages * L::kRaw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + L::kStages;

  // the tile is the slowest grid axis, walked last to first: the last
  // tiles hold the decode rows and a chunk's rows with the most keys, so
  // the longest blocks start first
  const int split = blockIdx.x, tile = gridDim.z - 1 - blockIdx.z;
  const int b = blockIdx.y / kvh_total, kvh = blockIdx.y % kvh_total;
  const int group = h_total / kvh_total, rows_t = 64 / group;
  const int r0 = tile * rows_t;
  const int seq_len = lens[b];
  int row_lo, row_hi, kstart, kend;
  ragged_rows_range(seq_len, qlens != nullptr ? qlens[b] : t, t, r0, rows_t,
                    window, mp, page, row_lo, row_hi, kstart, kend);
  const int chunk = chunk_pages * page;
  const int lo = max(split * chunk, kstart);
  const int hi = min(split * chunk + chunk, kend);
  if (lo >= hi) {
    if (part == nullptr) {  // one split: the block's rows are all zeros
      const int nrow = min(r0 + rows_t, t) - r0;
      for (int i = threadIdx.x; i < nrow * group * (D / 8); i += L::kThreads) {
        const int pr = i / (D / 8), c = i % (D / 8);
        const int64_t o = (((int64_t)b * t + r0 + pr / group) * h_total +
                           kvh * group + pr % group) * D + c * 8;
        *reinterpret_cast<uint4*>(out + o) = make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }
  const int kt0 = lo / 64, n = (hi - 1) / 64 - kt0 + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      ptt::mbar_init(&full[s], 128);
      ptt::mbar_init(&empty[s], 128);
    }
    ptt::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // --------------------- producer warpgroup
    // Each thread copies its own 16-byte chunks of every tile by cp.async
    // (bf16: straight into the stage, 128-byte swizzled; int8: into the
    // stage's raw slot) and keeps kAhead tiles in flight; once its copies
    // of tile j have landed (int8: and it has widened them to bf16 in the
    // stage), it fences them for wgmma and arrives on the stage's `full`.
    constexpr int VN = 16 / (int)sizeof(KT);  // elements of a 16-byte copy
    constexpr int VPR = D / VN;               // copies of a key row
    constexpr int PER = 64 * VPR / 128;       // a thread's copies of K (of V)
    const int pt = threadIdx.x - 128;
    // the block's slice of the page table, pages [lo / P, (hi - 1) / P]
    const int p_first = lo / page;
    const int n_tab = min((hi - 1) / page - p_first + 1, kRagMaxChunkPages);
    for (int i = pt; i < n_tab; i += 128)
      stab[i] = tbl[(int64_t)b * mp + p_first + i];
    ptt::attn::named_sync(1, 128);
    // the physical pages of this thread's keys of tile i (-1: no key of
    // the block's range, or a page id outside [0, NP): read as zeros)
    auto pages = [&](int i, int (&pg)[PER]) {
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int kpos = (kt0 + i) * 64 + (pt + 128 * u) / VPR;
        const int id =
            kpos >= lo && kpos < hi ? stab[kpos / page - p_first] : -1;
        pg[u] = id >= 0 && id < np ? id : -1;
      }
    };
    int pg[PER], pg_next[PER];
    pages(0, pg);
    for (int i = 0; i < n + L::kAhead; ++i) {
      // complete tile j = i - kAhead first: the consumers release a stage
      // only once the tile after it is complete
      const int j = i - L::kAhead;
      if (j >= 0) {
        ptt::cp_async_wait<L::kAhead - 1>();  // tiles 0..i-1 were committed
        const int s = j % L::kStages;
        if constexpr (kQuant) {
          if (j >= L::kStages)
            ptt::mbar_wait(&empty[s], (j / L::kStages - 1) & 1);
          const unsigned char* kr = raw + s * L::kRaw;
          const unsigned char* vr = kr + 64 * D;
          const float* rs = reinterpret_cast<const float*>(kr + 2 * 64 * D);
          unsigned char* kd = ring + s * L::kStage;
          unsigned char* vd = kd + L::kKV;
  #pragma unroll
          for (int u = 0; u < PER; ++u) {
            const int idx = pt + 128 * u, key = idx / VPR, c = idx % VPR;
            uint4 a, b2;
            widen_codes(*reinterpret_cast<const uint4*>(kr + key * D + c * 16),
                        a, b2);
            *reinterpret_cast<uint4*>(kd + sw128_offset(key, 2 * c)) = a;
            *reinterpret_cast<uint4*>(kd + sw128_offset(key, 2 * c + 1)) = b2;
            widen_codes(*reinterpret_cast<const uint4*>(vr + key * D + c * 16),
                        a, b2);
            *reinterpret_cast<uint4*>(vd + sw128_offset(key, 2 * c)) = a;
            *reinterpret_cast<uint4*>(vd + sw128_offset(key, 2 * c + 1)) = b2;
            if (c == 0) {
              scales[s * 128 + key] = rs[key];
              scales[s * 128 + 64 + key] = rs[64 + key];
            }
          }
        }
        ptt::attn::fence_proxy_async();
        ptt::mbar_arrive(&full[s]);
      }
      if (i < n) {
        const int s = i % L::kStages;
        if (i + 1 < n) pages(i + 1, pg_next);  // in flight during the copies
        unsigned char* kd = kQuant ? raw + s * L::kRaw : ring + s * L::kStage;
        unsigned char* vd = kd + (kQuant ? 64 * D : L::kKV);
        if (!kQuant && i >= L::kStages)  // the consumers released the stage
          ptt::mbar_wait(&empty[s], (i / L::kStages - 1) & 1);
        const int k0 = (kt0 + i) * 64;
#pragma unroll
        for (int u = 0; u < PER; ++u) {
          const int idx = pt + 128 * u, key = idx / VPR, c = idx % VPR;
          const bool ok = pg[u] >= 0;
          const int64_t off =
              ok ? (((int64_t)pg[u] * page + (k0 + key) % page) * kvh_total +
                    kvh) * D + c * VN
                 : 0;
          const int dst = kQuant ? key * D + c * 16 : sw128_offset(key, c);
          ptt::cp_async16(kd + dst, kp + off, ok ? 16 : 0);
          ptt::cp_async16(vd + dst, vp + off, ok ? 16 : 0);
          if (kQuant && c == 0) {  // the key's own page's scales
            const int page_id = ok ? pg[u] : 0;
            const int64_t scale_row = (int64_t)page_id * kvh_total + kvh;
            float* rs = reinterpret_cast<float*>(kd + 2 * 64 * D);
            cp_async4(rs + key, kscale + scale_row, ok ? 4 : 0);
            cp_async4(rs + 64 + key, vscale + scale_row, ok ? 4 : 0);
          }
        }
#pragma unroll
        for (int u = 0; u < PER; ++u) pg[u] = pg_next[u];
      }
      ptt::cp_async_commit();
    }
    return;
  }

  // ---------------------------------------------------- consumer warpgroup
  // the M tile's q: pair i is row r0 + i / group, q head kvh * group +
  // i % group; pairs past the tile's rows and rows past T stay zero
  for (int i = threadIdx.x; i < 64 * (D / 8); i += 128) {
    const int pair = i / (D / 8), c = i % (D / 8);
    const int row = r0 + pair / group;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (pair < rows_t * group && row < t)
      v = __ldg(reinterpret_cast<const uint4*>(
          q + (((int64_t)b * t + row) * h_total + kvh * group + pair % group) *
                  D + c * 8));
    *reinterpret_cast<uint4*>(sQ + sw128_offset(pair, c)) = v;
  }
  ptt::attn::fence_proxy_async();
  ptt::attn::named_sync(2, 128);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int pa0 = 16 * warp + g;  // this thread's pairs: pa0, pa0 + 8
  const int qbase = seq_len - t + r0;
  const RaggedHook<KT, D> hook{ring, scales, kt0, lo, hi,
                               seq_len - t + row_lo, seq_len - t + row_hi - 1,
                               window, qbase + pa0 / group,
                               qbase + (pa0 + 8) / group, 2 * t4,
                               scale * ptt::attn::kLog2e};
  float o[D / 2], m[2], l[2];
  ptt::attn::consume<D, L::kStages>(sQ, full, empty, n, hook, o, m, l);

  // accumulator element 4 j + i is pair pa0 + 8 (i / 2), column
  // 8 j + 2 t4 + i % 2
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pair = pa0 + 8 * r;
    const int row = r0 + pair / group;
    if (part == nullptr) {
      if (pair >= rows_t * group || row >= t) continue;
      const bool real = row >= row_lo && row < row_hi;
      const float inv = real ? 1.f / fmaxf(l[r], 1e-30f) : 0.f;
      __nv_bfloat16* dst =
          out + (((int64_t)b * t + row) * h_total + kvh * group +
                 pair % group) * D + 2 * t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) = ptt::attn::pack_bf16(
            o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    } else {
      float* dst = part + (((((int64_t)b * kvh_total + kvh) * gridDim.z +
                             tile) * gridDim.x + split) * 64 + pair) * (D + 2);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j + 2 * t4) =
            make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
      if (t4 == 0) {
        dst[D] = m[r];
        dst[D + 1] = l[r];
      }
    }
  }
}

// one block per (row, sequence), its threads over the row's (q head,
// column) outputs: a real row's non-empty chunks [first, last] combined in
// order (m in the log2 domain); padded rows and rows of seq_len 0 are
// exactly 0
template <int D>
__global__ void __launch_bounds__(256) ragged_kernel_merge(
    const float* __restrict__ part, const int* __restrict__ lens,
    const int* __restrict__ qlens, __nv_bfloat16* __restrict__ out, int t,
    int h_total, int kvh_total, int page, int mp, int chunk_pages,
    int tiles, int splits, int window) {
  const int row = blockIdx.x, b = blockIdx.y;
  const int group = h_total / kvh_total, rows_t = 64 / group;
  const int tile = row / rows_t, r0 = tile * rows_t;
  int row_lo, row_hi, kstart, kend;
  ragged_rows_range(lens[b], qlens != nullptr ? qlens[b] : t, t, r0, rows_t,
                    window, mp, page, row_lo, row_hi, kstart, kend);
  const int chunk = chunk_pages * page;
  const int first = kstart / chunk;
  const int last = kstart < kend ? (kend - 1) / chunk : first - 1;
  const bool real = row >= row_lo && row < row_hi;
  const int64_t stride = 64 * (D + 2);  // one split to the next
  __nv_bfloat16* o = out + ((int64_t)b * t + row) * h_total * D;
  for (int i = threadIdx.x; i < h_total * D; i += blockDim.x) {
    const int h = i / D, d = i % D;
    float val = 0.f;
    if (real) {
      const int pair = (row - r0) * group + h % group;
      const float* pr =
          part + ((((int64_t)b * kvh_total + h / group) * tiles + tile) *
                      splits * 64 + pair) * (D + 2);
      float mm = -INFINITY;
      for (int s = first; s <= last; ++s) mm = fmaxf(mm, pr[s * stride + D]);
      if (mm != -INFINITY) {
        float l = 0.f, a = 0.f;
        for (int s = first; s <= last; ++s) {
          const float w = exp2f(pr[s * stride + D] - mm);
          l += pr[s * stride + D + 1] * w;
          a += pr[s * stride + d] * w;
        }
        val = a / fmaxf(l, 1e-30f);
      }
    }
    o[i] = __float2bfloat16_rn(val);
  }
}

// ---------------------------------------------------------------- decode
//
// decode_kernel_split and decode_kernel_merge replace
// paddle_tpu/ops/kernels/paged_attention.py::_decode_kernel, the
// FLAGS_ragged_attention=off lowering of paged_attention(): one query
// token per sequence, q [B, H, D], out [B, H, D], over the pages of
// page_table[b, :] (same page layout and int8 scales as above). For each
// sequence b and q head h:
//   * keys at pos < seq_lens[b] are kept, and with window > 0 only
//     pos >= seq_len - window; no page wholly outside is ever loaded;
//   * q head h reads kv head h / (H / KVH);
//   * softmax statistics and the output accumulate in float32; the
//     output is divided by max(l, 1e-30), so a row with seq_len 0 (a
//     page-table padding row) returns exactly 0;
//   * called for the ragged entry at T = 1, q_lens [B] (or none) marks the
//     real rows: a row of q_len 0 returns exactly 0.
// Rounding: the Pallas float branch rounds p to the page type before PV
// (pvals.astype(v.dtype)), its int8 branch does not (v is float32 there).
// These kernels keep p in float32 on both branches.
//
// What bounds it on the H100: bytes. Each K/V byte serves the `group` q
// heads of its kv head once (~2 * group flops per byte), far below the
// card's ~295 flops per byte, so the design's work is to fill the card
// with loads (one block per (sequence, kv head) made 64 blocks on 132
// SMs at the serving batch, and the longest row's tiles ran one after
// another):
//   * split-K: grid (splits, KVH * row-head batches, B). A block takes
//     one chunk of a row's keys, chunk_pages whole pages (128 keys at
//     pages of 16), for up to kDecRH q heads of one kv head: the whole
//     group of every model the port serves (4 or 7), so each K/V byte is
//     read once. splits = ceil(MP / chunk_pages) comes from the table's
//     width on the host, never from seq_lens; a block whose chunk lies at
//     or past seq_len, or wholly below the window, exits at once and
//     writes nothing, since the merge reads only a row's non-empty chunks.
//   * each block writes float32 partials (acc[D], m, l) per row-head to
//     a workspace [B, KVH, splits, group, D + 2] that the wrapper
//     allocates; decode_kernel_merge, launched right after on the same
//     stream, combines a row's non-empty chunks in order (m = max m_i,
//     l = sum l_i exp(m_i - m), acc likewise), so two runs give the same
//     bits.
//   * bytes in flight: the chunk's slice of the page table (and its int8
//     scales) is read into shared memory once; each warp then streams its
//     16-key tiles of K and V (tile i of the chunk goes to warp i % 4)
//     through its own ring of kDecStages stages with 16-byte cp.async
//     copies, kept in the page type and widened to float32 in registers.
//     The key loop has no __syncthreads: a warp waits on its own copies.
//     At 128-key chunks a warp's two tiles are in flight at once, and
//     ~72 KB of shared memory a block (bf16, D = 128) leaves room for
//     three blocks an SM: 256-key chunks with 3-stage rings (114 KB, two
//     blocks an SM) ran 1.25-1.7x slower on the H100, held back by the
//     latency of too few warps, not by bytes.
//   * every warp serves every row-head of the block over its own keys, so
//     group 7 (Qwen2) keeps all four warps busy; the warps' states merge
//     in shared memory at the end of the block. QK^T takes two lanes a
//     key, each dotting half its row with the pre-scaled q rows (shared
//     memory, broadcast); for PV each lane owns D / 32 output columns and
//     reads the tile's p back from shared memory. The 16-byte vectors of
//     a staged row are XOR-swizzled by the row, so the lanes' reads are
//     free of bank conflicts.

constexpr int kDecTile = 16;            // keys a warp takes per step
constexpr int kDecStages = 2;           // cp.async ring depth, per warp
constexpr int kDecRH = 8;               // row-heads a block serves
constexpr int kDecMaxChunkPages = 128;  // pages of a chunk's table slice

// keys [kstart, kend) of a decode row with seq_len keys; none for a row
// that is not real (the ragged entry's q_len 0)
__device__ __forceinline__ void decode_range(int seq_len, bool real,
                                             int window, int mp, int page,
                                             int& kstart, int& kend) {
  kend = min(seq_len, mp * page);
  kstart = window > 0 ? max(0, seq_len - window) : 0;
  if (!real) kend = kstart;
}

// shared memory of decode_kernel_split (bytes): the pre-scaled q rows, the
// chunk's page table slice and scales, the warps' p, and the warps'
// cp.async rings, which the warps' final states reuse
template <typename KT, int D>
struct DecodeSmem {
  static constexpr int kRow = D * (int)sizeof(KT);  // a staged key row
  static constexpr int kQ = kDecRH * D * 4;
  static constexpr int kTab = 3 * kDecMaxChunkPages * 4;
  static constexpr int kP = kWarps * kDecRH * kDecTile * 4;
  static constexpr int kRing = kWarps * kDecStages * 2 * kDecTile * kRow;
  static constexpr int kState = kWarps * kDecRH * (D + 2) * 4;
  static constexpr int bytes = kQ + kTab + kP + (kRing > kState ? kRing
                                                                : kState);
};

// where 16-byte vector c of staged row j lies: vectors are XOR-swizzled
// by the row, so lanes reading one vector of 8 rows hit 8 bank groups
template <int VPR>
__device__ __forceinline__ int swz(int j, int c) {
  return c ^ (j & ((VPR < 8 ? VPR : 8) - 1));
}

// N elements of T from shared memory (N * sizeof(T) in {2, 4, 8, 16}
// bytes, aligned to that), widened to float32
template <typename T, int N>
__device__ __forceinline__ void load_n(const T* src, float* dst) {
  constexpr int B = N * (int)sizeof(T);
  static_assert(B == 2 || B == 4 || B == 8 || B == 16, "unsupported width");
  using V = typename std::conditional<
      B == 16, uint4,
      typename std::conditional<
          B == 8, uint2,
          typename std::conditional<B == 4, uint32_t,
                                    uint16_t>::type>::type>::type;
  const V raw = *reinterpret_cast<const V*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < N; ++k) dst[k] = ptt::to_f32(e[k]);
}

template <typename T, typename KT, int D>
__global__ void __launch_bounds__(kThreads) decode_kernel_split(
    const T* __restrict__ q, const KT* __restrict__ kp,
    const KT* __restrict__ vp, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ tbl,
    const int* __restrict__ lens, const int* __restrict__ qlens,
    float* __restrict__ part, int h_total,
    int kvh_total, int np, int page, int mp, int chunk_pages, float scale,
    int window) {
  using S = DecodeSmem<KT, D>;
  constexpr int VN = ptt::Vec16<KT>::N;  // elements a 16-byte vector
  constexpr int VPR = D / VN;            // 16-byte vectors a key row
  constexpr int DPL = D / 32;            // output columns a lane
  constexpr int kStage = 2 * kDecTile * S::kRow;  // a tile's K and V
  static_assert(kDecTile * VPR % 32 == 0, "tile does not split evenly");
  extern __shared__ __align__(16) unsigned char dsmem[];
  float* qs = reinterpret_cast<float*>(dsmem);  // [kDecRH][D], pre-scaled
  int* ptab = reinterpret_cast<int*>(dsmem + S::kQ);
  float* ksc = reinterpret_cast<float*>(ptab + kDecMaxChunkPages);
  float* vsc = ksc + kDecMaxChunkPages;
  float* pbuf = vsc + kDecMaxChunkPages;  // [kWarps][kDecRH][kDecTile]
  unsigned char* ring = dsmem + S::kQ + S::kTab + S::kP;

  const int group = h_total / kvh_total;
  const int nrb = (group + kDecRH - 1) / kDecRH;
  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / nrb, rh0 = blockIdx.y % nrb * kDecRH;
  const int nrh = min(kDecRH, group - rh0);
  int kstart, kend;
  decode_range(lens[b], qlens == nullptr || qlens[b] > 0, window, mp, page,
               kstart, kend);
  const int chunk = chunk_pages * page;
  const int lo = max(split * chunk, kstart);
  const int hi = min(split * chunk + chunk, kend);
  if (lo >= hi) return;
  const int p0 = split * chunk_pages;  // the chunk's first logical page
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < nrh * D; i += kThreads)
    qs[i] = ptt::to_f32(
                q[((int64_t)b * h_total + kvh * group + rh0) * D + i]) *
            scale;
  // the pages the chunk's keys lie in, their physical ids and scales
  for (int i = lo / page - p0 + threadIdx.x; i <= (hi - 1) / page - p0;
       i += kThreads) {
    const int pg = tbl[(int64_t)b * mp + p0 + i];
    ptab[i] = pg;
    if (kscale != nullptr) {  // a page out of range stages zeros
      const bool ok = pg >= 0 && pg < np;
      const int64_t srow = ok ? (int64_t)pg * kvh_total + kvh : 0;
      ksc[i] = ok ? kscale[srow] : 1.f;
      vsc[i] = ok ? vscale[srow] : 1.f;
    }
  }
  __syncthreads();

  // this warp's tiles: t = warp, warp + kWarps, ... of the chunk's ntiles;
  // lanes key and key + 16 own key `key` of each
  const int ntiles = (hi - lo + kDecTile - 1) / kDecTile;
  const int nmine = ntiles > warp ? (ntiles - warp + kWarps - 1) / kWarps : 0;
  const int key = lane % kDecTile, half = lane / kDecTile;
  unsigned char* wring = ring + warp * kDecStages * kStage;
  auto issue = [&](int i) {
    // row of key `key` in the pool's [NP * P] rows, -1 past hi or for a
    // page out of range (staged as zeros)
    const int kpos = lo + (warp + kWarps * i) * kDecTile + key;
    int row = -1;
    if (kpos < hi) {
      const int pg = ptab[kpos / page - p0];
      if (pg >= 0 && pg < np) row = pg * page + kpos % page;
    }
    unsigned char* kdst = wring + i % kDecStages * kStage;
    unsigned char* vdst = kdst + kDecTile * S::kRow;
#pragma unroll
    for (int v = lane; v < kDecTile * VPR; v += 32) {
      const int j = v / VPR, c = v % VPR;
      const int rj = __shfl_sync(0xffffffffu, row, j);
      const int64_t off =
          rj >= 0 ? ((int64_t)rj * kvh_total + kvh) * D + c * VN : 0;
      const int dst = j * S::kRow + swz<VPR>(j, c) * 16;
      ptt::cp_async16(kdst + dst, kp + off, rj >= 0 ? 16 : 0);
      ptt::cp_async16(vdst + dst, vp + off, rj >= 0 ? 16 : 0);
    }
  };

  float m[kDecRH], l[kDecRH], acc[kDecRH][DPL];
#pragma unroll
  for (int r = 0; r < kDecRH; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }
  float* pw = pbuf + warp * kDecRH * kDecTile;

#pragma unroll
  for (int i = 0; i < kDecStages - 1; ++i) {
    if (i < nmine) issue(i);
    ptt::cp_async_commit();
  }
  for (int i = 0; i < nmine; ++i) {
    if (i + kDecStages - 1 < nmine) issue(i + kDecStages - 1);
    ptt::cp_async_commit();
    ptt::cp_async_wait<kDecStages - 1>();
    __syncwarp();
    const unsigned char* kst = wring + i % kDecStages * kStage;
    const unsigned char* vst = kst + kDecTile * S::kRow;
    const int kpos = lo + (warp + kWarps * i) * kDecTile + key;
    const bool valid = kpos < hi;

    // s = q k^T over this lane's half of key `key`'s row
    float s[kDecRH];
#pragma unroll
    for (int r = 0; r < kDecRH; ++r) s[r] = 0.f;
#pragma unroll
    for (int c = 0; c < VPR / 2; ++c) {
      const int cl = half * (VPR / 2) + c;  // the logical vector
      float kf[VN];
      load_n<KT, VN>(reinterpret_cast<const KT*>(
                         kst + key * S::kRow + swz<VPR>(key, cl) * 16),
                     kf);
#pragma unroll
      for (int r = 0; r < kDecRH; ++r) {
        if (r < nrh) {
          const float4* qr =
              reinterpret_cast<const float4*>(qs + r * D + cl * VN);
#pragma unroll
          for (int e = 0; e < VN / 4; ++e) {
            const float4 qv = qr[e];
            s[r] += qv.x * kf[4 * e] + qv.y * kf[4 * e + 1] +
                    qv.z * kf[4 * e + 2] + qv.w * kf[4 * e + 3];
          }
        }
      }
    }
    float k_sc = 1.f, v_sc = 1.f;
    if (kscale != nullptr && valid) {  // int8 codes: the key's own page
      k_sc = ksc[kpos / page - p0];
      v_sc = vsc[kpos / page - p0];
    }
#pragma unroll
    for (int r = 0; r < kDecRH; ++r) {
      if (r < nrh) {
        float x = s[r] + __shfl_xor_sync(0xffffffffu, s[r], kDecTile);
        x = valid ? x * k_sc : kNegInf;
        float tmax = x;
#pragma unroll
        for (int o = kDecTile / 2; o > 0; o >>= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
        // the tile's first key is kept, so tmax is a real score
        const float m_new = fmaxf(m[r], tmax);
        const float corr = expf(m[r] - m_new);
        const float p = valid ? expf(x - m_new) : 0.f;
        l[r] = l[r] * corr + (half == 0 ? p : 0.f);  // summed at the end
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[r][c] *= corr;
        m[r] = m_new;
        if (half == 0) pw[r * kDecTile + key] = p * v_sc;
      }
    }
    __syncwarp();

    // acc += p v over the tile, lane `lane` owning columns lane * DPL..
    constexpr int kLaneBytes = DPL * (int)sizeof(KT);
    const int vc = lane * kLaneBytes / 16, vb = lane * kLaneBytes % 16;
#pragma unroll
    for (int j0 = 0; j0 < kDecTile; j0 += 4) {
      float vf[4][DPL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + jj;
        load_n<KT, DPL>(reinterpret_cast<const KT*>(
                            vst + j * S::kRow + swz<VPR>(j, vc) * 16 + vb),
                        vf[jj]);
      }
#pragma unroll
      for (int r = 0; r < kDecRH; ++r) {
        if (r < nrh) {
          const float4 p4 =
              *reinterpret_cast<const float4*>(pw + r * kDecTile + j0);
#pragma unroll
          for (int c = 0; c < DPL; ++c)
            acc[r][c] += p4.x * vf[0][c] + p4.y * vf[1][c] +
                         p4.z * vf[2][c] + p4.w * vf[3][c];
        }
      }
    }
    __syncwarp();  // the stage and pw are rewritten later
  }

  // merge the warps' states in shared memory (over the rings), one
  // partial per row-head to the workspace
#pragma unroll
  for (int r = 0; r < kDecRH; ++r) l[r] = ptt::warp_sum(l[r]);
  __syncthreads();
  float* st = reinterpret_cast<float*>(ring);  // [kWarps][kDecRH][D + 2]
#pragma unroll
  for (int r = 0; r < kDecRH; ++r) {
    if (r < nrh) {
      float* sw = st + (warp * kDecRH + r) * (D + 2);
#pragma unroll
      for (int c = 0; c < DPL; ++c) sw[lane * DPL + c] = acc[r][c];
      if (lane == 0) {
        sw[D] = m[r];
        sw[D + 1] = l[r];
      }
    }
  }
  __syncthreads();
  const int64_t prow =
      (((int64_t)b * kvh_total + kvh) * gridDim.x + split) * group + rh0;
  for (int i = threadIdx.x; i < nrh * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mm = fmaxf(mm, st[(w * kDecRH + r) * (D + 2) + D]);
    float a = 0.f, ll = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* sw = st + (w * kDecRH + r) * (D + 2);
      const float wt = expf(sw[D] - mm);  // 0 for a warp without keys
      a += sw[d] * wt;
      ll += sw[D + 1] * wt;
    }
    float* dst = part + (prow + r) * (D + 2);
    dst[d] = a;
    if (d == 0) {
      dst[D] = mm;
      dst[D + 1] = ll;
    }
  }
}

// one block per (q head, sequence), one thread per output column: the
// row's non-empty chunks [s_lo, s_hi) combined in order
template <typename T, int D>
__global__ void __launch_bounds__(D) decode_kernel_merge(
    const float* __restrict__ part, const int* __restrict__ lens,
    const int* __restrict__ qlens, T* __restrict__ out, int h_total,
    int kvh_total, int page, int mp,
    int chunk_pages, int splits, int window) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int group = h_total / kvh_total;
  int kstart, kend;
  decode_range(lens[b], qlens == nullptr || qlens[b] > 0, window, mp, page,
               kstart, kend);
  const int chunk = chunk_pages * page;
  const int s_lo = kstart / chunk;
  const int s_hi = kstart < kend ? (kend + chunk - 1) / chunk : s_lo;
  const int64_t stride = (int64_t)group * (D + 2);  // one split to the next
  const float* pr =
      part + (((int64_t)b * kvh_total + h / group) * splits * group +
              h % group) * (D + 2);
  float m = kNegInf;
  for (int s = s_lo; s < s_hi; ++s) m = fmaxf(m, pr[s * stride + D]);
  float l = 0.f, a = 0.f;
  for (int s = s_lo; s < s_hi; ++s) {
    const float w = expf(pr[s * stride + D] - m);
    l += pr[s * stride + D + 1] * w;
    a += pr[s * stride + d] * w;
  }
  out[((int64_t)b * h_total + h) * D + d] =
      ptt::from_f32<T>(a / fmaxf(l, 1e-30f));
}

// ---------------------------------------------------------------- host
struct Args {
  const void *q, *kp, *vp, *ks, *vs, *tbl, *lens, *qlens;
  void* out;
  int64_t b, t, h, kvh, np, page, mp, window;
  float scale;
  cudaStream_t stream;
  float* part;          // the split partials' workspace (or none)
  int64_t chunk_pages;  // pages a split block takes
};

// after a T > 1 route without q_lens, on the same stream: the rows that
// see no key
template <typename T, typename KT, int D>
int launch_no_key_rows(const Args& a) {
  if (a.qlens == nullptr)
    no_key_rows_kernel<T, KT, D>
        <<<dim3((unsigned)a.b, (unsigned)a.h), D, 0, a.stream>>>(
            static_cast<const KT*>(a.vp), static_cast<const float*>(a.vs),
            static_cast<const int*>(a.tbl), static_cast<const int*>(a.lens),
            static_cast<T*>(a.out), (int)a.t, (int)a.h, (int)a.kvh,
            (int)a.np, (int)a.page, (int)a.mp);
  return (int)cudaGetLastError();
}

// the tensor-core route: the split pass, then (with a workspace) the
// merge, then (q_lens absent) the rows that see no key, on one stream
template <typename KT, int D>
int launch_ragged_tc(const Args& a) {
  using L = RaggedTc<KT, D>;
  const int rows = (int)(64 / (a.h / a.kvh));
  const int64_t tiles = (a.t + rows - 1) / rows;
  const int64_t splits = (a.mp + a.chunk_pages - 1) / a.chunk_pages;
  if (a.chunk_pages < 1 || a.chunk_pages > kRagMaxChunkPages ||
      tiles > 65535 || a.t > 65535 ||
      a.b * a.kvh > 65535 || (a.part == nullptr && splits != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ragged_kernel_wgmma<KT, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kSmem);
  if (err != cudaSuccess) return (int)err;
  ragged_kernel_wgmma<KT, D>
      <<<dim3((unsigned)splits, (unsigned)(a.b * a.kvh), (unsigned)tiles),
         L::kThreads, L::kSmem, a.stream>>>(
          static_cast<const __nv_bfloat16*>(a.q),
          static_cast<const KT*>(a.kp), static_cast<const KT*>(a.vp),
          static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
          static_cast<const int*>(a.tbl), static_cast<const int*>(a.lens),
          static_cast<const int*>(a.qlens),
          static_cast<__nv_bfloat16*>(a.out), a.part, (int)a.t, (int)a.h,
          (int)a.kvh, (int)a.np, (int)a.page, (int)a.mp, (int)a.chunk_pages,
          a.scale, (int)a.window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (a.part != nullptr)
    ragged_kernel_merge<D>
        <<<dim3((unsigned)a.t, (unsigned)a.b), 256, 0, a.stream>>>(a.part, static_cast<const int*>(a.lens),
                       static_cast<const int*>(a.qlens),
                       static_cast<__nv_bfloat16*>(a.out), (int)a.t,
                       (int)a.h, (int)a.kvh, (int)a.page, (int)a.mp,
                       (int)a.chunk_pages, (int)tiles, (int)splits,
                       (int)a.window);
  return launch_no_key_rows<__nv_bfloat16, KT, D>(a);
}

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
  return launch_no_key_rows<T, KT, D>(a);
}

// the split pass, then the merge, on the same stream
template <typename T, typename KT, int D>
int launch_decode(const Args& a) {
  const int group = (int)(a.h / a.kvh);
  const int nrb = (group + kDecRH - 1) / kDecRH;
  const int splits = (int)((a.mp + a.chunk_pages - 1) / a.chunk_pages);
  const int smem = DecodeSmem<KT, D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel_split<T, KT, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  decode_kernel_split<T, KT, D>
      <<<dim3((unsigned)splits, (unsigned)(a.kvh * nrb), (unsigned)a.b),
         kThreads, smem, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const KT*>(a.kp),
          static_cast<const KT*>(a.vp), static_cast<const float*>(a.ks),
          static_cast<const float*>(a.vs), static_cast<const int*>(a.tbl),
          static_cast<const int*>(a.lens), static_cast<const int*>(a.qlens),
          a.part, (int)a.h, (int)a.kvh,
          (int)a.np, (int)a.page, (int)a.mp, (int)a.chunk_pages, a.scale,
          (int)a.window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_kernel_merge<T, D>
      <<<dim3((unsigned)a.h, (unsigned)a.b), D, 0, a.stream>>>(
          a.part, static_cast<const int*>(a.lens),
          static_cast<const int*>(a.qlens), static_cast<T*>(a.out),
          (int)a.h, (int)a.kvh, (int)a.page, (int)a.mp, (int)a.chunk_pages,
          splits, (int)a.window);
  return (int)cudaGetLastError();
}

// one route of one instantiation: the decode split (T = 1), the tensor
// cores (T > 1, bf16 q) or the CUDA cores (T > 1, float32 q)
template <typename T, typename KT, int D>
int launch_route(bool decode, const Args& a) {
  if (decode) return launch_decode<T, KT, D>(a);
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return launch_ragged_tc<KT, D>(a);
  else
    return launch_ragged<T, KT, D>(a);
}

// the instantiations: q/out type x page type (q's own, or int8) x D
template <typename T, typename KT>
int dispatch_d(int64_t d, bool decode, const Args& a) {
  switch (d) {
    case 64:
      return launch_route<T, KT, 64>(decode, a);
    case 128:
      return launch_route<T, KT, 128>(decode, a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int dispatch(int64_t d, int dtype, int kv_dtype, bool decode, const Args& a) {
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
      return quant ? dispatch_d<float, int8_t>(d, decode, a)
                   : dispatch_d<float, float>(d, decode, a);
    case ptt::kBFloat16:
      return quant ? dispatch_d<__nv_bfloat16, int8_t>(d, decode, a)
                   : dispatch_d<__nv_bfloat16, __nv_bfloat16>(d, decode, a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: [B, T, H, D] (dtype); k_pages, v_pages: [NP, P, KVH, D]
// (kv_dtype: dtype's own, or int8 with k_scales, v_scales [NP, KVH]
// float32; null for float pages); page_table: [B, MP] int32; seq_lens:
// [B] int32; q_lens: [B] int32 or null. All contiguous, q/pages/out
// 16-byte aligned. The route follows T and dtype:
//   * T = 1: workspace float32 [B, KVH, ceil(MP / chunk_pages), H / KVH,
//     D + 2] (1 <= chunk_pages <= 128), as ptt_paged_decode_attention;
//   * T > 1, bf16: workspace float32 [B, KVH, tiles, ceil(MP /
//     chunk_pages), 64, D + 2] (tiles = ceil(T / (64 / (H / KVH)))), or
//     null when chunk_pages >= MP (one split);
//   * T > 1, float32: workspace and chunk_pages unused.
// Returns the launches' cudaGetLastError() (0 on success).
extern "C" int ptt_paged_ragged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* page_table,
    const void* seq_lens, const void* q_lens, void* out, void* workspace,
    int64_t b, int64_t t, int64_t h, int64_t kvh, int64_t d, int64_t np,
    int64_t page, int64_t mp, int64_t chunk_pages, float scale,
    int64_t window, int dtype, int kv_dtype, void* stream) {
  if (b <= 0 || t <= 0) return 0;
  const bool decode = t == 1;
  if (decode && (workspace == nullptr || chunk_pages < 1 ||
                 chunk_pages > kDecMaxChunkPages))
    return (int)cudaErrorInvalidValue;
  const Args a{q,   k_pages, v_pages, k_scales, v_scales, page_table,
               seq_lens, q_lens, out, b, t, h, kvh, np, page, mp, window,
               scale, static_cast<cudaStream_t>(stream),
               static_cast<float*>(workspace), chunk_pages};
  return dispatch(d, dtype, kv_dtype, decode, a);
}

// q, out: [B, H, D] (dtype), one decode token per sequence; the pages,
// scales, page_table and seq_lens as above; workspace: float32
// [B, KVH, ceil(MP / chunk_pages), H / KVH, D + 2], the split partials
// (1 <= chunk_pages <= 256). Launches the split pass and the merge on
// `stream`; returns their cudaGetLastError() (0 on success).
extern "C" int ptt_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* page_table,
    const void* seq_lens, void* out, void* workspace, int64_t b, int64_t h,
    int64_t kvh, int64_t d, int64_t np, int64_t page, int64_t mp,
    int64_t chunk_pages, float scale, int64_t window, int dtype,
    int kv_dtype, void* stream) {
  if (b <= 0) return 0;
  if (workspace == nullptr || chunk_pages < 1 ||
      chunk_pages > kDecMaxChunkPages)
    return (int)cudaErrorInvalidValue;
  const Args a{q,   k_pages, v_pages, k_scales, v_scales, page_table,
               seq_lens, nullptr, out, b, 1, h, kvh, np, page, mp, window,
               scale, static_cast<cudaStream_t>(stream),
               static_cast<float*>(workspace), chunk_pages};
  return dispatch(d, dtype, kv_dtype, true, a);
}
