// Packed (varlen) flash attention forward and backward for Hopper
// (sm_90a).
//
// Replaces three Pallas kernels of paddle_tpu/ops/kernels/flash_varlen.py:
//   * _varlen_fwd_kernel      -> varlen_fwd_wgmma / varlen_fwd_f32
//   * _varlen_bwd_dkdv_kernel -> varlen_bwd_dkdv_wgmma / varlen_bwd_dkdv_f32
//   * _varlen_bwd_dq_kernel   -> varlen_bwd_dq_wgmma / varlen_bwd_dq_f32
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
// Design, shared by the three bf16 kernels:
//   * Every kept set is an interval. Row q keeps keys [klo, khi]: klo is
//     the first key of its segment, khi its last, or with causal
//     cu_k[s] + loc_q if that is smaller. Key k is kept by rows [qlo, qhi]
//     in the mirror image. Along the rows (keys) the ends of the
//     intervals that are not empty never decrease, so a thread finds its
//     two rows' (keys') intervals once by binary search over cu and masks
//     with two compares, and a tile is full when its last row's klo and
//     its first row's khi enclose it.
//   * A block walks only the key tiles (q tiles for dK/dV) that the
//     segments of its rows (keys) reach, segment by segment, each tile
//     once, found from cu and never by testing every tile: the work is
//     ~O(sum_i s_i^2). A q tile that spans several segments walks the key
//     tiles of each.
//   * All three run on wgmma, fed by TMA through a ring of stages that a
//     producer warp keeps full, on the tiles that the dense kernels share:
//     the forward on attn_fwd_tiles.cuh's core, the backward on
//     attn_bwd_tiles.cuh's steps. The forward and dQ: one block per (kv
//     head, M tiles of 64 (row, q head) pairs), walking the key tiles of
//     its rows. dK/dV: one block per (key tile, kv head), the tiles taken
//     largest work first, walking the group's q heads and, for each, its
//     q tiles. Out, dK, dV and dQ stay in float32 registers and are
//     written once: no atomics, so two runs give equal gradients.
// Only D = 64 and D = 128 are instantiated; the wrapper refuses others.

#include <climits>

#include "attn_bwd_tiles.cuh"
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
// cu_q and cu_k are read through plain pointers: in global memory, or in
// the shared-memory copy of the backward kernels (with_shared_cu).
//
// the segment of token t: the number of j in 1..B with cu[j] <= t
__device__ __forceinline__ int seg_of(const int* cu, int B, int t) {
  int lo = 1, hi = B + 1;  // the first j in [1, B] with cu[j] > t, or B + 1
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cu[mid] <= t) {
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
  return s == 0 ? 0 : min(max(cu[s], 0), T);
}
__device__ __forceinline__ int seg_end(const int* cu, int B, int s, int T) {
  return s == B ? T : min(max(cu[s + 1], 0), T);
}

// keys [lo, hi] that row q of segment s keeps (empty: hi < lo)
__device__ __forceinline__ void row_keys(const VParams& p, int s, int q,
                                         int& lo, int& hi) {
  lo = seg_beg(p.cu_k, s, p.Tk);
  hi = seg_end(p.cu_k, p.B, s, p.Tk) - 1;
  if (p.causal) hi = min(hi, p.cu_k[s] + q - p.cu_q[s]);
}

// rows [lo, hi] that keep key k of segment s (empty: hi < lo)
__device__ __forceinline__ void key_rows(const VParams& p, int s, int k,
                                         int& lo, int& hi) {
  lo = seg_beg(p.cu_q, s, p.Tq);
  hi = seg_end(p.cu_q, p.B, s, p.Tq) - 1;
  if (p.causal) lo = max(lo, p.cu_q[s] + k - p.cu_k[s]);
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
  // the number of tiles of the walk from here, a segment at a time
  __device__ int count(const VParams& p) {
    int n = 0;
    for (; next(p) >= 0; kt = t_hi) n += t_hi - kt + 1;
    return n;
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
  // the number of tiles of the walk from here, a segment at a time
  __device__ int count(const VParams& p) {
    int n = 0;
    for (; next(p) >= 0; qt = t_hi) n += t_hi - qt + 1;
    return n;
  }
};

// ---------------------------------------------------- bf16, on wgmma
// The forward runs the core of attn_fwd_tiles.cuh, the backward kernels
// the steps of attn_bwd_tiles.cuh. Their hooks take this thread's two
// rows' (forward and dQ: keys of two (row, head) pairs; dK/dV: rows of
// two keys) intervals, and the warpgroup's hull. hi never decreases
// along the axis; lo does, across a segment boundary, only after keys
// that no row keeps (cu_q != cu_k: a key past its q segment's length has
// lo > hi). lo' = min(lo, hi + 1) never decreases, so a tile
// [x0, x0 + 63] is live when it meets [l_lo, l_hi] (the warpgroup's first
// lo', last hi) and full when [f_lo, f_hi] (its last lo', first hi)
// encloses it.
// Each walk step and interval reads cu a few times, one dependent load
// after another, so the kernels copy both boundary arrays into
// shared memory first when they fit (kCuMax entries each): p with its
// cu pointers on the copy at `cu` (2 (B + 1) ints), every thread copying;
// the caller synchronizes before reading it.
constexpr int kCuMax = 1024;

__device__ __forceinline__ VParams with_shared_cu(const VParams& p,
                                                  int* cu) {
  VParams ps = p;
  if (p.B + 1 <= kCuMax) {
    for (int i = threadIdx.x; i <= p.B; i += blockDim.x) {
      cu[i] = p.cu_q[i];
      cu[p.B + 1 + i] = p.cu_k[i];
    }
    ps.cu_q = cu;
    ps.cu_k = cu + p.B + 1;
  }
  return ps;
}

// shared memory for with_shared_cu (bytes)
int shared_cu_bytes(const VParams& p) {
  return p.B + 1 <= kCuMax ? 8 * (p.B + 1) : 0;
}

struct Intervals {
  int lo[2], hi[2];
  int l_lo, l_hi, f_lo, f_hi;
  __device__ bool live(int x0) const { return x0 <= l_hi && x0 + 63 >= l_lo; }
  __device__ bool full(int x0) const { return f_lo <= x0 && x0 + 63 <= f_hi; }
  __device__ bool kept(int x0, int r, int c) const {
    return x0 + c >= lo[r] && x0 + c <= hi[r];
  }
  // l_lo .. f_hi from the intervals of [first, last] on an axis of n
  // (keys' rows, or rows' keys); none when first >= n
  template <bool kOfKeys>
  __device__ void hull(const VParams& p, int first, int last, int n) {
    if (first >= n) {
      l_lo = f_lo = 1;
      l_hi = f_hi = -1;
      return;
    }
    last = min(last, n - 1);
    if (kOfKeys) {
      key_interval(p, first, l_lo, f_hi);
      key_interval(p, last, f_lo, l_hi);
    } else {
      row_interval(p, first, l_lo, f_hi);
      row_interval(p, last, f_lo, l_hi);
    }
    l_lo = min(l_lo, f_hi + 1);  // lo' of an empty interval (see above)
    f_lo = min(f_lo, l_hi + 1);
  }
};

// --------------------------------------------------------- bf16 forward
// varlen_fwd_wgmma: flash_fwd_wgmma's shape (flash_attention.cu) on the
// same core and layout (attn::consume, attn::Fwd), with the varlen walk in
// place of the band. One block per (kv head, NWG M tiles), NWG consumer
// warpgroups (3 at D = 64, 2 at D = 128, fewer where that would leave SMs
// without a block) and one producer warp:
//   * M packing, as the dQ kernel's: an M tile is 64 (row, q head) pairs
//     of one kv head's group, 64 / group consecutive rows x the group's
//     heads, one TMA box of Q, so every K/V tile the block stages serves
//     all the group's heads of its rows (one block per (q tile, q head)
//     stages it once per q head). The M tiles go last to first, so blocks
//     whose rows walk the most keys (the late rows of long documents)
//     tend to start first;
//   * the producer's lane 0 loads the warpgroups' Q tiles once, then the
//     64-key K and V tiles of the block rows' walk (KeyTiles, in order,
//     each once) into a ring of kStages stages (5 at D = 64, 3 at
//     D = 128), with each tile's first key in step_k0;
//   * the hook (VarlenFwdHook) scales the scores into the log2 domain and,
//     on a tile that the warpgroup's hull does not enclose, sets to -inf
//     every key outside the pair's own interval (row_interval). Every
//     warpgroup runs the products of every tile of the block's walk: a
//     tile that none of its rows sees gives p = 0;
//   * out = o / l and lse = m ln 2 + log l are written from registers; a
//     row that sees no key (an empty k segment, a q tail past cu[-1])
//     gets out = 0 and lse = -1e30.
// A pair past the tile's rows x heads, or a row past Tq (read as zeros),
// keeps no key and is never written.
using ptt::attn::Fwd;

template <int D>
struct VarlenFwdHook {
  const unsigned char* ring;
  const int* step_k0;  // each stage's first key
  Intervals keys;      // this thread's two pairs', the warpgroup's hull
  int col0;            // this thread's first column of an 8-key group
  float sl2;
  __device__ const unsigned char* k(int st) const {
    return ring + st * Fwd<D, 1>::kStage;
  }
  __device__ const unsigned char* v(int st) const {
    return k(st) + Fwd<D, 1>::kSub * ptt::attn::kTile;
  }
  // the hull's f_hi lies below Tk: a full tile holds no key past Tk
  __device__ void score(int, int st, float (&s)[32]) const {
    const int k0 = step_k0[st];
    if (keys.full(k0)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] *= sl2;
      return;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = (e >> 1) & 1, c = 8 * (e >> 2) + col0 + (e & 1);
      float x = s[e] * sl2;
      if (!keys.kept(k0, r, c)) x = -INFINITY;
      s[e] = x;
    }
  }
  __device__ void prob(int, int, float (&)[32]) const {}
};

template <int D, int NWG>
__global__ void __launch_bounds__(Fwd<D, NWG>::kThreads, 1)
    varlen_fwd_wgmma(const __grid_constant__ CUtensorMap tmQ,
                     const __grid_constant__ CUtensorMap tmK,
                     const __grid_constant__ CUtensorMap tmV,
                     const VParams p) {
  using L = Fwd<D, NWG>;
  using ptt::attn::kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* base =
      smem + ((1024 - (ptt::smem_addr(smem) & 1023)) & 1023);
  unsigned char* ring = base + L::kNWG * L::kQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* qbar = empty + L::kStages;
  int* step_k0 = reinterpret_cast<int*>(qbar + 1);  // [kStages]
  const VParams ps = with_shared_cu(p, step_k0 + L::kStages);

  const int group = p.H / p.KVH, rows = 64 / group;
  const int kvh = blockIdx.x;
  const int mt = gridDim.y - 1 - blockIdx.y;  // the last rows first
  const int r0 = mt * L::kNWG * rows;
  const int r_last = min(r0 + L::kNWG * rows, p.Tq) - 1;

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
    if (lane == 0) {  // Q first: it needs no walk
      ptt::mbar_arrive_expect_tx(qbar, L::kNWG * L::kSub * group * rows * 128);
      for (int wg = 0; wg < L::kNWG; ++wg)
        for (int sub = 0; sub < L::kSub; ++sub)
          ptt::tma_load_4d(base + wg * L::kQ + sub * kTile, &tmQ, qbar,
                           sub * 64, kvh * group, r0 + wg * rows, 0);
      KeyTiles walk(ps, r0, r_last);
      for (int j = 0, kt = walk.next(ps); kt >= 0; kt = walk.next(ps), ++j) {
        const int s = j % L::kStages;
        if (j >= L::kStages)  // the consumers released this stage
          ptt::mbar_wait(&empty[s], (j / L::kStages - 1) & 1);
        step_k0[s] = kt * 64;  // published by the arrive below
        unsigned char* st = ring + s * L::kStage;
        ptt::mbar_arrive_expect_tx(&full[s], L::kStage);
        for (int sub = 0; sub < L::kSub; ++sub) {
          ptt::tma_load_4d(st + sub * kTile, &tmK, &full[s], sub * 64, kvh,
                           kt * 64, 0);
          ptt::tma_load_4d(st + (L::kSub + sub) * kTile, &tmV, &full[s],
                           sub * 64, kvh, kt * 64, 0);
        }
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, t = lane % 4;
  const int w0 = r0 + wg * rows;  // this warpgroup's rows w0..
  const int pa0 = 16 * wq + g;    // this thread's pairs: pa0, pa0 + 8
  Intervals keys;
  keys.hull<false>(ps, w0, w0 + rows - 1, p.Tq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pair = pa0 + 8 * r, row = w0 + pair / group;
    keys.lo[r] = 0;
    keys.hi[r] = -1;
    if (pair < rows * group && row < p.Tq)
      row_interval(ps, row, keys.lo[r], keys.hi[r]);
  }
  const VarlenFwdHook<D> hook{ring, step_k0, keys, 2 * t,
                              p.scale * kLog2e};
  const int n = KeyTiles(ps, r0, r_last).count(ps);
  float o[D / 2], m[2], l[2];
  ptt::mbar_wait(qbar, 0);
  ptt::attn::consume<D, L::kStages>(base + wg * L::kQ, full, empty, n, hook,
                                    o, m, l);

  // out = o / l; accumulator element 4 j + i is pair pa0 + 8 (i / 2),
  // column 8 j + 2 t + i % 2
  const int64_t qs = (int64_t)p.H * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pair = pa0 + 8 * r;
    const int row = w0 + pair / group, h = kvh * group + pair % group;
    if (pair >= rows * group || row >= p.Tq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    bf16* dst = static_cast<bf16*>(p.out) + row * qs + h * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack2(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    if (t == 0)
      p.lse[(int64_t)h * p.Tq + row] =
          l[r] > 0.f ? m[r] * kLn2 + logf(l[r]) : kNoKeyLse;
  }
}

// ---------------------------------------------------------- bf16 dK/dV
// varlen_bwd_dkdv_wgmma: flash_bwd_dkdv_wgmma's shape (flash_attention.cu)
// on the same step and layout (attn::dkdv_step, attn::Dkdv: NWG consumer
// warpgroups of 64 keys, 2 at D = 64 and 1 at D = 128, and a producer
// warp), with segments in place of the causal band. One block per (key
// tile of 64 * NWG keys, kv head):
//   * order: a key tile's work is its walk's q tiles (QueryTiles<64>)
//     times the group, from a few rows to a whole document's. Where the
//     blocks are more than one wave (rank_tiles), each block counts every
//     tile's walk (O(segments) a tile), ranks the tiles by work, largest
//     first, and takes the one of its own rank, so that the first tiles of
//     the long documents start first wherever they lie in the pack (past
//     kOrderMax tiles it takes them in order). A greedy schedule of
//     varlen_train's 256 blocks on 132 SMs ends at 321 step units in pack
//     order and at 219 in this one (the mean is 190);
//   * the producer's lane 0 loads the block's K and V once by TMA, then
//     walks the steps, for each q head of the group the q tiles of the
//     walk: Q and dO tiles of 64 rows (a box of `map_rows` over the packed
//     axis, rows past Tq read as zeros) and the rows' lse and delta (a
//     1-D box over H x Tq, which past a head's last row reads the next
//     head's values: those rows lie outside every key's interval and are
//     masked) into the ring, with the step's first row in step_q0;
//   * each consumer warpgroup runs attn::dkdv_step on each staged tile;
//     the mask is each thread's two keys' row intervals (key_interval),
//     run only on tiles that the warpgroup's first and last keys' do not
//     enclose; a tile that none of its 64 keys sees runs no product.
// dK and dV stay in float32 registers and are written once.
constexpr int kOrderMax = 512;  // key tiles a block ranks

template <int D>
__global__ void __launch_bounds__(ptt::attn::Dkdv<D>::kThreads, 1)
    varlen_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tmQ,
                          const __grid_constant__ CUtensorMap tmO,
                          const __grid_constant__ CUtensorMap tmK,
                          const __grid_constant__ CUtensorMap tmV,
                          const __grid_constant__ CUtensorMap tmL,
                          const __grid_constant__ CUtensorMap tmDelta,
                          const VParams p, int rank_tiles) {
  using L = ptt::attn::Dkdv<D>;
  using ptt::attn::kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* base =
      smem + ((1024 - (ptt::smem_addr(smem) & 1023)) & 1023);
  unsigned char* sK = base;
  unsigned char* sV = base + L::kKV;
  auto stage = [&](int s) { return base + 2 * L::kKV + s * L::kStage; };
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* kvbar = empty + L::kStages;
  int* step_q0 = reinterpret_cast<int*>(kvbar + 1);  // [kStages]
  int* work = step_q0 + L::kStages;  // [kOrderMax], then the block's tile
  const VParams ps = with_shared_cu(p, work + kOrderMax + 1);

  const int group = p.H / p.KVH, ntiles = gridDim.x / p.KVH;
  const int kvh = blockIdx.x % p.KVH, rank = blockIdx.x / p.KVH;
  auto tile_steps = [&](int kt) {
    return QueryTiles<64>(ps, kt * L::kBK,
                          min(kt * L::kBK + L::kBK, p.Tk) - 1)
        .count(ps);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      ptt::mbar_init(&full[s], 1);
      ptt::mbar_init(&empty[s], L::kNWG * 128);
    }
    ptt::mbar_init(kvbar, 1);
    ptt::mbar_fence_init();
  }
  __syncthreads();
  // the block's key tile, and its steps: (q head, q tile)
  int kt = rank, n_steps;
  if (rank_tiles) {  // more blocks than one wave: rank the tiles by work
    for (int i = threadIdx.x; i < ntiles; i += blockDim.x)
      work[i] = tile_steps(i);
    __syncthreads();
    // the tile of rank `rank`: more work first, then the lower index
    for (int i = threadIdx.x; i < ntiles; i += blockDim.x) {
      const int wi = work[i];
      int r = 0;
      for (int j = 0; j < ntiles; ++j)
        r += work[j] > wi || (work[j] == wi && j < i);
      if (r == rank) work[kOrderMax] = i;
    }
    __syncthreads();
    kt = work[kOrderMax];
    n_steps = group * work[kt];
  } else {
    n_steps = group * tile_steps(kt);
  }
  const int k0 = kt * L::kBK, k1 = min(k0 + L::kBK, p.Tk) - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == L::kNWG * 4) {  // ------------------------------- producer
    if (lane == 0 && n_steps > 0) {
      ptt::mbar_arrive_expect_tx(kvbar, 2 * L::kKV);
      for (int sub = 0; sub < L::kSub; ++sub) {
        ptt::tma_load_4d(sK + sub * L::kBK * 128, &tmK, kvbar, sub * 64, kvh,
                         k0, 0);
        ptt::tma_load_4d(sV + sub * L::kBK * 128, &tmV, kvbar, sub * 64, kvh,
                         k0, 0);
      }
      int it = 0;
      for (int gi = 0; gi < group; ++gi) {
        const int h = kvh * group + gi;
        QueryTiles<64> walk(ps, k0, k1);
        for (int qt = walk.next(ps); qt >= 0; qt = walk.next(ps), ++it) {
          const int s = it % L::kStages;
          if (it >= L::kStages)  // the consumers released this stage
            ptt::mbar_wait(&empty[s], (it / L::kStages - 1) & 1);
          const int q0 = qt * 64;
          step_q0[s] = q0;  // published by the arrive below
          unsigned char* st = stage(s);
          ptt::mbar_arrive_expect_tx(&full[s], L::kStageTx);
          for (int sub = 0; sub < L::kSub; ++sub) {
            ptt::tma_load_4d(st + sub * kTile, &tmQ, &full[s], sub * 64, h,
                             q0, 0);
            ptt::tma_load_4d(st + L::kQO + sub * kTile, &tmO, &full[s],
                             sub * 64, h, q0, 0);
          }
          const int row = h * p.Tq + q0;  // from 16 bytes
          ptt::tma_load_1d(st + 2 * L::kQO, &tmL, &full[s], row & ~3);
          ptt::tma_load_1d(st + 2 * L::kQO + 512, &tmDelta, &full[s],
                           row & ~3);
        }
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, t = lane % 4;
  const int kw0 = k0 + 64 * wg;  // this warpgroup's 64 keys
  const int kr0 = kw0 + 16 * wq + g;  // this thread's keys: kr0, kr0 + 8
  Intervals rows;
  key_interval(ps, kr0, rows.lo[0], rows.hi[0]);
  key_interval(ps, kr0 + 8, rows.lo[1], rows.hi[1]);
  rows.hull<true>(ps, kw0, kw0 + 63, p.Tk);
  float dk[D / 2] = {}, dv[D / 2] = {};
  if (n_steps > 0) ptt::mbar_wait(kvbar, 0);
  const int nqt = n_steps / group;  // every head walks the same q tiles
  for (int it = 0; it < n_steps; ++it) {
    const int s = it % L::kStages;
    ptt::mbar_wait(&full[s], (it / L::kStages) & 1);
    const int q0 = step_q0[s];
    const int row = (kvh * group + it / nqt) * p.Tq + q0;
    ptt::attn::dkdv_step<D>(sK + wg * 64 * 128, sV + wg * 64 * 128,
                            L::kBK * 128, stage(s), row & 3,
                            p.scale * kLog2e, p.scale, rows, q0, dk, dv);
    ptt::mbar_arrive(&empty[s]);
  }

  // dK, dV: accumulator element 4 j + i is key kr0 + 8 (i / 2), column
  // 8 j + 2 t + i % 2
  const int64_t ks = (int64_t)p.KVH * D;
  bf16* dkg = static_cast<bf16*>(p.dk) + kvh * D;
  bf16* dvg = static_cast<bf16*>(p.dv) + kvh * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kr = kr0 + 8 * r;
    if (kr >= p.Tk) continue;
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
// varlen_bwd_dq_wgmma: one block per (kv head, NWG M tiles), on
// attn::dq_consume (shared with the dense dQ kernel). NWG consumer
// warpgroups (up to 3 at D = 64, 2 at D = 128, fewer where that would
// leave SMs without a block) and one producer warp:
//   * M packing, as the forwards': an M tile is 64 (row, q head) pairs of
//     one kv head's group, 64 / group consecutive rows x the group's heads
//     (9 x 7 at Qwen2's group 7, 16 x 4 at group 4), one TMA box {64
//     columns, group heads, rows} of Q (and of dO), so every K/V tile the
//     block stages serves all the group's heads of its rows, where one
//     block per (q tile, q head) staged it once per q head;
//   * a pair's lse and delta are fixed for the block: each thread reads
//     its two pairs' values once into registers;
//   * the producer's lane 0 loads the warpgroups' Q and dO tiles once,
//     then the 64-key K and V tiles of the block rows' walk (KeyTiles, in
//     order, each once) into a ring of kStages stages (5 at D = 64, 4 at
//     D = 128), with each tile's first key in step_k0;
//   * the mask is each pair's own key interval (row_interval), run only on
//     tiles that the warpgroup's first and last rows' intervals do not
//     enclose; a warpgroup skips a tile that none of its rows sees. The
//     M tiles go last to first, so blocks whose rows walk the most keys
//     (the late rows of long documents) tend to start first.
// dQ stays in float32 registers and is written once. Its shared memory is
// attn::Dq's.
using ptt::attn::Dq;

template <int D, int NWG>
__global__ void __launch_bounds__(Dq<D, NWG>::kThreads, 1)
    varlen_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tmQ,
                        const __grid_constant__ CUtensorMap tmO,
                        const __grid_constant__ CUtensorMap tmK,
                        const __grid_constant__ CUtensorMap tmV,
                        const VParams p) {
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
  const VParams ps = with_shared_cu(p, step_k0 + L::kStages);

  const int group = p.H / p.KVH, rows = 64 / group;
  const int nmt = gridDim.x / p.KVH, kvh = blockIdx.x % p.KVH;
  const int mt = nmt - 1 - blockIdx.x / p.KVH;  // the last rows first
  const int r0 = mt * L::kNWG * rows;
  const int r_last = min(r0 + L::kNWG * rows, p.Tq) - 1;

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
    if (lane == 0) {  // Q and dO first: they need no walk
      ptt::mbar_arrive_expect_tx(qbar,
                                 L::kNWG * 2 * L::kSub * group * rows * 128);
      for (int wg = 0; wg < L::kNWG; ++wg)
        for (int sub = 0; sub < L::kSub; ++sub) {
          unsigned char* q = base + wg * L::kQdO + sub * kTile;
          ptt::tma_load_4d(q, &tmQ, qbar, sub * 64, kvh * group,
                           r0 + wg * rows, 0);
          ptt::tma_load_4d(q + L::kSub * kTile, &tmO, qbar, sub * 64,
                           kvh * group, r0 + wg * rows, 0);
        }
      KeyTiles walk(ps, r0, r_last);
      for (int j = 0, kt = walk.next(ps); kt >= 0; kt = walk.next(ps), ++j) {
        const int s = j % L::kStages;
        if (j >= L::kStages)  // the consumers released this stage
          ptt::mbar_wait(&empty[s], (j / L::kStages - 1) & 1);
        step_k0[s] = kt * 64;  // published by the arrive below
        unsigned char* st = ring + s * L::kStage;
        ptt::mbar_arrive_expect_tx(&full[s], L::kStage);
        for (int sub = 0; sub < L::kSub; ++sub) {
          ptt::tma_load_4d(st + sub * kTile, &tmK, &full[s], sub * 64, kvh,
                           kt * 64, 0);
          ptt::tma_load_4d(st + (L::kSub + sub) * kTile, &tmV, &full[s],
                           sub * 64, kvh, kt * 64, 0);
        }
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, t = lane % 4;
  const int w0 = r0 + wg * rows;  // this warpgroup's rows w0..
  const int pa0 = 16 * wq + g;    // this thread's pairs: pa0, pa0 + 8
  Intervals keys;
  keys.hull<false>(ps, w0, w0 + rows - 1, p.Tq);
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pair = pa0 + 8 * r, row = w0 + pair / group;
    const bool real = pair < rows * group && row < p.Tq;
    const int64_t i = (int64_t)(kvh * group + pair % group) * p.Tq + row;
    keys.lo[r] = 0;
    keys.hi[r] = -1;
    if (real) row_interval(ps, row, keys.lo[r], keys.hi[r]);
    lse2[r] = real ? p.lse_in[i] * kLog2e : 0.f;
    dl[r] = real ? p.delta[i] : 0.f;
  }
  const unsigned char* sQ = base + wg * L::kQdO;
  const int n = KeyTiles(ps, r0, r_last).count(ps);
  float dq[D / 2] = {};
  ptt::mbar_wait(qbar, 0);
  ptt::attn::dq_consume<D, L::kStages>(
      sQ, sQ + L::kSub * kTile, ring, L::kStage, step_k0, full, empty, n,
      lse2, dl, p.scale * kLog2e, p.scale, keys, dq);

  // dq: accumulator element 4 j + i is pair pa0 + 8 (i / 2), column
  // 8 j + 2 t + i % 2
  const int64_t qs = (int64_t)p.H * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pair = pa0 + 8 * r, row = w0 + pair / group;
    if (pair >= rows * group || row >= p.Tq) continue;
    bf16* dst = static_cast<bf16*>(p.dq) + row * qs +
                (kvh * group + pair % group) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
  }
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

// the tensor maps (built on the host for each call), then the launch.
// The token axis is a 4-D map's row axis with one "batch".
template <int D>
int launch_dkdv_wgmma(const VParams& p, cudaStream_t stream) {
  using L = ptt::attn::Dkdv<D>;
  const ptt::EncodeTiled enc = ptt::tensor_map_encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const int64_t ntiles = blocks(p.Tk, L::kBK);
  if ((int64_t)p.H * p.Tq + 64 > INT_MAX || ntiles * p.KVH > INT_MAX)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mo, mk, mv, ml, md;
  if (!ptt::map_rows(enc, &mq, p.q, D, p.H, p.Tq, 1, 64) ||
      !ptt::map_rows(enc, &mo, p.dout, D, p.H, p.Tq, 1, 64) ||
      !ptt::map_rows(enc, &mk, p.k, D, p.KVH, p.Tk, 1, L::kBK) ||
      !ptt::map_rows(enc, &mv, p.v, D, p.KVH, p.Tk, 1, L::kBK) ||
      !ptt::map_flat(enc, &ml, p.lse_in, (int64_t)p.H * p.Tq,
                     ptt::attn::kRowBox) ||
      !ptt::map_flat(enc, &md, p.delta, (int64_t)p.H * p.Tq,
                     ptt::attn::kRowBox))
    return (int)cudaErrorInvalidValue;
  // step_q0, the tile ranks, the block's tile and cu after the barriers
  const int smem =
      L::kSmem + 4 * (L::kStages + kOrderMax + 1) + shared_cu_bytes(p);
  int dev, sms;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return (int)cudaGetLastError();
  const int rank_tiles = ntiles <= kOrderMax && ntiles * p.KVH > sms;
  const cudaError_t e = cudaFuncSetAttribute(
      varlen_bwd_dkdv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  varlen_bwd_dkdv_wgmma<D><<<(unsigned)(ntiles * p.KVH), L::kThreads, smem,
                             stream>>>(mq, mo, mk, mv, ml, md, p,
                                       rank_tiles);
  return (int)cudaGetLastError();
}

template <int D, int NWG>
int launch_fwd_wgmma(const VParams& p, const CUtensorMap& mq,
                     const CUtensorMap& mk, const CUtensorMap& mv,
                     cudaStream_t stream) {
  using L = Fwd<D, NWG>;
  const unsigned mtiles = blocks(p.Tq, NWG * (64 / (p.H / p.KVH)));
  if (mtiles > 65535) return (int)cudaErrorInvalidValue;
  const int smem = L::kSmem + shared_cu_bytes(p);
  const cudaError_t e = cudaFuncSetAttribute(
      varlen_fwd_wgmma<D, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  varlen_fwd_wgmma<D, NWG><<<dim3(p.KVH, mtiles), L::kThreads, smem,
                             stream>>>(mq, mk, mv, p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_fwd(const VParams& p, cudaStream_t stream) {
  const ptt::EncodeTiled enc = ptt::tensor_map_encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const int group = p.H / p.KVH;
  if (group > 64) return (int)cudaErrorInvalidValue;  // an M tile's pairs
  const int rows = 64 / group;
  CUtensorMap mq, mk, mv;
  if (!ptt::map_heads_rows(enc, &mq, p.q, D, p.H, p.Tq, 1, group, rows) ||
      !ptt::map_rows(enc, &mk, p.k, D, p.KVH, p.Tk, 1, 64) ||
      !ptt::map_rows(enc, &mv, p.v, D, p.KVH, p.Tk, 1, 64))
    return (int)cudaErrorInvalidValue;
  const int nwg = consumer_warpgroups<D>(p.Tq, rows, p.KVH);
  if constexpr (D == 64)
    if (nwg == 3) return launch_fwd_wgmma<D, 3>(p, mq, mk, mv, stream);
  return nwg == 2 ? launch_fwd_wgmma<D, 2>(p, mq, mk, mv, stream)
                  : launch_fwd_wgmma<D, 1>(p, mq, mk, mv, stream);
}

template <int D, int NWG>
int launch_dq_wgmma(const VParams& p, const CUtensorMap& mq,
                    const CUtensorMap& mo, const CUtensorMap& mk,
                    const CUtensorMap& mv, cudaStream_t stream) {
  using L = Dq<D, NWG>;
  const int64_t n =
      (int64_t)blocks(p.Tq, NWG * (64 / (p.H / p.KVH))) * p.KVH;
  if (n > INT_MAX) return (int)cudaErrorInvalidValue;
  const int smem = L::kSmem + shared_cu_bytes(p);
  const cudaError_t e = cudaFuncSetAttribute(
      varlen_bwd_dq_wgmma<D, NWG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  varlen_bwd_dq_wgmma<D, NWG><<<(unsigned)n, L::kThreads, smem, stream>>>(
      mq, mo, mk, mv, p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const VParams& p, cudaStream_t stream) {
  const ptt::EncodeTiled enc = ptt::tensor_map_encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const int group = p.H / p.KVH;
  if (group > 64) return (int)cudaErrorInvalidValue;  // an M tile's pairs
  const int rows = 64 / group;
  CUtensorMap mq, mo, mk, mv;
  if (!ptt::map_heads_rows(enc, &mq, p.q, D, p.H, p.Tq, 1, group, rows) ||
      !ptt::map_heads_rows(enc, &mo, p.dout, D, p.H, p.Tq, 1, group, rows) ||
      !ptt::map_rows(enc, &mk, p.k, D, p.KVH, p.Tk, 1, 64) ||
      !ptt::map_rows(enc, &mv, p.v, D, p.KVH, p.Tk, 1, 64))
    return (int)cudaErrorInvalidValue;
  const int nwg = consumer_warpgroups<D>(p.Tq, rows, p.KVH);
  if constexpr (D == 64)
    if (nwg == 3) return launch_dq_wgmma<D, 3>(p, mq, mo, mk, mv, stream);
  return nwg == 2 ? launch_dq_wgmma<D, 2>(p, mq, mo, mk, mv, stream)
                  : launch_dq_wgmma<D, 1>(p, mq, mo, mk, mv, stream);
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
  if (dtype == ptt::kBFloat16)
    return D == 64 ? launch_fwd<64>(p, s) : launch_fwd<128>(p, s);
  const dim3 gf(blocks(p.Tq, kWarps), p.H);
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
  const dim3 gf(blocks(p.Tk, kWarps), p.KVH);
  if (dtype == ptt::kBFloat16)
    return D == 64 ? launch_dkdv_wgmma<64>(p, s) : launch_dkdv_wgmma<128>(p, s);
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
  const dim3 gf(blocks(p.Tq, kWarps), p.H);
  if (dtype == ptt::kBFloat16)
    return D == 64 ? launch_dq<64>(p, s) : launch_dq<128>(p, s);
  return D == 64 ? launch(varlen_bwd_dq_f32<64>, gf, 0, s, p)
                 : launch(varlen_bwd_dq_f32<128>, gf, 0, s, p);
}
