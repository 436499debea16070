// RMSNorm and LayerNorm forward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/kernels/rms_norm.py::_rms_kernel (the Pallas
// row-tiled RMSNorm forward behind rms_norm(), pallas_call at :56) and
// ::_ln_kernel (the LayerNorm forward behind layer_norm_fused(),
// pallas_call at :182).
//
// Per row of x [rows, hidden], with every statistic and product in
// float32 and one cast to x's dtype last, in the reference's order:
//   RMSNorm   y = cast((x * rsqrt(mean(x^2) + eps)) * w)   (:37-42)
//   LayerNorm y = cast((x - mean) * rsqrt(var + eps) * w + b), with
//             var = mean((x - mean)^2) over the centred values (:130-139)
// w and b may each be null. Any hidden size is accepted.
//
// What bounds it: bytes at the training widths (x read once, y written
// once, ~4 flops a byte, far below the tensor cores' ~295), launch
// latency and dependent memory trips at the decode widths ([8, 4096]
// bf16 moves 128 KB, ~0.04 us of HBM time).
//
// Design: the row lives in registers. A group of lanes owns a row; lane
// t of `lanes` holds the row's 16-byte vectors j * lanes + t for j <
// VPL, a template parameter, so all of a lane's loads (x, and the weight
// and bias with them) are issued before the first use. Vectors past the
// row's end are masked: nothing is read past it. x is read from device
// memory once; LayerNorm's centred second pass and the output pass run
// on the registers. The host (rms_norm.py's norm_launch_plan) picks one
// of three classes from the width and the dtype, and the entries below
// check the plan against the instantiations:
//   warp   a warp per row, rows up to 128 vectors (1,024 bf16, 512
//          float32): VPL 1-4, reductions by warp shuffles only, 8 warps
//          (rows) a block, one row a warp. An SM then holds 24-32 rows'
//          loads in flight (by the registers: 56-71 a thread at VPL 4
//          in bf16), where the one-block-a-row design had at most 8,
//          below the ~25 KB an SM that 3.35 TB/s needs at HBM's
//          latency. bf16 is widened to float32 at each use, so a row
//          takes its packed size in registers.
//   block  a block per row, wider rows up to 2,048 vectors (16,384 bf16,
//          8,192 float32): threads = 32 * ceil(ceil(vectors / 4) / 32)
//          <= 512, VPL = ceil(vectors / threads), which is 3 or 4; one
//          shared-memory exchange (one __syncthreads) per reduction.
//   scalar the rest (a width that is not a multiple of the vector, a
//          pointer that is not 16-byte aligned, or a wider row): a
//          block of 256 threads per row with element loads, re-reading
//          the row from L1/L2 for each pass.
// Instantiations: warp VPL {1, 2, 3, 4}, block VPL {3, 4}, scalar, for
// two dtypes and two norms: 28 kernels.

#include "common.cuh"

namespace {

enum PlanKind : int { kScalarPlan = 0, kWarpPlan = 1, kBlockPlan = 2 };
constexpr int kWarpRows = 8;          // rows (warps) a block, warp class
constexpr int kBlockMaxThreads = 512;  // widest block class
constexpr int kScalarThreads = 256;
// the weight and bias are loaded beside x, before the first reduction
constexpr bool kWeightFirst = true;
// bf16 elements are widened to float32 at each use, from the packed
// vectors, so a row takes its packed size in registers in every pass
constexpr bool kWidenAtUse = true;

enum class Norm { kRms, kLayer };

struct NormArgs {
  const void* x;
  const void* w;  // [hidden] or null
  const void* b;  // [hidden] or null (LayerNorm only)
  void* y;
  int64_t rows;
  int hidden;
  float eps;
};

// element k of a packed 16-byte vector, in float32. For bf16 the
// widening is volatile asm, which the compiler may not hoist or share
// between the passes: otherwise it keeps a float32 copy of the row live
// from the first pass to the output, twice the registers of the packed
// row (80 a thread for RMSNorm at VPL 4, 120 for LayerNorm).
template <typename T>
__device__ __forceinline__ float elem(const uint4& v, int k) {
  if constexpr (kWidenAtUse && sizeof(T) == 2) {
    const uint32_t w = reinterpret_cast<const uint32_t*>(&v)[k / 2];
    uint32_t r;
    if (k % 2 == 0) {
      asm volatile("shl.b32 %0, %1, 16;" : "=r"(r) : "r"(w));
    } else {
      asm volatile("and.b32 %0, %1, 0xffff0000;" : "=r"(r) : "r"(w));
    }
    return __uint_as_float(r);
  } else {
    return ptt::to_f32(reinterpret_cast<const T*>(&v)[k]);
  }
}

// a lane's vectors j * lanes + t (j < VPL) of a row of nv 16-byte
// vectors; zeros past nv, which is read nowhere
template <int VPL>
__device__ __forceinline__ void load_vectors(const void* row, int t,
                                             int lanes, int nv,
                                             uint4 (&r)[VPL]) {
  const uint4* p = static_cast<const uint4*>(row);
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int i = j * lanes + t;
    r[j] = i < nv ? p[i] : make_uint4(0u, 0u, 0u, 0u);
  }
}

// the sum of v over the threads that own a row: a warp, or the block
// (one shared-memory exchange, one __syncthreads; red is this
// reduction's own buffer, so two reductions need no barrier between)
template <bool kBlock>
__device__ __forceinline__ float row_sum(float v, float* red) {
  v = ptt::warp_sum(v);
  if (!kBlock) return v;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = blockDim.x / 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < nw ? red[lane] : 0.f;
  return ptt::warp_sum(v);
}

// The row-in-registers body of both norms. kBlock: the block owns row
// blockIdx.x; else warp threadIdx.x / 32 takes rows grid-stride (one
// row, with launch_warp's grid).
template <Norm kNorm, typename T, int VPL, bool kBlock>
__device__ __forceinline__ void norm_rows(const NormArgs& a) {
  __shared__ float red[2][32];
  constexpr int N = ptt::Vec16<T>::N;
  const int nv = a.hidden / N;
  const int lanes = kBlock ? (int)blockDim.x : 32;
  const int t = kBlock ? (int)threadIdx.x : (int)(threadIdx.x % 32);
  int64_t row = kBlock ? (int64_t)blockIdx.x
                       : (int64_t)blockIdx.x * kWarpRows + threadIdx.x / 32;
  const int64_t stride = kBlock ? a.rows : (int64_t)gridDim.x * kWarpRows;
  const bool has_w = a.w != nullptr;
  const bool has_b = kNorm == Norm::kLayer && a.b != nullptr;

  uint4 w[VPL], b[VPL];
  auto load_params = [&]() {
    if (has_w) load_vectors<VPL>(a.w, t, lanes, nv, w);
    if (has_b) load_vectors<VPL>(a.b, t, lanes, nv, b);
  };
  if (kWeightFirst) load_params();

  for (; row < a.rows; row += stride) {
    uint4 x[VPL];
    load_vectors<VPL>(static_cast<const T*>(a.x) + row * a.hidden, t,
                      lanes, nv, x);
    float mean = 0.f, inv;
    if (kNorm == Norm::kRms) {
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < VPL; ++j)
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float f = elem<T>(x[j], k);
          ss += f * f;
        }
      inv = rsqrtf(row_sum<kBlock>(ss, red[0]) / (float)a.hidden + a.eps);
    } else {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < VPL; ++j)
#pragma unroll
        for (int k = 0; k < N; ++k) s += elem<T>(x[j], k);
      mean = row_sum<kBlock>(s, red[0]) / (float)a.hidden;
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        if (j * lanes + t >= nv) continue;  // masked: not part of the row
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float c = elem<T>(x[j], k) - mean;
          ss += c * c;
        }
      }
      inv = rsqrtf(row_sum<kBlock>(ss, red[1]) / (float)a.hidden + a.eps);
    }
    if (!kWeightFirst) load_params();

    uint4* yr = reinterpret_cast<uint4*>(static_cast<T*>(a.y) +
                                         row * a.hidden);
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int i = j * lanes + t;
      if (i >= nv) continue;
      uint4 raw;
      T* o = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        float v = (elem<T>(x[j], k) - mean) * inv;
        if (has_w) v *= elem<T>(w[j], k);
        if (has_b) v += elem<T>(b[j], k);
        o[k] = ptt::from_f32<T>(v);
      }
      yr[i] = raw;
    }
  }
}

template <typename T, int VPL, bool kBlock>
__global__ void __launch_bounds__(kBlock ? kBlockMaxThreads
                                         : 32 * kWarpRows)
    rms_norm_kernel(NormArgs a) {
  norm_rows<Norm::kRms, T, VPL, kBlock>(a);
}

template <typename T, int VPL, bool kBlock>
__global__ void __launch_bounds__(kBlock ? kBlockMaxThreads
                                         : 32 * kWarpRows)
    layer_norm_kernel(NormArgs a) {
  norm_rows<Norm::kLayer, T, VPL, kBlock>(a);
}

// The scalar path: a block per row, element loads, each pass re-reading
// the row.
template <typename T>
__global__ void __launch_bounds__(kScalarThreads)
    rms_norm_kernel_scalar(NormArgs a) {
  __shared__ float red[32];
  const T* xr = static_cast<const T*>(a.x) + (int64_t)blockIdx.x * a.hidden;
  T* yr = static_cast<T*>(a.y) + (int64_t)blockIdx.x * a.hidden;
  const T* w = static_cast<const T*>(a.w);
  float ss = 0.f;
  for (int i = threadIdx.x; i < a.hidden; i += blockDim.x) {
    const float f = ptt::to_f32(xr[i]);
    ss += f * f;
  }
  const float inv =
      rsqrtf(row_sum<true>(ss, red) / (float)a.hidden + a.eps);
  for (int i = threadIdx.x; i < a.hidden; i += blockDim.x) {
    const float v = ptt::to_f32(xr[i]) * inv;
    yr[i] = ptt::from_f32<T>(w != nullptr ? v * ptt::to_f32(w[i]) : v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kScalarThreads)
    layer_norm_kernel_scalar(NormArgs a) {
  __shared__ float red[2][32];
  const T* xr = static_cast<const T*>(a.x) + (int64_t)blockIdx.x * a.hidden;
  T* yr = static_cast<T*>(a.y) + (int64_t)blockIdx.x * a.hidden;
  const T* w = static_cast<const T*>(a.w);
  const T* b = static_cast<const T*>(a.b);
  float sum = 0.f;
  for (int i = threadIdx.x; i < a.hidden; i += blockDim.x)
    sum += ptt::to_f32(xr[i]);
  const float mean = row_sum<true>(sum, red[0]) / (float)a.hidden;
  float ss = 0.f;
  for (int i = threadIdx.x; i < a.hidden; i += blockDim.x) {
    const float c = ptt::to_f32(xr[i]) - mean;
    ss += c * c;
  }
  const float inv =
      rsqrtf(row_sum<true>(ss, red[1]) / (float)a.hidden + a.eps);
  for (int i = threadIdx.x; i < a.hidden; i += blockDim.x) {
    float v = (ptt::to_f32(xr[i]) - mean) * inv;
    if (w != nullptr) v *= ptt::to_f32(w[i]);
    if (b != nullptr) v += ptt::to_f32(b[i]);
    yr[i] = ptt::from_f32<T>(v);
  }
}

template <Norm kNorm, typename T, int VPL, bool kBlock>
void launch_vector(unsigned grid, int threads, const NormArgs& a,
                   cudaStream_t s) {
  if constexpr (kNorm == Norm::kRms) {
    rms_norm_kernel<T, VPL, kBlock><<<grid, threads, 0, s>>>(a);
  } else {
    layer_norm_kernel<T, VPL, kBlock><<<grid, threads, 0, s>>>(a);
  }
}

template <Norm kNorm, typename T, int VPL>
cudaError_t launch_warp(const NormArgs& a, cudaStream_t s) {
  const int64_t blocks = (a.rows + kWarpRows - 1) / kWarpRows;
  const unsigned grid = (unsigned)blocks;
  launch_vector<kNorm, T, VPL, false>(grid, 32 * kWarpRows, a, s);
  return cudaSuccess;
}

bool aligned16(const void* p) { return ((uintptr_t)p % 16) == 0; }

// Launches the plan (kind, vpl, threads a row, rows a block) that the
// wrapper computed, after checking it against the instantiations and
// the arguments; cudaErrorInvalidValue for a plan it lacks.
template <Norm kNorm, typename T>
cudaError_t launch_plan(const NormArgs& a, int kind, int vpl, int threads,
                        int rows_per_block, cudaStream_t s) {
  constexpr int N = ptt::Vec16<T>::N;
  if (kind == kScalarPlan) {
    if (threads != kScalarThreads || rows_per_block != 1)
      return cudaErrorInvalidValue;
    if constexpr (kNorm == Norm::kRms) {
      rms_norm_kernel_scalar<T>
          <<<(unsigned)a.rows, kScalarThreads, 0, s>>>(a);
    } else {
      layer_norm_kernel_scalar<T>
          <<<(unsigned)a.rows, kScalarThreads, 0, s>>>(a);
    }
    return cudaSuccess;
  }
  if (a.hidden % N != 0 || !aligned16(a.x) || !aligned16(a.y) ||
      !aligned16(a.w) || !aligned16(a.b))
    return cudaErrorInvalidValue;
  const int64_t nv = a.hidden / N;
  if (kind == kWarpPlan) {
    if (threads != 32 || rows_per_block != kWarpRows || 32LL * vpl < nv)
      return cudaErrorInvalidValue;
    switch (vpl) {
      case 1: return launch_warp<kNorm, T, 1>(a, s);
      case 2: return launch_warp<kNorm, T, 2>(a, s);
      case 3: return launch_warp<kNorm, T, 3>(a, s);
      case 4: return launch_warp<kNorm, T, 4>(a, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (kind == kBlockPlan) {
    if (rows_per_block != 1 || threads % 32 != 0 || threads <= 0 ||
        threads > kBlockMaxThreads || (int64_t)threads * vpl < nv)
      return cudaErrorInvalidValue;
    switch (vpl) {
      case 3:
        launch_vector<kNorm, T, 3, true>((unsigned)a.rows, threads, a, s);
        return cudaSuccess;
      case 4:
        launch_vector<kNorm, T, 4, true>((unsigned)a.rows, threads, a, s);
        return cudaSuccess;
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

template <Norm kNorm>
int run(const NormArgs& a, int dtype, int kind, int vpl, int threads,
        int rows_per_block, void* stream) {
  if (a.rows <= 0 || a.hidden <= 0) return 0;
  if (a.rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case ptt::kFloat32:
      err = launch_plan<kNorm, float>(a, kind, vpl, threads,
                                      rows_per_block, s);
      break;
    case ptt::kBFloat16:
      err = launch_plan<kNorm, __nv_bfloat16>(a, kind, vpl, threads,
                                              rows_per_block, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: [rows, hidden] contiguous; w: [hidden] or null. (kind, vpl,
// threads, rows_per_block): rms_norm.py's norm_launch_plan. Returns the
// launch's cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for a plan this library has no kernel for.
extern "C" int ptt_rms_norm(const void* x, const void* w, void* y,
                            int64_t rows, int64_t hidden, float eps,
                            int dtype, int kind, int vpl, int threads,
                            int rows_per_block, void* stream) {
  if (hidden > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const NormArgs a{x, w, nullptr, y, rows, (int)hidden, eps};
  return run<Norm::kRms>(a, dtype, kind, vpl, threads, rows_per_block,
                         stream);
}

// x, y: [rows, hidden] contiguous; w, b: [hidden] or null. The plan and
// the result as for ptt_rms_norm.
extern "C" int ptt_layer_norm(const void* x, const void* w, const void* b,
                              void* y, int64_t rows, int64_t hidden,
                              float eps, int dtype, int kind, int vpl,
                              int threads, int rows_per_block,
                              void* stream) {
  if (hidden > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const NormArgs a{x, w, b, y, rows, (int)hidden, eps};
  return run<Norm::kLayer>(a, dtype, kind, vpl, threads, rows_per_block,
                           stream);
}
