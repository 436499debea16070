// RMSNorm forward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/kernels/rms_norm.py::_rms_kernel (the Pallas
// row-tiled RMSNorm forward behind rms_norm()).
//
// Computes, per row of x [rows, hidden]:
//   y = cast((x * rsqrt(mean(x^2) + eps)) * w)
// with the mean-square, the scaling and the weight multiply all in
// float32, and the cast to x's dtype last -- the reference's order
// (rms_norm.py:37-42), which multiplies by the weight before the cast.
// Any hidden size is accepted.
//
// What bounds it on the H100: bytes. It reads each element once (plus
// the weight row) and writes each once, doing ~4 flops per element,
// far below the ~295 flops per byte where the tensor cores would start
// to matter; at the serving shapes ([<=256, 4096] bf16, 2 MB in + 2 MB
// out) the floor is ~1.3 us of HBM time, so launch latency is a large
// share.
//
// Design: one block per row; 16-byte vector loads (8 bf16) when the row
// and pointers allow it, scalar loads otherwise; the sum of squares is
// reduced in float32 by warp shuffles and one shared-memory exchange.
// The second pass re-reads the row, which is then served from L1/L2
// (a 4096-wide bf16 row is 8 KB).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// block-wide float sum; every thread gets the total
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = ptt::warp_sum(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int nw = blockDim.x / 32;
  v = lane < nw ? red[lane] : 0.f;
  return ptt::warp_sum(v);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ y, int64_t hidden, float eps) {
  __shared__ float red[32];
  constexpr int N = ptt::Vec16<T>::N;
  const T* xr = x + (int64_t)blockIdx.x * hidden;
  T* yr = y + (int64_t)blockIdx.x * hidden;

  float ss = 0.f;
  if (kVec) {
    const int64_t nv = hidden / N;
    for (int64_t i = threadIdx.x; i < nv; i += blockDim.x) {
      float f[N];
      ptt::load16(xr + i * N, f);
#pragma unroll
      for (int k = 0; k < N; ++k) ss += f[k] * f[k];
    }
  } else {
    for (int64_t i = threadIdx.x; i < hidden; i += blockDim.x) {
      const float f = ptt::to_f32(xr[i]);
      ss += f * f;
    }
  }
  ss = block_sum(ss, red);
  const float inv = rsqrtf(ss / (float)hidden + eps);

  if (kVec) {
    const int64_t nv = hidden / N;
    for (int64_t i = threadIdx.x; i < nv; i += blockDim.x) {
      float fx[N], fw[N];
      ptt::load16(xr + i * N, fx);
      if (w != nullptr) {
        ptt::load16(w + i * N, fw);
      } else {
#pragma unroll
        for (int k = 0; k < N; ++k) fw[k] = 1.f;
      }
      uint4 raw;
      T* o = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float v = fx[k] * inv;
        o[k] = ptt::from_f32<T>(w != nullptr ? v * fw[k] : v);
      }
      *reinterpret_cast<uint4*>(yr + i * N) = raw;
    }
  } else {
    for (int64_t i = threadIdx.x; i < hidden; i += blockDim.x) {
      const float v = ptt::to_f32(xr[i]) * inv;
      yr[i] = ptt::from_f32<T>(w != nullptr ? v * ptt::to_f32(w[i]) : v);
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, void* y, int64_t rows,
            int64_t hidden, float eps, cudaStream_t stream) {
  const bool vec = (hidden % ptt::Vec16<T>::N) == 0 &&
                   ((uintptr_t)x % 16) == 0 && ((uintptr_t)y % 16) == 0 &&
                   (w == nullptr || ((uintptr_t)w % 16) == 0);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  if (vec) {
    rms_norm_kernel<T, true>
        <<<(unsigned)rows, kThreads, 0, stream>>>(xp, wp, yp, hidden, eps);
  } else {
    rms_norm_kernel<T, false>
        <<<(unsigned)rows, kThreads, 0, stream>>>(xp, wp, yp, hidden, eps);
  }
}

}  // namespace

// x, y: [rows, hidden] contiguous; w: [hidden] or null. Returns the
// launch's cudaGetLastError() (0 on success).
extern "C" int ptt_rms_norm(const void* x, const void* w, void* y,
                            int64_t rows, int64_t hidden, float eps,
                            int dtype, void* stream) {
  if (rows <= 0 || hidden <= 0) return 0;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kFloat32:
      launch<float>(x, w, y, rows, hidden, eps, s);
      break;
    case ptt::kBFloat16:
      launch<__nv_bfloat16>(x, w, y, rows, hidden, eps, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
