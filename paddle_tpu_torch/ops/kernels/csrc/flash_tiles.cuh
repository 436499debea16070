// What the flash-attention sources (flash_attention.cu, flash_varlen.cu)
// share outside the tensor-core tiles: the block shape of the float32
// kernels (one warp a row or key, on the CUDA cores), the softmax
// constants, the bf16 pair store of the epilogues, and the launch helpers.
// The bf16 kernels' tiles are wgmma's (hopper_tiles.cuh, attn_fwd_tiles.cuh,
// attn_bwd_tiles.cuh).
#pragma once

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;  // a float32 block: one row (key) a warp
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 64;  // keys a K/V tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNoKeyLse = -1e30f;  // lse of a row that sees no key

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------- launch
// kThreads threads a block; above 48 KB of dynamic shared memory the
// kernel is opted in first. Returns the launch's cudaGetLastError().
template <typename Kernel, typename P>
int launch(Kernel kernel, dim3 grid, int smem, cudaStream_t stream,
           const P& p) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

inline unsigned blocks(int n, int per) {
  return (unsigned)((n + per - 1) / per);
}

// Consumer warpgroups a block of the M-tile kernels (the forwards and the
// dQ kernels: one M tile of `rows` q rows each over n rows, `others` blocks
// along the other grid axes): the most, 3 at D = 64 and 2 at D = 128 (where
// the float32 accumulator of D columns takes twice the registers), that
// still give each of the H100's 132 SMs a block.
template <int D>
int consumer_warpgroups(int n, int rows, int64_t others) {
  int nwg = D == 64 ? 3 : 2;
  while (nwg > 1 && (int64_t)blocks(n, nwg * rows) * others < 132) --nwg;
  return nwg;
}

}  // namespace
