// Tile machinery of the mma.sync flash-attention kernels (the dense dQ,
// flash_attention.cu, and the varlen forward, flash_varlen.cu): the block
// shape, mma.sync m16n8k16 bf16 products with float32 accumulators,
// ldmatrix fragment addressing into padded shared tiles, cp.async
// 16-byte copies, and the row loads and stores of [rows, heads, D]
// tensors read in place.
#pragma once

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = 64;  // q rows per block (forward, dQ): 16 per warp
constexpr int kBK = 64;  // keys per tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNoKeyLse = -1e30f;  // lse of a row that sees no key

// ------------------------------------------------ tensor-core plumbing
__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, asynchronously; bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t* r, const bf16* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}
__device__ __forceinline__ void ldsm4_t(uint32_t* r, const bf16* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

// c[16x8] += a[16x16] b[16x8], bf16 operands, float32 accumulator
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment addresses in a row-major shared tile of row stride SD. lane is
// the thread's lane. In the mma layouts a thread owns rows g = lane / 4
// and g + 8 and columns 2 * (lane % 4) + {0, 1} of each 8-wide n-tile.
//   A operand, rows [r0, r0 + 16) x k [k0, k0 + 16):
template <int SD>
__device__ __forceinline__ const bf16* a_addr(const bf16* s, int r0, int k0,
                                              int lane) {
  return s + (r0 + (lane & 15)) * SD + k0 + (lane >> 4) * 8;
}
//   B operands of two n-tiles [n0, n0 + 16) x k [k0, k0 + 16) from a tile
//   stored [n][k] (ldsm4: r[0..1] for n-tile n0, r[2..3] for n0 + 8):
template <int SD>
__device__ __forceinline__ const bf16* bn_addr(const bf16* s, int n0, int k0,
                                               int lane) {
  return s + (n0 + (lane >> 4) * 8 + (lane & 7)) * SD + k0 +
         ((lane >> 3) & 1) * 8;
}
//   the same from a tile stored [k][n] (ldsm4_t):
template <int SD>
__device__ __forceinline__ const bf16* bt_addr(const bf16* s, int k0, int n0,
                                               int lane) {
  return s + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * SD + n0 +
         (lane >> 4) * 8;
}

// A operand of k-step kk from a float accumulator [16 x 8*NT] (P or dS),
// rounded to bf16: the register reuse of the FlashAttention-2 design
template <int NT>
__device__ __forceinline__ void acc_to_a(const float (*c)[4], int kk,
                                         uint32_t* a) {
  a[0] = pack2(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack2(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// c[16 x 8*NT] += A[16 x D] (rows r0.. of sa) * B^T, B stored [n][k] in sb
template <int D, int NT>
__device__ __forceinline__ void gemm_abt(float (*c)[4], const bf16* sa,
                                         int r0, const bf16* sb, int lane) {
  constexpr int SD = D + 8;
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 16) {
    uint32_t a[4];
    ldsm4(a, a_addr<SD>(sa, r0, k0, lane));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm4(b, bn_addr<SD>(sb, np * 16, k0, lane));
      mma16816(c[2 * np], a, b[0], b[1]);
      mma16816(c[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// c[16 x D] += P[16 x 16*KT] (a float accumulator, rounded to bf16) * B,
// B [16*KT][D] stored [k][n] in sb
template <int D, int KT>
__device__ __forceinline__ void gemm_pb(float (*c)[4], const float (*pacc)[4],
                                        const bf16* sb, int lane) {
  constexpr int SD = D + 8;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t a[4];
    acc_to_a<2 * KT>(pacc, kk, a);
#pragma unroll
    for (int n0 = 0; n0 < D; n0 += 16) {
      uint32_t b[4];
      ldsm4_t(b, bt_addr<SD>(sb, kk * 16, n0, lane));
      mma16816(c[n0 / 8], a, b[0], b[1]);
      mma16816(c[n0 / 8 + 1], a, b[2], b[3]);
    }
  }
}

// ROWS rows of D bf16 (row stride `stride` elements) into a padded shared
// tile; rows >= valid are zero-filled
template <int ROWS, int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int64_t stride, int valid) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * (D + 8) + c, src + (ok ? r * stride : 0) + c,
               ok ? 16 : 0);
  }
}

// 16 rows x D of a float accumulator -> bf16 rows of a global tensor
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, int64_t stride,
                                           int row0, int nrows,
                                           const float (*c)[4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + r * 8;
    if (row >= nrows) continue;
    bf16* dst = base + (int64_t)row * stride + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack2(c[n][2 * r], c[n][2 * r + 1]);
  }
}

// dynamic shared memory of the mma.sync forward and dQ kernels (bytes)
template <int D>
constexpr int fwd_smem() {
  return (kBQ + 4 * kBK) * (D + 8) * 2;
}

template <int D>
constexpr int dq_smem() {
  return (2 * kBQ + 4 * kBK) * (D + 8) * 2;
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

}  // namespace
