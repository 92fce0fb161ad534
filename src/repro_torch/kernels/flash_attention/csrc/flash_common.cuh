// Shared pieces of the flash attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Every kernel works on 64 x 64 (q rows x kv rows) tiles of one (batch,
// head) slab with 256 threads arranged 16 x 16: thread (ty, tx) owns tile
// rows ty*4 .. ty*4+3 and tile columns tx, tx+16, tx+32, tx+48, and output
// columns tx + 16*n of the head dimension.  Operand tiles live in shared
// memory in fp32, transposed (d-major) with a row length of 65 so that
// both the transposing stores and the per-d reads are free of bank
// conflicts.  Arithmetic is fp32 FMAs on the CUDA cores: the port's
// tolerance (2e-5 in fp32) rules out TF32 tensor cores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int kThreads = 256;       // 16 x 16
constexpr int kTile = 64;           // q rows and kv rows of one tile
constexpr int kPad = kTile + 1;     // row length of a transposed tile
constexpr int kRows = kTile / 16;   // tile rows (and columns) per thread
constexpr int kMaxHeadDim = 128;
constexpr float kNeg = -1e30f;      // the TPU kernels' finite mask value

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

// The TPU kernels' mask: causal without an Sk - Sq offset, and a sliding
// window when window > 0.
__device__ __forceinline__ bool keep(int64_t qi, int64_t ki, int causal,
                                     int64_t window) {
  if (!causal) return true;
  return ki <= qi && (window <= 0 || ki > qi - window);
}

// Whether the tile [q0, q_last] x [k0, k_last] holds an unmasked pair
// (kernel.py:67-74, backward.py:77-81 and :121-126).
__device__ __forceinline__ bool tile_live(int64_t q0, int64_t q_last,
                                          int64_t k0, int64_t k_last,
                                          int causal, int64_t window) {
  if (!causal) return true;
  return k0 <= q_last && (window <= 0 || k_last > q0 - window);
}

// dst[d * kPad + r] = src[(r0 + r) * D + d] for r < kTile, d < DP; zero
// past row S or column D.  src is one (S, D) slab.
template <int DP, typename T>
__device__ __forceinline__ void load_t(float* __restrict__ dst,
                                       const T* __restrict__ src, int64_t r0,
                                       int64_t S, int D) {
  for (int idx = threadIdx.x; idx < kTile * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP;
    float x = 0.0f;
    if (r0 + r < S && d < D) x = to_f32(src[(r0 + r) * D + d]);
    dst[d * kPad + r] = x;
  }
}

// dst[r * DP + d] = src[(r0 + r) * D + d], zero-padded as load_t.
template <int DP, typename T>
__device__ __forceinline__ void load_rows(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          int64_t r0, int64_t S, int D) {
  for (int idx = threadIdx.x; idx < kTile * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP;
    float x = 0.0f;
    if (r0 + r < S && d < D) x = to_f32(src[(r0 + r) * D + d]);
    dst[r * DP + d] = x;
  }
}

// A row load of kTile floats (lse, delta) into shared memory, 0 past S.
__device__ __forceinline__ void load_vec(float* __restrict__ dst,
                                         const float* __restrict__ src,
                                         int64_t r0, int64_t S) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    dst[r] = r0 + r < S ? src[r0 + r] : 0.0f;
  }
}

// acc[i][j] += sum_d a[d][ty*4 + i] * b[d][tx + 16 j] over two transposed
// tiles: one 64 x 64 tile product, 16 entries per thread.
template <int DP>
__device__ __forceinline__ void mma_t(float (&acc)[kRows][kRows],
                                      const float* __restrict__ a,
                                      const float* __restrict__ b, int ty,
                                      int tx) {
#pragma unroll 4
  for (int d = 0; d < DP; ++d) {
    float av[kRows], bv[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) av[i] = a[d * kPad + ty * kRows + i];
#pragma unroll
    for (int j = 0; j < kRows; ++j) bv[j] = b[d * kPad + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// acc[i][n] += sum_c p[ty*4 + i][c] * m(c, tx + 16 n), where p is a
// kTile x kPad row-major tile and m(c, d) = m[c * SC + d * SD].
template <int DN, int SC, int SD>
__device__ __forceinline__ void mma_p(float (&acc)[kRows][DN],
                                      const float* __restrict__ p,
                                      const float* __restrict__ m, int ty,
                                      int tx) {
#pragma unroll 4
  for (int c = 0; c < kTile; ++c) {
    float pv[kRows], mv[DN];
#pragma unroll
    for (int i = 0; i < kRows; ++i) pv[i] = p[(ty * kRows + i) * kPad + c];
#pragma unroll
    for (int n = 0; n < DN; ++n) mv[n] = m[c * SC + (tx + 16 * n) * SD];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int n = 0; n < DN; ++n) acc[i][n] = fmaf(pv[i], mv[n], acc[i][n]);
    }
  }
}

// Reductions over the 16 threads (tx = 0..15) that share a tile row; they
// are the 16 consecutive lanes of one half-warp.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// The padded head dimension a kernel is instantiated for (0: too wide).
inline int padded_head_dim(int D) {
  return D <= 32 ? 32 : D <= 64 ? 64 : D <= kMaxHeadDim ? 128 : 0;
}

// Sets the kernel's dynamic shared memory and launches it; returns the
// CUDA error code (0 = launched).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, void* stream,
           Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash
