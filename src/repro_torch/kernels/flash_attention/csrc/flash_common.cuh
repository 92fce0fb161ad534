// Shared pieces of the flash attention kernels: the TPU kernels' mask
// (kNeg, keep, tile_live), cp.async copies into shared memory, and the
// 3xTF32 arithmetic of the fp32 kernels (flash_fwd_3xtf32.cu,
// flash_bwd_3xtf32.cu); bf16 inputs go to flash_fwd_tc.cu and
// flash_bwd_tc.cu.
//
// 3xTF32: one TF32 tensor-core product keeps 10 mantissa bits of each
// operand, about three decimal digits, too few for the port's fp32
// tolerance (2e-5 forward, 2e-4 gradients).  Each fp32 operand is split
// as x = hi + lo, hi = x rounded to TF32 (to nearest, ties away from
// zero, as cvt.rna does) and lo = x - hi (exact in fp32; the tensor core
// reads its top 19 bits), and a b is taken as lo_a hi_b + hi_a lo_b +
// hi_a hi_b with fp32 accumulation: the dropped lo_a lo_b and the
// truncation of lo leave an error near 2^-21 of each product, close to
// fp32's own.  It is CUTLASS's OpMultiplyAddFastF32, at a third of the
// TF32 tensor-core rate (495 / 3 = 165 TFLOP/s on an H100 SXM, 2.5 times
// the CUDA cores' 67).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int kMaxHeadDim = 128;
constexpr float kNeg = -1e30f;      // the TPU kernels' finite mask value

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

// --- cp.async ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared dst, or 16 zero bytes when !valid.
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src,
                                    bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ROWS rows from row r0 of an fp32 (S, D) slab into a shared tile of DP
// columns and row stride ST floats, by `threads` threads; zero past row
// S and column D.  D % 4 == 0 and the slab 16-byte aligned.
template <int ROWS, int DP, int ST>
__device__ __forceinline__ void load_rows_f32(float* dst,
                                              const float* __restrict__ src,
                                              int64_t r0, int64_t S, int D,
                                              int threads) {
  constexpr int kChunks = DP / 4;
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += threads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const bool valid = r0 + r < S && c * 4 < D;
    cp16(smem_u32(dst + r * ST + c * 4),
         valid ? src + (r0 + r) * D + c * 4 : src, valid);
  }
}

// --- 3xTF32 ------------------------------------------------------------

// x = hi + lo: hi is x rounded to TF32 (add half a TF32 ulp to the
// magnitude's bits, clear the 13 bits TF32 drops), lo the exact rest.
struct Split {
  uint32_t hi, lo;
};
__device__ __forceinline__ Split split(float x) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  return {h, __float_as_uint(x - __uint_as_float(h))};
}

// d (16 x 8) += a (16 x 8, row) * b (8 x 8, col), TF32 in, fp32 out.
// Fragments (g = lane / 4, t = lane % 4): a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k t, n g), b1 (k t + 4, n g);
// d0, d1 (g, 2t and 2t + 1), d2, d3 (g + 8, 2t and 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// An A fragment split once, reused across the n-tiles of a k-step.
struct FragA {
  Split x[4];
};
__device__ __forceinline__ FragA split_a(float a0, float a1, float a2,
                                         float a3) {
  return {{split(a0), split(a1), split(a2), split(a3)}};
}

// d += a b in 3xTF32: the two small terms first, then hi hi.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     float b0, float b1) {
  const Split x = split(b0), y = split(b1);
  mma_tf32(d, a.x[0].lo, a.x[1].lo, a.x[2].lo, a.x[3].lo, x.hi, y.hi);
  mma_tf32(d, a.x[0].hi, a.x[1].hi, a.x[2].hi, a.x[3].hi, x.lo, y.lo);
  mma_tf32(d, a.x[0].hi, a.x[1].hi, a.x[2].hi, a.x[3].hi, x.hi, y.hi);
}

// The padded head dimension an fp32 kernel is instantiated for (0: too
// wide).
inline int padded_head_dim(int D) {
  return D <= 32 ? 32 : D <= 64 ? 64 : D <= kMaxHeadDim ? 128 : 0;
}

// Sets the kernel's dynamic shared memory and launches it; returns the
// CUDA error code (0 = launched).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, void* stream,
           Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash
