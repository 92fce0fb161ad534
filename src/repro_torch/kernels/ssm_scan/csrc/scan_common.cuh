// Helpers shared by the selective scan's forward (ssm_scan.cu) and
// backward (ssm_scan_bwd.cu): fp32 reads of fp32 or bf16 values, the
// exponential as one ex2, cp.async staging of 2-D tiles into shared
// memory (at a runtime copy width, or one fixed at compile time), and the
// copy width a tile's pointers and strides allow.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace scan {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// four consecutive values from shared memory (16- or 8-byte aligned)
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
  }
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// Stage `rows` rows of W elements (the first `valid` of them real, the rest
// zero) from g (row stride `stride` elements) into s (row stride W).  vec is
// the copy width in bytes (16, 8 or 4, dividing valid * sizeof(T) and every
// row's address) or 0 for element loads.
template <typename T, int W>
__device__ __forceinline__ void stage(T* s, const T* g, int64_t stride,
                                      int rows, int valid, int vec, int tid,
                                      int nthreads) {
  if (vec == 0) {
    for (int i = tid; i < rows * W; i += nthreads) {
      const int r = i / W, col = i % W;
      s[r * W + col] = col < valid ? g[r * stride + col] : zero_of<T>();
    }
    return;
  }
  const int per = vec / static_cast<int>(sizeof(T));
  const int pieces = W / per;
  for (int i = tid; i < rows * pieces; i += nthreads) {
    const int r = i / pieces, col = (i % pieces) * per;
    T* dst = s + r * W + col;
    if (col < valid) {
      cp_async(dst, g + r * stride + col, vec);
    } else {
      for (int k = 0; k < per; ++k) dst[k] = zero_of<T>();
    }
  }
}

// stage() with the copy width V (16, 8 or 4 bytes) fixed at compile time,
// so that an item's row and column are a shift and a mask where stage()
// divides by a runtime count (the backward's staging: a fifth of its time;
// the forward keeps stage(), whose bf16 instantiation spilled with this)
template <typename T, int W, int V>
__device__ __forceinline__ void stage_v(T* s, const T* g, int64_t stride,
                                        int rows, int valid, int tid,
                                        int nthreads) {
  constexpr int per = V / static_cast<int>(sizeof(T));
  constexpr int pieces = W / per;
  for (int i = tid; i < rows * pieces; i += nthreads) {
    const int r = i / pieces, col = (i % pieces) * per;
    T* dst = s + r * W + col;
    if (col < valid) {
      cp_async(dst, g + r * stride + col, V);
    } else {
#pragma unroll
      for (int k = 0; k < per; ++k) dst[k] = zero_of<T>();
    }
  }
}

// stage() dispatched once on the copy width to stage_v
template <typename T, int W>
__device__ __forceinline__ void stage_fixed(T* s, const T* g, int64_t stride,
                                            int rows, int valid, int vec,
                                            int tid, int nthreads) {
  if (vec == 16) {
    stage_v<T, W, 16>(s, g, stride, rows, valid, tid, nthreads);
  } else if (vec == 8) {
    stage_v<T, W, 8>(s, g, stride, rows, valid, tid, nthreads);
  } else if (vec == 4) {
    stage_v<T, W, 4>(s, g, stride, rows, valid, tid, nthreads);
  } else {
    stage<T, W>(s, g, stride, rows, valid, 0, tid, nthreads);
  }
}

// The widest cp.async copy (16, 8 or 4 bytes) that divides the base
// address, every stride and the row's valid bytes; 0 when none does.
inline int copy_width(const void* base, int64_t row_bytes, int64_t s1,
                      int64_t s2) {
  const int64_t addr = static_cast<int64_t>(reinterpret_cast<uintptr_t>(base));
  for (int v = 16; v >= 4; v /= 2) {
    if (addr % v == 0 && row_bytes % v == 0 && s1 % v == 0 && s2 % v == 0) {
      return v;
    }
  }
  return 0;
}

}  // namespace scan
