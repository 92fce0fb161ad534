// Peak rate of the warp-level tensor-core instruction mma.sync on one
// card, for the two shapes the flash kernels use: m16n8k8 TF32 (the
// fp32 kernels' 3xTF32 products) and m16n8k16 bf16 (flash_bwd_tc.cu).
// Each warp issues `iters` rounds of 8 independent products on operands
// held in registers, so nothing but the tensor pipe bounds it.  Built
// and run by tools/mma_rate.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <bool kTf32>
__global__ void mma_loop(float* out, int iters) {
  float d[8][4] = {};
  // small finite operands in either format
  const uint32_t x = kTf32 ? __float_as_uint(1e-3f * (threadIdx.x % 7))
                           : 0x3c003c00u * (threadIdx.x % 2);
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (kTf32) {
        mma_tf32(d[n], x, x, x, x, x, x);
      } else {
        mma_bf16(d[n], x, x, x, x, x, x);
      }
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int n = 0; n < 8; ++n) s += d[n][0] + d[n][1] + d[n][2] + d[n][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" {

// kind 0: TF32 m16n8k8, 1: bf16 m16n8k16.  out holds blocks * threads
// floats.  Returns the CUDA error of the launch (0 = launched).
int mma_rate_launch(int kind, float* out, int blocks, int threads,
                    int iters, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    mma_loop<true><<<blocks, threads, 0, s>>>(out, iters);
  } else {
    mma_loop<false><<<blocks, threads, 0, s>>>(out, iters);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
