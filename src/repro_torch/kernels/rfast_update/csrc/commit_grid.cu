// Fused R-FAST wave commit on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rfast_update/grid.py::_grid_kernel
// (launched by commit_grid through _build_launch).  For every lane b of a
// wave and every parameter element j:
//
//   recv    = sum_k mask[b,k] * (ri[b,k] - rb[b,k])
//   z_half  = z[b] + recv + g_new[b] - g_old[b]
//   z'      = a_self[b] * z_half
//   rho_out'[k] = ro[b,k] + a_out[b,k] * z_half
//   rho_buf'[k] = mask[b,k] * ri[b,k] + (1 - mask[b,k]) * rb[b,k]
//
// where the z, g_old, ri, rb, ro rows are gathered from flat (rows, Pf)
// source arrays through five int32 row tables, each clamped into its
// source's row range (grid.py clamps the same way, so drop-sentinel lanes
// read a valid row that the caller's commit then discards).  Sources may
// alias each other (the engine passes the packed node and rho arrays twice);
// outputs are fresh arrays.  Arithmetic is fp32 whatever the source type.
//
// Bound: device-memory bandwidth.  Per lane the kernel reads 3 + 2*ka + ko
// rows of Pf elements and writes 1 + ka + ko rows, i.e. moves
// B * (4 + 3*ka + 2*ko) * Pf * sizeof(T) bytes and does ~(4*ka + 2*ko + 4)
// flops per element -- far below the H100's 295 flop/byte ridge.
//
// Design: grid = (ceil(Pf / TILE), B).  A block loads its lane's clamped row
// offsets (as 64-bit element offsets: at full width row * Pf exceeds 2^31)
// and per-lane floats into shared memory once, then streams its TILE of the
// parameter axis with neighbouring threads on neighbouring elements, every
// input element read once and every output element written once.  The
// ragged tail is masked here, so any Pf is accepted (the TPU's
// Pf % 32768 rule was a VMEM tiling artefact).  Loads are scalar; 16-byte
// vector loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;        // elements of one lane per block
constexpr int kMaxK = 16;          // largest ka / ko the wrapper accepts

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

__device__ __forceinline__ int64_t clamp_row(int r, int64_t rows) {
  int64_t v = r;
  v = v < 0 ? 0 : v;
  return v > rows - 1 ? rows - 1 : v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) commit_grid_kernel(
    const int* __restrict__ idx_z, const int* __restrict__ idx_g,
    const int* __restrict__ idx_ri, const int* __restrict__ idx_rb,
    const int* __restrict__ idx_ro, const float* __restrict__ a_self,
    const float* __restrict__ mask, const float* __restrict__ a_out,
    const T* __restrict__ z_src, const T* __restrict__ g_new,
    const T* __restrict__ go_src, const T* __restrict__ ri_src,
    const T* __restrict__ rb_src, const T* __restrict__ ro_src,
    T* __restrict__ z_out, T* __restrict__ ro_out, T* __restrict__ rb_out,
    int64_t Pf, int ka, int ko, int64_t rows_z, int64_t rows_g,
    int64_t rows_ri, int64_t rows_rb, int64_t rows_ro) {
  __shared__ int64_t s_ri[kMaxK], s_rb[kMaxK], s_ro[kMaxK];
  __shared__ float s_m[kMaxK], s_ao[kMaxK];
  __shared__ int64_t s_z, s_g;
  __shared__ float s_as;

  const int b = blockIdx.y;
  const int t = threadIdx.x;
  if (t == 0) {
    s_z = clamp_row(idx_z[b], rows_z) * Pf;
    s_g = clamp_row(idx_g[b], rows_g) * Pf;
    s_as = a_self[b];
  }
  if (t < ka) {
    s_ri[t] = clamp_row(idx_ri[b * ka + t], rows_ri) * Pf;
    s_rb[t] = clamp_row(idx_rb[b * ka + t], rows_rb) * Pf;
    s_m[t] = mask[b * ka + t];
  }
  if (t < ko) {
    s_ro[t] = clamp_row(idx_ro[b * ko + t], rows_ro) * Pf;
    s_ao[t] = a_out[b * ko + t];
  }
  __syncthreads();

  const int64_t lane = static_cast<int64_t>(b) * Pf;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t stop = start + kTile < Pf ? start + kTile : Pf;
  for (int64_t j = start + t; j < stop; j += kThreads) {
    float recv = 0.0f;
    for (int k = 0; k < ka; ++k) {
      const float ri = to_f32(ri_src[s_ri[k] + j]);
      const float rb = to_f32(rb_src[s_rb[k] + j]);
      const float m = s_m[k];
      recv += m * (ri - rb);
      rb_out[(lane * ka) + static_cast<int64_t>(k) * Pf + j] =
          from_f32<T>(m * ri + (1.0f - m) * rb);
    }
    const float z_half = to_f32(z_src[s_z + j]) + recv
        + to_f32(g_new[lane + j]) - to_f32(go_src[s_g + j]);
    z_out[lane + j] = from_f32<T>(s_as * z_half);
    for (int k = 0; k < ko; ++k) {
      ro_out[(lane * ko) + static_cast<int64_t>(k) * Pf + j] =
          from_f32<T>(to_f32(ro_src[s_ro[k] + j]) + s_ao[k] * z_half);
    }
  }
}

}  // namespace

extern "C" {

int commit_grid_max_k() { return kMaxK; }

// dtype: 0 = float32, 1 = bfloat16 (every source and output).  Returns
// cudaGetLastError() after the launch (0 = launched).
int commit_grid_launch(int dtype, const void* idx_z, const void* idx_g,
                       const void* idx_ri, const void* idx_rb,
                       const void* idx_ro, const void* a_self,
                       const void* mask, const void* a_out,
                       const void* z_src, const void* g_new,
                       const void* go_src, const void* ri_src,
                       const void* rb_src, const void* ro_src, void* z_out,
                       void* ro_out, void* rb_out, int64_t Pf, int B, int ka,
                       int ko, int64_t rows_z, int64_t rows_g, int64_t rows_ri,
                       int64_t rows_rb, int64_t rows_ro, void* stream) {
  if (ka > kMaxK || ko > kMaxK || ka < 0 || ko < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((Pf + kTile - 1) / kTile),
                  static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define COMMIT_GRID_ARGS(T)                                                  \
  static_cast<const int*>(idx_z), static_cast<const int*>(idx_g),            \
      static_cast<const int*>(idx_ri), static_cast<const int*>(idx_rb),      \
      static_cast<const int*>(idx_ro), static_cast<const float*>(a_self),    \
      static_cast<const float*>(mask), static_cast<const float*>(a_out),     \
      static_cast<const T*>(z_src), static_cast<const T*>(g_new),            \
      static_cast<const T*>(go_src), static_cast<const T*>(ri_src),          \
      static_cast<const T*>(rb_src), static_cast<const T*>(ro_src),          \
      static_cast<T*>(z_out), static_cast<T*>(ro_out),                       \
      static_cast<T*>(rb_out), Pf, ka, ko, rows_z, rows_g, rows_ri, rows_rb, \
      rows_ro
  if (dtype == 0) {
    commit_grid_kernel<float><<<grid, kThreads, 0, s>>>(
        COMMIT_GRID_ARGS(float));
  } else if (dtype == 1) {
    commit_grid_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        COMMIT_GRID_ARGS(__nv_bfloat16));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef COMMIT_GRID_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
