// Per-node R-FAST update and commit on Hopper (sm_90a).
//
// Replaces two TPU kernels of src/repro/kernels/rfast_update/kernel.py:
//
//   rfast_update_node  <- rfast_update_pallas (body _kernel), the full
//                         fused update with five outputs;
//   rfast_commit_node  <- rfast_commit_pallas (body _commit_kernel), its
//                         commit-only tail (the oracle route of the
//                         protocol round and of ops.rfast_commit).
//
// For one node and every parameter element j (K-stacks are (K, P) rows):
//
//   v        = x - gamma * z                              (full only)
//   x'       = w_self * v + sum_k w_in[k] * v_in[k]       (full only)
//   recv     = sum_k mask[k] * (rho_in[k] - rho_buf[k])
//   z_half   = z + recv + g_new - g_old
//   z'       = a_self * z_half
//   rho_out'[k] = rho_out[k] + a_out[k] * z_half
//   rho_buf'[k] = mask[k] * rho_in[k] + (1 - mask[k]) * rho_buf[k]
//
// Every source and output has one dtype (float32 or bfloat16); the
// arithmetic is fp32.  The per-slot weights (w_in, mask, a_out) and the
// scalars ([gamma, w_self, a_self] or [a_self]) are device pointers, so a
// mask computed on the device needs no host round trip.
//
// Bound: device-memory bandwidth.  The full update reads 4 + Kw + 2*Ka + Ko
// rows of P elements and writes 3 + Ka + Ko; the commit reads 3 + 2*Ka + Ko
// and writes 1 + Ka + Ko.  That is (7 + Kw + 3*Ka + 2*Ko) and
// (4 + 3*Ka + 2*Ko) rows, against about 2*(Kw + 2*Ka + Ko) + 8 flops per
// element: far below the H100's 295 flop/byte ridge.
//
// Design: a grid over P only, ceil(P / kTile) blocks of kThreads threads;
// each block stages the slot weights in shared memory once and streams its
// tile with neighbouring threads on neighbouring elements, every input
// element read once and every output element written once.  Row offsets
// are 64-bit (k * P exceeds 2^31 at full width with a few slots).  The
// ragged tail is masked, so any P is accepted (the TPU's (R, 128) blocking
// with R % 256 == 0 was a VMEM layout rule).  Loads are scalar; 16-byte
// vector loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;        // elements of P per block
constexpr int kMaxK = 8;           // largest Kw / Ka / Ko the wrapper accepts

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

// kFull: the full update (x', v, z', rho_out', rho_buf'); otherwise the
// commit tail only (z', rho_out', rho_buf'), where x, v_in, w_in, x_out and
// v_out are unused and may be null.
template <typename T, bool kFull>
__global__ void __launch_bounds__(kThreads) rfast_node_kernel(
    const T* __restrict__ x, const T* __restrict__ z,
    const T* __restrict__ g_new, const T* __restrict__ g_old,
    const T* __restrict__ v_in, const T* __restrict__ rho_in,
    const T* __restrict__ rho_buf, const T* __restrict__ rho_out,
    const float* __restrict__ w_in, const float* __restrict__ mask,
    const float* __restrict__ a_out, const float* __restrict__ scal,
    T* __restrict__ x_out, T* __restrict__ v_out, T* __restrict__ z_out,
    T* __restrict__ ro_out, T* __restrict__ rb_out, int64_t P, int kw,
    int ka, int ko) {
  __shared__ float s_w[kMaxK], s_m[kMaxK], s_ao[kMaxK];
  __shared__ float s_gamma, s_wself, s_aself;

  const int t = threadIdx.x;
  if (kFull && t < kw) s_w[t] = w_in[t];
  if (t < ka) s_m[t] = mask[t];
  if (t < ko) s_ao[t] = a_out[t];
  if (t == 0) {
    if (kFull) {
      s_gamma = scal[0];
      s_wself = scal[1];
      s_aself = scal[2];
    } else {
      s_aself = scal[0];
    }
  }
  __syncthreads();

  const int64_t start = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t stop = start + kTile < P ? start + kTile : P;
  for (int64_t j = start + t; j < stop; j += kThreads) {
    const float zf = to_f32(z[j]);
    if (kFull) {
      const float v = to_f32(x[j]) - s_gamma * zf;
      float xn = s_wself * v;
      for (int k = 0; k < kw; ++k) {
        xn += s_w[k] * to_f32(v_in[static_cast<int64_t>(k) * P + j]);
      }
      x_out[j] = from_f32<T>(xn);
      v_out[j] = from_f32<T>(v);
    }
    float recv = 0.0f;
    for (int k = 0; k < ka; ++k) {
      const int64_t o = static_cast<int64_t>(k) * P + j;
      const float ri = to_f32(rho_in[o]);
      const float rb = to_f32(rho_buf[o]);
      const float m = s_m[k];
      recv += m * (ri - rb);
      rb_out[o] = from_f32<T>(m * ri + (1.0f - m) * rb);
    }
    const float z_half = zf + recv + to_f32(g_new[j]) - to_f32(g_old[j]);
    z_out[j] = from_f32<T>(s_aself * z_half);
    for (int k = 0; k < ko; ++k) {
      const int64_t o = static_cast<int64_t>(k) * P + j;
      ro_out[o] = from_f32<T>(to_f32(rho_out[o]) + s_ao[k] * z_half);
    }
  }
}

template <bool kFull>
int launch(int dtype, const void* x, const void* z, const void* g_new,
           const void* g_old, const void* v_in, const void* rho_in,
           const void* rho_buf, const void* rho_out, const void* w_in,
           const void* mask, const void* a_out, const void* scal, void* x_out,
           void* v_out, void* z_out, void* ro_out, void* rb_out, int64_t P,
           int kw, int ka, int ko, void* stream) {
  if (ka < 0 || ko < 0 || kw < 0 || ka > kMaxK || ko > kMaxK || kw > kMaxK ||
      P < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (P == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>((P + kTile - 1) / kTile));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RFAST_NODE_ARGS(T)                                                   \
  static_cast<const T*>(x), static_cast<const T*>(z),                        \
      static_cast<const T*>(g_new), static_cast<const T*>(g_old),            \
      static_cast<const T*>(v_in), static_cast<const T*>(rho_in),            \
      static_cast<const T*>(rho_buf), static_cast<const T*>(rho_out),        \
      static_cast<const float*>(w_in), static_cast<const float*>(mask),      \
      static_cast<const float*>(a_out), static_cast<const float*>(scal),     \
      static_cast<T*>(x_out), static_cast<T*>(v_out), static_cast<T*>(z_out), \
      static_cast<T*>(ro_out), static_cast<T*>(rb_out), P, kw, ka, ko
  if (dtype == 0) {
    rfast_node_kernel<float, kFull><<<grid, kThreads, 0, s>>>(
        RFAST_NODE_ARGS(float));
  } else if (dtype == 1) {
    rfast_node_kernel<__nv_bfloat16, kFull><<<grid, kThreads, 0, s>>>(
        RFAST_NODE_ARGS(__nv_bfloat16));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RFAST_NODE_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int rfast_node_max_k() { return kMaxK; }

// dtype: 0 = float32, 1 = bfloat16 (every source and output).  scal points
// at 3 floats [gamma, w_self, a_self].  Returns cudaGetLastError() after
// the launch (0 = launched).
int rfast_update_node_launch(int dtype, const void* x, const void* z,
                             const void* g_new, const void* g_old,
                             const void* v_in, const void* rho_in,
                             const void* rho_buf, const void* rho_out,
                             const void* w_in, const void* mask,
                             const void* a_out, const void* scal, void* x_out,
                             void* v_out, void* z_out, void* ro_out,
                             void* rb_out, int64_t P, int kw, int ka, int ko,
                             void* stream) {
  return launch<true>(dtype, x, z, g_new, g_old, v_in, rho_in, rho_buf,
                      rho_out, w_in, mask, a_out, scal, x_out, v_out, z_out,
                      ro_out, rb_out, P, kw, ka, ko, stream);
}

// The commit tail: scal points at 1 float [a_self].
int rfast_commit_node_launch(int dtype, const void* z, const void* g_new,
                             const void* g_old, const void* rho_in,
                             const void* rho_buf, const void* rho_out,
                             const void* mask, const void* a_out,
                             const void* scal, void* z_out, void* ro_out,
                             void* rb_out, int64_t P, int ka, int ko,
                             void* stream) {
  return launch<false>(dtype, nullptr, z, g_new, g_old, nullptr, rho_in,
                       rho_buf, rho_out, nullptr, mask, a_out, scal, nullptr,
                       nullptr, z_out, ro_out, rb_out, P, 0, ka, ko, stream);
}

}  // extern "C"
