// Mamba-1 selective scan on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan/kernel.py::_kernel
// (launched by ssm_scan_pallas).  For every batch row b, channel d < di and
// state n < N, from h_0 = 0:
//
//   h_t[d,n] = exp(dt_t[d] * A[d,n]) * h_{t-1}[d,n] + (dt_t[d] * u_t[d]) * B_t[n]
//   y_t[d]   = sum_n C_t[n] * h_t[d,n] + D[d] * u_t[d]
//
// and h_last = h_S.  u, dt are (batch, S, di) contiguous; B, C are
// (batch, S, N) with any batch and time stride and unit stride over N (the
// model passes column slices of one projection); A is (di, N) and D (di,),
// both fp32.  u/dt/B/C are fp32 or bf16 (one type), read and upcast; all
// arithmetic is fp32; y (batch, S, di) and h_last (batch, di, N) are fp32.
//
// Bound.  Per (b, t, d, n) one exponential and ~6 fp32 operations; per
// (b, t, d) four input bytes per element of u and dt and one fp32 y.  At the
// model's widths (N = 16) the exponentials at the MUFU rate (16 per clock per
// SM) and the bytes at 3.35 TB/s give bounds of the same size; the y
// reduction over n and the sequential time loop are what the kernel pays on
// top (see PERF.md for the measured share).
//
// Design.  The TPU kernel's grid (B, di/BD, S/chunk), sequential over the
// chunks with a (BD, N) carry in VMEM, becomes: one block per (32-channel
// tile, b); one thread per (channel, state), each holding its h[n] in a
// register for the whole sequence; a loop over time inside the block.  The
// TPU's chunk is the staging depth: kChunk steps of u and dt (kChunk x 32,
// loaded coalesced over d) and of B and C (kChunk x N) go through shared
// memory as fp32.  y_t is a reduction over the G lanes of a channel
// (G = N rounded up to a power of two, G <= 16) with __shfl_xor_sync; lane 0
// stores it into a shared (kChunk x 32) tile that the block writes out
// coalesced over d after each chunk.  A ragged channel tail (di % 32), lanes
// n >= N and a ragged last chunk are masked (A, B, C read as 0 there, so h
// stays 0); nothing is asserted about the shapes.  Offsets are int64.
// The exponential is expf (within 2 ulp over its whole range; one MUFU.EX2
// plus a few FMAs of range reduction), not __expf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCh = 32;       // channels per block
constexpr int kChunk = 64;    // time steps staged per pass
constexpr int kMaxG = 16;     // largest state group (N <= 16)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int G>
__global__ void __launch_bounds__(kCh * G) ssm_scan_kernel(
    const T* __restrict__ u, const T* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ D,
    float* __restrict__ y, float* __restrict__ h_last, int64_t S, int64_t di,
    int N, int64_t b_sb, int64_t b_st, int64_t c_sb, int64_t c_st) {
  __shared__ float s_u[kChunk][kCh];
  __shared__ float s_dt[kChunk][kCh];
  __shared__ float s_y[kChunk][kCh];
  __shared__ float s_B[kChunk][G];
  __shared__ float s_C[kChunk][G];

  constexpr int kThreads = kCh * G;
  const int tid = threadIdx.x;
  const int c = tid / G;
  const int n = tid % G;
  const int64_t b = blockIdx.y;
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * kCh;
  const int64_t d = d0 + c;
  const bool live = d < di && n < N;
  const float a = live ? A[d * N + n] : 0.0f;
  const float dd = d < di ? D[d] : 0.0f;
  const int64_t base = b * S * di;
  const T* Bb = Bm + b * b_sb;
  const T* Cb = Cm + b * c_sb;

  float h = 0.0f;
  for (int64_t t0 = 0; t0 < S; t0 += kChunk) {
    const int steps = S - t0 < kChunk ? static_cast<int>(S - t0) : kChunk;
    // stage u, dt (steps x 32 channels) and B, C (steps x N) as fp32; the
    // previous pass's reads of these tiles ended at its last barrier
    for (int i = tid; i < kChunk * kCh; i += kThreads) {
      const int r = i / kCh, col = i % kCh;
      const bool ok = r < steps && d0 + col < di;
      const int64_t off = base + (t0 + r) * di + d0 + col;
      s_u[r][col] = ok ? to_f32(u[off]) : 0.0f;
      s_dt[r][col] = ok ? to_f32(dt[off]) : 0.0f;
    }
    for (int i = tid; i < kChunk * G; i += kThreads) {
      const int r = i / G, col = i % G;
      const bool ok = r < steps && col < N;
      s_B[r][col] = ok ? to_f32(Bb[(t0 + r) * b_st + col]) : 0.0f;
      s_C[r][col] = ok ? to_f32(Cb[(t0 + r) * c_st + col]) : 0.0f;
    }
    __syncthreads();
    for (int r = 0; r < steps; ++r) {
      const float ut = s_u[r][c];
      const float dtt = s_dt[r][c];
      h = expf(dtt * a) * h + (dtt * ut) * s_B[r][n];
      float p = h * s_C[r][n];
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) {
        p += __shfl_xor_sync(0xffffffffu, p, o, G);
      }
      if (n == 0) s_y[r][c] = p + dd * ut;
    }
    __syncthreads();
    for (int i = tid; i < kChunk * kCh; i += kThreads) {
      const int r = i / kCh, col = i % kCh;
      if (r < steps && d0 + col < di) {
        y[base + (t0 + r) * di + d0 + col] = s_y[r][col];
      }
    }
  }
  if (live) h_last[(b * di + d) * N + n] = h;
}

template <typename T>
int launch(int G, const void* u, const void* dt, const void* A,
           const void* Bm, const void* Cm, const void* D, void* y,
           void* h_last, int64_t batch, int64_t S, int64_t di, int N,
           int64_t b_sb, int64_t b_st, int64_t c_sb, int64_t c_st,
           cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((di + kCh - 1) / kCh),
                  static_cast<unsigned>(batch));
#define SSM_SCAN_LAUNCH(GG)                                                   \
  ssm_scan_kernel<T, GG><<<grid, kCh * GG, 0, s>>>(                          \
      static_cast<const T*>(u), static_cast<const T*>(dt),                   \
      static_cast<const float*>(A), static_cast<const T*>(Bm),               \
      static_cast<const T*>(Cm), static_cast<const float*>(D),               \
      static_cast<float*>(y), static_cast<float*>(h_last), S, di, N, b_sb,   \
      b_st, c_sb, c_st)
  switch (G) {
    case 1: SSM_SCAN_LAUNCH(1); break;
    case 2: SSM_SCAN_LAUNCH(2); break;
    case 4: SSM_SCAN_LAUNCH(4); break;
    case 8: SSM_SCAN_LAUNCH(8); break;
    case 16: SSM_SCAN_LAUNCH(16); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SSM_SCAN_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (u, dt, B and C).  Returns
// cudaGetLastError() after the launch (0 = launched).
int ssm_scan_launch(int dtype, const void* u, const void* dt, const void* A,
                    const void* Bm, const void* Cm, const void* D, void* y,
                    void* h_last, int64_t batch, int64_t S, int64_t di, int N,
                    int64_t b_sb, int64_t b_st, int64_t c_sb, int64_t c_st,
                    void* stream) {
  if (N < 1 || N > kMaxG || batch < 1 || batch > 65535 || di < 1 || S < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int G = 1;
  while (G < N) G *= 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(G, u, dt, A, Bm, Cm, D, y, h_last, batch, S, di, N,
                         b_sb, b_st, c_sb, c_st, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(G, u, dt, A, Bm, Cm, D, y, h_last, batch, S,
                                 di, N, b_sb, b_st, c_sb, c_st, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
