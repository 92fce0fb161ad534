// Flash attention forward on Hopper (sm_90a) for fp32 inputs (bf16 inputs
// run flash_fwd_tc.cu on the tensor cores).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// _kernel (launched by flash_attention_pallas).  For query head h of
// batch b, with kv head h / (H / KV):
//
//   s   = q k^T * scale, NEG = -1e30 where the mask drops (ki > qi, or
//         ki <= qi - window), with no Sk - Sq offset, as on the TPU;
//   o   = softmax(s) v, in fp32;
//   lse = m + log(l) per row, fp32, for the backward.
//
// Design: one block per (q tile of 64 rows, h, b); a loop over the kv
// tiles replaces the TPU grid's sequential fourth axis.  The running max
// m and sum l stay in registers (each of the 16 threads of a row keeps the
// same copy), the 64 x D accumulator in registers spread over the row's
// threads.  The p tile reuses the k tile's shared memory once q k^T is
// done, so that at D = 128 a block takes 97 KB and two fit on an SM.
// Tiles with no unmasked pair are skipped with the TPU kernel's test; a
// row's first visited tile can still be fully masked, where p =
// exp(NEG - NEG) = 1 is garbage that alpha = exp(NEG - m) = 0 erases once
// a real maximum arrives (the finite NEG keeps this free of NaN).  Keys
// past Sk are -inf and weigh nothing.  q tiles are launched last-first so
// that the longest causal rows start first.
//
// Bound: at the configs' widths the kernel is bound by operations: 4 * D
// flops per unmasked (q, k) pair against about 2 * D * (B H Sq + 2 B KV Sk)
// bytes.  In fp32 they run on the CUDA cores (67 TFLOP/s); each thread
// does 16 FMAs per 8 shared-memory loads in q k^T, which caps it well
// below that.

#include "flash_common.cuh"

namespace {

using namespace flash;

// Rows of the shared region that holds the k tile (DP x kPad) and, once
// q k^T is done, the p tile (kTile x kPad).
template <int DP>
__host__ __device__ constexpr int kt_rows() {
  return DP > kTile ? DP : kTile;
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse,
    int H, int KV, int64_t Sq, int64_t Sk, int D, float scale, int causal,
    int64_t window) {
  constexpr int DN = DP / 16;
  extern __shared__ float smem[];
  float* qT = smem;                   // DP x kPad
  float* kT = qT + DP * kPad;         // DP x kPad, then p: kTile x kPad
  float* vs = kT + kt_rows<DP>() * kPad;  // kTile x DP
  float* ps = kT;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kTile;
  const int64_t bh = static_cast<int64_t>(blockIdx.z) * H + blockIdx.y;
  const int64_t bkv = static_cast<int64_t>(blockIdx.z) * KV
      + blockIdx.y / (H / KV);
  const float* kb = k + bkv * Sk * D;
  const float* vb = v + bkv * Sk * D;
  const int64_t q_last = (q0 + kTile < Sq ? q0 + kTile : Sq) - 1;

  load_t<DP>(qT, q + bh * Sq * D, q0, Sq, D);
  float m[kRows], l[kRows], acc[kRows][DN];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int n = 0; n < DN; ++n) acc[i][n] = 0.0f;
  }

  for (int64_t k0 = 0; k0 < Sk; k0 += kTile) {
    const int64_t k_last = (k0 + kTile < Sk ? k0 + kTile : Sk) - 1;
    if (!tile_live(q0, q_last, k0, k_last, causal, window)) continue;
    __syncthreads();                  // the last tile's readers are done
    load_t<DP>(kT, kb, k0, Sk, D);
    load_rows<DP>(vs, vb, k0, Sk, D);
    __syncthreads();

    float s[kRows][kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) s[i][j] = 0.0f;
    }
    mma_t<DP>(s, qT, kT, ty, tx);

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int64_t qi = q0 + ty * kRows + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int64_t ki = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (ki >= Sk) {
          x = -INFINITY;
        } else if (!keep(qi, ki, causal, window)) {
          x = kNeg;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = alpha * l[i] + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < DN; ++n) acc[i][n] *= alpha;
    }
    __syncthreads();                  // every read of kT is done: p over it
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        ps[(ty * kRows + i) * kPad + tx + 16 * j] = s[i][j];
      }
    }
    __syncthreads();
    mma_p<DN, DP, 1>(acc, ps, vs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t qi = q0 + ty * kRows + i;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = o + (bh * Sq + qi) * D;
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      const int d = tx + 16 * n;
      if (d < D) orow[d] = acc[i][n] / den;
    }
    if (tx == 0) lse[bh * Sq + qi] = m[i] + logf(l[i]);
  }
}

template <int DP>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int H, int KV, int64_t Sq, int64_t Sk,
               int D, float scale, int causal, int64_t window, void* stream) {
  const size_t smem = ((DP + kt_rows<DP>()) * kPad + kTile * DP)
      * sizeof(float);
  const dim3 grid(static_cast<unsigned>((Sq + kTile - 1) / kTile),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  return launch(flash_fwd_kernel<DP>, grid, smem, stream,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<float*>(o),
                static_cast<float*>(lse), H, KV, Sq, Sk, D, scale, causal,
                window);
}

}  // namespace

extern "C" {

// q (B,H,Sq,D), k/v (B,KV,Sk,D), o (B,H,Sq,D), lse (B,H,Sq), all float32
// and contiguous.  window <= 0: none.  Returns the CUDA error of the
// launch (0 = launched).
int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                     void* lse, int B, int H, int KV, int64_t Sq, int64_t Sk,
                     int D, float scale, int causal, int64_t window,
                     void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || KV < 1 || H % KV != 0
      || Sq < 1 || Sk < 1 || D < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (padded_head_dim(D)) {
    case 32:
      return launch_fwd<32>(q, k, v, o, lse, B, H, KV, Sq, Sk, D, scale,
                            causal, window, stream);
    case 64:
      return launch_fwd<64>(q, k, v, o, lse, B, H, KV, Sq, Sk, D, scale,
                            causal, window, stream);
    case 128:
      return launch_fwd<128>(q, k, v, o, lse, B, H, KV, Sq, Sk, D, scale,
                             causal, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
