// Flash attention backward on Hopper (sm_90a) for fp32 inputs: the dq
// kernel and the dk/dv kernel (bf16 inputs run flash_bwd_tc.cu, one fused
// tensor-core kernel).
//
// Replace the TPU kernels src/repro/kernels/flash_attention/backward.py::
// _dq_kernel (launched by _run_dq) and ::_dkv_kernel (launched by
// _run_dkv).  From the forward's saved fp32 row statistic lse and
// delta = rowsum(dO * O), for one (batch, head) with k/v already repeated
// to the query heads by the caller:
//
//   p   = exp(q k^T * scale - lse)        (0 where the mask drops)
//   dp  = dO v^T
//   ds  = p * (dp - delta) * scale
//   dq  = ds k           dk = ds^T q           dv = p^T dO
//
// Design: each output is accumulated by exactly one block, so no atomics
// and no second pass: the dq kernel runs one block per (q tile, h, b) and
// loops over kv tiles; the dk/dv kernel one block per (kv tile, h, b) and
// loops over q tiles.  Both recompute p from lse with the forward's mask
// and skip the tiles that hold no unmasked pair, with the TPU kernels'
// test.  Heavy causal blocks are launched first.  Outputs are fp32.
//
// Bound: operations.  Per unmasked pair the dq kernel does three products
// (q k^T, dO v^T, ds k: 6 D flops) and the dk/dv kernel four (q k^T,
// dO v^T, p^T dO, ds^T q: 8 D flops) on the CUDA cores in fp32; the
// minimum for the whole backward is five products (10 D flops), since
// q k^T and dO v^T are recomputed by both (flash_bwd_tc.cu does five).

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int H, int64_t Sq, int64_t Sk, int D,
    float scale, int causal, int64_t window) {
  constexpr int DN = DP / 16;
  extern __shared__ float smem[];
  float* qT = smem;                   // DP x kPad each
  float* doT = qT + DP * kPad;
  float* kT = doT + DP * kPad;
  float* vT = kT + DP * kPad;
  float* ds_s = vT + DP * kPad;       // kTile x kPad
  float* lse_s = ds_s + kTile * kPad; // kTile
  float* dl_s = lse_s + kTile;        // kTile

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kTile;
  const int64_t bh = static_cast<int64_t>(blockIdx.z) * H + blockIdx.y;
  const float* kb = k + bh * Sk * D;
  const float* vb = v + bh * Sk * D;
  const int64_t q_last = (q0 + kTile < Sq ? q0 + kTile : Sq) - 1;

  load_t<DP>(qT, q + bh * Sq * D, q0, Sq, D);
  load_t<DP>(doT, dO + bh * Sq * D, q0, Sq, D);
  load_vec(lse_s, lse + bh * Sq, q0, Sq);
  load_vec(dl_s, delta + bh * Sq, q0, Sq);
  float acc[kRows][DN];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int n = 0; n < DN; ++n) acc[i][n] = 0.0f;
  }

  for (int64_t k0 = 0; k0 < Sk; k0 += kTile) {
    const int64_t k_last = (k0 + kTile < Sk ? k0 + kTile : Sk) - 1;
    if (!tile_live(q0, q_last, k0, k_last, causal, window)) continue;
    __syncthreads();
    load_t<DP>(kT, kb, k0, Sk, D);
    load_t<DP>(vT, vb, k0, Sk, D);
    __syncthreads();

    float s[kRows][kRows], dp[kRows][kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) s[i][j] = dp[i][j] = 0.0f;
    }
    mma_t<DP>(s, qT, kT, ty, tx);
    mma_t<DP>(dp, doT, vT, ty, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const int64_t qi = q0 + r;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int64_t ki = k0 + tx + 16 * j;
        float p = 0.0f;
        if (qi < Sq && ki < Sk && keep(qi, ki, causal, window)) {
          p = expf(s[i][j] * scale - lse_s[r]);
        }
        ds_s[r * kPad + tx + 16 * j] = p * (dp[i][j] - dl_s[r]) * scale;
      }
    }
    __syncthreads();
    mma_p<DN, 1, kPad>(acc, ds_s, kT, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t qi = q0 + ty * kRows + i;
    if (qi >= Sq) continue;
    float* row = dq + (bh * Sq + qi) * D;
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      const int d = tx + 16 * n;
      if (d < D) row[d] = acc[i][n];
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int H, int64_t Sq,
    int64_t Sk, int D, float scale, int causal, int64_t window) {
  constexpr int DN = DP / 16;
  extern __shared__ float smem[];
  float* kT = smem;                   // DP x kPad each
  float* vT = kT + DP * kPad;
  float* qT = vT + DP * kPad;
  float* doT = qT + DP * kPad;
  float* p_s = doT + DP * kPad;       // kTile x kPad: p^T (kv rows)
  float* ds_s = p_s + kTile * kPad;   // kTile x kPad: ds^T
  float* lse_s = ds_s + kTile * kPad; // kTile
  float* dl_s = lse_s + kTile;        // kTile

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t bh = static_cast<int64_t>(blockIdx.z) * H + blockIdx.y;
  const float* qb = q + bh * Sq * D;
  const float* dob = dO + bh * Sq * D;
  const int64_t k_last = (k0 + kTile < Sk ? k0 + kTile : Sk) - 1;

  load_t<DP>(kT, k + bh * Sk * D, k0, Sk, D);
  load_t<DP>(vT, v + bh * Sk * D, k0, Sk, D);
  float dk_acc[kRows][DN], dv_acc[kRows][DN];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int n = 0; n < DN; ++n) dk_acc[i][n] = dv_acc[i][n] = 0.0f;
  }

  for (int64_t q0 = 0; q0 < Sq; q0 += kTile) {
    const int64_t q_last = (q0 + kTile < Sq ? q0 + kTile : Sq) - 1;
    if (!tile_live(q0, q_last, k0, k_last, causal, window)) continue;
    __syncthreads();
    load_t<DP>(qT, qb, q0, Sq, D);
    load_t<DP>(doT, dob, q0, Sq, D);
    load_vec(lse_s, lse + bh * Sq, q0, Sq);
    load_vec(dl_s, delta + bh * Sq, q0, Sq);
    __syncthreads();

    // transposed scores: row = kv position, column = q position
    float st[kRows][kRows], dpt[kRows][kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) st[i][j] = dpt[i][j] = 0.0f;
    }
    mma_t<DP>(st, kT, qT, ty, tx);
    mma_t<DP>(dpt, vT, doT, ty, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int c = ty * kRows + i;
      const int64_t ki = k0 + c;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int r = tx + 16 * j;
        const int64_t qi = q0 + r;
        float p = 0.0f;
        if (qi < Sq && ki < Sk && keep(qi, ki, causal, window)) {
          p = expf(st[i][j] * scale - lse_s[r]);
        }
        p_s[c * kPad + r] = p;
        ds_s[c * kPad + r] = p * (dpt[i][j] - dl_s[r]) * scale;
      }
    }
    __syncthreads();
    mma_p<DN, 1, kPad>(dv_acc, p_s, doT, ty, tx);
    mma_p<DN, 1, kPad>(dk_acc, ds_s, qT, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t ki = k0 + ty * kRows + i;
    if (ki >= Sk) continue;
    float* krow = dk + (bh * Sk + ki) * D;
    float* vrow = dv + (bh * Sk + ki) * D;
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      const int d = tx + 16 * n;
      if (d < D) {
        krow[d] = dk_acc[i][n];
        vrow[d] = dv_acc[i][n];
      }
    }
  }
}

template <int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dO,
              const void* lse, const void* delta, void* dq, int B, int H,
              int64_t Sq, int64_t Sk, int D, float scale, int causal,
              int64_t window, void* stream) {
  const size_t smem = (4 * DP * kPad + kTile * kPad + 2 * kTile)
      * sizeof(float);
  const dim3 grid(static_cast<unsigned>((Sq + kTile - 1) / kTile),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  return launch(flash_dq_kernel<DP>, grid, smem, stream,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(dO),
                static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<float*>(dq), H,
                Sq, Sk, D, scale, causal, window);
}

template <int DP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dO,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int H, int64_t Sq, int64_t Sk, int D, float scale, int causal,
               int64_t window, void* stream) {
  const size_t smem = (4 * DP * kPad + 2 * kTile * kPad + 2 * kTile)
      * sizeof(float);
  const dim3 grid(static_cast<unsigned>((Sk + kTile - 1) / kTile),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  return launch(flash_dkv_kernel<DP>, grid, smem, stream,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(dO),
                static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<float*>(dk),
                static_cast<float*>(dv), H, Sq, Sk, D, scale, causal, window);
}

bool bad_shape(int B, int H, int64_t Sq, int64_t Sk, int D) {
  return B < 1 || B > 65535 || H < 1 || H > 65535 || Sq < 1 || Sk < 1
      || D < 1;
}

}  // namespace

extern "C" {

// q, dO (B,H,Sq,D); k, v (B,H,Sk,D); lse, delta (B,H,Sq); the outputs dq
// (B,H,Sq,D), dk and dv (B,H,Sk,D); all float32 and contiguous.
// window <= 0: none.  Each returns the CUDA error of its launch.
int flash_dq_launch(const void* q, const void* k, const void* v,
                    const void* dO, const void* lse, const void* delta,
                    void* dq, int B, int H, int64_t Sq, int64_t Sk, int D,
                    float scale, int causal, int64_t window, void* stream) {
  if (bad_shape(B, H, Sq, Sk, D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (padded_head_dim(D)) {
    case 32:
      return launch_dq<32>(q, k, v, dO, lse, delta, dq, B, H, Sq, Sk, D,
                           scale, causal, window, stream);
    case 64:
      return launch_dq<64>(q, k, v, dO, lse, delta, dq, B, H, Sq, Sk, D,
                           scale, causal, window, stream);
    case 128:
      return launch_dq<128>(q, k, v, dO, lse, delta, dq, B, H, Sq, Sk, D,
                            scale, causal, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int flash_dkv_launch(const void* q, const void* k, const void* v,
                     const void* dO, const void* lse, const void* delta,
                     void* dk, void* dv, int B, int H, int64_t Sq, int64_t Sk,
                     int D, float scale, int causal, int64_t window,
                     void* stream) {
  if (bad_shape(B, H, Sq, Sk, D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (padded_head_dim(D)) {
    case 32:
      return launch_dkv<32>(q, k, v, dO, lse, delta, dk, dv, B, H, Sq, Sk, D,
                            scale, causal, window, stream);
    case 64:
      return launch_dkv<64>(q, k, v, dO, lse, delta, dk, dv, B, H, Sq, Sk, D,
                            scale, causal, window, stream);
    case 128:
      return launch_dkv<128>(q, k, v, dO, lse, delta, dk, dv, B, H, Sq, Sk,
                             D, scale, causal, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
