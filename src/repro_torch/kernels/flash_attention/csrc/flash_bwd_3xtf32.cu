// Flash attention backward for fp32 inputs on Hopper's tensor cores
// (sm_90a), in 3xTF32 (flash_common.cuh): dq, dk and dv in one fused
// kernel; bf16 inputs run flash_bwd_tc.cu.
//
// Replaces, for fp32 inputs, the two TPU kernels
// src/repro/kernels/flash_attention/backward.py:135 (_run_dq, body
// _dq_kernel at :51) and backward.py:156 (_run_dkv, body _dkv_kernel at
// :90).  From the forward's fp32 row statistic lse and
// delta = rowsum(dO * O), for one (batch, head) with k/v already repeated
// to the query heads:
//
//   p   = exp(q k^T * scale - lse)        (0 where the mask drops)
//   dp  = dO v^T
//   ds  = p * (dp - delta) * scale
//   dq  = ds k           dk = ds^T q           dv = p^T dO
//
// with q, k, v, dO read in fp32 and all three gradients in fp32.
//
// Bound: operations, five products of 2 * D flops per unmasked (q, k)
// pair, 10 * D flops, at the 3xTF32 rate of 165 TFLOP/s.  What the
// design does about it:
// - Five products, not the seven of a dq pass and a dk/dv pass that each
//   recompute s and dp.  One block per (64-row kv tile, h, b), heavy
//   causal tiles first; its k and v tiles stay in shared memory while it
//   loops over the 64-row q tiles the TPU kernels' tile test keeps; q,
//   dO, lse and delta are double-buffered by cp.async, the next tile's
//   copy under this tile's products.
// - 8 warps; warps w and w + 4 share kv rows 16 (w % 4) .. + 15 and split
//   the work by product, so that each keeps one D-wide accumulator
//   (64 registers at D = 128) and none spills: warp w computes
//   s^T = k q^T, then p^T, and accumulates dv += p^T dO; warp w + 4
//   computes dp^T = v dO^T, takes p^T from warp w through shared memory,
//   makes ds^T and accumulates dk += ds^T q.  p^T and ds^T stay in the
//   accumulator layout, which is the A layout of the next product once
//   its contracted q index is read in that layout's order (logical k
//   t -> column 2t, t + 4 -> 2t + 1): dO's and q's B fragments are then
//   rows 2t and 2t + 1 of their tiles.  Each q tile's share of dk, dv is
//   summed in fresh registers and added by an fp32 add: the tensor
//   core's accumulation truncates, and one chain over all of S drifted
//   by 2.6e-4 at S = 4096.
// - dq += ds k needs ds with q as rows: warp w + 4 writes ds^T to a shared
//   tile (over the p^T it read), and after a barrier each warp
//   multiplies 16 q rows by half of the k tile's columns and adds the
//   result to dq in device memory by fp32 atomics (float2 adds) into a
//   dq the wrapper zeroes.  The order of those adds changes from run to
//   run, so dq is not bitwise repeatable; dk and dv are.
// - Every tile has a row stride of D + 4 floats (ds^T: 64 + 4), which
//   keeps the scalar fragment reads free of bank conflicts for both the
//   K-contiguous (s^T, dp^T) and the K-strided (dv, dk, dq) products.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::cp4;
using flash::cp_commit;
using flash::cp_wait;
using flash::FragA;
using flash::keep;
using flash::load_rows_f32;
using flash::mma3;
using flash::smem_u32;
using flash::split_a;
using flash::tile_live;

constexpr int kKB = 64;             // kv rows per block
constexpr int kQB = 64;             // q rows per step
constexpr int kThreads = 256;       // 8 warps: 4 row groups x 2 roles
constexpr int kDS = kQB + 4;        // ds^T row stride
constexpr float kLog2e = 1.4426950408889634f;

// Shared layout, in floats.
template <int DP>
struct Smem {
  static constexpr int kS = DP + 4;             // k, v, q, dO row stride
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKB * kS;
  static constexpr int kQ = kV + kKB * kS;      // two buffers each:
  static constexpr int kDO = kQ + 2 * kQB * kS; // q, dO
  static constexpr int kDs = kDO + 2 * kQB * kS;  // ds^T: 64 x kDS
  static constexpr int kLse = kDs + kKB * kDS;  // two buffers each:
  static constexpr int kDelta = kLse + 2 * kQB; // lse, delta
  static constexpr int kBytes = 4 * (kDelta + 2 * kQB);
};

// 64 floats from row r0 of a length-S vector; zero past S.
__device__ __forceinline__ void load_vec(float* dst,
                                         const float* __restrict__ src,
                                         int64_t r0, int64_t S) {
  for (int r = threadIdx.x; r < kQB; r += kThreads) {
    const bool valid = r0 + r < S;
    cp4(smem_u32(dst + r), valid ? src + r0 + r : src, valid);
  }
}

// The 64 threads of warps w and w + 4 meet at barrier 1 + w % 4.
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;" ::"r"(1 + pair) : "memory");
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_3xtf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    int H, int64_t Sq, int64_t Sk, int D, float scale, int causal,
    int64_t window) {
  using L = Smem<DP>;
  constexpr int S = L::kS;
  constexpr int kNB = DP / 8;       // n8 blocks over the head dimension
  constexpr int kNG = kNB < 8 ? kNB : 8;  // n8 blocks per partial sum
  extern __shared__ __align__(16) float smem[];
  float* const k_s = smem + L::kK;
  float* const v_s = smem + L::kV;
  float* const ds_s = smem + L::kDs;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int pair = warp % 4, role = warp / 4;  // role 0: p, dv; 1: ds, dk
  const int kv_row = 16 * pair;     // this warp's first kv row in the tile
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * kKB;
  const int64_t k_last = (k0 + kKB < Sk ? k0 + kKB : Sk) - 1;
  const int64_t bh = static_cast<int64_t>(blockIdx.z) * H + blockIdx.y;
  const float* qb = q + bh * Sq * D;
  const float* dob = dO + bh * Sq * D;
  const float* lseb = lse + bh * Sq;
  const float* dlb = delta + bh * Sq;

  // the q tiles that hold an unmasked pair with this kv tile (contiguous)
  const int nq = static_cast<int>((Sq + kQB - 1) / kQB);
  int j_lo = nq, j_hi = -1;
  for (int j = 0; j < nq; ++j) {
    const int64_t q0 = static_cast<int64_t>(j) * kQB;
    const int64_t q_last = (q0 + kQB < Sq ? q0 + kQB : Sq) - 1;
    if (tile_live(q0, q_last, k0, k_last, causal, window)) {
      j_lo = j < j_lo ? j : j_lo;
      j_hi = j;
    }
  }
  auto load_q = [&](int j, int buf) {
    const int64_t q0 = static_cast<int64_t>(j) * kQB;
    load_rows_f32<kQB, DP, S>(smem + L::kQ + buf * kQB * S, qb, q0, Sq, D,
                              kThreads);
    load_rows_f32<kQB, DP, S>(smem + L::kDO + buf * kQB * S, dob, q0, Sq, D,
                              kThreads);
    load_vec(smem + L::kLse + buf * kQB, lseb, q0, Sq);
    load_vec(smem + L::kDelta + buf * kQB, dlb, q0, Sq);
  };
  if (j_lo <= j_hi) {
    load_rows_f32<kKB, DP, S>(k_s, k + bh * Sk * D, k0, Sk, D, kThreads);
    load_rows_f32<kKB, DP, S>(v_s, v + bh * Sk * D, k0, Sk, D, kThreads);
    load_q(j_lo, 0);
    cp_commit();
  }

  // role 0 accumulates dv, role 1 dk: 16 kv rows x DP
  float acc[kNB][4];
#pragma unroll
  for (int n = 0; n < kNB; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }
  const float sl2 = scale * kLog2e;
  // role 0 multiplies k by q, role 1 v by dO
  const float* a_s = (role ? v_s : k_s) + (kv_row + g) * S + t;
  float* const xch = ds_s + kv_row * kDS;   // this pair's p^T, then ds^T

  for (int j = j_lo; j <= j_hi; ++j) {
    const int buf = (j - j_lo) & 1;
    cp_wait<0>();                   // tile j (and k, v) have landed here
    __syncthreads();                // ... everywhere; tile j - 1 is done
    if (j < j_hi) load_q(j + 1, buf ^ 1);
    cp_commit();
    const float* q_s = smem + L::kQ + buf * kQB * S;
    const float* do_s = smem + L::kDO + buf * kQB * S;
    const float* lse_t = smem + L::kLse + buf * kQB;
    const float* dl_t = smem + L::kDelta + buf * kQB;
    const int64_t q0 = static_cast<int64_t>(j) * kQB;
    const int64_t q_last = (q0 + kQB < Sq ? q0 + kQB : Sq) - 1;

    // s^T = k q^T (role 0) or dp^T = v dO^T (role 1): 16 kv x 64 q
    float st[8][4];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[c][e] = 0.0f;
    }
    const float* b_s = (role ? do_s : q_s) + g * S + t;
#pragma unroll 2
    for (int kk = 0; kk < DP / 8; ++kk) {
      const float* ar = a_s + 8 * kk;
      const FragA a = split_a(ar[0], ar[8 * S], ar[4], ar[8 * S + 4]);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float* br = b_s + 8 * c * S + 8 * kk;
        mma3(st[c], a, br[0], br[4]);
      }
    }

    const bool edge = q0 + kQB > Sq || k0 + kKB > Sk
        || (causal && (k_last > q0 || (window > 0 && k0 <= q_last - window)));
    if (role == 0) {
      // p^T, 0 where masked, handed to warp w + 4
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * c + 2 * t + (e & 1);
          float p = exp2f(fmaf(st[c][e], sl2, -lse_t[qc] * kLog2e));
          if (edge) {
            const int64_t ki = k0 + kv_row + g + 8 * (e >> 1);
            const int64_t qi = q0 + qc;
            if (qi >= Sq || ki >= Sk || !keep(qi, ki, causal, window)) {
              p = 0.0f;
            }
          }
          st[c][e] = p;
        }
        *reinterpret_cast<float4*>(xch + 4 * (32 * c + lane)) =
            make_float4(st[c][0], st[c][1], st[c][2], st[c][3]);
      }
      pair_sync(pair);
    } else {
      pair_sync(pair);
      // ds^T = p^T (dp^T - delta) scale, then over p^T in shared memory
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 p = *reinterpret_cast<const float4*>(
            xch + 4 * (32 * c + lane));
        const float d0 = dl_t[8 * c + 2 * t], d1 = dl_t[8 * c + 2 * t + 1];
        st[c][0] = p.x * (st[c][0] - d0) * scale;
        st[c][1] = p.y * (st[c][1] - d1) * scale;
        st[c][2] = p.z * (st[c][2] - d0) * scale;
        st[c][3] = p.w * (st[c][3] - d1) * scale;
      }
      __syncwarp();
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          *reinterpret_cast<float2*>(xch + (g + 8 * i) * kDS + 8 * c
                                     + 2 * t) =
              make_float2(st[c][2 * i], st[c][2 * i + 1]);
        }
      }
    }

    // dv += p^T dO (role 0), dk += ds^T q (role 1): 16 kv x DP over the
    // 64 q rows; k-step c of 8 q rows is n-block c of st.  This tile's
    // sum is made apart, kNG n-blocks at a time, and added by an fp32 add.
    const float* m_s = (role ? q_s : do_s) + 2 * t * S + g;
#pragma unroll
    for (int n0 = 0; n0 < kNB; n0 += kNG) {
      float part[kNG][4];
#pragma unroll
      for (int n = 0; n < kNG; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) part[n][e] = 0.0f;
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const FragA a = split_a(st[c][0], st[c][2], st[c][1], st[c][3]);
        const float* mr = m_s + 8 * c * S + 8 * n0;
#pragma unroll
        for (int n = 0; n < kNG; ++n) {
          mma3(part[n], a, mr[8 * n], mr[S + 8 * n]);
        }
      }
#pragma unroll
      for (int n = 0; n < kNG; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];
      }
    }
    __syncthreads();                // ds^T is whole

    // dq += ds k: q rows 16 pair .. + 15, head-dim columns of half `role`
    float dq_acc[kNB / 2][4];
#pragma unroll
    for (int n = 0; n < kNB / 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.0f;
    }
    const float* dsr = ds_s + 2 * t * kDS + 16 * pair + g;
    const float* kr = k_s + 2 * t * S + role * (DP / 2) + g;
#pragma unroll 2
    for (int c = 0; c < 8; ++c) {
      const float* a = dsr + 8 * c * kDS;
      const FragA fa = split_a(a[0], a[8], a[kDS], a[kDS + 8]);
      const float* b = kr + 8 * c * S;
#pragma unroll
      for (int n = 0; n < kNB / 2; ++n) {
        mma3(dq_acc[n], fa, b[8 * n], b[S + 8 * n]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t qi = q0 + 16 * pair + g + 8 * i;
      if (qi >= Sq) continue;
      float* row = dq + (bh * Sq + qi) * D;
#pragma unroll
      for (int n = 0; n < kNB / 2; ++n) {
        const int d = role * (DP / 2) + 8 * n + 2 * t;
        if (d < D) {
          atomicAdd(reinterpret_cast<float2*>(row + d),
                    make_float2(dq_acc[n][2 * i], dq_acc[n][2 * i + 1]));
        }
      }
    }
  }

  // dv (role 0) or dk (role 1): written once (zero for a kv tile no q
  // tile reaches)
  float* out = role ? dk : dv;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t ki = k0 + kv_row + g + 8 * i;
    if (ki >= Sk) continue;
    float* row = out + (bh * Sk + ki) * D;
#pragma unroll
    for (int n = 0; n < kNB; ++n) {
      const int d = 8 * n + 2 * t;
      if (d < D) {
        *reinterpret_cast<float2*>(row + d) =
            make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
      }
    }
  }
}

template <int DP>
int launch_bwd(const void* q, const void* k, const void* v, const void* dO,
               const void* lse, const void* delta, void* dq, void* dk,
               void* dv, int B, int H, int64_t Sq, int64_t Sk, int D,
               float scale, int causal, int64_t window, void* stream) {
  const dim3 grid(static_cast<unsigned>((Sk + kKB - 1) / kKB),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  return flash::launch(
      flash_bwd_3xtf32_kernel<DP>, grid, kThreads, Smem<DP>::kBytes, stream,
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), H, Sq, Sk, D, scale, causal, window);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block at head dim D (D <= 128), in bytes.
int flash_bwd_3xtf32_smem(int D) {
  switch (flash::padded_head_dim(D)) {
    case 32: return Smem<32>::kBytes;
    case 64: return Smem<64>::kBytes;
    default: return Smem<128>::kBytes;
  }
}

// q, dO (B,H,Sq,D) and k, v (B,H,Sk,D); lse, delta (B,H,Sq); dq
// (B,H,Sq,D), zeroed; dk, dv (B,H,Sk,D); all float32, contiguous and
// 16-byte aligned, D % 4 == 0, D <= 128.  window <= 0: none.  Returns
// the CUDA error of the launch (0 = launched).
int flash_bwd_3xtf32_launch(const void* q, const void* k, const void* v,
                            const void* dO, const void* lse,
                            const void* delta, void* dq, void* dk, void* dv,
                            int B, int H, int64_t Sq, int64_t Sk, int D,
                            float scale, int causal, int64_t window,
                            void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || Sq < 1 || Sk < 1
      || D < 4 || D % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (flash::padded_head_dim(D)) {
    case 32:
      return launch_bwd<32>(q, k, v, dO, lse, delta, dq, dk, dv, B, H, Sq,
                            Sk, D, scale, causal, window, stream);
    case 64:
      return launch_bwd<64>(q, k, v, dO, lse, delta, dq, dk, dv, B, H, Sq,
                            Sk, D, scale, causal, window, stream);
    case 128:
      return launch_bwd<128>(q, k, v, dO, lse, delta, dq, dk, dv, B, H, Sq,
                             Sk, D, scale, causal, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
