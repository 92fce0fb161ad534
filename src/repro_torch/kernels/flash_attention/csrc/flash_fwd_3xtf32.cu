// Flash attention forward for fp32 inputs on Hopper's tensor cores
// (sm_90a), in 3xTF32 (flash_common.cuh); bf16 inputs run
// flash_fwd_tc.cu.
//
// Replaces, for fp32 inputs, the TPU kernel
// src/repro/kernels/flash_attention/kernel.py:85 (flash_attention_pallas,
// body _kernel at :28).  For query head h of batch b, kv head
// h / (H / KV):
//
//   s   = q k^T * scale, NEG = -1e30 where the mask drops (ki > qi, or
//         ki <= qi - window), with no Sk - Sq offset, as on the TPU;
//   o   = softmax(s) v, in fp32;
//   lse = m + log(l) per row, fp32, for the backward.
//
// Bound: operations, 4 * D flops per unmasked (q, k) pair at the 3xTF32
// rate of 165 TFLOP/s (three TF32 products per fp32 product); the bytes
// (q, k, v read once, o and lse written once) are 10-60 times smaller at
// the configs' widths.  Besides the tensor cores, each product step
// costs its operands' shared loads and splits (3 integer or fp32 ops per
// element), so the design keeps those few per mma:
// - One block per (128-row q tile, h, b), heavy causal tiles first, 8
//   warps of 16 q rows.  The q tile stays in shared memory; k and v tiles
//   of 64 rows arrive by cp.async in two stages, the next tile's copy
//   under this tile's products.  Rows past S and columns past D
//   zero-fill (the wrapper pads D to a multiple of 4 for the 16-byte
//   copies).  A warp skips a tile where none of its rows has an unmasked
//   key.
// - s = q k^T on mma.sync m16n8k8 TF32, three per product step.  The
//   contracted index d is read in the order the accumulator layout keeps
//   (logical k t -> column 2t, t + 4 -> 2t + 1), so each thread reads
//   its two A and its two B elements as one 8-byte load; q's fragment is
//   split once per k-step and reused over 8 n-tiles.
// - Online softmax in registers, in log2 units (exp2f): keys >= Sk are
//   -inf and the causal / window mask NEG, set only on edge tiles.
// - o += p v takes p from the s accumulators with no trip through shared
//   memory: in that layout a thread holds kv columns 2t and 2t + 1 of
//   each 8-column block, so the same permutation of the contracted kv
//   index makes them p's A fragment, and v's B fragment is rows 2t and
//   2t + 1 of the v tile.  Row strides of D + 8 floats (q, k) and D + 4
//   (v) keep both reads free of bank conflicts.
// - Each tile's p v is summed in fresh registers and added to o by an
//   fp32 fma: the tensor core's accumulation truncates, so one chain of
//   mma over all of S would drift with S.
// wgmma is not used: its TF32 form wants both shared operands K-major,
// so p v would need transposed hi and lo copies of v in shared memory,
// and at D = 128 the q tile and one stage of those copies fill it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::cp_commit;
using flash::cp_wait;
using flash::FragA;
using flash::keep;
using flash::kNeg;
using flash::load_rows_f32;
using flash::mma3;
using flash::split_a;
using flash::tile_live;

constexpr int kBM = 128;            // q rows per block
constexpr int kBN = 64;             // kv rows per tile
constexpr int kWarps = kBM / 16;    // each warp owns 16 q rows
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared layout, in floats: q, then two stages of k, then two of v.
template <int DP>
struct Smem {
  static constexpr int kQS = DP + 8;   // q and k row stride: 8-byte
                                       // reads at column 2t, no conflict
  static constexpr int kVS = DP + 4;   // v: rows 2t, 2t + 1, no conflict
  static constexpr int kK = kBM * kQS;
  static constexpr int kV = kK + 2 * kBN * kQS;
  static constexpr int kBytes = 4 * (kV + 2 * kBN * kVS);
};

template <int DP>
__global__ void __launch_bounds__(kThreads, DP <= 64 ? 2 : 1)
    flash_fwd_3xtf32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ o, float* __restrict__ lse,
                            int H, int KV, int64_t Sq, int64_t Sk, int D,
                            float scale, int causal, int64_t window) {
  using L = Smem<DP>;
  constexpr int QS = L::kQS, VS = L::kVS;
  constexpr int kNB = DP / 8;       // n8 blocks of o over the head dim
  constexpr int kNG = kNB < 8 ? kNB : 8;  // n8 blocks per partial sum
  extern __shared__ __align__(16) float smem[];
  float* const q_s = smem;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kBM;
  const int64_t bh = static_cast<int64_t>(blockIdx.z) * H + blockIdx.y;
  const int64_t bkv = static_cast<int64_t>(blockIdx.z) * KV
      + blockIdx.y / (H / KV);
  const float* kb = k + bkv * Sk * D;
  const float* vb = v + bkv * Sk * D;
  const int64_t q_last = (q0 + kBM < Sq ? q0 + kBM : Sq) - 1;
  const int64_t wq0 = q0 + 16 * warp;            // this warp's rows
  const int64_t wq_last = (wq0 + 16 < Sq ? wq0 + 16 : Sq) - 1;

  // the kv tiles that hold an unmasked pair with this q tile (contiguous)
  const int nk = static_cast<int>((Sk + kBN - 1) / kBN);
  int j_lo = nk, j_hi = -1;
  for (int j = 0; j < nk; ++j) {
    const int64_t k0 = static_cast<int64_t>(j) * kBN;
    const int64_t k_last = (k0 + kBN < Sk ? k0 + kBN : Sk) - 1;
    if (tile_live(q0, q_last, k0, k_last, causal, window)) {
      j_lo = j < j_lo ? j : j_lo;
      j_hi = j;
    }
  }
  auto load_kv = [&](int j, int buf) {
    const int64_t k0 = static_cast<int64_t>(j) * kBN;
    load_rows_f32<kBN, DP, QS>(smem + L::kK + buf * kBN * QS, kb, k0, Sk,
                               D, kThreads);
    load_rows_f32<kBN, DP, VS>(smem + L::kV + buf * kBN * VS, vb, k0, Sk,
                               D, kThreads);
  };
  if (j_lo <= j_hi) {
    load_rows_f32<kBM, DP, QS>(q_s, q + bh * Sq * D, q0, Sq, D, kThreads);
    load_kv(j_lo, 0);
    cp_commit();
  }

  float acc[kNB][4];
#pragma unroll
  for (int n = 0; n < kNB; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};  // rows g and g + 8
  const float sl2 = scale * kLog2e;
  const float* qw = q_s + (16 * warp + g) * QS + 2 * t;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int buf = (j - j_lo) & 1;
    cp_wait<0>();                   // tile j (and q) have landed here
    __syncthreads();                // ... everywhere; tile j - 1 is done
    if (j < j_hi) load_kv(j + 1, buf ^ 1);
    cp_commit();
    const int64_t k0 = static_cast<int64_t>(j) * kBN;
    const int64_t k_last = (k0 + kBN < Sk ? k0 + kBN : Sk) - 1;
    if (wq0 > wq_last
        || !tile_live(wq0, wq_last, k0, k_last, causal, window)) {
      continue;
    }
    const float* k_s = smem + L::kK + buf * kBN * QS;
    const float* v_s = smem + L::kV + buf * kBN * VS;

    // s = q k^T: 16 q rows x 64 kv columns
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    }
#pragma unroll 2
    for (int kk = 0; kk < DP / 8; ++kk) {
      const float2 x0 = *reinterpret_cast<const float2*>(qw + 8 * kk);
      const float2 x1 = *reinterpret_cast<const float2*>(qw + 8 * QS
                                                         + 8 * kk);
      const FragA a = split_a(x0.x, x1.x, x0.y, x1.y);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 y = *reinterpret_cast<const float2*>(
            k_s + (8 * n + g) * QS + 8 * kk + 2 * t);
        mma3(s[n], a, y.x, y.y);
      }
    }

    // online softmax; only tiles on a ragged edge, the diagonal or the
    // window's edge mask
    const bool edge = k0 + kBN > Sk
        || (causal && (k_last > wq0
                       || (window > 0 && k0 <= wq_last - window)));
    float alpha_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t qi = wq0 + g + 8 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[n][2 * r + c] * sl2;
          if (edge) {
            const int64_t ki = k0 + 8 * n + 2 * t + c;
            if (ki >= Sk) {
              x = -INFINITY;
            } else if (!keep(qi, ki, causal, window)) {
              x = kNeg;
            }
          }
          s[n][2 * r + c] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2f(s[n][2 * r + c] - m_new);
          s[n][2 * r + c] = p;
          rs += p;
        }
      }
      l[r] = alpha * l[r] + rs;     // this thread's share of the row sum
      m[r] = m_new;
      alpha_r[r] = alpha;
    }

    // o = alpha o + p v: k-step c of 8 kv rows is n-block c of s.  This
    // tile's p v is made apart, kNG n-blocks at a time, and added by an
    // fp32 fma.
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
        const FragA a = split_a(s[c][0], s[c][2], s[c][1], s[c][3]);
        const float* vr = v_s + (8 * c + 2 * t) * VS + 8 * n0 + g;
#pragma unroll
        for (int n = 0; n < kNG; ++n) {
          mma3(part[n], a, vr[8 * n], vr[VS + 8 * n]);
        }
      }
#pragma unroll
      for (int n = 0; n < kNG; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[n0 + n][e] = fmaf(acc[n0 + n][e], alpha_r[e / 2], part[n][e]);
        }
      }
    }
  }

  // o = acc / l, lse = m + log l (natural units)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int64_t qi = wq0 + g + 8 * r;
    if (qi >= Sq) continue;
    const float inv = 1.0f / fmaxf(lr, 1e-30f);
    float* orow = o + (bh * Sq + qi) * D;
#pragma unroll
    for (int n = 0; n < kNB; ++n) {
      const int d = 8 * n + 2 * t;
      if (d < D) {
        *reinterpret_cast<float2*>(orow + d) =
            make_float2(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
      }
    }
    if (t == 0) lse[bh * Sq + qi] = (m[r] + log2f(lr)) * kLn2;
  }
}

template <int DP>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int H, int KV, int64_t Sq, int64_t Sk,
               int D, float scale, int causal, int64_t window, void* stream) {
  const dim3 grid(static_cast<unsigned>((Sq + kBM - 1) / kBM),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  return flash::launch(flash_fwd_3xtf32_kernel<DP>, grid, kThreads,
                       Smem<DP>::kBytes, stream,
                       static_cast<const float*>(q),
                       static_cast<const float*>(k),
                       static_cast<const float*>(v), static_cast<float*>(o),
                       static_cast<float*>(lse), H, KV, Sq, Sk, D, scale,
                       causal, window);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block at head dim D (D <= 128), in bytes.
int flash_fwd_3xtf32_smem(int D) {
  switch (flash::padded_head_dim(D)) {
    case 32: return Smem<32>::kBytes;
    case 64: return Smem<64>::kBytes;
    default: return Smem<128>::kBytes;
  }
}

// q (B,H,Sq,D), k/v (B,KV,Sk,D), o (B,H,Sq,D), lse (B,H,Sq), all float32,
// contiguous and 16-byte aligned, D % 4 == 0, D <= 128.  window <= 0:
// none.  Returns the CUDA error of the launch (0 = launched).
int flash_fwd_3xtf32_launch(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int H, int KV,
                            int64_t Sq, int64_t Sk, int D, float scale,
                            int causal, int64_t window, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || KV < 1 || H % KV != 0
      || Sq < 1 || Sk < 1 || D < 4 || D % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (flash::padded_head_dim(D)) {
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
