// Flash attention backward for bf16 inputs on Hopper's tensor cores
// (sm_90a): dq, dk and dv in one fused kernel.
//
// Replaces, for bf16 inputs, the two TPU kernels
// src/repro/kernels/flash_attention/backward.py:135 (_run_dq, body
// _dq_kernel at :51) and backward.py:156 (_run_dkv, body _dkv_kernel at
// :90), which flash_bwd_3xtf32.cu replaces for fp32 inputs.
// From the forward's fp32 row statistic lse and delta = rowsum(dO * O),
// for one (batch, head) with k/v already repeated to the query heads:
//
//   p   = exp(q k^T * scale - lse)        (0 where the mask drops)
//   dp  = dO v^T
//   ds  = p * (dp - delta) * scale
//   dq  = ds k           dk = ds^T q           dv = p^T dO
//
// all three gradients in fp32.  q, k, v and dO are read in bf16; p and ds
// are rounded to bf16 before their products.
//
// Bound: operations, five products of 2 * D flops per unmasked (q, k)
// pair, 10 * D flops, at 989 TFLOP/s (bf16 in, fp32 accumulate).
//
// Design, as in FlashAttention-2:
// - One block per (64-row kv tile, h, b), 4 warps, heavy causal tiles
//   first.  Its k and v tiles stay in shared memory while it loops over
//   the 64-row q tiles the TPU kernels' tile test keeps; q, dO, lse and
//   delta are double-buffered by cp.async.  Tiles are stored in 16-byte
//   chunks XOR-swizzled by row, so ldmatrix reads them without bank
//   conflicts; rows past S and columns past D are zero-filled.
// - Each warp owns 16 kv rows.  It computes s^T = k q^T and dp^T = v dO^T
//   for them (mma.sync m16n8k16, bf16 in, fp32 accumulate), so p^T and
//   ds^T come out in registers in the accumulator layout, which is the A
//   operand's layout of dv += p^T dO and dk += ds^T q: those two
//   products take p and ds from registers, and dk, dv accumulate in
//   registers over the whole loop and are written once.  Five products
//   per tile, not the seven of a dq pass and a dk/dv pass that each
//   recompute s and dp.
// - dq += ds k needs ds with q as rows: each warp writes its ds^T rows to
//   a shared tile, and after a barrier each warp multiplies 16 q rows of
//   it by the k tile (ldmatrix.trans for both operands) and adds the
//   result to dq in device memory by fp32 atomics (float2 adds) into a
//   dq the wrapper zeroes.  The order of those adds changes from run to
//   run, so dq is not bitwise repeatable; dk and dv are.
// mma.sync is the warp-level tensor-core instruction; wgmma (warpgroup,
// asynchronous) needs the transposed operands p^T, ds^T and ds k in
// layouts that are the harder part, and is later work, as are TMA
// loads and a bulk reduction of dq.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::cp16;
using flash::cp4;
using flash::cp_commit;
using flash::cp_wait;
using flash::keep;
using flash::smem_u32;
using flash::tile_live;

constexpr int kKB = 64;             // kv rows per block
constexpr int kQB = 64;             // q rows per step
constexpr int kWarps = kKB / 16;    // each warp owns 16 kv rows
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// Byte offset of 16-byte chunk `chunk` of row `r` in a tile of rows of
// `rowb` bytes (8 or more chunks a row), XOR-swizzled by r % 8.
__device__ __forceinline__ uint32_t swz(int r, int chunk, int rowb) {
  return static_cast<uint32_t>(r * rowb + ((chunk ^ (r & 7)) << 4));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d (16 x 8 fp32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 64 rows from row r0 of a (S, D) bf16 slab into a swizzled tile of DP
// columns; zero past row S and column D (D % 8 == 0).
template <int DP>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const bf16* __restrict__ src,
                                          int64_t r0, int64_t S, int D) {
  constexpr int kChunks = DP / 8;
  for (int idx = threadIdx.x; idx < 64 * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const bool valid = r0 + r < S && c * 8 < D;
    cp16(dst + swz(r, c, DP * 2), valid ? src + (r0 + r) * D + c * 8 : src,
         valid);
  }
}

// 64 floats from row r0 of a length-S vector; zero past S.
__device__ __forceinline__ void load_vec(uint32_t dst,
                                         const float* __restrict__ src,
                                         int64_t r0, int64_t S) {
  for (int r = threadIdx.x; r < kQB; r += kThreads) {
    const bool valid = r0 + r < S;
    cp4(dst + 4 * r, valid ? src + r0 + r : src, valid);
  }
}

template <int DP>
struct Smem {
  static constexpr int kTile = 64 * DP * 2;   // a 64-row bf16 tile
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTile;
  static constexpr int kQ = kV + kTile;       // two buffers each:
  static constexpr int kDO = kQ + 2 * kTile;  // q, dO
  static constexpr int kDS = kDO + 2 * kTile; // ds^T: 64 x 64 bf16
  static constexpr int kLse = kDS + 64 * 128; // two buffers each:
  static constexpr int kDelta = kLse + 2 * kQB * 4;  // lse, delta
  static constexpr int kBytes = kDelta + 2 * kQB * 4;
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    int H, int64_t Sq, int64_t Sk, int D, float scale, int causal,
    int64_t window) {
  using L = Smem<DP>;
  constexpr int kRowB = DP * 2;     // bytes of a tile row
  constexpr int kNB = DP / 8;       // n8 blocks over the head dimension
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t k_s = base + L::kK, v_s = base + L::kV;
  const uint32_t ds_s = base + L::kDS;
  float* lse_s = reinterpret_cast<float*>(smem + L::kLse);
  float* dl_s = reinterpret_cast<float*>(smem + L::kDelta);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, col = 2 * (lane % 4);
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * kKB;
  const int64_t k_last = (k0 + kKB < Sk ? k0 + kKB : Sk) - 1;
  const int64_t bh = static_cast<int64_t>(blockIdx.z) * H + blockIdx.y;
  const bf16* qb = q + bh * Sq * D;
  const bf16* dob = dO + bh * Sq * D;
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
    load_tile<DP>(base + L::kQ + buf * L::kTile, qb, q0, Sq, D);
    load_tile<DP>(base + L::kDO + buf * L::kTile, dob, q0, Sq, D);
    load_vec(base + L::kLse + buf * kQB * 4, lseb, q0, Sq);
    load_vec(base + L::kDelta + buf * kQB * 4, dlb, q0, Sq);
  };

  float dk_acc[kNB][4], dv_acc[kNB][4];
#pragma unroll
  for (int n = 0; n < kNB; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.0f;
  }

  if (j_lo <= j_hi) {
    load_tile<DP>(k_s, k + bh * Sk * D, k0, Sk, D);
    load_tile<DP>(v_s, v + bh * Sk * D, k0, Sk, D);
    load_q(j_lo, 0);
    cp_commit();
  }
  const float sl2 = scale * kLog2e;
  const int kv_row = 16 * warp;     // this warp's first kv row in the tile

  for (int j = j_lo; j <= j_hi; ++j) {
    const int buf = (j - j_lo) & 1;
    if (j < j_hi) load_q(j + 1, buf ^ 1);
    cp_commit();
    cp_wait<1>();                   // tile j (and k, v) have landed
    __syncthreads();
    const uint32_t q_s = base + L::kQ + buf * L::kTile;
    const uint32_t do_s = base + L::kDO + buf * L::kTile;
    const float* lse_t = lse_s + buf * kQB;
    const float* dl_t = dl_s + buf * kQB;
    const int64_t q0 = static_cast<int64_t>(j) * kQB;
    const int64_t q_last = (q0 + kQB < Sq ? q0 + kQB : Sq) - 1;

    // s^T = k q^T and dp^T = v dO^T: 16 kv rows x 64 q columns
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[c][e] = dpt[c][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int a_row = kv_row + (lane % 8) + 8 * ((lane / 8) % 2);
      const int a_chunk = 2 * kk + lane / 16;
      uint32_t ak[4], av[4];
      ldsm_x4(ak, k_s + swz(a_row, a_chunk, kRowB));
      ldsm_x4(av, v_s + swz(a_row, a_chunk, kRowB));
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int b_row = 16 * nb + (lane % 8) + 8 * (lane / 16);
        const int b_chunk = 2 * kk + (lane / 8) % 2;
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, q_s + swz(b_row, b_chunk, kRowB));
        ldsm_x4(bo, do_s + swz(b_row, b_chunk, kRowB));
        mma(st[2 * nb], ak, bq[0], bq[1]);
        mma(st[2 * nb + 1], ak, bq[2], bq[3]);
        mma(dpt[2 * nb], av, bo[0], bo[1]);
        mma(dpt[2 * nb + 1], av, bo[2], bo[3]);
      }
    }

    // p^T and ds^T in place; only tiles on a ragged edge, the diagonal or
    // the window's edge mask
    const bool edge = q0 + kQB > Sq || k0 + kKB > Sk
        || (causal && (k_last > q0 || (window > 0 && k0 <= q_last - window)));
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * c + col + (e % 2);
        float p = exp2f(fmaf(st[c][e], sl2, -lse_t[qc] * kLog2e));
        if (edge) {
          const int64_t ki = k0 + kv_row + g + 8 * (e / 2);
          const int64_t qi = q0 + qc;
          if (qi >= Sq || ki >= Sk || !keep(qi, ki, causal, window)) {
            p = 0.0f;
          }
        }
        st[c][e] = p;
        dpt[c][e] = p * (dpt[c][e] - dl_t[qc]) * scale;
      }
    }
    // bf16 A fragments (k = q): k-step t covers the chunks 2t and 2t+1;
    // ds^T also goes to shared memory for dq
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = 2 * t + r / 2, e = 2 * (r % 2);
        pa[t][r] = pack_bf16(st[c][e], st[c][e + 1]);
        da[t][r] = pack_bf16(dpt[c][e], dpt[c][e + 1]);
      }
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = kv_row + g + 8 * i;
        const uint32_t addr = ds_s + swz(r, c, 128) + 2 * col;
        asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr),
                     "r"(pack_bf16(dpt[c][2 * i], dpt[c][2 * i + 1]))
                     : "memory");
      }
    }

    // dv += p^T dO, dk += ds^T q: 16 kv rows x DP, k = the 64 q rows
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int b_row = 16 * t + (lane % 8) + 8 * ((lane / 8) % 2);
#pragma unroll
      for (int nb = 0; nb < kNB / 2; ++nb) {
        const int b_chunk = 2 * nb + lane / 16;
        uint32_t bo[4], bq[4];
        ldsm_x4_t(bo, do_s + swz(b_row, b_chunk, kRowB));
        ldsm_x4_t(bq, q_s + swz(b_row, b_chunk, kRowB));
        mma(dv_acc[2 * nb], pa[t], bo[0], bo[1]);
        mma(dv_acc[2 * nb + 1], pa[t], bo[2], bo[3]);
        mma(dk_acc[2 * nb], da[t], bq[0], bq[1]);
        mma(dk_acc[2 * nb + 1], da[t], bq[2], bq[3]);
      }
    }
    __syncthreads();                // ds^T is whole; q, dO reads are done

    // dq += ds k: this warp's 16 q rows, one 64-column half of D at a time
    const int q_row = 16 * warp;
#pragma unroll
    for (int half = 0; half < DP / 64; ++half) {
      float dq_acc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.0f;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        uint32_t a[4];
        ldsm_x4_t(a, ds_s + swz(16 * t + (lane % 8) + 8 * (lane / 16),
                                q_row / 8 + (lane / 8) % 2, 128));
        const int b_row = 16 * t + (lane % 8) + 8 * ((lane / 8) % 2);
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          uint32_t b[4];
          ldsm_x4_t(b, k_s + swz(b_row, 8 * half + 2 * nb + lane / 16,
                                 kRowB));
          mma(dq_acc[2 * nb], a, b[0], b[1]);
          mma(dq_acc[2 * nb + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int64_t qi = q0 + q_row + g + 8 * i;
        if (qi >= Sq) continue;
        float* row = dq + (bh * Sq + qi) * D;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int d = 64 * half + 8 * n + col;
          if (d < D) {
            atomicAdd(reinterpret_cast<float2*>(row + d),
                      make_float2(dq_acc[n][2 * i], dq_acc[n][2 * i + 1]));
          }
        }
      }
    }
  }

  // dk, dv: written once (zero for a kv tile no q tile reaches)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t ki = k0 + kv_row + g + 8 * i;
    if (ki >= Sk) continue;
    float* krow = dk + (bh * Sk + ki) * D;
    float* vrow = dv + (bh * Sk + ki) * D;
#pragma unroll
    for (int n = 0; n < kNB; ++n) {
      const int d = 8 * n + col;
      if (d < D) {
        *reinterpret_cast<float2*>(krow + d) =
            make_float2(dk_acc[n][2 * i], dk_acc[n][2 * i + 1]);
        *reinterpret_cast<float2*>(vrow + d) =
            make_float2(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
      }
    }
  }
}

template <int DP>
int launch_bwd(const void* q, const void* k, const void* v, const void* dO,
               const void* lse, const void* delta, void* dq, void* dk,
               void* dv, int B, int H, int64_t Sq, int64_t Sk, int D,
               float scale, int causal, int64_t window, void* stream) {
  auto kernel = flash_bwd_tc_kernel<DP>;
  const int smem = Smem<DP>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((Sk + kKB - 1) / kKB),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), H, Sq, Sk, D, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block at head dim D (D <= 128), in bytes.
int flash_bwd_tc_smem(int D) {
  return D > 64 ? Smem<128>::kBytes : Smem<64>::kBytes;
}

// q, dO (B,H,Sq,D) and k, v (B,H,Sk,D) bfloat16; lse, delta (B,H,Sq)
// float32; dq (B,H,Sq,D) float32 and zeroed; dk, dv (B,H,Sk,D) float32;
// all contiguous and 16-byte aligned, D % 8 == 0, D <= 128.  window <= 0:
// none.  Returns the CUDA error of the launch (0 = launched).
int flash_bwd_tc_launch(const void* q, const void* k, const void* v,
                        const void* dO, const void* lse, const void* delta,
                        void* dq, void* dk, void* dv, int B, int H,
                        int64_t Sq, int64_t Sk, int D, float scale,
                        int causal, int64_t window, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || Sq < 1 || Sk < 1
      || D < 8 || D > 128 || D % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (D > 64) {
    return launch_bwd<128>(q, k, v, dO, lse, delta, dq, dk, dv, B, H, Sq,
                           Sk, D, scale, causal, window, stream);
  }
  return launch_bwd<64>(q, k, v, dO, lse, delta, dq, dk, dv, B, H, Sq, Sk, D,
                        scale, causal, window, stream);
}

}  // extern "C"
