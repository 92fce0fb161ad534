// Flash attention forward for bf16 inputs on Hopper's tensor cores
// (sm_90a): wgmma for both products, TMA for every tile.
//
// Replaces, for bf16 inputs, the TPU kernel
// src/repro/kernels/flash_attention/kernel.py:85 (flash_attention_pallas,
// body _kernel at :28).  It computes what flash_fwd.cu computes (which
// keeps the fp32 inputs): for query head h of batch b, kv head
// h / (H / KV),
//
//   s   = q k^T * scale, NEG = -1e30 where the mask drops (ki > qi, or
//         ki <= qi - window), with no Sk - Sq offset, as on the TPU;
//   o   = softmax(s) v, written in bf16 or fp32;
//   lse = m + log(l) per row, fp32, for the backward.
//
// Bound: operations, 4 * D flops per unmasked (q, k) pair at 989 TFLOP/s
// (bf16 in, fp32 accumulate); the bytes (q, k, v read once, o and lse
// written once) are 20-60 times smaller at the configs' widths.
//
// Design, after FlashAttention-3:
// - One block per (128-row q tile, h, b), heavy causal tiles first: two
//   consumer warpgroups of 64 q rows each and one producer warpgroup, of
//   which one thread issues every load.  setmaxnreg gives the producer's
//   registers to the consumers.
// - Loads: the producer brings the q tile once and keeps k and v tiles of
//   128 rows in flight by TMA, in a ring of kStages stages guarded by full
//   (TMA bytes) and empty (8 consumer warps) mbarriers.  The tensor maps
//   are 3-D, (D, S, B * heads), so rows past S zero-fill and never read
//   the next (b, h) slab; columns D..DP zero-fill too.  A 128-byte
//   swizzle box holds 64 bf16 columns, so DP = 128 loads as two boxes
//   ("halves") per tile.
// - s = q k^T: wgmma m64n128k16, both operands from shared memory in the
//   128-byte swizzle TMA writes (K-major); a k-step of 16 columns moves
//   the descriptor's start by 32 bytes inside the swizzle atom.  A kv
//   tile of 128 rows took 13-19 % less time than one of 64 on an H100
//   (tools/flash_tc_ab.py): half the waits and barrier trips a product.
// - Online softmax in registers, in log2 units (exp2f): keys >= Sk are
//   -inf and the causal / window mask NEG, set explicitly because
//   zero-filled keys score 0.  Row max and sum over the 4 lanes that
//   share a row in the accumulator layout.  p is rounded to bf16 in
//   registers, where the accumulator layout is already wgmma's A-operand
//   layout.
// - o += p v: wgmma m64n64k16 with A = p from registers and B = v from
//   shared memory, transposed (v's rows are the k dimension), one
//   instruction per 64-column half of D; fp32 accumulators.
// - Epilogue: o = acc / l, lse = m + log l, stores masked to Sq and D.
// Each consumer waits for its own products before the softmax
// (wgmma.wait_group 0); the two warpgroups of a block overlap each
// other's softmax with their products.  Issuing the next tile's q k^T
// before this tile's softmax was slower on an H100 (it spilled at
// D = 128); ping-pong scheduling and TMA stores of o are later work.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::keep;
using flash::tile_live;

constexpr int kBM = 128;            // q rows per block
constexpr int kBN = 128;            // kv rows per tile
constexpr int kStages = 2;          // kv tiles in flight
constexpr int kConsumers = 2;       // warpgroups of 64 q rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBox = 64;            // bf16 columns per 128-byte swizzle row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// --- shared-memory barriers and TMA ---------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.  A
// wait that outlasts 2^26 polls (seconds) traps: a lost arrival is a
// fault, reported instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0, polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// --- wgmma ----------------------------------------------------------------

// Descriptor of a bf16 tile in shared memory in the 128-byte swizzle:
// rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO); LBO is unused by
// the shapes below (one k-step or one N of 64 never leaves a 128-byte row).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
      | (static_cast<uint64_t>(1) << 16)
      | (static_cast<uint64_t>(1024 >> 4) << 32)
      | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma boundary.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define WG_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_OUT32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])
#define WG_D64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define WG_OUT64(d)                                                        \
  WG_OUT32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),         \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),     \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),     \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),     \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),     \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),     \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (64 x 128 fp32) (+)= A (64 x 16, smem, K-major) * B (16 x 128, smem,
// K-major).
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_OUT64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 fp32) += A (64 x 16 bf16, registers) * B (16 x 64, smem,
// MN-major: the 16 k rows hold 64 contiguous n columns each).
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// --- the kernel -----------------------------------------------------------

template <int DP>
struct Smem {
  static constexpr int kHalves = DP / kBox;
  static constexpr int kQHalf = kBM * 128;           // bytes of a q half
  static constexpr int kKHalf = kBN * 128;           // of a k or v half
  static constexpr int kQ = kHalves * kQHalf;
  static constexpr int kStage = 2 * kHalves * kKHalf;  // k then v
  static constexpr int kBars = kQ + kStages * kStage;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages);
  static constexpr int kAlloc = kBytes + 1024;       // room to align
};

template <typename TO, int DP>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_tc_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, TO* __restrict__ o,
    float* __restrict__ lse, int H, int KV, int64_t Sq, int64_t Sk, int D,
    float scale, int causal, int64_t window) {
  using L = Smem<DP>;
  constexpr int kHalves = L::kHalves;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle is a function of the shared address: align the
  // tiles to its 1024-byte atom
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = base + L::kQ;
  const uint32_t bar_q = base + L::kBars;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;

  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kBM;
  const int64_t q_last = (q0 + kBM < Sq ? q0 + kBM : Sq) - 1;
  const int bh = blockIdx.z * H + blockIdx.y;
  const int bkv = blockIdx.z * KV + blockIdx.y / (H / KV);
  const int nk = static_cast<int>((Sk + kBN - 1) / kBN);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kConsumers) {
    // ---- producer warpgroup: one thread issues every TMA load ----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(bar_q, L::kQ);
      for (int h = 0; h < kHalves; ++h) {
        tma_load_3d(q_s + h * L::kQHalf, &tm_q, bar_q, h * kBox,
                    static_cast<int>(q0), bh);
      }
      int it = 0;
      for (int j = 0; j < nk; ++j) {
        const int64_t k0 = static_cast<int64_t>(j) * kBN;
        const int64_t k_last = (k0 + kBN < Sk ? k0 + kBN : Sk) - 1;
        if (!tile_live(q0, q_last, k0, k_last, causal, window)) continue;
        const int stage = it % kStages;
        const uint32_t parity = (it / kStages) & 1;
        ++it;
        mbar_wait(bar_empty + 8 * stage, parity ^ 1);
        const uint32_t full = bar_full + 8 * stage;
        const uint32_t ks = kv_s + stage * L::kStage;
        mbar_expect_tx(full, L::kStage);
        for (int h = 0; h < kHalves; ++h) {
          tma_load_3d(ks + h * L::kKHalf, &tm_k, full, h * kBox,
                      static_cast<int>(k0), bkv);
          tma_load_3d(ks + (kHalves + h) * L::kKHalf, &tm_v, full, h * kBox,
                      static_cast<int>(k0), bkv);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each ---------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    // this thread's two rows in the accumulator layout, and its columns
    // 8 c + 2 (lane % 4) + {0, 1} of every 8-column chunk c
    const int row0 = wg * 64 + warp * 16 + lane / 4;
    const int64_t qi[2] = {q0 + row0, q0 + row0 + 8};
    const int col = 2 * (lane % 4);
    const float sl2 = scale * kLog2e;

    float acc[kHalves][32];
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[h][e] = 0.0f;
    }
    float m[2] = {flash::kNeg, flash::kNeg}, l[2] = {0.0f, 0.0f};

    mbar_wait(bar_q, 0);
    const uint32_t q_wg = q_s + wg * 64 * 128;
    int it = 0;
    for (int j = 0; j < nk; ++j) {
      const int64_t k0 = static_cast<int64_t>(j) * kBN;
      const int64_t k_last = (k0 + kBN < Sk ? k0 + kBN : Sk) - 1;
      if (!tile_live(q0, q_last, k0, k_last, causal, window)) continue;
      const int stage = it % kStages;
      const uint32_t parity = (it / kStages) & 1;
      ++it;
      const uint32_t ks = kv_s + stage * L::kStage;
      const uint32_t vs = ks + kHalves * L::kKHalf;
      mbar_wait(bar_full + 8 * stage, parity);

      // s = q k^T over DP / 16 k-steps
      float s[kBN / 2];
#pragma unroll
      for (int e = 0; e < kBN / 2; ++e) s[e] = 0.0f;
      fence_regs(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        const uint64_t da = sw128_desc(q_wg + (kk / 4) * L::kQHalf + off);
        const uint64_t db = sw128_desc(ks + (kk / 4) * L::kKHalf + off);
        wgmma_ss(s, da, db, kk > 0);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(s);

      // mask and scale (log2 units), then the online softmax; only tiles
      // on the ragged Sk edge, the diagonal or the window's edge mask
      const bool edge = k0 + kBN > Sk
          || (causal && (k_last > q0
                         || (window > 0 && k0 <= q_last - window)));
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int c = 0; c < kBN / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2;
          float x = s[4 * c + e] * sl2;
          if (edge) {
            const int64_t ki = k0 + 8 * c + col + (e % 2);
            if (ki >= Sk) {
              x = -INFINITY;
            } else if (!keep(qi[i], ki, causal, window)) {
              x = flash::kNeg;
            }
          }
          s[4 * c + e] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
      float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
      }
#pragma unroll
      for (int e = 0; e < kBN / 2; ++e) {
        const int i = (e / 2) % 2;
        s[e] = exp2f(s[e] - m[i]);
        rs[i] += s[e];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
        l[i] = alpha[i] * l[i] + rs[i];
      }
      // p in bf16 as wgmma's A fragments: k-step t covers the s chunks
      // 2t (columns 16t..16t+7) and 2t+1
      uint32_t pf[kBN / 16][4];
#pragma unroll
      for (int t = 0; t < kBN / 16; ++t) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pf[t][r] = pack_bf16(s[8 * t + 2 * r], s[8 * t + 2 * r + 1]);
        }
      }
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[h][e] *= alpha[(e / 2) % 2];
        fence_regs(acc[h]);
      }
#pragma unroll
      for (int t = 0; t < kBN / 16; ++t) fence_regs(pf[t]);

      // o += p v: k = the tile's kBN kv rows, 16 per step; one 64-column
      // half of D per instruction
      wg_fence();
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
#pragma unroll
        for (int t = 0; t < kBN / 16; ++t) {
          wgmma_rs_t(acc[h], pf[t],
                     sw128_desc(vs + h * L::kKHalf + t * 16 * 128));
        }
      }
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int h = 0; h < kHalves; ++h) fence_regs(acc[h]);
      if (lane == 0) mbar_arrive(bar_empty + 8 * stage);
    }

    // epilogue: o = acc / l, lse = m + log l (natural units)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (qi[i] >= Sq) continue;
      const float inv = 1.0f / fmaxf(l[i], 1e-30f);
      TO* orow = o + (static_cast<int64_t>(bh) * Sq + qi[i]) * D;
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int d = h * kBox + 8 * c + col;
          if (d >= D) continue;
          const float x0 = acc[h][4 * c + 2 * i] * inv;
          const float x1 = acc[h][4 * c + 2 * i + 1] * inv;
          if constexpr (sizeof(TO) == 4) {
            *reinterpret_cast<float2*>(orow + d) = make_float2(x0, x1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(orow + d) =
                __floats2bfloat162_rn(x0, x1);
          }
        }
      }
      if (lane % 4 == 0) {
        lse[static_cast<int64_t>(bh) * Sq + qi[i]] = m[i] * kLn2 + logf(l[i]);
      }
    }
  }
}

// --- host side ------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in the driver library; reach it through
// the runtime so that the build needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A 3-D map over a contiguous (slabs, S, D) bf16 array, D % 8 == 0: boxes
// of (64 columns, rows, 1 slab) in the 128-byte swizzle, zero fill.
bool make_map(CUtensorMap* map, const void* ptr, int64_t slabs, int64_t S,
              int D, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(slabs)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kBox),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TO, int DP>
int launch_fwd(const CUtensorMap& tq, const CUtensorMap& tk,
               const CUtensorMap& tv, void* o, void* lse, int B, int H,
               int KV, int64_t Sq, int64_t Sk, int D, float scale,
               int causal, int64_t window, void* stream) {
  auto kernel = flash_fwd_tc_kernel<TO, DP>;
  const int smem = Smem<DP>::kAlloc;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((Sq + kBM - 1) / kBM),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<TO*>(o), static_cast<float*>(lse), H, KV, Sq,
      Sk, D, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block at head dim D (D <= 128), in bytes.
int flash_fwd_tc_smem(int D) {
  return D > kBox ? Smem<128>::kAlloc : Smem<64>::kAlloc;
}

// q (B,H,Sq,D), k/v (B,KV,Sk,D) bfloat16, contiguous and 16-byte aligned,
// D % 8 == 0 and D <= 128; o (B,H,Sq,D) in float32 when out_f32 else
// bfloat16; lse (B,H,Sq) float32.  window <= 0: none.  Returns the CUDA
// error of the launch (0 = launched).
int flash_fwd_tc_launch(int out_f32, const void* q, const void* k,
                        const void* v, void* o, void* lse, int B, int H,
                        int KV, int64_t Sq, int64_t Sk, int D, float scale,
                        int causal, int64_t window, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || KV < 1 || H % KV != 0
      || Sq < 1 || Sk < 1 || D < 8 || D > 2 * kBox || D % 8 != 0
      || Sq > INT32_MAX || Sk > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, static_cast<int64_t>(B) * H, Sq, D, kBM)
      || !make_map(&tk, k, static_cast<int64_t>(B) * KV, Sk, D, kBN)
      || !make_map(&tv, v, static_cast<int64_t>(B) * KV, Sk, D, kBN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool wide = D > kBox;
  if (out_f32) {
    return wide ? launch_fwd<float, 128>(tq, tk, tv, o, lse, B, H, KV, Sq,
                                         Sk, D, scale, causal, window, stream)
                : launch_fwd<float, 64>(tq, tk, tv, o, lse, B, H, KV, Sq, Sk,
                                        D, scale, causal, window, stream);
  }
  return wide ? launch_fwd<__nv_bfloat16, 128>(tq, tk, tv, o, lse, B, H, KV,
                                               Sq, Sk, D, scale, causal,
                                               window, stream)
              : launch_fwd<__nv_bfloat16, 64>(tq, tk, tv, o, lse, B, H, KV,
                                              Sq, Sk, D, scale, causal,
                                              window, stream);
}

}  // extern "C"
