// Mamba-1 selective scan on Hopper (sm_90a): the backward.
//
// No TPU kernel computes this: the JAX package differentiates
// src/repro/models/ssm.py::selective_scan_ref (lax.scan) by autodiff.  This
// kernel computes the same gradient.  With dA_t = exp(dt_t A),
// x_t = dt_t u_t B_t and the forward h_t = dA_t h_{t-1} + x_t,
// y_t = C_t . h_t + D u_t, walking t from S down to 1 with G the gradient
// of the loss in h_t (G_S starts from gh, or zero):
//
//   G_t     = gy_t C_t + dA_{t+1} G_{t+1}
//   du_t    = sum_n G_t dt_t B_t + D gy_t
//   ddt_t   = sum_n G_t (A dA_t h_{t-1} + u_t B_t)
//   dA     += sum_{b,t} G_t dt_t dA_t h_{t-1}
//   dB_t[n] = sum_d G_t dt_t u_t,   dC_t[n] = sum_d gy_t h_t
//   dD     += sum_{b,t} gy_t u_t
//
// Inputs as the forward's (u, dt (batch, S, di) contiguous, fp32 or bf16;
// B, C (batch, S, N) strided, unit stride over N; A (di, N), D (di,)
// fp32), gy (batch, S, di) fp32 contiguous, gh (batch, di, N) fp32 or
// null, and the forward's checkpoints ckpt[b, k] = h_{k T} (batch,
// ceil(S / T), di, N) fp32.  Outputs fp32: du, ddt (batch, S, di) written;
// dA (di, N), dD (di,), dB, dC (batch, S, N) contiguous, zeroed by the
// caller and added to with atomics.
//
// Bound.  Bytes: u, dt, gy and the checkpoints read, du and ddt written
// (B, C, A, D, gh and their gradients are small); one exponential and ~19
// fp32 operations per (b, t, d, n).  At hymba-1.5b's train shape the bytes
// bound it.
//
// Design (simple and right first).  One block per (32-channel tile, batch
// row), four states of a channel a thread as in the forward, walking the
// checkpoint chunks from the last to the first:
//  1. stage the chunk's u, dt, gy (T x 32) and B, C (T x N) in shared memory
//     by cp.async, double-buffered: the chunk before loads while this one
//     runs;
//  2. from the chunk's checkpoint (loaded into registers a chunk ahead),
//     rerun the forward over its T steps and keep h_t and dA_t (one
//     exponential per (t, n), never a second) in a thread-private slice of
//     shared memory, [t][thread] as float4;
//  3. sweep the chunk backward: G, and dA in registers; the lane's parts
//     of du and ddt (sums over its 4 states), and its per-(channel, state)
//     terms of dB and dC, to shared memory (dB and dC over the step's h
//     and dA slots, which the sweep no longer needs).  The rerun and the
//     sweep load kGroup steps before they compute and store, as the
//     forward does;
//  4. write du, ddt for the chunk in 128-byte rows (the L lane parts
//     summed, D gy added; dD summed per channel), sum dB and dC over the
//     tile's channels in shared memory (one float4 of 4 states a thread
//     per (t, lane)) and add them to the batch row's dB, dC with
//     atomicAdd; the tiles of di add in an order that varies from run to
//     run (fp32, so dB, dC vary in their last bits).
// At the end dA and dD are added over batch rows by atomicAdd (same note).
// Shared memory is T (32 L 40 + 2 (32 4 + 2 32 e + 2 16 e)) bytes for
// inputs of e bytes: 49,152 at T = 8, N = 16, fp32, so four blocks fit an
// SM and hymba-1.5b's train shape (400 blocks) runs in one wave.  Offsets
// are int64; nothing is asserted about S or di.

#include "scan_common.cuh"

namespace {

using namespace scan;

constexpr int kCh = 32;       // channels per block
constexpr int kMaxN = 16;     // largest state size
constexpr int kNS = 4;        // states per thread
constexpr int kGroup = 2;     // steps a lane loads before it computes
                              // (2 beat 4 and 8 here: tools/scan_ab.py)
constexpr int kMaxSmem = 232448;   // a block's shared memory on sm_90

// G steps of the rerun: every load first, then the exponentials, then the
// h chain, then the stores of h_t and dA_t (see the note in ssm_scan.cu:
// a shared store inside a step keeps the next step's loads behind it).
template <typename T, int G>
__device__ __forceinline__ void rerun_steps(const T* su, const T* sdt,
                                            const T* sB, int r, int c,
                                            int n0, const float* a2,
                                            float* h, float4* s_h,
                                            float4* s_a, int stride) {
  float ut[G], dtv[G], bv[G][kNS], e[G][kNS], hs[G][kNS];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    ut[q] = to_f32(su[(r + q) * kCh + c]);
    dtv[q] = to_f32(sdt[(r + q) * kCh + c]);
    load4(sB + (r + q) * kMaxN + n0, bv[q]);
  }
#pragma unroll
  for (int q = 0; q < G; ++q) {
#pragma unroll
    for (int j = 0; j < kNS; ++j) e[q][j] = ex2(dtv[q] * a2[j]);
  }
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const float dtu = dtv[q] * ut[q];
#pragma unroll
    for (int j = 0; j < kNS; ++j) {
      h[j] = fmaf(e[q][j], h[j], dtu * bv[q][j]);
      hs[q][j] = h[j];
    }
  }
#pragma unroll
  for (int q = 0; q < G; ++q) {
    s_h[(r + q) * stride] = make_float4(hs[q][0], hs[q][1], hs[q][2],
                                        hs[q][3]);
    s_a[(r + q) * stride] = make_float4(e[q][0], e[q][1], e[q][2], e[q][3]);
  }
}

// G steps of the sweep, from step r down to r - G + 1: every load first
// (h_{t-1} of each step is read before any step's slot is overwritten),
// then the steps in order, then the stores of the lane's du, ddt parts and
// its dB, dC terms over the steps' h and dA slots.
template <typename T, int G>
__device__ __forceinline__ void sweep_steps(
    const T* su, const T* sdt, const float* sgy, const T* sB, const T* sC,
    int r, int c, int n0, const float* a, const float* h0, float* h,
    float* carry, float* dA_acc, float4* s_h, float4* s_a, float2* s_s,
    int stride) {
  float hp[G][kNS], ev[G][kNS], bv[G][kNS], cv[G][kNS], ut[G], dtv[G], g[G];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const int rr = r - q;
    const float4 pq = rr > 0 ? s_h[(rr - 1) * stride]
                             : make_float4(h0[0], h0[1], h0[2], h0[3]);
    const float4 eq = s_a[rr * stride];
    hp[q][0] = pq.x; hp[q][1] = pq.y; hp[q][2] = pq.z; hp[q][3] = pq.w;
    ev[q][0] = eq.x; ev[q][1] = eq.y; ev[q][2] = eq.z; ev[q][3] = eq.w;
    load4(sB + rr * kMaxN + n0, bv[q]);
    load4(sC + rr * kMaxN + n0, cv[q]);
    ut[q] = to_f32(su[rr * kCh + c]);
    dtv[q] = to_f32(sdt[rr * kCh + c]);
    g[q] = sgy[rr * kCh + c];
  }
  float pB[G][kNS], pC[G][kNS], sBv[G], sAv[G];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const float dtu = dtv[q] * ut[q];
    float sB_ = 0.0f, sA = 0.0f;
#pragma unroll
    for (int j = 0; j < kNS; ++j) {
      const float Gj = fmaf(g[q], cv[q][j], carry[j]);
      pC[q][j] = g[q] * h[j];
      pB[q][j] = Gj * dtu;
      sB_ = fmaf(Gj, bv[q][j], sB_);
      const float w = Gj * (ev[q][j] * hp[q][j]);
      sA = fmaf(w, a[j], sA);
      dA_acc[j] = fmaf(w, dtv[q], dA_acc[j]);
      carry[j] = ev[q][j] * Gj;
      h[j] = hp[q][j];
    }
    sBv[q] = sB_;
    sAv[q] = sA;
  }
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const int rr = r - q;
    s_s[rr * stride] = make_float2(sBv[q], sAv[q]);
    s_h[rr * stride] = make_float4(pB[q][0], pB[q][1], pB[q][2], pB[q][3]);
    s_a[rr * stride] = make_float4(pC[q][0], pC[q][1], pC[q][2], pC[q][3]);
  }
}

struct BwdParams {
  const void* u;
  const void* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* D;
  const float* gy;
  const float* gh;     // or null
  const float* ckpt;
  float* du;
  float* ddt;
  float* dA;
  float* dB;
  float* dC;
  float* dD;
  int64_t batch, S, di;
  int N;
  int64_t b_sb, b_st, c_sb, c_st;
  int64_t T, n_ckpt;
  int tiles;
  int vec_ud, vec_gy, vec_b, vec_c;
};

// Shared memory a step of a chunk takes: h and dA as a float4 a thread,
// the lane's du, ddt sums as a float2 a thread, and two staging buffers of
// u, dt (T), gy (fp32), B and C (T).
template <typename T, int L>
constexpr int smem_per_step() {
  return 2 * kCh * L * 16 + kCh * L * 8
         + 2 * (kCh * 4 + 2 * kCh * static_cast<int>(sizeof(T))
                + 2 * kMaxN * static_cast<int>(sizeof(T)));
}

template <typename T, int L>
__global__ void __launch_bounds__(kCh * L, 4)
    ssm_scan_bwd_kernel(BwdParams p) {
  constexpr int kThreads = kCh * L;
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t Tc = p.T;
  float4* s_h = reinterpret_cast<float4*>(smem);            // [T][threads]
  float4* s_a = s_h + Tc * kThreads;                        // [T][threads]
  float2* s_s = reinterpret_cast<float2*>(s_a + Tc * kThreads);  // likewise
  // two staging buffers, each gy (fp32), u, dt (T) [T][32], B, C (T) [T][16]
  unsigned char* const stage0 =
      reinterpret_cast<unsigned char*>(s_s + Tc * kThreads);
  constexpr int64_t es = sizeof(T);
  const int64_t buf_bytes = Tc * (kCh * 4 + 2 * kCh * es + 2 * kMaxN * es);
  auto s_gy = [=](int buf) {
    return reinterpret_cast<float*>(stage0 + buf * buf_bytes);
  };
  auto s_u = [=](int buf) {
    return reinterpret_cast<T*>(stage0 + buf * buf_bytes + Tc * kCh * 4);
  };
  auto s_dt = [=](int buf) { return s_u(buf) + Tc * kCh; };
  auto s_B = [=](int buf) { return s_u(buf) + 2 * Tc * kCh; };
  auto s_C = [=](int buf) { return s_u(buf) + 2 * Tc * kCh + Tc * kMaxN; };

  const int tid = threadIdx.x;
  const int c = tid / L;
  const int l = tid % L;
  const int tile = static_cast<int>(blockIdx.x % p.tiles);
  const int64_t b = blockIdx.x / p.tiles;
  const int64_t d0 = static_cast<int64_t>(tile) * kCh;
  const int64_t d = d0 + c;
  const bool dlive = d < p.di;
  const int N = p.N;
  const int n0 = l * kNS;
  const int dvalid = p.di - d0 < kCh ? static_cast<int>(p.di - d0) : kCh;

  float a[kNS], a2[kNS], carry[kNS], dA_acc[kNS];
#pragma unroll
  for (int j = 0; j < kNS; ++j) {
    const bool live = dlive && n0 + j < N;
    a[j] = live ? p.A[d * N + n0 + j] : 0.0f;
    a2[j] = a[j] * kLog2e;
    carry[j] = live && p.gh != nullptr ? p.gh[(b * p.di + d) * N + n0 + j]
                                       : 0.0f;
    dA_acc[j] = 0.0f;
  }
  // the lane's channel in the du, ddt pass: kThreads is a multiple of kCh
  const int col = tid % kCh;
  const float dcol = col < dvalid ? p.D[d0 + col] : 0.0f;
  float dD_acc = 0.0f;
  // kernel parameters the loops read, as locals: a lambda that captured
  // p by reference would put p on the stack and reload it every step
  const int64_t S = p.S, di = p.di, b_st = p.b_st, c_st = p.c_st;
  const int64_t n_ckpt = p.n_ckpt;
  const int vec_ud = p.vec_ud, vec_gy = p.vec_gy, vec_b = p.vec_b,
            vec_c = p.vec_c;
  const float* const ckpt = p.ckpt;
  float* const du = p.du;
  float* const ddt = p.ddt;
  float* const dB = p.dB;
  float* const dC = p.dC;
  const T* ub = static_cast<const T*>(p.u) + b * S * di + d0;
  const T* dtb = static_cast<const T*>(p.dt) + b * S * di + d0;
  const float* gyb = p.gy + b * S * di + d0;
  const T* Bb = static_cast<const T*>(p.Bm) + b * p.b_sb;
  const T* Cb = static_cast<const T*>(p.Cm) + b * p.c_sb;

  // 1. chunk k's u, dt, gy (T x 32) and B, C (T x N) into buffer k & 1
  auto issue = [=](int64_t k) {
    const int64_t t0 = k * Tc;
    const int steps = static_cast<int>(S - t0 < Tc ? S - t0 : Tc);
    const int buf = static_cast<int>(k & 1);
    stage<T, kCh>(s_u(buf), ub + t0 * di, di, steps, dvalid, vec_ud, tid,
                  kThreads);
    stage<T, kCh>(s_dt(buf), dtb + t0 * di, di, steps, dvalid, vec_ud, tid,
                  kThreads);
    stage<float, kCh>(s_gy(buf), gyb + t0 * di, di, steps, dvalid, vec_gy,
                      tid, kThreads);
    stage<T, kMaxN>(s_B(buf), Bb + t0 * b_st, b_st, steps, N, vec_b, tid,
                    kThreads);
    stage<T, kMaxN>(s_C(buf), Cb + t0 * c_st, c_st, steps, N, vec_c, tid,
                    kThreads);
    cp_commit();
  };

  // the checkpoint of the chunk after next is loaded one chunk ahead too
  auto load_ckpt = [=](int64_t k, float* out) {
    const float* ck = ckpt + ((b * n_ckpt + k) * di + d) * N + n0;
#pragma unroll
    for (int j = 0; j < kNS; ++j) {
      out[j] = dlive && n0 + j < N ? ck[j] : 0.0f;
    }
  };
  float ck_next[kNS] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (n_ckpt > 0) {
    issue(n_ckpt - 1);
    load_ckpt(n_ckpt - 1, ck_next);
  }
  for (int64_t k = n_ckpt - 1; k >= 0; --k) {
    // the chunk before this one loads while this one runs
    if (k > 0) {
      issue(k - 1);
    } else {
      cp_commit();
    }
    cp_wait_prev();
    __syncthreads();
    const int64_t t0 = k * Tc;
    const int steps = static_cast<int>(S - t0 < Tc ? S - t0 : Tc);
    const int buf = static_cast<int>(k & 1);
    const T* su = s_u(buf);
    const T* sdt = s_dt(buf);
    const float* sgy = s_gy(buf);
    const T* sB = s_B(buf);
    const T* sC = s_C(buf);

    // 2. rerun the chunk's forward from its checkpoint
    float h0[kNS], h[kNS];
#pragma unroll
    for (int j = 0; j < kNS; ++j) {
      h0[j] = ck_next[j];
      h[j] = h0[j];
    }
    if (k > 0) load_ckpt(k - 1, ck_next);
    {
      int r = 0;
      for (; r + kGroup <= steps; r += kGroup) {
        rerun_steps<T, kGroup>(su, sdt, sB, r, c, n0, a2, h, s_h + tid,
                               s_a + tid, kThreads);
      }
      for (; r < steps; ++r) {
        rerun_steps<T, 1>(su, sdt, sB, r, c, n0, a2, h, s_h + tid, s_a + tid,
                          kThreads);
      }
    }

    // 3. sweep the chunk backward
    {
      int r = steps - 1;
      for (; r >= kGroup - 1; r -= kGroup) {
        sweep_steps<T, kGroup>(su, sdt, sgy, sB, sC, r, c, n0, a, h0, h,
                               carry, dA_acc, s_h + tid, s_a + tid,
                               s_s + tid, kThreads);
      }
      for (; r >= 0; --r) {
        sweep_steps<T, 1>(su, sdt, sgy, sB, sC, r, c, n0, a, h0, h, carry,
                          dA_acc, s_h + tid, s_a + tid, s_s + tid, kThreads);
      }
    }
    __syncthreads();

    // du, ddt of the chunk: the channel's L lane sums, 128-byte rows
    if (col < dvalid) {
      const int64_t base = (b * S + t0) * di + d0 + col;
      for (int r = tid / kCh; r < steps; r += kThreads / kCh) {
        const float2* part = s_s + r * kThreads + col * L;
        float sB_ = 0.0f, sA = 0.0f;
#pragma unroll
        for (int q = 0; q < L; ++q) {
          sB_ += part[q].x;
          sA += part[q].y;
        }
        const float ut = to_f32(su[r * kCh + col]);
        const float dtt = to_f32(sdt[r * kCh + col]);
        const float g = sgy[r * kCh + col];
        du[base + r * di] = fmaf(dtt, sB_, dcol * g);
        ddt[base + r * di] = fmaf(ut, sB_, sA);
        dD_acc = fmaf(g, ut, dD_acc);
      }
    }

    // 4. dB, dC: sum over the tile's channels, then over tiles by atomics
    for (int i = tid; i < 2 * steps * L; i += kThreads) {
      const int which = i / (steps * L);
      const int r = (i / L) % steps;
      const int li = i % L;
      const float4* src = (which == 0 ? s_h : s_a) + r * kThreads + li;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
      for (int cc = 0; cc < kCh; ++cc) {
        const float4 v = src[cc * L];
        acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
      }
      float* dst = (which == 0 ? dB : dC) + (b * S + t0 + r) * N;
      const float av[kNS] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
      for (int j = 0; j < kNS; ++j) {
        const int n = li * kNS + j;
        if (n < N) atomicAdd(dst + n, av[j]);
      }
    }
    __syncthreads();   // the next chunk overwrites h, dA and this buffer
  }

  if (dlive) {
#pragma unroll
    for (int j = 0; j < kNS; ++j) {
      if (n0 + j < N) atomicAdd(p.dA + d * N + n0 + j, dA_acc[j]);
    }
  }
  if (col < dvalid) atomicAdd(p.dD + d0 + col, dD_acc);
}

template <typename T, int L>
int launch_one(const BwdParams& p, cudaStream_t s) {
  const int64_t smem = p.T * smem_per_step<T, L>();
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = p.batch * p.tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ssm_scan_bwd_kernel<T, L><<<static_cast<unsigned>(blocks), kCh * L,
                              static_cast<size_t>(smem), s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(BwdParams p, cudaStream_t s) {
  const int64_t es = sizeof(T);
  const int64_t row = p.S * p.di * es;
  p.vec_ud = copy_width(p.u, p.di * es, p.di * es, row);
  const int vdt = copy_width(p.dt, p.di * es, p.di * es, row);
  if (vdt < p.vec_ud) p.vec_ud = vdt;
  p.vec_gy = copy_width(p.gy, p.di * 4, p.di * 4, p.S * p.di * 4);
  p.vec_b = copy_width(p.Bm, p.N * es, p.b_st * es, p.b_sb * es);
  p.vec_c = copy_width(p.Cm, p.N * es, p.c_st * es, p.c_sb * es);
  int L = 1;
  while (L * kNS < p.N) L *= 2;
  switch (L) {
    case 1: return launch_one<T, 1>(p, s);
    case 2: return launch_one<T, 2>(p, s);
    case 4: return launch_one<T, 4>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (u, dt, B and C).  Returns
// cudaGetLastError() after the launch (0 = launched).
int ssm_scan_bwd_launch(int dtype, const void* u, const void* dt,
                        const void* A, const void* Bm, const void* Cm,
                        const void* D, const void* gy, const void* gh,
                        const void* ckpt, void* du, void* ddt, void* dA,
                        void* dB, void* dC, void* dD, int64_t batch,
                        int64_t S, int64_t di, int N, int64_t b_sb,
                        int64_t b_st, int64_t c_sb, int64_t c_st, int64_t T,
                        void* stream) {
  if (N < 1 || N > kMaxN || batch < 1 || di < 1 || S < 0 || T < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdParams p;
  p.u = u; p.dt = dt; p.A = static_cast<const float*>(A);
  p.Bm = Bm; p.Cm = Cm; p.D = static_cast<const float*>(D);
  p.gy = static_cast<const float*>(gy); p.gh = static_cast<const float*>(gh);
  p.ckpt = static_cast<const float*>(ckpt);
  p.du = static_cast<float*>(du); p.ddt = static_cast<float*>(ddt);
  p.dA = static_cast<float*>(dA); p.dB = static_cast<float*>(dB);
  p.dC = static_cast<float*>(dC); p.dD = static_cast<float*>(dD);
  p.batch = batch; p.S = S; p.di = di; p.N = N;
  p.b_sb = b_sb; p.b_st = b_st; p.c_sb = c_sb; p.c_st = c_st;
  p.T = T; p.n_ckpt = (S + T - 1) / T;
  p.tiles = static_cast<int>((di + kCh - 1) / kCh);
  p.vec_ud = p.vec_gy = p.vec_b = p.vec_c = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
