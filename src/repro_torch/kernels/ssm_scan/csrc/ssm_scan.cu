// Mamba-1 selective scan on Hopper (sm_90a): the forward.
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
// On request the kernel also writes the backward's checkpoints: the state
// before every ckpt_every-th step, ckpt[b, k] = h_{k * ckpt_every}, as
// (batch, ceil(S / ckpt_every), di, N) fp32 (ckpt[b, 0] is zero).
//
// Bound.  Per (b, t, d, n) one exponential and ~6 fp32 operations; per
// (b, t, d) the bytes of u, dt and y.  At the model's widths (N = 16) the
// exponentials at the MUFU rate (16 per clock per SM) and the bytes at
// 3.35 TB/s give bounds of the same size.  What a thread issues beside its
// exponentials decides how near the kernel comes to them.
//
// Design.
//  * Four states of one channel a thread (L = ceil(N / 4) lanes a channel,
//    L in {1, 2, 4}), 32 channels a block.  A step costs a lane two shared
//    loads of u and dt (one word for the channel's lanes), one 16-byte load
//    each of B and C, per state an FMUL, the exponential, an FMUL and two
//    FFMAs, and one shared store of its part of y: about 30 instructions a
//    warp for 128 (channel, state) pairs, where the old kernel (one thread
//    per (channel, state), a 4-level shuffle tree and expf) issued about
//    55 for 32.  After each chunk the block sums the L parts of y, adds
//    D u and writes y in 128-byte rows.
//  * Grouped steps.  A lane loads kGroup steps, then takes their
//    exponentials, then runs the h chain, then stores: a shuffle, a branch
//    or a store inside a step kept the compiler from moving the next
//    step's loads above it, and each step ran as one dependent chain
//    (~260 clocks a step at one warp per SM sub-partition; PERF.md).
//  * The exponential is ex2.approx.ftz(dt * A * log2(e)), A scaled once per
//    thread: one MUFU.EX2 where expf added range reduction.  Its error is
//    2 ulp of the result plus the rounding of the product (|x| * 2^-24 in
//    the exponent: below 1e-6 relative for |dt * A| < 10, the model's
//    inputs); a result below 2^-126 flushes to 0, which changes h by less
//    than 1e-38 of its size.
//  * Double-buffered staging: u, dt, B and C of the next kStage steps go to
//    shared memory by cp.async (16, 8 or 4 bytes a copy, the widest that
//    the pointers, strides and row lengths allow; element loads where none
//    does) while the block steps through the current ones.  (scan_common.cuh
//    holds the staging and the exponential, shared with the backward.)
//  * A split time axis.  Where batch x channel tiles leave the SMs idle (a
//    long S at batch 1), the wrapper splits S into nseg segments.  Pass-A
//    blocks scan segments 0..nseg-2 from zero (no y, no C) and publish
//    their end state and decay exp(A * sum dt); pass-B blocks combine the
//    carries of the segments before theirs in order, carry =
//    P[s] * carry + h_end[s], and rescan their segment from the true
//    carry-in, writing y, the checkpoints and h_last.  Cost: the scan's
//    B*S*di*N exponentials grow by the pass-A share, (nseg - 1) / nseg of
//    them, plus nseg - 1 per (b, d, n) for the decays.  Blocks take a
//    ticket from an atomic counter, pass A first, so a pass-B block only
//    waits for blocks that are already running and never wait themselves.
//  * Any S and di (ragged channel tiles and chunks masked), 1 <= N <= 16
//    (states past N read A, B and C as 0, so h stays 0 there), int64
//    offsets; nothing is asserted about the shapes.

#include "scan_common.cuh"

namespace {

using namespace scan;

constexpr int kCh = 32;       // channels per block
constexpr int kStage = 32;    // time steps staged per buffer
constexpr int kMaxN = 16;     // largest state size; B, C rows in shared
constexpr int kNS = 4;        // states per thread
constexpr int kGroup = 4;     // steps a lane loads before it computes
                              // (4 beat 2 and 8 here: tools/scan_ab.py)

// kGroup steps of one lane: every load first, then the exponentials, then
// the h chain, then the stores of y's parts.  A store to shared memory in
// the middle of a step keeps the compiler from moving the next step's
// loads above it, so without the grouping each step runs as one dependent
// chain (shared load, exponential, FMAs: ~260 clocks a step measured).
template <typename T, int G, bool kWithY>
__device__ __forceinline__ void scan_steps(const T* su, const T* sdt,
                                           const T* sB, const T* sC, int r,
                                           int c, int n0, const float* a2,
                                           float* h, float* y_out,
                                           int y_stride, float& sum_dt) {
  float ut[G], dtv[G], bv[G][kNS], cv[G][kNS], e[G][kNS], yv[G];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    ut[q] = to_f32(su[(r + q) * kCh + c]);
    dtv[q] = to_f32(sdt[(r + q) * kCh + c]);
    load4(sB + (r + q) * kMaxN + n0, bv[q]);
    if (kWithY) load4(sC + (r + q) * kMaxN + n0, cv[q]);
  }
#pragma unroll
  for (int q = 0; q < G; ++q) {
#pragma unroll
    for (int j = 0; j < kNS; ++j) e[q][j] = ex2(dtv[q] * a2[j]);
  }
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const float dtu = dtv[q] * ut[q];
    float yp = 0.0f;
#pragma unroll
    for (int j = 0; j < kNS; ++j) {
      h[j] = fmaf(e[q][j], h[j], dtu * bv[q][j]);
      if (kWithY) yp = fmaf(h[j], cv[q][j], yp);
    }
    yv[q] = yp;
    if (!kWithY) sum_dt += dtv[q];
  }
  if (kWithY) {
#pragma unroll
    for (int q = 0; q < G; ++q) y_out[(r + q) * y_stride] = yv[q];
  }
}

struct FwdParams {
  const void* u;
  const void* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* D;
  float* y;
  float* h_last;
  float* ckpt;     // (batch, n_ckpt, di, N) or null
  float* carry;    // split: decay then end state, each (nseg-1, batch, di, N)
  int* sync;       // split: [0] the ticket counter, then one flag per
                   // (segment, batch row, tile) of pass A; zeroed
  int64_t batch, S, di;
  int N;
  int64_t b_sb, b_st, c_sb, c_st;
  int64_t ckpt_every, n_ckpt;
  int64_t seg_len;
  int nseg, tiles;
  int vec_ud, vec_b, vec_c;
};

template <typename T, int L>
__global__ void __launch_bounds__(kCh * L, 4)
    ssm_scan_fwd_kernel(FwdParams p) {
  constexpr int kThreads = kCh * L;
  __shared__ __align__(16) T s_u[2][kStage * kCh];
  __shared__ __align__(16) T s_dt[2][kStage * kCh];
  __shared__ __align__(16) T s_B[2][kStage * kMaxN];
  __shared__ __align__(16) T s_C[2][kStage * kMaxN];
  __shared__ __align__(16) float s_y[kStage * kThreads];   // y per lane
  __shared__ int s_ticket;

  const int tid = threadIdx.x;
  const int c = tid / L;
  const int l = tid % L;
  int64_t blk = blockIdx.x;
  if (p.nseg > 1) {
    if (tid == 0) s_ticket = atomicAdd(p.sync, 1);
    __syncthreads();
    blk = s_ticket;
  }
  const int64_t rows = p.batch * p.tiles;
  const int64_t n_pass_a = static_cast<int64_t>(p.nseg - 1) * rows;
  const bool pass_a = blk < n_pass_a;
  const int64_t rest = pass_a ? blk : blk - n_pass_a;
  const int seg = static_cast<int>(rest / rows);
  const int64_t b = (rest % rows) / p.tiles;
  const int tile = static_cast<int>((rest % rows) % p.tiles);
  const int64_t d0 = static_cast<int64_t>(tile) * kCh;
  const int64_t d = d0 + c;
  const bool dlive = d < p.di;
  const int N = p.N;
  const int n0 = l * kNS;

  float a2[kNS];
#pragma unroll
  for (int j = 0; j < kNS; ++j) {
    a2[j] = dlive && n0 + j < N ? p.A[d * N + n0 + j] * kLog2e : 0.0f;
  }
  const int64_t ts = seg * p.seg_len;
  const int64_t te = ts + p.seg_len < p.S ? ts + p.seg_len : p.S;
  const int64_t plane = p.batch * p.di * N;   // one segment's carries
  const int64_t hoff = (b * p.di + d) * N + n0;

  float h[kNS] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (!pass_a && seg > 0) {
    // the carry-in: the end states of the segments before this one, in
    // order, each through its successors' decay
    for (int s2 = 0; s2 < seg; ++s2) {
      const int* flag = p.sync + 1 + (static_cast<int64_t>(s2) * p.batch + b)
                                         * p.tiles + tile;
      long long spins = 0;
      while (ld_acquire(flag) == 0) {
        __nanosleep(64);
        if (++spins > (1LL << 26)) __trap();   // a pass-A block never came
      }
      if (dlive) {
        const float* P = p.carry + s2 * plane + hoff;
        const float* E = p.carry + (p.nseg - 1) * plane + s2 * plane + hoff;
#pragma unroll
        for (int j = 0; j < kNS; ++j) {
          if (n0 + j < N) h[j] = __ldcg(P + j) * h[j] + __ldcg(E + j);
        }
      }
    }
  }

  // kernel parameters the loops read, as locals: a lambda that captured
  // p by reference would put p on the stack and reload it every step
  const int64_t di = p.di, b_st = p.b_st, c_st = p.c_st;
  const int64_t every = p.ckpt_every, n_ckpt = p.n_ckpt;
  const int vec_ud = p.vec_ud, vec_b = p.vec_b, vec_c = p.vec_c;
  float* const y = p.y;
  float* const ckpt = p.ckpt;
  const T* ub = static_cast<const T*>(p.u) + b * p.S * di + d0;
  const T* dtb = static_cast<const T*>(p.dt) + b * p.S * di + d0;
  const T* Bb = static_cast<const T*>(p.Bm) + b * p.b_sb;
  const T* Cb = static_cast<const T*>(p.Cm) + b * p.c_sb;
  const int dvalid = di - d0 < kCh ? static_cast<int>(di - d0) : kCh;
  const int64_t nsteps = te > ts ? te - ts : 0;
  const int nchunks = static_cast<int>((nsteps + kStage - 1) / kStage);

  auto issue = [=](int k) {
    const int64_t t0 = ts + static_cast<int64_t>(k) * kStage;
    const int steps = te - t0 < kStage ? static_cast<int>(te - t0) : kStage;
    const int buf = k & 1;
    stage<T, kCh>(s_u[buf], ub + t0 * di, di, steps, dvalid, vec_ud, tid,
                  kThreads);
    stage<T, kCh>(s_dt[buf], dtb + t0 * di, di, steps, dvalid, vec_ud, tid,
                  kThreads);
    stage<T, kMaxN>(s_B[buf], Bb + t0 * b_st, b_st, steps, N, vec_b, tid,
                    kThreads);
    if (!pass_a) {
      stage<T, kMaxN>(s_C[buf], Cb + t0 * c_st, c_st, steps, N, vec_c, tid,
                      kThreads);
    }
    cp_commit();
  };

  int64_t next_ck = ckpt == nullptr ? -1 : (ts + every - 1) / every * every;
  float sum_dt = 0.0f;
  // the lane's channel in the y pass: kThreads is a multiple of kCh
  const int col = tid % kCh;
  const float dcol = col < dvalid ? p.D[d0 + col] : 0.0f;
  if (nchunks > 0) issue(0);
  for (int k = 0; k < nchunks; ++k) {
    cp_wait_all();
    // chunk k is in; every thread is past chunk k - 1's y pass, so its
    // buffer takes chunk k + 1, which loads while this chunk steps
    __syncthreads();
    if (k + 1 < nchunks) issue(k + 1);
    const int buf = k & 1;
    const int64_t t0 = ts + static_cast<int64_t>(k) * kStage;
    const int steps = te - t0 < kStage ? static_cast<int>(te - t0) : kStage;
    const T* su = s_u[buf];
    const T* sdt = s_dt[buf];
    const T* sB = s_B[buf];
    const T* sC = s_C[buf];
    float* const y_out = s_y + tid;
    if (pass_a) {
      int r = 0;
      for (; r + kGroup <= steps; r += kGroup) {
        scan_steps<T, kGroup, false>(su, sdt, sB, sC, r, c, n0, a2, h,
                                     y_out, kThreads, sum_dt);
      }
      for (; r < steps; ++r) {
        scan_steps<T, 1, false>(su, sdt, sB, sC, r, c, n0, a2, h, y_out,
                                kThreads, sum_dt);
      }
      continue;
    }
    for (int r = 0; r < steps;) {
      // a checkpoint falls before step t0 + r: write it, then run the
      // steps up to the next one
      if (t0 + r == next_ck) {
        if (dlive) {
          float* ck = ckpt + ((b * n_ckpt + next_ck / every) * di + d) * N
                      + n0;
#pragma unroll
          for (int j = 0; j < kNS; ++j) {
            if (n0 + j < N) ck[j] = h[j];
          }
        }
        next_ck += every;
      }
      const int r_end = next_ck >= 0 && next_ck - t0 < steps
                            ? static_cast<int>(next_ck - t0) : steps;
      for (; r + kGroup <= r_end; r += kGroup) {
        scan_steps<T, kGroup, true>(su, sdt, sB, sC, r, c, n0, a2, h, y_out,
                                    kThreads, sum_dt);
      }
      for (; r < r_end; ++r) {
        scan_steps<T, 1, true>(su, sdt, sB, sC, r, c, n0, a2, h, y_out,
                               kThreads, sum_dt);
      }
    }
    __syncthreads();
    // y of the chunk: the channel's L lane sums plus D u, 128-byte rows
    if (col < dvalid) {
      float* yb = y + (b * p.S + t0) * di + d0 + col;
      for (int r = tid / kCh; r < steps; r += kThreads / kCh) {
        const float* part = s_y + r * kThreads + col * L;
        float s = 0.0f;
#pragma unroll
        for (int q = 0; q < L; ++q) s += part[q];
        yb[r * di] = fmaf(dcol, to_f32(su[r * kCh + col]), s);
      }
    }
  }

  if (pass_a) {
    // publish this segment's decay and end state, then its flag
    if (dlive) {
      float* P = p.carry + seg * plane + hoff;
      float* E = p.carry + (p.nseg - 1) * plane + seg * plane + hoff;
#pragma unroll
      for (int j = 0; j < kNS; ++j) {
        if (n0 + j < N) {
          P[j] = ex2(a2[j] * sum_dt);
          E[j] = h[j];
        }
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      int* flag = p.sync + 1 + (static_cast<int64_t>(seg) * p.batch + b)
                                   * p.tiles + tile;
      asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(flag), "r"(1)
                   : "memory");
    }
    return;
  }
  if (seg == p.nseg - 1 && dlive) {
#pragma unroll
    for (int j = 0; j < kNS; ++j) {
      if (n0 + j < N) p.h_last[hoff + j] = h[j];
    }
  }
}

template <typename T>
int launch(FwdParams p, cudaStream_t s) {
  const int64_t es = sizeof(T);
  int L = 1;
  while (L * kNS < p.N) L *= 2;
  p.tiles = static_cast<int>((p.di + kCh - 1) / kCh);
  const int64_t row = p.S * p.di * es;
  p.vec_ud = copy_width(p.u, p.di * es, p.di * es, row);
  const int vdt = copy_width(p.dt, p.di * es, p.di * es, row);
  if (vdt < p.vec_ud) p.vec_ud = vdt;
  p.vec_b = copy_width(p.Bm, p.N * es, p.b_st * es, p.b_sb * es);
  p.vec_c = copy_width(p.Cm, p.N * es, p.c_st * es, p.c_sb * es);
  const int64_t blocks =
      static_cast<int64_t>(2 * p.nseg - 1) * p.batch * p.tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (L) {
    case 1: ssm_scan_fwd_kernel<T, 1><<<grid, kCh * 1, 0, s>>>(p); break;
    case 2: ssm_scan_fwd_kernel<T, 2><<<grid, kCh * 2, 0, s>>>(p); break;
    case 4: ssm_scan_fwd_kernel<T, 4><<<grid, kCh * 4, 0, s>>>(p); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (u, dt, B and C).  ckpt may be null
// (no checkpoints); with nseg > 1, carry holds 2 (nseg-1) batch di N floats
// and sync 1 + (nseg-1) batch ceil(di/32) zeroed ints.  Returns
// cudaGetLastError() after the launch (0 = launched).
int ssm_scan_launch(int dtype, const void* u, const void* dt, const void* A,
                    const void* Bm, const void* Cm, const void* D, void* y,
                    void* h_last, void* ckpt, void* carry, void* sync,
                    int64_t batch, int64_t S, int64_t di, int N, int64_t b_sb,
                    int64_t b_st, int64_t c_sb, int64_t c_st,
                    int64_t ckpt_every, int64_t n_ckpt, int nseg,
                    int64_t seg_len, void* stream) {
  if (N < 1 || N > kMaxN || batch < 1 || di < 1 || S < 0 || nseg < 1 ||
      (nseg > 1 && (carry == nullptr || sync == nullptr)) ||
      static_cast<int64_t>(nseg) * seg_len < S ||
      (ckpt != nullptr && ckpt_every < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FwdParams p;
  p.u = u; p.dt = dt; p.A = static_cast<const float*>(A);
  p.Bm = Bm; p.Cm = Cm; p.D = static_cast<const float*>(D);
  p.y = static_cast<float*>(y); p.h_last = static_cast<float*>(h_last);
  p.ckpt = static_cast<float*>(ckpt); p.carry = static_cast<float*>(carry);
  p.sync = static_cast<int*>(sync);
  p.batch = batch; p.S = S; p.di = di; p.N = N;
  p.b_sb = b_sb; p.b_st = b_st; p.c_sb = c_sb; p.c_st = c_st;
  p.ckpt_every = ckpt_every; p.n_ckpt = n_ckpt;
  p.seg_len = seg_len; p.nseg = nseg;
  p.tiles = 0; p.vec_ud = p.vec_b = p.vec_c = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
