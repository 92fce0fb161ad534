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
// ceil(S / T), di, N) fp32, T <= 8.  Outputs fp32: du, ddt (batch, S, di)
// written; dA (di, N), dD (di,), dB, dC (batch, S, N) contiguous, zeroed
// by the caller and added to with atomics.
//
// Bound.  Bytes: u, dt, gy and the checkpoints read, du and ddt written
// (B, C, A, D, gh and their gradients are small); one exponential and ~19
// fp32 operations per (b, t, d, n).  At hymba-1.5b's train shape the bytes
// bound it; what a warp issues per step (not the bytes) decides how near
// the kernel comes: ~135 instructions a warp-step, four warps a block,
// four blocks an SM (128 registers a thread).
//
// Design.
//  * A split time axis in one launch.  The backward's carry is linear and
//    needs no h (G_t = gy_t C_t + carry, carry <- dA_t G_t), so S splits
//    into nseg segments whose bounds fall on checkpoints (seg_ck chunks of
//    T steps each).  Pass-A blocks (segments 1..nseg-1) run only that
//    chain over their segment from a zero carry -- dt, gy and C read, one
//    exponential and two fp32 operations per (b, t, d, n) -- and publish
//    its carry-out and its decay exp(A sum dt).  Pass-B blocks combine the
//    carries of the segments after theirs, from the last: c = out[s'] +
//    P[s'] c, from gh or zero, then rerun and sweep their segment from that
//    carry-in.  Blocks take a ticket from an atomic counter, pass A first,
//    so a pass-B block waits only on blocks that are already running.
//  * A chunk in registers.  One block per (segment, batch row, 32-channel
//    tile), four states of a channel a thread (L = ceil(N / 4) lanes a
//    channel).  A chunk of T <= 8 steps (a shorter one padded with dt = u
//    = gy = B = C = 0, which leave h and the carry as they are and add
//    nothing) is swept in two halves of 4 steps, the later first: each
//    half reruns its steps from the state before it into registers (h_t
//    and dA_t, 32 a thread), then sweeps them backward; the state before
//    the later half comes from a rerun of the earlier one that keeps
//    nothing.  Twelve reruns a chunk instead of eight, but 32 registers
//    fewer than keeping all eight steps, which spilled at four blocks an
//    SM (tools/scan_ab.py).  No store inside a step: a store keeps the
//    compiler from moving the next step's shared loads above it; a half's
//    outputs wait in registers and are stored after it.
//  * Sums across threads by shuffles.  A channel's du and ddt parts are
//    summed over its L lanes (two shuffles at L = 4) and written by the
//    lanes that hold them.  A thread's 8 dB and dC terms of a step are
//    summed over the warp's channels by a halving butterfly (each level
//    sends half its values and keeps half: 7 shuffles for 8 values over 8
//    channels; faster here than 16-byte stores to shared memory summed
//    once a chunk), then over the block's warps through shared memory once
//    a chunk, and added to dB, dC with one float4 atomicAdd per (step, four
//    states): ceil(di / 32) adds an address, a quarter as many instructions
//    as scalar adds (the adds cost 1-4 % of the time).  Their order varies
//    from run to run, so dB, dC (and dA, dD, added once a block) are
//    repeatable only to fp32 rounding.
//  * Staging.  The chunk before this one (u, dt, gy, B, C and its
//    checkpoint; pass A: dt, gy, C) loads by cp.async while this one runs,
//    double-buffered in static shared memory (16 KB a block at fp32, N 16),
//    with the copy width fixed at compile time once per tile
//    (scan_common.cuh's stage_fixed: a division by a runtime width per
//    copied piece cost a fifth of the time).  Bulk copies (cp.async.bulk
//    on an mbarrier, a row a copy from one warp), a third buffer and
//    rounds of two chunks were slower here.
//  * Any S and di (ragged channel tiles and chunks masked), 1 <= N <= 16,
//    int64 offsets.

#include <type_traits>

#include "scan_common.cuh"

namespace {

using namespace scan;

constexpr int kCh = 32;       // channels per block
constexpr int kMaxN = 16;     // largest state size
constexpr int kNS = 4;        // states per thread
constexpr int kT = 8;         // a chunk's steps: the largest spacing taken
constexpr int kHalf = kT / 2;  // steps a half-chunk holds in registers
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int L>
struct Smem {
  struct Buf {
    float gy[kT * kCh];
    float ck[kCh * kMaxN];     // the chunk's checkpoint, [channel][state]
    T u[kT * kCh];
    T dt[kT * kCh];
    T B[kT * kMaxN];
    T C[kT * kMaxN];
  };
  Buf buf[2];
  float red[kT][L][2 * kMaxN];   // [step][warp][dB states | dC states]
};

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
  float* carry;        // split: decay then carry-out, each (nseg-1, batch,
                       // di, N), segments 1..nseg-1
  int* sync;           // split: [0] the ticket counter, then one flag per
                       // (segment 1..nseg-1, batch row, tile); zeroed
  int64_t batch, S, di;
  int N;
  int64_t b_sb, b_st, c_sb, c_st;
  int64_t T, n_ckpt, seg_ck;
  int nseg, tiles;
  int vec_ud, vec_gy, vec_b, vec_c, vec_ck, vec_dbc;
};

// rows [from, kT) of a staged [kT][W] tile set to zero (a ragged chunk)
template <typename T, int W>
__device__ __forceinline__ void zero_rows(T* s, int from, int tid,
                                          int nthreads) {
  for (int i = from * W + tid; i < kT * W; i += nthreads) s[i] = zero_of<T>();
}

// The eight dB, dC terms v of a thread summed over the warp's channels
// (lane bits 2..4 at L = 4; 1..4 at L = 2; 0..4 at L = 1).  Three halving
// levels leave one value a thread: term (lane >> 2) & 7 of v, summed over
// the channels that differ in lane bits 2..4; plain levels add the rest.
template <int L>
__device__ __forceinline__ float sum_channels(float v[8], int lane) {
#pragma unroll
  for (int lvl = 0; lvl < 3; ++lvl) {
    const int m = 16 >> lvl;
    const int k = 4 >> lvl;
    const bool hi = (lane & m) != 0;
#pragma unroll
    for (int i = 0; i < k; ++i) {
      const float send = hi ? v[i] : v[i + k];
      const float keep = hi ? v[i + k] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, m);
    }
  }
  float r = v[0];
#pragma unroll
  for (int m = 2; m >= L; m >>= 1) r += __shfl_xor_sync(kFull, r, m);
  return r;
}

template <typename T, int L>
__global__ void __launch_bounds__(kCh * L, 4)
    ssm_scan_bwd_kernel(BwdParams p) {
  constexpr int kThreads = kCh * L;
  __shared__ __align__(16) Smem<T, L> sm;
  __shared__ int s_ticket;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c = tid / L;
  const int l = tid % L;
  int64_t blk = blockIdx.x;
  if (p.nseg > 1) {
    if (tid == 0) s_ticket = atomicAdd(p.sync, 1);
    __syncthreads();
    blk = s_ticket;
  }
  // tickets: pass A (segments 1..nseg-1), then pass B from the last
  // segment (which waits on nothing) to the first
  const int64_t rows = p.batch * p.tiles;
  const int64_t n_pass_a = static_cast<int64_t>(p.nseg - 1) * rows;
  const bool pass_a = blk < n_pass_a;
  const int64_t rest = pass_a ? blk : blk - n_pass_a;
  const int seg = pass_a ? 1 + static_cast<int>(rest / rows)
                         : p.nseg - 1 - static_cast<int>(rest / rows);
  const int64_t b = (rest % rows) / p.tiles;
  const int tile = static_cast<int>((rest % rows) % p.tiles);
  const int64_t d0 = static_cast<int64_t>(tile) * kCh;
  const int64_t d = d0 + c;
  const bool dlive = d < p.di;
  const int N = p.N;
  const int n0 = l * kNS;
  const int dvalid = p.di - d0 < kCh ? static_cast<int>(p.di - d0) : kCh;

  float a2[kNS];
#pragma unroll
  for (int j = 0; j < kNS; ++j) {
    a2[j] = dlive && n0 + j < N ? p.A[d * N + n0 + j] * kLog2e : 0.0f;
  }
  const int64_t plane = p.batch * p.di * N;   // one segment's carries
  const int64_t hoff = (b * p.di + d) * N + n0;

  // kernel parameters the loops read, as locals: a lambda that captured
  // p by reference would put p on the stack and reload it every step
  const int64_t S = p.S, di = p.di, b_st = p.b_st, c_st = p.c_st;
  const int64_t Tc = p.T, n_ckpt = p.n_ckpt;
  const int vec_ud = p.vec_ud, vec_gy = p.vec_gy, vec_b = p.vec_b,
            vec_c = p.vec_c, vec_ck = p.vec_ck;
  const T* ub = static_cast<const T*>(p.u) + b * S * di + d0;
  const T* dtb = static_cast<const T*>(p.dt) + b * S * di + d0;
  const float* gyb = p.gy + b * S * di + d0;
  const T* Bb = static_cast<const T*>(p.Bm) + b * p.b_sb;
  const T* Cb = static_cast<const T*>(p.Cm) + b * p.c_sb;
  const float* ckb = p.ckpt + (b * n_ckpt * di + d0) * N;
  const int64_t k_lo = seg * p.seg_ck;
  const int64_t k_hi = k_lo + p.seg_ck < n_ckpt ? k_lo + p.seg_ck : n_ckpt;

  // chunk k's inputs into buffer `slot` (pass A: dt, gy and C only)
  auto issue = [=](int64_t k, int slot) {
    auto& bf = sm.buf[slot];
    const int64_t t0 = k * Tc;
    const int steps = static_cast<int>(S - t0 < Tc ? S - t0 : Tc);
    stage_fixed<T, kCh>(bf.dt, dtb + t0 * di, di, steps, dvalid, vec_ud,
                        tid, kThreads);
    stage_fixed<float, kCh>(bf.gy, gyb + t0 * di, di, steps, dvalid, vec_gy,
                            tid, kThreads);
    stage_fixed<T, kMaxN>(bf.C, Cb + t0 * c_st, c_st, steps, N, vec_c, tid,
                          kThreads);
    if (!pass_a) {
      stage_fixed<T, kCh>(bf.u, ub + t0 * di, di, steps, dvalid, vec_ud,
                          tid, kThreads);
      stage_fixed<T, kMaxN>(bf.B, Bb + t0 * b_st, b_st, steps, N, vec_b,
                            tid, kThreads);
      stage_fixed<float, kMaxN>(bf.ck, ckb + k * di * N, N, dvalid, N,
                                vec_ck, tid, kThreads);
    }
    if (steps < kT) {
      zero_rows<T, kCh>(bf.dt, steps, tid, kThreads);
      zero_rows<float, kCh>(bf.gy, steps, tid, kThreads);
      zero_rows<T, kMaxN>(bf.C, steps, tid, kThreads);
      if (!pass_a) {
        zero_rows<T, kCh>(bf.u, steps, tid, kThreads);
        zero_rows<T, kMaxN>(bf.B, steps, tid, kThreads);
      }
    }
  };
  // the chunks of this segment walk down from k_hi - 1, alternating
  // buffers; a chunk's copies start while the chunk after it runs, one
  // commit group a chunk (empty past the segment's first chunk).  The
  // loops start one pass early, a pass that only issues, so that `issue`
  // is inlined once a loop (a second site cost a third of the kernel's
  // build time)
  auto ahead = [=](int64_t k, int slot) {
    if (k >= k_lo) issue(k, slot);
    cp_commit();
  };
  float carry[kNS] = {0.0f, 0.0f, 0.0f, 0.0f};

  if (pass_a) {
    // the G chain of this segment from a zero carry at its end
    float sum_dt = 0.0f;
    int slot = 1;
    for (int64_t k = k_hi; k >= k_lo; --k) {
      ahead(k - 1, slot ^ 1);
      slot ^= 1;
      if (k == k_hi) continue;   // the first pass only issues
      cp_wait_prev();
      __syncthreads();
      const auto& bf = sm.buf[slot ^ 1];
#pragma unroll
      for (int q = kT - 1; q >= 0; --q) {
        const float g = bf.gy[q * kCh + c];
        const float dtv = to_f32(bf.dt[q * kCh + c]);
        float cv[kNS];
        load4(bf.C + q * kMaxN + n0, cv);
#pragma unroll
        for (int j = 0; j < kNS; ++j) {
          carry[j] = ex2(dtv * a2[j]) * fmaf(g, cv[j], carry[j]);
        }
        sum_dt += dtv;
      }
      __syncthreads();   // the next chunk's copies reuse the other buffer
    }
    // publish this segment's decay and carry-out, then its flag
    if (dlive) {
      float* P = p.carry + (seg - 1) * plane + hoff;
      float* E = p.carry + (p.nseg - 1) * plane + (seg - 1) * plane + hoff;
#pragma unroll
      for (int j = 0; j < kNS; ++j) {
        if (n0 + j < N) {
          P[j] = ex2(a2[j] * sum_dt);
          E[j] = carry[j];
        }
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      int* flag = p.sync + 1 + (static_cast<int64_t>(seg - 1) * p.batch + b)
                                   * p.tiles + tile;
      asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(flag), "r"(1)
                   : "memory");
    }
    return;
  }

  // pass B: the carry-in at this segment's end, from gh and the segments
  // after this one, the last first
#pragma unroll
  for (int j = 0; j < kNS; ++j) {
    carry[j] = dlive && n0 + j < N && p.gh != nullptr ? p.gh[hoff + j]
                                                      : 0.0f;
  }
  for (int s2 = p.nseg - 1; s2 > seg; --s2) {
    const int* flag = p.sync + 1 + (static_cast<int64_t>(s2 - 1) * p.batch
                                    + b) * p.tiles + tile;
    long long spins = 0;
    while (ld_acquire(flag) == 0) {
      __nanosleep(64);
      if (++spins > (1LL << 26)) __trap();   // a pass-A block never came
    }
    if (dlive) {
      const float* P = p.carry + (s2 - 1) * plane + hoff;
      const float* E = p.carry + (p.nseg - 1) * plane + (s2 - 1) * plane
                       + hoff;
#pragma unroll
      for (int j = 0; j < kNS; ++j) {
        if (n0 + j < N) {
          carry[j] = fmaf(__ldcg(P + j), carry[j], __ldcg(E + j));
        }
      }
    }
  }

  float dA_acc[kNS] = {0.0f, 0.0f, 0.0f, 0.0f};
  float dD_acc = 0.0f;
  const float dcol = dlive ? p.D[d] : 0.0f;
  float* const du = p.du;
  float* const ddt = p.ddt;
  float* const dB = p.dB;
  float* const dC = p.dC;
  const int vec_dbc = p.vec_dbc;
  // the lane that writes du (l 0) or ddt (l 1) of its channel
  float* const out_l = l == 0 ? du : ddt;
  // the dB, dC term a thread holds after sum_channels: which (0 dB, 1 dC)
  // and state, and whether it writes it (lanes that hold a copy do not)
  const int vidx = (lane >> 2) & 7;
  const int red_col = (vidx >> 2) * kMaxN + l * kNS + (vidx & 3);
  const bool red_writer = (lane & 3 & ~(L - 1)) == 0;
  const int ngroups = (N + kNS - 1) / kNS;   // groups of 4 states

  int slot = 1;
  for (int64_t k = k_hi; k >= k_lo; --k) {
    ahead(k - 1, slot ^ 1);
    slot ^= 1;
    if (k == k_hi) continue;   // the first pass only issues
    cp_wait_prev();
    __syncthreads();
    const auto& bf = sm.buf[slot ^ 1];
    const int64_t t0 = k * Tc;
    const int steps = static_cast<int>(S - t0 < Tc ? S - t0 : Tc);

    // the chunk in two halves of kHalf steps, the later first: each half
    // reruns its steps from the state before it into registers (h_t and
    // dA_t), then sweeps them backward; the state before the later half
    // comes from a rerun of the earlier one that keeps nothing
    float h0[kNS];
    load4(bf.ck + c * kMaxN + n0, h0);
#pragma unroll
    for (int j = 0; j < kNS; ++j) h0[j] = dlive ? h0[j] : 0.0f;
    const int64_t row0 = (b * S + t0) * di + d;
    auto rerun = [&](int q, const float* hin, float* hout, float* eout) {
      const float ut = to_f32(bf.u[q * kCh + c]);
      const float dtv = to_f32(bf.dt[q * kCh + c]);
      float bv[kNS];
      load4(bf.B + q * kMaxN + n0, bv);
      const float dtu = dtv * ut;
#pragma unroll
      for (int j = 0; j < kNS; ++j) {
        const float e = ex2(dtv * a2[j]);
        if (eout != nullptr) eout[j] = e;
        hout[j] = fmaf(e, hin[j], dtu * bv[j]);
      }
    };
    auto half = [&](auto q0c, const float* hstart) {
      constexpr int Q0 = decltype(q0c)::value;
      float hs[kHalf][kNS], es[kHalf][kNS], outv[kHalf], redv[kHalf];
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        rerun(Q0 + i, i > 0 ? hs[i - 1] : hstart, hs[i], es[i]);
      }
#pragma unroll
      for (int i = kHalf - 1; i >= 0; --i) {
        const int q = Q0 + i;
        const float g = bf.gy[q * kCh + c];
        const float ut = to_f32(bf.u[q * kCh + c]);
        const float dtv = to_f32(bf.dt[q * kCh + c]);
        float bv[kNS], cv[kNS], v[8];
        load4(bf.B + q * kMaxN + n0, bv);
        load4(bf.C + q * kMaxN + n0, cv);
        const float dtu = dtv * ut;
        float sB = 0.0f, sA = 0.0f;
#pragma unroll
        for (int j = 0; j < kNS; ++j) {
          const float hp = i > 0 ? hs[i - 1][j] : hstart[j];
          const float Gj = fmaf(g, cv[j], carry[j]);
          v[j] = Gj * dtu;               // dB term
          v[kNS + j] = g * hs[i][j];     // dC term
          sB = fmaf(Gj, bv[j], sB);
          const float w = Gj * (es[i][j] * hp);
          sA = fmaf(w, a2[j], sA);
          dA_acc[j] = fmaf(w, dtv, dA_acc[j]);
          carry[j] = es[i][j] * Gj;
        }
        const float x = dtv * sB;                    // du's
        const float y = fmaf(ut, sB, sA * kLn2);     // ddt's
        if (L == 1) {
          if (dlive && q < steps) {
            du[row0 + q * di] = fmaf(dcol, g, x);
            ddt[row0 + q * di] = y;
          }
          outv[i] = 0.0f;
        } else {
          const bool odd = (l & 1) != 0;
          float keep = (odd ? y : x) + __shfl_xor_sync(kFull, odd ? x : y, 1);
          if (L == 4) keep += __shfl_xor_sync(kFull, keep, 2);
          outv[i] = l == 0 ? fmaf(dcol, g, keep) : keep;
        }
        if (l == 0) dD_acc = fmaf(g, ut, dD_acc);
        redv[i] = sum_channels<L>(v, lane);
      }
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const int q = Q0 + i;
        if (L > 1 && dlive && q < steps && l < 2) {
          out_l[row0 + q * di] = outv[i];
        }
        if (red_writer) sm.red[q][warp][red_col] = redv[i];
      }
    };
    float hm[kNS];
#pragma unroll
    for (int j = 0; j < kNS; ++j) hm[j] = h0[j];
#pragma unroll
    for (int q = 0; q < kHalf; ++q) rerun(q, hm, hm, nullptr);
    half(std::integral_constant<int, kHalf>(), hm);
    half(std::integral_constant<int, 0>(), h0);
    __syncthreads();

    // dB, dC of the chunk: the block's warps summed, added over tiles
    for (int i = tid; i < steps * 2 * ngroups; i += kThreads) {
      const int r = i / (2 * ngroups);
      const int which = (i / ngroups) & 1;
      const int l4 = i % ngroups;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int w = 0; w < L; ++w) {
        const float4 v4 = *reinterpret_cast<const float4*>(
            &sm.red[r][w][which * kMaxN + l4 * kNS]);
        acc.x += v4.x; acc.y += v4.y; acc.z += v4.z; acc.w += v4.w;
      }
      float* dst = (which == 0 ? dB : dC) + (b * S + t0 + r) * N + l4 * kNS;
      if (vec_dbc) {
        atomicAdd(reinterpret_cast<float4*>(dst), acc);
      } else {
        const float av[kNS] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
        for (int j = 0; j < kNS; ++j) {
          if (l4 * kNS + j < N) atomicAdd(dst + j, av[j]);
        }
      }
    }
  }

  if (dlive) {
#pragma unroll
    for (int j = 0; j < kNS; ++j) {
      if (n0 + j < N) atomicAdd(p.dA + d * N + n0 + j, dA_acc[j]);
    }
    if (l == 0) atomicAdd(p.dD + d, dD_acc);
  }
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
  p.vec_ck = copy_width(p.ckpt, p.N * 4, p.N * 4, p.di * p.N * 4);
  const auto a16 = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  p.vec_dbc = p.N % kNS == 0 && a16(p.dB) && a16(p.dC);
  const int64_t blocks =
      static_cast<int64_t>(2 * p.nseg - 1) * p.batch * p.tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  int L = 1;
  while (L * kNS < p.N) L *= 2;
  switch (L) {
    case 1: ssm_scan_bwd_kernel<T, 1><<<grid, kCh * 1, 0, s>>>(p); break;
    case 2: ssm_scan_bwd_kernel<T, 2><<<grid, kCh * 2, 0, s>>>(p); break;
    case 4: ssm_scan_bwd_kernel<T, 4><<<grid, kCh * 4, 0, s>>>(p); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (u, dt, B and C).  1 <= T <= 8; S split
// into nseg segments of seg_len steps (a multiple of T; the last takes the
// rest); with nseg > 1, carry holds 2 (nseg-1) batch di N floats and sync
// 1 + (nseg-1) batch ceil(di/32) zeroed ints.  Returns cudaGetLastError()
// after the launch (0 = launched).
int ssm_scan_bwd_launch(int dtype, const void* u, const void* dt,
                        const void* A, const void* Bm, const void* Cm,
                        const void* D, const void* gy, const void* gh,
                        const void* ckpt, void* du, void* ddt, void* dA,
                        void* dB, void* dC, void* dD, void* carry, void* sync,
                        int64_t batch, int64_t S, int64_t di, int N,
                        int64_t b_sb, int64_t b_st, int64_t c_sb,
                        int64_t c_st, int64_t T, int nseg, int64_t seg_len,
                        void* stream) {
  if (N < 1 || N > kMaxN || batch < 1 || di < 1 || S < 0 || T < 1 ||
      T > kT || nseg < 1 || seg_len < T || seg_len % T != 0 ||
      static_cast<int64_t>(nseg) * seg_len < S ||
      (nseg > 1 && (carry == nullptr || sync == nullptr))) {
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
  p.carry = static_cast<float*>(carry); p.sync = static_cast<int*>(sync);
  p.batch = batch; p.S = S; p.di = di; p.N = N;
  p.b_sb = b_sb; p.b_st = b_st; p.c_sb = c_sb; p.c_st = c_st;
  p.T = T; p.n_ckpt = (S + T - 1) / T; p.seg_ck = seg_len / T;
  p.nseg = nseg;
  p.tiles = static_cast<int>((di + kCh - 1) / kCh);
  p.vec_ud = p.vec_gy = p.vec_b = p.vec_c = p.vec_ck = p.vec_dbc = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
