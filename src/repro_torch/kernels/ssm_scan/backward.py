"""Mamba-1 selective scan backward: one launch for the whole sequence.

The JAX package has no backward scan kernel: it differentiates
``src/repro/models/ssm.py::selective_scan_ref`` (``lax.scan``) by autodiff.
This module computes the same gradient from the forward's checkpoints
(:func:`.kernel.ssm_scan` with ``ckpt_every=T``).  With dA_t = exp(dt_t·A),
walking t from S down to 1, G the gradient in h_t (G_S from gh or zero):

  G_t     = gy_t·C_t + dA_{t+1}·G_{t+1}
  du_t    = Σ_n G_t·dt_t·B_t + D·gy_t
  ddt_t   = Σ_n G_t·(A·dA_t·h_{t−1} + u_t·B_t)
  dA      = Σ_{b,t} G_t·dt_t·dA_t·h_{t−1}
  dB_t[n] = Σ_d G_t·dt_t·u_t,   dC_t[n] = Σ_d gy_t·h_t
  dD      = Σ_{b,t} gy_t·u_t

:func:`ssm_scan_bwd` follows its tensors: on CUDA tensors it launches the
hand-written kernel (``csrc/ssm_scan_bwd.cu``: the time axis split into
segments on checkpoint bounds (:func:`.kernel.scan_bwd_segments`), a cheap
pass over each later segment's carry chain, then one block per (segment,
batch row, 32-channel tile) rerunning each checkpoint chunk into registers
from its checkpoint and sweeping it backward, the sums across threads by
shuffles) or raises; on CPU tensors it runs :func:`ssm_scan_bwd_plain`,
the same algebra in PyTorch.  The kernel adds dB and dC over its channel
tiles, and dA and dD over batch rows and segments, with fp32 atomics,
whose order varies from run to run: those four gradients are repeatable
only to fp32 rounding.  Every gradient is computed in fp32 and returned in
the dtype of its input.  On meta tensors nothing runs: :func:`ssm_scan_bwd`
returns empty meta gradients and notes the launch's operations
(:func:`ssm_scan_bwd_ops`) and bytes for the dry-run (:mod:`...meta`).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import meta
from ..rfast_update import dispatch
from .kernel import (_DTYPE_CODE, BWD_MAX_CKPT_EVERY, CKPT_EVERY,
                     MAX_STATE, SCAN_TILE, _sm_count, bwd_segment_length,
                     check_inputs, lanes, n_checkpoints, scan_bwd_segments)

__all__ = ["ssm_scan_bwd", "ssm_scan_bwd_plain", "ssm_scan_bwd_bytes",
           "ssm_scan_bwd_ops", "bwd_smem_bytes", "KERNEL_SOURCE",
           "META_SMS"]

KERNEL_SOURCE = Path(__file__).resolve().parent / "csrc" / "ssm_scan_bwd.cu"
META_SMS = 132       # the SMs of the card a dry-run describes (an H100)

_lib = None


def _library():
    global _lib
    if _lib is None:
        from .._build import load
        lib = load(KERNEL_SOURCE)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.ssm_scan_bwd_launch.argtypes = (
            [i32] + [vp] * 17 + [i64, i64, i64, i32] + [i64] * 5
            + [i32, i64, vp])
        lib.ssm_scan_bwd_launch.restype = i32
        _lib = lib
    return _lib


def bwd_smem_bytes(N: int, itemsize: int = 4) -> int:
    """Static shared memory one block of the kernel takes, as ptxas counts
    it, for inputs of ``itemsize`` bytes: two staging buffers, each a
    chunk's gy (8 steps × 32 channels, fp32), its checkpoint (32 × 16,
    fp32), u and dt (8 × 32, ``itemsize``), B and C (8 × 16,
    ``itemsize``); the dB, dC partials of the chunk, 8 steps × lanes(N)
    warps × 32 floats; and the block's ticket (4 bytes)."""
    steps = BWD_MAX_CKPT_EVERY
    buf = (steps * SCAN_TILE * 4 + SCAN_TILE * MAX_STATE * 4
           + 2 * steps * SCAN_TILE * itemsize
           + 2 * steps * MAX_STATE * itemsize)
    return 2 * buf + steps * lanes(N) * 2 * MAX_STATE * 4 + 4


def ssm_scan_bwd_bytes(Bsz: int, S: int, di: int, N: int, itemsize: int,
                       n_ckpt: int, with_h: bool = True) -> int:
    """Bytes the backward must move: u, dt, B and C read once
    (``itemsize``), gy, the ``n_ckpt`` checkpoints a batch row, gh, A and
    D read once (fp32), and du, ddt, dA, dB, dC and dD written once
    (fp32)."""
    return (Bsz * S * (2 * di + 2 * N) * itemsize
            + 4 * (Bsz * S * di + Bsz * n_ckpt * di * N
                   + (Bsz * di * N if with_h else 0) + di * N + di)
            + 4 * (2 * Bsz * S * di + di * N + 2 * Bsz * S * N + di))


def ssm_scan_bwd_ops(Bsz: int, S: int, di: int, N: int, segments: int = 1,
                     every: int = CKPT_EVERY) -> tuple[int, int]:
    """(fp32 operations, exponentials) of the backward.  Unsplit, the
    gradient's own work: per (b, t, d, n) the rerun's dt·A and h update
    (4); the sweep's G = gy·C + carry, gy·h, G·dt·u, G·B into du,
    dA·h_{t−1}, its product with G, that into ddt and into dA, dA·G for the
    next step (13); the d sums of dB and dC (2); and one exponential (the
    rerun's, kept for the sweep); per (b, t, d): dt·u twice, du's and
    ddt's multiply-adds and dD's (9).  Split in ``segments`` (as the
    kernel splits at checkpoint spacing ``every``), pass A adds for every
    step of segments 1.. per (b, t, d, n) dt·A, G = gy·C + carry and dA·G
    (4) and an exponential, per (b, t, d) its Σ dt (1), per (b, d, n) and
    such segment the decay's exponent and exponential; the pass-B blocks'
    combines add a multiply-add (2) per (b, d, n) for each pair of a
    segment and one after it.  The kernel's second rerun of each chunk's
    first four steps is a cost of keeping a chunk in registers, as its
    checkpoint spacing is, and is not counted."""
    ops, exps = Bsz * S * di * (19 * N + 9), Bsz * S * di * N
    if segments > 1 and S:
        seg_len = bwd_segment_length(S, segments, every)
        nseg = n_checkpoints(S, seg_len)
        steps_a = S - min(S, seg_len)
        planes = Bsz * di * N
        ops += (Bsz * steps_a * di * (4 * N + 1) + (nseg - 1) * planes
                + nseg * (nseg - 1) * planes)
        exps += Bsz * steps_a * di * N + (nseg - 1) * planes
    return ops, exps


def _as_dtypes(grads, like):
    return tuple(g.to(t.dtype) for g, t in zip(grads, like))


def ssm_scan_bwd_plain(u, dt, A, B, C, D, gy, gh, ckpt, *, ckpt_every: int,
                       segments: int = 1):
    """The kernel's algebra in PyTorch on any device.  S split as the
    kernel splits it into ``segments`` on checkpoint bounds: pass A runs
    each segment after the first from a zero carry (its carry-out and its
    decay exp(A·Σ dt)); the combine gives every segment's carry-in, from
    the last, c = out + P·c from gh or zero; pass B walks each checkpoint
    chunk from the last, the chunk's states and decays rerun from its
    checkpoint, then swept backward from its segment's carry-in.  Returns
    (du, ddt, dA, dB, dC, dD), each in its input's dtype."""
    if ckpt_every < 1:
        raise ValueError(f"ckpt_every must be >= 1, got {ckpt_every}")
    if segments < 1:
        raise ValueError(f"segments must be >= 1, got {segments}")
    f32 = torch.float32
    Bsz, S, di = u.shape
    N = A.shape[1]
    n_ck = n_checkpoints(S, ckpt_every)
    if tuple(ckpt.shape) != (Bsz, n_ck, di, N):
        raise ValueError(f"ssm_scan_bwd: checkpoints must be "
                         f"{(Bsz, n_ck, di, N)} at spacing {ckpt_every}, "
                         f"got {tuple(ckpt.shape)}")
    uf, dtf, Bf, Cf = (a.to(f32) for a in (u, dt, B, C))
    Af, Df, gy = A.to(f32), D.to(f32), gy.to(f32)
    du = torch.empty((Bsz, S, di), dtype=f32, device=u.device)
    ddt = torch.empty_like(du)
    dB = torch.empty((Bsz, S, N), dtype=f32, device=u.device)
    dC = torch.empty_like(dB)
    dA = torch.zeros((di, N), dtype=f32, device=u.device)
    seg_len = bwd_segment_length(S, segments, ckpt_every)
    nseg = max(1, n_checkpoints(S, seg_len))
    # pass A, then the combine: the carry at each segment's end
    carry = (torch.zeros((Bsz, di, N), dtype=f32, device=u.device)
             if gh is None else gh.to(f32))
    carry_in = [None] * nseg
    for s in range(nseg - 1, -1, -1):
        carry_in[s] = carry
        if s == 0:
            break
        t0, t1 = s * seg_len, min(S, (s + 1) * seg_len)
        out = torch.zeros_like(carry)
        for t in range(t1 - 1, t0 - 1, -1):
            out = (torch.exp(dtf[:, t, :, None] * Af)
                   * (gy[:, t, :, None] * Cf[:, t, None, :] + out))
        P = torch.exp(dtf[:, t0:t1].sum(1)[..., None] * Af)
        carry = out + P * carry
    # pass B: each segment's chunks from its carry-in
    seg_ck = seg_len // ckpt_every
    for k in range(n_ck - 1, -1, -1):
        if k == min(n_ck, (k // seg_ck + 1) * seg_ck) - 1:
            carry = carry_in[k // seg_ck]
        t0, t1 = k * ckpt_every, min(S, (k + 1) * ckpt_every)
        hs, es = [ckpt[:, k].to(f32)], []
        for t in range(t0, t1):
            es.append(torch.exp(dtf[:, t, :, None] * Af))
            hs.append(es[-1] * hs[-1]
                      + (dtf[:, t] * uf[:, t])[..., None] * Bf[:, t, None, :])
        for r in range(t1 - t0 - 1, -1, -1):
            t = t0 + r
            g, dtt, ut = gy[:, t], dtf[:, t], uf[:, t]
            G = g[..., None] * Cf[:, t, None, :] + carry        # (B, di, N)
            sB = (G * Bf[:, t, None, :]).sum(-1)
            q = G * es[r] * hs[r]
            du[:, t] = dtt * sB + Df * g
            ddt[:, t] = (q * Af).sum(-1) + ut * sB
            dA += (q * dtt[..., None]).sum(0)
            dB[:, t] = (G * (dtt * ut)[..., None]).sum(1)
            dC[:, t] = (g[..., None] * hs[r + 1]).sum(1)
            carry = es[r] * G
    dD = (gy * uf).sum((0, 1))
    return _as_dtypes((du, ddt, dA, dB, dC, dD), (u, dt, A, B, C, D))


def ssm_scan_bwd(u, dt, A, B, C, D, gy, gh, ckpt, *, ckpt_every: int,
                 segments: int | None = None):
    """Gradients (du, ddt, dA, dB, dC, dD) of Σ y·gy + Σ h_last·gh (gh may
    be None) from the forward's checkpoints at spacing ``ckpt_every``
    (at most ``BWD_MAX_CKPT_EVERY``), each in its input's dtype.  On CUDA
    tensors the Hopper kernel runs (or this raises on what it does not
    take), its time axis split into ``segments`` (default:
    :func:`.kernel.scan_bwd_segments` of the shape and the card); on CPU
    tensors, :func:`ssm_scan_bwd_plain` (unsplit unless ``segments`` is
    given); on meta tensors, empty meta gradients and a noted launch (its
    operations at the split an H100 would take)."""
    if meta.is_meta(u):
        check_inputs(u, dt, A, B, C, D, "ssm_scan_bwd")
        Bsz, S, di = u.shape
        N = A.shape[1]
        if segments is None:
            segments = scan_bwd_segments(Bsz, S, di, N, META_SMS)
        meta.note("ssm_scan_bwd",
                  flops=ssm_scan_bwd_ops(Bsz, S, di, N, segments,
                                         ckpt_every)[0],
                  nbytes=ssm_scan_bwd_bytes(
                      Bsz, S, di, N, u.element_size(),
                      n_checkpoints(S, ckpt_every), gh is not None))
        return tuple(torch.empty_like(t) for t in (u, dt, A, B, C, D))
    if u.device.type == "cpu":
        return ssm_scan_bwd_plain(u, dt, A, B, C, D, gy, gh, ckpt,
                                  ckpt_every=ckpt_every,
                                  segments=segments or 1)
    if u.device.type != "cuda":
        raise ValueError(f"ssm_scan_bwd runs on cuda or cpu tensors, got "
                         f"{u.device}")
    dtype = check_inputs(u, dt, A, B, C, D, "ssm_scan_bwd")
    Bsz, S, di = u.shape
    N = A.shape[1]
    if not 1 <= ckpt_every <= BWD_MAX_CKPT_EVERY:
        raise ValueError(
            f"ssm_scan_bwd kernel takes checkpoints every 1 to "
            f"{BWD_MAX_CKPT_EVERY} steps (a chunk in registers), got "
            f"ckpt_every={ckpt_every}")
    n_ck = n_checkpoints(S, ckpt_every)
    f32, dev = torch.float32, u.device
    for name, t, shape in (("gy", gy, (Bsz, S, di)),
                           ("gh", gh, (Bsz, di, N)),
                           ("ckpt", ckpt, (Bsz, n_ck, di, N))):
        if t is None and name == "gh":
            continue
        if t.device != dev:
            raise ValueError(f"ssm_scan_bwd kernel needs {name} on {dev}; it "
                             f"is on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"ssm_scan_bwd: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    if ckpt.dtype != f32 or not ckpt.is_contiguous():
        raise ValueError("ssm_scan_bwd kernel takes contiguous float32 "
                         "checkpoints")
    if segments is None:
        segments = scan_bwd_segments(Bsz, S, di, N, _sm_count(dev.index))
    if segments < 1:
        raise ValueError(f"segments must be >= 1, got {segments}")
    gy = gy.to(f32).contiguous()
    gh = None if gh is None else gh.to(f32).contiguous()
    du = torch.empty((Bsz, S, di), dtype=f32, device=dev)
    ddt = torch.empty_like(du)
    dA = torch.zeros((di, N), dtype=f32, device=dev)
    dB = torch.zeros((Bsz, S, N), dtype=f32, device=dev)
    dC = torch.zeros_like(dB)
    dD = torch.zeros((di,), dtype=f32, device=dev)
    if Bsz and di:
        seg_len = bwd_segment_length(S, segments, ckpt_every)
        nseg = max(1, n_checkpoints(S, seg_len))
        carry = sync = None
        if nseg > 1:
            carry = torch.empty(2 * (nseg - 1) * Bsz * di * N, dtype=f32,
                                device=dev)
            sync = torch.zeros(1 + (nseg - 1) * Bsz * -(-di // SCAN_TILE),
                               dtype=torch.int32, device=dev)
        D = D.to(f32).contiguous()
        ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
        err = _library().ssm_scan_bwd_launch(
            _DTYPE_CODE[dtype], ptr(u), ptr(dt), ptr(A), ptr(B), ptr(C),
            ptr(D), ptr(gy), ptr(gh), ptr(ckpt), ptr(du), ptr(ddt), ptr(dA),
            ptr(dB), ptr(dC), ptr(dD), ptr(carry), ptr(sync), Bsz, S, di, N,
            B.stride(0), B.stride(1), C.stride(0), C.stride(1), ckpt_every,
            nseg, seg_len,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        if err != 0:
            raise RuntimeError(f"ssm_scan_bwd kernel launch failed: CUDA "
                               f"error {err}")
        dispatch.record_launch("ssm_scan_bwd")
    return _as_dtypes((du, ddt, dA, dB, dC, dD), (u, dt, A, B, C, D))
