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
hand-written kernel (``csrc/ssm_scan_bwd.cu``: one block per (32-channel
tile, batch row), the checkpoint chunks walked in reverse and staged by
``cp.async`` one ahead, each chunk's states and decays rerun into shared
memory from its checkpoint and swept backward) or raises; on CPU tensors
it runs :func:`ssm_scan_bwd_plain`, the same reverse recurrence in
PyTorch.  The kernel adds dB and dC over its
channel tiles, and dA and dD over batch rows, with fp32 atomics, whose
order varies from run to run: those four gradients are repeatable only to
fp32 rounding.  Every gradient is computed in fp32 and returned in the
dtype of its input.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..rfast_update import dispatch
from .kernel import (_DTYPE_CODE, SCAN_TILE, check_inputs, lanes,
                     n_checkpoints)

__all__ = ["ssm_scan_bwd", "ssm_scan_bwd_plain", "ssm_scan_bwd_bytes",
           "bwd_smem_bytes", "KERNEL_SOURCE", "MAX_SMEM"]

KERNEL_SOURCE = Path(__file__).resolve().parent / "csrc" / "ssm_scan_bwd.cu"
MAX_SMEM = 232448    # a block's shared memory on sm_90 (kMaxSmem)

_lib = None


def _library():
    global _lib
    if _lib is None:
        from .._build import load
        lib = load(KERNEL_SOURCE)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.ssm_scan_bwd_launch.argtypes = (
            [i32] + [vp] * 15 + [i64, i64, i64, i32] + [i64] * 5 + [vp])
        lib.ssm_scan_bwd_launch.restype = i32
        _lib = lib
    return _lib


def bwd_smem_bytes(T: int, N: int, itemsize: int = 4) -> int:
    """Shared memory one block of the kernel takes at checkpoint spacing
    ``T`` for inputs of ``itemsize`` bytes: per step, h and dA as a float4
    and the lane's du, ddt sums as a float2 a thread (32 · lanes(N)
    threads), and two staging buffers of u, dt (32 channels,
    ``itemsize``), gy (32, fp32), B and C (16, ``itemsize``)."""
    threads = SCAN_TILE * lanes(N)
    return T * (2 * threads * 16 + threads * 8
                + 2 * (SCAN_TILE * 4 + 2 * SCAN_TILE * itemsize
                       + 2 * 16 * itemsize))


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


def _as_dtypes(grads, like):
    return tuple(g.to(t.dtype) for g, t in zip(grads, like))


def ssm_scan_bwd_plain(u, dt, A, B, C, D, gy, gh, ckpt, *, ckpt_every: int):
    """The kernel's reverse recurrence in PyTorch on any device: for each
    checkpoint chunk from the last, the chunk's states and decays rerun
    from its checkpoint, then swept backward.  Returns (du, ddt, dA, dB,
    dC, dD), each in its input's dtype."""
    if ckpt_every < 1:
        raise ValueError(f"ckpt_every must be >= 1, got {ckpt_every}")
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
    carry = (torch.zeros((Bsz, di, N), dtype=f32, device=u.device)
             if gh is None else gh.to(f32))
    for k in range(n_ck - 1, -1, -1):
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


def ssm_scan_bwd(u, dt, A, B, C, D, gy, gh, ckpt, *, ckpt_every: int):
    """Gradients (du, ddt, dA, dB, dC, dD) of Σ y·gy + Σ h_last·gh (gh may
    be None) from the forward's checkpoints at spacing ``ckpt_every``, each
    in its input's dtype.  On CUDA tensors the Hopper kernel runs (or this
    raises on what it does not take); on CPU tensors,
    :func:`ssm_scan_bwd_plain`."""
    if u.device.type == "cpu":
        return ssm_scan_bwd_plain(u, dt, A, B, C, D, gy, gh, ckpt,
                                  ckpt_every=ckpt_every)
    if u.device.type != "cuda":
        raise ValueError(f"ssm_scan_bwd runs on cuda or cpu tensors, got "
                         f"{u.device}")
    dtype = check_inputs(u, dt, A, B, C, D, "ssm_scan_bwd")
    Bsz, S, di = u.shape
    N = A.shape[1]
    if ckpt_every < 1:
        raise ValueError(f"ckpt_every must be >= 1, got {ckpt_every}")
    smem = bwd_smem_bytes(ckpt_every, N, u.element_size())
    if smem > MAX_SMEM:
        raise ValueError(
            f"ssm_scan_bwd kernel: a block at ckpt_every={ckpt_every}, N={N} "
            f"needs {smem} bytes of shared memory, more than {MAX_SMEM}")
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
    gy = gy.to(f32).contiguous()
    gh = None if gh is None else gh.to(f32).contiguous()
    du = torch.empty((Bsz, S, di), dtype=f32, device=dev)
    ddt = torch.empty_like(du)
    dA = torch.zeros((di, N), dtype=f32, device=dev)
    dB = torch.zeros((Bsz, S, N), dtype=f32, device=dev)
    dC = torch.zeros_like(dB)
    dD = torch.zeros((di,), dtype=f32, device=dev)
    if Bsz and di:
        D = D.to(f32).contiguous()
        ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
        err = _library().ssm_scan_bwd_launch(
            _DTYPE_CODE[dtype], ptr(u), ptr(dt), ptr(A), ptr(B), ptr(C),
            ptr(D), ptr(gy), ptr(gh), ptr(ckpt), ptr(du), ptr(ddt), ptr(dA),
            ptr(dB), ptr(dC), ptr(dD), Bsz, S, di, N, B.stride(0),
            B.stride(1), C.stride(0), C.stride(1), ckpt_every,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        if err != 0:
            raise RuntimeError(f"ssm_scan_bwd kernel launch failed: CUDA "
                               f"error {err}")
        dispatch.record_launch("ssm_scan_bwd")
    return _as_dtypes((du, ddt, dA, dB, dC, dD), (u, dt, A, B, C, D))
