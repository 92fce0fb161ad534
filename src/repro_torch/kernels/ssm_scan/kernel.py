"""Mamba-1 selective scan: one launch for the whole sequence.

Counterpart of ``src/repro/kernels/ssm_scan/kernel.py::ssm_scan_pallas``:
the same arguments (less ``chunk``, ``bd`` and ``interpret``) and the same
outputs.  From h_0 = 0, for every batch row, channel d and state n:

  h_t = exp(dt_t ⊙ A) · h_{t−1} + (dt_t · u_t) · B_t
  y_t = C_t · h_t + D · u_t

u, dt (B, S, di); A (di, N) fp32; B, C (B, S, N); D (di,).  u/dt/B/C are
fp32 or bf16 and are upcast; every sum is fp32.  Returns y (B, S, di) fp32
and h_last (B, di, N) fp32.

Where it runs follows from the tensors: on CUDA tensors :func:`ssm_scan`
launches the hand-written kernel (``csrc/ssm_scan.cu``: one thread per
(channel, state), the carry in a register, ``SCAN_CHUNK`` time steps staged
in shared memory per pass) or raises; on CPU tensors it runs
:func:`ssm_scan_plain`, the kernel's per-step arithmetic in PyTorch, a loop
over S.  Nothing falls back from one to the other.

The kernel takes u and dt contiguous and B and C with any batch and time
stride (unit stride over N), so the model's column slices of its x
projection go in without a copy.  It takes N <= ``MAX_STATE`` and any S and
di: a ragged channel tail and a ragged last chunk are masked, where the TPU
kernel asserts ``S % chunk == 0`` and ``di % bd == 0``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..rfast_update import dispatch

__all__ = ["ssm_scan", "ssm_scan_plain", "ssm_scan_bytes", "KERNEL_SOURCE",
           "SCAN_CHUNK", "MAX_STATE"]

KERNEL_SOURCE = Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu"
SCAN_CHUNK = 64      # the kernel's staging depth (kChunk in csrc/ssm_scan.cu)
MAX_STATE = 16       # largest N the kernel takes (kMaxG)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library():
    global _lib
    if _lib is None:
        from .._build import load
        lib = load(KERNEL_SOURCE)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.ssm_scan_launch.argtypes = (
            [i32] + [vp] * 8 + [i64, i64, i64, i32] + [i64] * 4 + [vp])
        lib.ssm_scan_launch.restype = i32
        _lib = lib
    return _lib


def ssm_scan_plain(u, dt, A, B, C, D, *, chunk: int = SCAN_CHUNK):
    """The kernel's arithmetic in PyTorch: ``chunk`` steps of u, dt, B and
    C staged (upcast to fp32) per pass, then a loop over them carrying h.
    Runs on whatever device the inputs lie on."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    f32 = torch.float32
    Bsz, S, di = u.shape
    N = A.shape[1]
    A, D = A.to(f32), D.to(f32)
    y = torch.empty((Bsz, S, di), dtype=f32, device=u.device)
    h = torch.zeros((Bsz, di, N), dtype=f32, device=u.device)
    for t0 in range(0, S, chunk):
        steps = slice(t0, min(S, t0 + chunk))
        u_c, dt_c, B_c, C_c = (a[:, steps].to(f32) for a in (u, dt, B, C))
        for r in range(u_c.shape[1]):
            u_t, dt_t = u_c[:, r], dt_c[:, r]
            h = (torch.exp(dt_t[..., None] * A) * h
                 + (dt_t * u_t)[..., None] * B_c[:, r, None, :])
            y[:, t0 + r] = (h * C_c[:, r, None, :]).sum(-1) + D * u_t
    return y, h


def ssm_scan_bytes(Bsz: int, S: int, di: int, N: int, itemsize: int) -> int:
    """Bytes one launch must move: u, dt, B and C read once (``itemsize``
    each), A and D read once (fp32), y and h_last written once (fp32)."""
    return (Bsz * S * (2 * di + 2 * N) * itemsize + 4 * (di * N + di)
            + 4 * (Bsz * S * di + Bsz * di * N))


def _check(u, dt, A, B, C, D) -> torch.dtype:
    dev, dtype = u.device, u.dtype
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"ssm_scan kernel takes float32 or bfloat16 u, got "
                        f"{dtype}")
    for name, t in (("dt", dt), ("A", A), ("B", B), ("C", C), ("D", D)):
        if t.device != dev:
            raise ValueError(f"ssm_scan kernel needs every input on {dev}; "
                             f"{name} is on {t.device}")
    for name, t in (("dt", dt), ("B", B), ("C", C)):
        if t.dtype != dtype:
            raise TypeError(f"ssm_scan kernel needs u, dt, B and C of one "
                            f"dtype; {name} is {t.dtype} beside {dtype}")
    if A.dtype != torch.float32:
        raise TypeError(f"ssm_scan kernel takes a float32 A, got {A.dtype}")
    if u.dim() != 3 or A.dim() != 2:
        raise ValueError(f"ssm_scan: u must be (B, S, di) and A (di, N); got "
                         f"{tuple(u.shape)} and {tuple(A.shape)}")
    Bsz, S, di = u.shape
    N = A.shape[1]
    if (dt.shape != u.shape or A.shape[0] != di or B.shape != (Bsz, S, N)
            or C.shape != (Bsz, S, N) or D.shape != (di,)):
        raise ValueError(
            f"ssm_scan: inconsistent shapes u {tuple(u.shape)} dt "
            f"{tuple(dt.shape)} A {tuple(A.shape)} B {tuple(B.shape)} C "
            f"{tuple(C.shape)} D {tuple(D.shape)}")
    if not (u.is_contiguous() and dt.is_contiguous() and A.is_contiguous()):
        raise ValueError("ssm_scan kernel needs contiguous u, dt and A")
    if N > 1 and (B.stride(2) != 1 or C.stride(2) != 1):
        raise ValueError("ssm_scan kernel needs B and C of unit stride over "
                         "N")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"ssm_scan kernel takes 1 <= N <= {MAX_STATE}, got "
                         f"{N}")
    if Bsz > 65535:
        raise ValueError(f"ssm_scan kernel takes a batch <= 65535, got {Bsz}")
    return dtype


def ssm_scan(u, dt, A, B, C, D):
    """The selective scan from h_0 = 0: ``(y (B,S,di) fp32, h_last
    (B,di,N) fp32)``.  On CUDA tensors the Hopper kernel runs (or this
    raises on what it does not take); on CPU tensors,
    :func:`ssm_scan_plain`."""
    if u.device.type == "cpu":
        return ssm_scan_plain(u, dt, A, B, C, D)
    if u.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cuda or cpu tensors, got "
                         f"{u.device}")
    dtype = _check(u, dt, A, B, C, D)
    Bsz, S, di = u.shape
    N = A.shape[1]
    y = torch.empty((Bsz, S, di), dtype=torch.float32, device=u.device)
    h = torch.empty((Bsz, di, N), dtype=torch.float32, device=u.device)
    if Bsz == 0 or di == 0:
        return y, h
    D = D.to(torch.float32).contiguous()
    lib = _library()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    err = lib.ssm_scan_launch(
        _DTYPE_CODE[dtype], ptr(u), ptr(dt), ptr(A), ptr(B), ptr(C), ptr(D),
        ptr(y), ptr(h), Bsz, S, di, N, B.stride(0), B.stride(1), C.stride(0),
        C.stride(1),
        ctypes.c_void_p(torch.cuda.current_stream(u.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error {err}")
    dispatch.record_launch("ssm_scan")
    return y, h
