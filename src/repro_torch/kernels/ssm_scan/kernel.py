"""Mamba-1 selective scan: one launch for the whole sequence.

Counterpart of ``src/repro/kernels/ssm_scan/kernel.py::ssm_scan_pallas``:
the same arguments (less ``chunk``, ``bd`` and ``interpret``) and the same
outputs.  From h_0 = 0, for every batch row, channel d and state n:

  h_t = exp(dt_t ⊙ A) · h_{t−1} + (dt_t · u_t) · B_t
  y_t = C_t · h_t + D · u_t

u, dt (B, S, di); A (di, N) fp32; B, C (B, S, N); D (di,).  u/dt/B/C are
fp32 or bf16 and are upcast; every sum is fp32.  Returns y (B, S, di) fp32
and h_last (B, di, N) fp32, and with ``ckpt_every=T`` also the backward's
checkpoints, the state before every T-th step: ``ckpt[:, k] = h_{kT}``,
(B, ⌈S/T⌉, di, N) fp32 (``ckpt[:, 0]`` is zero).

Where it runs follows from the tensors: on CUDA tensors :func:`ssm_scan`
launches the hand-written kernel (``csrc/ssm_scan.cu``: four states of a
channel a thread, the exponential as one ``ex2``, the next
``SCAN_STAGE`` steps staged by ``cp.async`` while the block steps through
the current ones, and a split time axis where batch × channel tiles leave
the SMs idle, :func:`scan_segments`) or raises; on CPU tensors it runs
:func:`ssm_scan_plain`, the kernel's per-step arithmetic in PyTorch, a loop
over S (unsplit: the split changes only the order of the kernel's work).
Nothing falls back from one to the other.  On meta tensors neither runs:
:func:`ssm_scan` returns empty meta outputs and notes the launch's
operations (:func:`ssm_scan_ops`) and bytes for the dry-run
(:mod:`...meta`).

The kernel takes u and dt contiguous and B and C with any batch and time
stride (unit stride over N), so the model's column slices of its x
projection go in without a copy.  It takes N <= ``MAX_STATE`` and any S and
di: a ragged channel tail and a ragged last chunk are masked, where the TPU
kernel asserts ``S % chunk == 0`` and ``di % bd == 0``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from .. import meta
from ..rfast_update import dispatch

__all__ = ["ssm_scan", "ssm_scan_plain", "ssm_scan_bytes", "ssm_scan_ops",
           "scan_segments",
           "segment_length", "n_checkpoints", "KERNEL_SOURCE", "SCAN_CHUNK",
           "SCAN_STAGE", "SCAN_TILE", "MAX_STATE", "CKPT_EVERY"]

KERNEL_SOURCE = Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu"
SCAN_CHUNK = 64      # the twin's default staging depth
SCAN_STAGE = 32      # the kernel's staging depth (kStage in csrc/ssm_scan.cu)
SCAN_TILE = 32       # channels per block (kCh)
MAX_STATE = 16       # largest N the kernel takes (kMaxN)
CKPT_EVERY = 8       # checkpoint spacing the autograd function asks for
                     # (the backward's chunk: four of its blocks fit an SM)
# the split rule (scan_segments): split the time axis only while the blocks
# give fewer than SPLIT_BELOW_WARPS_PER_SM warps an SM (one a sub-
# partition), then up to SPLIT_WARPS_PER_SM, in segments of at least
# MIN_SEGMENT steps, and never in fewer than MIN_SEGMENTS
SPLIT_BELOW_WARPS_PER_SM = 4
SPLIT_WARPS_PER_SM = 24
MIN_SEGMENT = 512
MIN_SEGMENTS = 4

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library():
    global _lib
    if _lib is None:
        from .._build import load
        lib = load(KERNEL_SOURCE)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.ssm_scan_launch.argtypes = (
            [i32] + [vp] * 11 + [i64, i64, i64, i32] + [i64] * 6
            + [i32, i64, vp])
        lib.ssm_scan_launch.restype = i32
        _lib = lib
    return _lib


def n_checkpoints(S: int, every: int) -> int:
    """Checkpoints of a length-S scan at spacing ``every``: ⌈S/every⌉."""
    return -(-S // every)


def lanes(N: int) -> int:
    """Threads a channel in both kernels: ⌈N/4⌉ rounded up to 1, 2 or 4."""
    L = 1
    while 4 * L < N:
        L *= 2
    return L


def segment_length(S: int, segments: int) -> int:
    """Steps a segment of the split time axis covers: ⌈S/segments⌉ rounded
    up to the kernel's staging depth (the last segment takes the rest)."""
    seg = -(-S // max(1, segments))
    return max(SCAN_STAGE, -(-seg // SCAN_STAGE) * SCAN_STAGE)


def scan_segments(Bsz: int, S: int, di: int, N: int, sms: int) -> int:
    """How many segments the kernel splits S into on a card of ``sms`` SMs.

    Unsplit, the kernel runs Bsz · ⌈di/32⌉ blocks of 32 · lanes(N)
    threads, each stepping through all of S.  A split costs
    (segments − 1)/segments more exponentials (every segment but the last
    is scanned twice) and leaves a path of two segments' steps (a pass-B
    block waits for the pass-A blocks before it), so it pays only where
    the unsplit blocks leave SM sub-partitions without a warp: below
    ``SPLIT_BELOW_WARPS_PER_SM`` warps an SM the axis is split until the
    blocks give ``SPLIT_WARPS_PER_SM``, into segments of at least
    ``MIN_SEGMENT`` steps; fewer than ``MIN_SEGMENTS`` do not pay (H100:
    ``chip_smoke.py`` phase 16 and ``tools/scan_ab.py --splits`` time
    both).  Long sequences in small batches take it: training hymba-1.5b
    at ``--batch-per-node 1 --seq 4096`` gives every SSM layer's scan
    (1, 4096, 3200, 16), 400 warps, which a 132-SM card splits in 8."""
    warps = Bsz * -(-di // SCAN_TILE) * lanes(N)
    if S == 0 or warps >= SPLIT_BELOW_WARPS_PER_SM * sms:
        return 1
    want = math.ceil(SPLIT_WARPS_PER_SM * sms / max(1, warps))
    nseg = n_checkpoints(S, segment_length(S, min(want, S // MIN_SEGMENT)))
    return nseg if nseg >= MIN_SEGMENTS else 1


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    return torch.cuda.get_device_properties(
        torch.cuda.current_device() if index is None else index
    ).multi_processor_count


def ssm_scan_plain(u, dt, A, B, C, D, *, chunk: int = SCAN_CHUNK,
                   ckpt_every: int | None = None):
    """The kernel's arithmetic in PyTorch: ``chunk`` steps of u, dt, B and
    C staged (upcast to fp32) per pass, then a loop over them carrying h,
    and the state before every ``ckpt_every``-th step kept when asked.
    Runs on whatever device the inputs lie on."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if ckpt_every is not None and ckpt_every < 1:
        raise ValueError(f"ckpt_every must be >= 1, got {ckpt_every}")
    f32 = torch.float32
    Bsz, S, di = u.shape
    N = A.shape[1]
    A, D = A.to(f32), D.to(f32)
    y = torch.empty((Bsz, S, di), dtype=f32, device=u.device)
    h = torch.zeros((Bsz, di, N), dtype=f32, device=u.device)
    ckpt = (None if ckpt_every is None else torch.empty(
        (Bsz, n_checkpoints(S, ckpt_every), di, N), dtype=f32,
        device=u.device))
    for c0 in range(0, S, chunk):
        steps = slice(c0, min(S, c0 + chunk))
        u_c, dt_c, B_c, C_c = (a[:, steps].to(f32) for a in (u, dt, B, C))
        for r in range(u_c.shape[1]):
            t = c0 + r
            if ckpt is not None and t % ckpt_every == 0:
                ckpt[:, t // ckpt_every] = h
            u_t, dt_t = u_c[:, r], dt_c[:, r]
            h = (torch.exp(dt_t[..., None] * A) * h
                 + (dt_t * u_t)[..., None] * B_c[:, r, None, :])
            y[:, t] = (h * C_c[:, r, None, :]).sum(-1) + D * u_t
    return (y, h) if ckpt is None else (y, h, ckpt)


def ssm_scan_bytes(Bsz: int, S: int, di: int, N: int, itemsize: int) -> int:
    """Bytes one launch must move: u, dt, B and C read once (``itemsize``
    each), A and D read once (fp32), y and h_last written once (fp32)."""
    return (Bsz * S * (2 * di + 2 * N) * itemsize + 4 * (di * N + di)
            + 4 * (Bsz * S * di + Bsz * di * N))


def ssm_scan_ops(Bsz: int, S: int, di: int, N: int) -> tuple[int, int]:
    """(fp32 operations, exponentials) of the scan: per (b, t, d, n) dt·A,
    the three of the h update, h·C and its share of the n sum, and one
    exponential; per (b, t, d) dt·u and the D·u multiply-add."""
    return Bsz * S * di * (6 * N + 3), Bsz * S * di * N


def check_inputs(u, dt, A, B, C, D, what: str = "ssm_scan") -> torch.dtype:
    """Raise unless the kernels take these operands on the card; returns
    the dtype of u, dt, B and C."""
    dev, dtype = u.device, u.dtype
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{what} kernel takes float32 or bfloat16 u, got "
                        f"{dtype}")
    for name, t in (("dt", dt), ("A", A), ("B", B), ("C", C), ("D", D)):
        if t.device != dev:
            raise ValueError(f"{what} kernel needs every input on {dev}; "
                             f"{name} is on {t.device}")
    for name, t in (("dt", dt), ("B", B), ("C", C)):
        if t.dtype != dtype:
            raise TypeError(f"{what} kernel needs u, dt, B and C of one "
                            f"dtype; {name} is {t.dtype} beside {dtype}")
    if A.dtype != torch.float32:
        raise TypeError(f"{what} kernel takes a float32 A, got {A.dtype}")
    if u.dim() != 3 or A.dim() != 2:
        raise ValueError(f"{what}: u must be (B, S, di) and A (di, N); got "
                         f"{tuple(u.shape)} and {tuple(A.shape)}")
    Bsz, S, di = u.shape
    N = A.shape[1]
    if (dt.shape != u.shape or A.shape[0] != di or B.shape != (Bsz, S, N)
            or C.shape != (Bsz, S, N) or D.shape != (di,)):
        raise ValueError(
            f"{what}: inconsistent shapes u {tuple(u.shape)} dt "
            f"{tuple(dt.shape)} A {tuple(A.shape)} B {tuple(B.shape)} C "
            f"{tuple(C.shape)} D {tuple(D.shape)}")
    if not (u.is_contiguous() and dt.is_contiguous() and A.is_contiguous()):
        raise ValueError(f"{what} kernel needs contiguous u, dt and A")
    if N > 1 and (B.stride(2) != 1 or C.stride(2) != 1):
        raise ValueError(f"{what} kernel needs B and C of unit stride over "
                         f"N")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"{what} kernel takes 1 <= N <= {MAX_STATE}, got "
                         f"{N}")
    return dtype


def ssm_scan(u, dt, A, B, C, D, *, ckpt_every: int | None = None,
             segments: int | None = None):
    """The selective scan from h_0 = 0: ``(y (B,S,di) fp32, h_last
    (B,di,N) fp32)``, and the checkpoints third when ``ckpt_every`` is
    given.  On CUDA tensors the Hopper kernel runs (or this raises on what
    it does not take), its time axis split into ``segments`` (default:
    :func:`scan_segments` of the shape and the card); on CPU tensors,
    :func:`ssm_scan_plain`; on meta tensors, empty meta outputs and a
    noted launch (the checkpoints' bytes counted with its own)."""
    if meta.is_meta(u):
        check_inputs(u, dt, A, B, C, D)
        Bsz, S, di = u.shape
        N = A.shape[1]
        new = lambda *s: torch.empty(s, dtype=torch.float32, device="meta")
        y, h = new(Bsz, S, di), new(Bsz, di, N)
        ckpt = (None if ckpt_every is None else
                new(Bsz, n_checkpoints(S, ckpt_every), di, N))
        meta.note("ssm_scan", flops=ssm_scan_ops(Bsz, S, di, N)[0],
                  nbytes=ssm_scan_bytes(Bsz, S, di, N, u.element_size())
                  + (0 if ckpt is None else 4 * ckpt.numel()))
        return (y, h) if ckpt is None else (y, h, ckpt)
    if u.device.type == "cpu":
        if segments is not None:
            raise ValueError("segments splits the kernel's time axis; the "
                             "plain twin on CPU tensors takes none")
        return ssm_scan_plain(u, dt, A, B, C, D, ckpt_every=ckpt_every)
    if u.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cuda or cpu tensors, got "
                         f"{u.device}")
    dtype = check_inputs(u, dt, A, B, C, D)
    if ckpt_every is not None and ckpt_every < 1:
        raise ValueError(f"ckpt_every must be >= 1, got {ckpt_every}")
    Bsz, S, di = u.shape
    N = A.shape[1]
    f32, dev = torch.float32, u.device
    y = torch.empty((Bsz, S, di), dtype=f32, device=dev)
    h = torch.empty((Bsz, di, N), dtype=f32, device=dev)
    n_ck = 0 if ckpt_every is None else n_checkpoints(S, ckpt_every)
    ckpt = (None if ckpt_every is None else
            torch.empty((Bsz, n_ck, di, N), dtype=f32, device=dev))
    if Bsz == 0 or di == 0:
        return (y, h) if ckpt is None else (y, h, ckpt)
    if segments is None:
        segments = scan_segments(Bsz, S, di, N, _sm_count(dev.index))
    if segments < 1:
        raise ValueError(f"segments must be >= 1, got {segments}")
    seg_len = segment_length(S, segments) if segments > 1 else max(S, 1)
    nseg = max(1, n_checkpoints(S, seg_len))
    carry = sync = None
    if nseg > 1:
        carry = torch.empty(2 * (nseg - 1) * Bsz * di * N, dtype=f32,
                            device=dev)
        sync = torch.zeros(1 + (nseg - 1) * Bsz * -(-di // SCAN_TILE),
                           dtype=torch.int32, device=dev)
    D = D.to(f32).contiguous()
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    err = _library().ssm_scan_launch(
        _DTYPE_CODE[dtype], ptr(u), ptr(dt), ptr(A), ptr(B), ptr(C), ptr(D),
        ptr(y), ptr(h), ptr(ckpt), ptr(carry), ptr(sync), Bsz, S, di, N,
        B.stride(0), B.stride(1), C.stride(0), C.stride(1), ckpt_every or 0,
        n_ck, nseg, seg_len,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error {err}")
    dispatch.record_launch("ssm_scan")
    return (y, h) if ckpt is None else (y, h, ckpt)
