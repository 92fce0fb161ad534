"""Flash attention backward (two passes, no S² traffic) and the
differentiable op.

Counterpart of ``src/repro/kernels/flash_attention/backward.py``.  From
the forward's fp32 row statistic lse and δ = rowsum(dO ⊙ O):

  p   = exp(q·kᵀ·scale − lse)       (0 where the mask drops)
  dp  = dO · vᵀ
  ds  = p ⊙ (dp − δ) · scale
  dq  = ds · k                     (:func:`flash_dq`,  one kernel)
  dk  = dsᵀ · q,   dv = pᵀ · dO    (:func:`flash_dkv`, one kernel)

As in the reference, k and v come already repeated to the H query heads
(GQA gradients flow back through the caller's repeat), dO, lse and δ are
fp32 and the three gradients are fp32.  On CUDA tensors the wrappers
launch the hand-written kernels (``csrc/flash_bwd.cu``) or raise; on CPU
tensors they run their plain twins, which compute the same function
densely.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..rfast_update import dispatch
from .kernel import (DTYPE_CODE, MAX_HEAD_DIM, check_blocks, check_cuda,
                     check_window, flash_fwd, launch_status, masked_scores,
                     ptr, stream_of)

__all__ = ["flash_attention_vjp", "FlashAttentionFn", "flash_dq",
           "flash_dq_plain", "flash_dkv", "flash_dkv_plain", "KERNEL_SOURCE"]

KERNEL_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_bwd.cu"

_lib = None


def _library():
    global _lib
    if _lib is None:
        from .._build import load
        lib = load(KERNEL_SOURCE)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        tail = [i32, i32, i64, i64, i32, ctypes.c_float, i32, i64, vp]
        lib.flash_dq_launch.argtypes = [i32] + [vp] * 7 + tail
        lib.flash_dq_launch.restype = i32
        lib.flash_dkv_launch.argtypes = [i32] + [vp] * 8 + tail
        lib.flash_dkv_launch.restype = i32
        _lib = lib
    return _lib


def _check(q, k, v, do, lse, delta, bq, bk):
    if q.dim() != 4 or k.shape[:2] != q.shape[:2] or k.shape != v.shape \
            or k.shape[3] != q.shape[3] or do.shape != q.shape \
            or lse.shape != q.shape[:3] or delta.shape != q.shape[:3]:
        raise ValueError(
            f"flash backward takes q, dO (B,H,Sq,D), k, v (B,H,Sk,D), lse, "
            f"delta (B,H,Sq); got q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, dO {tuple(do.shape)}, lse "
            f"{tuple(lse.shape)}, delta {tuple(delta.shape)}")
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"flash attention kernels take D <= {MAX_HEAD_DIM}, "
                         f"got {q.shape[3]}")
    check_blocks(q.shape[2], k.shape[2], bq, bk)


def _p_ds(q, k, v, do, lse, delta, scale, causal, window):
    cdt = torch.float64 if q.dtype == torch.float64 else torch.float32
    s = masked_scores(q, k, scale, causal, window, cdt)
    p = torch.exp(s - lse.to(cdt)[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do.to(cdt), v.to(cdt))
    return p, p * (dp - delta.to(cdt)[..., None]) * scale, cdt


def flash_dq_plain(q, k, v, do, lse, delta, *, scale, causal=True,
                   window=None, bq=128, bk=128):
    """dq = ds · k, dense; fp32 (fp64 for fp64 inputs)."""
    _check(q, k, v, do, lse, delta, bq, bk)
    check_window(window)
    _, ds, cdt = _p_ds(q, k, v, do, lse, delta, scale, causal, window)
    return torch.einsum("bhqk,bhkd->bhqd", ds, k.to(cdt))


def flash_dkv_plain(q, k, v, do, lse, delta, *, scale, causal=True,
                    window=None, bq=128, bk=128):
    """(dk, dv) = (dsᵀ · q, pᵀ · dO), dense; fp32 (fp64 for fp64)."""
    _check(q, k, v, do, lse, delta, bq, bk)
    check_window(window)
    p, ds, cdt = _p_ds(q, k, v, do, lse, delta, scale, causal, window)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(cdt))
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.to(cdt))
    return dk, dv


def _cuda_args(name, q, k, v, do, lse, delta, bq, bk, window):
    _check(q, k, v, do, lse, delta, bq, bk)
    win = check_window(window)
    dt = check_cuda(name, q, k, v)
    f32 = torch.float32
    for t in (do, lse, delta):
        if t.device != q.device or t.dtype != f32:
            raise ValueError(f"{name} kernel takes dO, lse and delta in "
                             f"float32 on {q.device}; got {t.dtype} on "
                             f"{t.device}")
    ts = [t.contiguous() for t in (q, k, v, do, lse, delta)]
    return dt, win, ts


def flash_dq(q, k, v, do, lse, delta, *, scale, causal=True, window=None,
             bq=128, bk=128):
    """dq (B,H,Sq,D) fp32 — the counterpart of ``_run_dq``.  On CUDA
    tensors one ``flash_dq`` launch; on CPU tensors, the plain twin."""
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, scale=scale,
                              causal=causal, window=window, bq=bq, bk=bk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_dq runs on cuda or cpu tensors, got "
                         f"{q.device}")
    dt, win, ts = _cuda_args("flash_dq", q, k, v, do, lse, delta, bq, bk,
                             window)
    B, H, Sq, D = q.shape
    dq = torch.empty((B, H, Sq, D), dtype=torch.float32, device=q.device)
    err = _library().flash_dq_launch(
        DTYPE_CODE[dt], *(ptr(t) for t in ts), ptr(dq), B, H, Sq,
        k.shape[2], D, float(scale), int(bool(causal)), win, stream_of(q))
    launch_status("flash_dq", err)
    dispatch.record_launch("flash_dq")
    return dq


def flash_dkv(q, k, v, do, lse, delta, *, scale, causal=True, window=None,
              bq=128, bk=128):
    """(dk, dv), each (B,H,Sk,D) fp32 — the counterpart of ``_run_dkv``.
    On CUDA tensors one ``flash_dkv`` launch; on CPU, the plain twin."""
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta, scale=scale,
                               causal=causal, window=window, bq=bq, bk=bk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_dkv runs on cuda or cpu tensors, got "
                         f"{q.device}")
    dt, win, ts = _cuda_args("flash_dkv", q, k, v, do, lse, delta, bq, bk,
                             window)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    dk = torch.empty((B, H, Sk, D), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    err = _library().flash_dkv_launch(
        DTYPE_CODE[dt], *(ptr(t) for t in ts), ptr(dk), ptr(dv), B, H, Sq,
        Sk, D, float(scale), int(bool(causal)), win, stream_of(q))
    launch_status("flash_dkv", err)
    dispatch.record_launch("flash_dkv")
    return dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention over q, k, v (B,H,S,D).

    The reference's forward rule (``backward.py:189-207``) is dense jnp;
    here the forward is the flash forward kernel (:func:`.kernel.
    flash_fwd`), which computes the same function and its lse in one
    pass.  It writes o in fp32, saved unrounded for δ as the reference
    saves it, and returns o in q's dtype.  δ = rowsum(dO ⊙ O) is plain
    PyTorch, as it is plain jnp in the reference (``backward.py:220``).
    """

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, bq, bk):
        if k.dim() != 4 or q.dim() != 4 or k.shape[1] != q.shape[1]:
            raise ValueError(f"flash_attention_vjp takes k/v repeated to "
                             f"q's heads; got q {tuple(q.shape)}, k "
                             f"{tuple(k.shape)}")
        scale_ = scale if scale is not None else q.shape[-1] ** -0.5
        o, lse = flash_fwd(q, k, v, causal=causal, window=window,
                           scale=scale_, bq=bq, bk=bk,
                           out_dtype=torch.promote_types(q.dtype,
                                                         torch.float32))
        ctx.save_for_backward(q, k, v, lse, o)
        ctx.kw = dict(scale=scale_, causal=causal, window=window, bq=bq,
                      bk=bk)
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse, o = ctx.saved_tensors
        dof = do.to(o.dtype)
        delta = (dof * o).sum(-1)
        dq = flash_dq(q, k, v, dof, lse, delta, **ctx.kw)
        dk, dv = flash_dkv(q, k, v, dof, lse, delta, **ctx.kw)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None)


def flash_attention_vjp(q, k, v, causal=True, window=None, scale=None,
                        bq=128, bk=128):
    """Differentiable flash attention, (B,H,S,D) layout, with k/v
    already repeated to q's heads by the caller (grads flow back through
    the repeat).  The positional signature of the reference's
    ``flash_attention_vjp`` less ``interpret``; ``causal, window, scale,
    bq, bk`` are not differentiable."""
    return FlashAttentionFn.apply(q, k, v, causal, window, scale, bq, bk)
