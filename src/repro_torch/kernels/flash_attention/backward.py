"""Flash attention backward (one fused kernel, no S² traffic) and the
differentiable op.

Counterpart of ``src/repro/kernels/flash_attention/backward.py``.  From
the forward's fp32 row statistic lse and δ = rowsum(dO ⊙ O):

  p   = exp(q·kᵀ·scale − lse)       (0 where the mask drops)
  dp  = dO · vᵀ
  ds  = p ⊙ (dp − δ) · scale
  dq  = ds · k
  dk  = dsᵀ · q,   dv = pᵀ · dO

As in the reference, k and v come already repeated to the H query heads
(GQA gradients flow back through the caller's repeat), lse and δ are fp32
and the three gradients are fp32.  :func:`flash_bwd` computes all three
and follows its tensors: bf16 CUDA tensors launch one fused tensor-core
kernel (``csrc/flash_bwd_tc.cu``, dO read in bf16), fp32 CUDA tensors
one fused kernel in 3xTF32 (``csrc/flash_bwd_3xtf32.cu``, dO read in
fp32), each or it raises; CPU tensors run :func:`flash_bwd_plain`,
which computes the same function densely.  Both kernels add dq's
partial sums by atomics, so their dq is not bitwise repeatable from run
to run.  :func:`flash_dq` and :func:`flash_dkv`, the counterparts of
the reference's two kernels, run their plain twins on CPU tensors and
refuse CUDA tensors, which :func:`flash_bwd` serves.  On meta tensors
:func:`flash_bwd` runs nothing: it returns empty meta gradients and
notes the launch's operations and bytes for the dry-run (:mod:`...meta`).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import meta
from ..rfast_update import dispatch
from .kernel import (MAX_HEAD_DIM, check_blocks, check_cuda, check_window,
                     flash_bwd_work, flash_fwd, flash_names, launch_status,
                     masked_scores, pad_head_dim, ptr, stream_of)

__all__ = ["flash_attention_vjp", "FlashAttentionFn", "flash_bwd",
           "flash_bwd_plain", "flash_dq", "flash_dq_plain", "flash_dkv",
           "flash_dkv_plain", "KERNEL_SOURCE", "TC_SOURCE"]

KERNEL_SOURCE = (Path(__file__).resolve().parent / "csrc"
                 / "flash_bwd_3xtf32.cu")
TC_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_bwd_tc.cu"

_libs: dict = {}


def _library(source):
    if source not in _libs:
        from .._build import load
        lib = load(source)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        tail = [i32, i32, i64, i64, i32, ctypes.c_float, i32, i64, vp]
        fn = (lib.flash_bwd_3xtf32_launch if source == KERNEL_SOURCE
              else lib.flash_bwd_tc_launch)
        fn.argtypes = [vp] * 9 + tail
        fn.restype = i32
        _libs[source] = lib
    return _libs[source]


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


def flash_bwd_plain(q, k, v, do, lse, delta, *, scale, causal=True,
                    window=None, bq=128, bk=128):
    """(dq, dk, dv) = (ds · k, dsᵀ · q, pᵀ · dO) in one dense pass; fp32
    (fp64 for fp64 inputs)."""
    _check(q, k, v, do, lse, delta, bq, bk)
    check_window(window)
    p, ds, cdt = _p_ds(q, k, v, do, lse, delta, scale, causal, window)
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k.to(cdt)),
            torch.einsum("bhqk,bhqd->bhkd", ds, q.to(cdt)),
            torch.einsum("bhqk,bhqd->bhkd", p, do.to(cdt)))


def _plain_only(name, q):
    if q.device.type != "cpu":
        raise TypeError(f"{name} runs its plain twin on CPU tensors only; "
                        f"on {q.device} run flash_bwd (one fused kernel "
                        f"for dq, dk and dv)")


def flash_dq(q, k, v, do, lse, delta, *, scale, causal=True, window=None,
             bq=128, bk=128):
    """dq (B,H,Sq,D) fp32 — the counterpart of ``_run_dq``, on CPU
    tensors of any dtype (the plain twin); CUDA tensors raise: they run
    :func:`flash_bwd`."""
    _plain_only("flash_dq", q)
    return flash_dq_plain(q, k, v, do, lse, delta, scale=scale,
                          causal=causal, window=window, bq=bq, bk=bk)


def flash_dkv(q, k, v, do, lse, delta, *, scale, causal=True, window=None,
              bq=128, bk=128):
    """(dk, dv), each (B,H,Sk,D) fp32 — the counterpart of ``_run_dkv``,
    on CPU tensors of any dtype (the plain twin); CUDA tensors raise:
    they run :func:`flash_bwd`."""
    _plain_only("flash_dkv", q)
    return flash_dkv_plain(q, k, v, do, lse, delta, scale=scale,
                           causal=causal, window=window, bq=bq, bk=bk)


def flash_bwd(q, k, v, do, lse, delta, *, scale, causal=True, window=None,
              bq=128, bk=128):
    """(dq, dk, dv), fp32, of q, dO (B,H,Sq,D) and k, v (B,H,Sk,D) (k/v
    repeated to H heads), lse and δ (B,H,Sq) fp32 — the counterpart of
    ``_run_dq`` and ``_run_dkv`` together.

    On bfloat16 CUDA tensors one fused ``flash_bwd_tc`` launch, dO read
    in bf16 (an fp32 dO is rounded to bf16 once, here); on float32 CUDA
    tensors one fused ``flash_bwd_3xtf32`` launch, dO in fp32.  q, k, v
    and dO are zero-padded to rows of a multiple of 16 bytes and the
    gradients sliced back; dq is summed by atomics (not bitwise
    repeatable).  On CPU tensors, :func:`flash_bwd_plain`; on meta
    tensors, empty meta gradients and a noted launch.
    """
    kw = dict(scale=scale, causal=causal, window=window, bq=bq, bk=bk)
    if meta.is_meta(q):
        _check(q, k, v, do, lse, delta, bq, bk)
        win = check_window(window)
        dt = check_cuda("flash_bwd", q, k, v)
        B, H, Sq, D = q.shape
        Sk = k.shape[2]
        flops, nbytes = flash_bwd_work(B, H, Sq, Sk, D, causal, win,
                                       q.element_size())
        meta.note(flash_names(dt)[1], flops=flops, nbytes=nbytes)
        grad = lambda S: torch.empty((B, H, S, D), dtype=torch.float32,
                                     device="meta")
        return grad(Sq), grad(Sk), grad(Sk)
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, do, lse, delta, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd runs on cuda or cpu tensors, got "
                         f"{q.device}")
    _check(q, k, v, do, lse, delta, bq, bk)
    win = check_window(window)
    dt = check_cuda("flash_bwd", q, k, v)
    for t in (do, lse, delta):
        if t.device != q.device:
            raise ValueError(f"flash_bwd needs dO, lse and delta on "
                             f"{q.device}, got {t.device}")
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError(f"flash_bwd takes lse and delta in float32; got "
                         f"{lse.dtype}, {delta.dtype}")
    if dt == torch.float32 and do.dtype != dt:
        raise ValueError(f"flash_bwd takes dO in float32 beside float32 "
                         f"q, k, v; got {do.dtype}")
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    q, k, v, do = (pad_head_dim(t) for t in (q, k, v, do.to(dt)))
    lse, delta = lse.contiguous(), delta.contiguous()
    Dp = q.shape[-1]
    dq = torch.zeros((B, H, Sq, Dp), dtype=torch.float32, device=q.device)
    dk = torch.empty((B, H, Sk, Dp), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    if dt == torch.bfloat16:
        name, fn = "flash_bwd_tc", _library(TC_SOURCE).flash_bwd_tc_launch
    else:
        name = "flash_bwd_3xtf32"
        fn = _library(KERNEL_SOURCE).flash_bwd_3xtf32_launch
    err = fn(ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(dq),
             ptr(dk), ptr(dv), B, H, Sq, Sk, Dp, float(scale),
             int(bool(causal)), win, stream_of(q))
    launch_status(name, err)
    dispatch.record_launch(name)
    if Dp != D:
        dq, dk, dv = dq[..., :D], dk[..., :D], dv[..., :D]
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention over q, k, v (B,H,S,D).

    The reference's forward rule (``backward.py:189-207``) is dense jnp;
    here the forward is the flash forward kernel (:func:`.kernel.
    flash_fwd`), which computes the same function and its lse in one
    pass.  It writes o in fp32, saved unrounded for δ as the reference
    saves it, and returns o in q's dtype.  δ = rowsum(dO ⊙ O) is plain
    PyTorch in fp32, as it is plain jnp in the reference
    (``backward.py:220``).  The backward is :func:`flash_bwd`, given the
    cotangent as it arrives (bf16 for bf16 inputs, fp32 for fp32 inputs:
    each fused kernel reads it so).
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
        delta = (do.to(o.dtype) * o).sum(-1)
        dq, dk, dv = flash_bwd(q, k, v, do, lse, delta, **ctx.kw)
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
