"""Flash attention forward: online softmax over kv tiles, one launch.

Counterpart of ``src/repro/kernels/flash_attention/kernel.py::
flash_attention_pallas``: the (B,H,S,D) layout, the same keyword
arguments (less ``interpret``), the same mask and the same rule that
``S % min(b, S) == 0`` for the block sizes ``bq`` / ``bk`` (the CUDA
kernels' own tiles, 128 q × 64 kv rows in fp32 and 128 × 128 in bf16,
take ragged edges, so ``bq`` / ``bk`` only decide which calls are
refused, as they do in the reference).

Semantics, shared by the kernel and its plain twin:

  s   = q · kᵀ · scale, masked to NEG = −1e30 where ``causal`` and not
        (ki ≤ qi [and ki > qi − window]) — no Sk − Sq offset, as in the
        TPU kernel (``ref.attention_ref`` has the offset);
  o   = softmax(s) · v in q's dtype (or ``out_dtype``), fp32 inside;
  lse = logsumexp(s) per row, fp32 (B,H,Sq) — what the backward needs.

GQA: query head h reads kv head ``h // (H // KV)``; k/v are never
repeated in memory.  Where it runs follows from the tensors: on bf16
CUDA tensors :func:`flash_fwd` launches ``csrc/flash_fwd_tc.cu`` (wgmma
and TMA), on fp32 CUDA tensors ``csrc/flash_fwd_3xtf32.cu`` (mma.sync
in 3xTF32: each fp32 product as three TF32 tensor-core products, close
to fp32's accuracy), each or it raises; on CPU tensors it runs
:func:`flash_fwd_plain`, a dense masked softmax computing the same
function.  Nothing falls back from one to another.  On meta tensors
nothing runs: :func:`flash_fwd` returns empty meta outputs and notes
the launch's operations and bytes (:func:`flash_fwd_work`) for the
dry-run (:mod:`...meta`).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from .. import meta
from ..rfast_update import dispatch

__all__ = ["flash_fwd", "flash_fwd_plain", "masked_scores", "check_blocks",
           "pad_head_dim", "attn_pairs", "flash_fwd_work", "flash_bwd_work",
           "flash_names", "KERNEL_SOURCE", "TC_SOURCE", "NEG",
           "MAX_HEAD_DIM"]

KERNEL_SOURCE = (Path(__file__).resolve().parent / "csrc"
                 / "flash_fwd_3xtf32.cu")
TC_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd_tc.cu"
NEG = -1e30
MAX_HEAD_DIM = 128
ALIGN = 16                 # bytes: the unit of TMA and of 16-byte cp.async

CUDA_DTYPES = (torch.float32, torch.bfloat16)
_libs: dict = {}
_TAIL = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
         ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_int,
         ctypes.c_int64, ctypes.c_void_p]


def _library(source):
    if source not in _libs:
        from .._build import load
        lib = load(source)
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        if source == KERNEL_SOURCE:
            lib.flash_fwd_3xtf32_launch.argtypes = [vp] * 5 + _TAIL
            lib.flash_fwd_3xtf32_launch.restype = i32
        else:
            lib.flash_fwd_tc_launch.argtypes = [i32, vp, vp, vp, vp,
                                                vp] + _TAIL
            lib.flash_fwd_tc_launch.restype = i32
        _libs[source] = lib
    return _libs[source]


def pad_head_dim(t: torch.Tensor) -> torch.Tensor:
    """``t`` (..., D) with zero columns appended up to a row of a
    multiple of 16 bytes (D a multiple of 8 in bf16, of 4 in fp32),
    contiguous and 16-byte aligned: what TMA and 16-byte cp.async copies
    read.  Zero columns change no product q·k or p·v, so slicing the
    output back to D gives the unpadded result.  Returns ``t`` itself
    when it needs nothing."""
    D = t.shape[-1]
    pad = -D % (ALIGN // t.element_size())
    if pad:
        t = torch.nn.functional.pad(t, (0, pad))
    t = t.contiguous()
    if t.data_ptr() % ALIGN:
        t = t.clone()
    return t


def check_blocks(Sq: int, Sk: int, bq: int, bk: int) -> None:
    """Refuse the calls the reference refuses: ``S % min(b, S) != 0``."""
    if Sq < 1 or Sk < 1:
        raise ValueError(f"flash attention needs Sq, Sk >= 1; got {Sq}, {Sk}")
    bq_, bk_ = min(bq, Sq), min(bk, Sk)
    if bq_ < 1 or bk_ < 1 or Sq % bq_ or Sk % bk_:
        raise ValueError(f"flash attention needs Sq % min(bq, Sq) == 0 and "
                         f"Sk % min(bk, Sk) == 0; got Sq={Sq} bq={bq} "
                         f"Sk={Sk} bk={bk}")


def check_window(window) -> int:
    """The window as the kernels take it: 0 for none, else >= 1."""
    if window is None:
        return 0
    if int(window) < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    return int(window)


def check_cuda(name: str, *tensors: torch.Tensor) -> torch.dtype:
    """Every tensor on one CUDA device, of one dtype the kernels take
    (float32 or bfloat16).  Returns that dtype."""
    dev, dt = tensors[0].device, tensors[0].dtype
    if dt not in CUDA_DTYPES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got {dt}")
    for t in tensors:
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{name} kernel needs q, k, v of one dtype on "
                             f"one device; got {t.dtype} on {t.device} "
                             f"beside {dt} on {dev}")
    return dt


def launch_status(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def masked_scores(q, k, scale, causal, window, cdt):
    """s = q · kᵀ · scale in ``cdt``, NEG where the kernels mask.
    q (B,H,Sq,D), k (B,H,Sk,D)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(cdt), k.to(cdt)) * scale
    if causal:
        Sq, Sk = q.shape[2], k.shape[2]
        qi = torch.arange(Sq, device=q.device)[:, None]
        ki = torch.arange(Sk, device=q.device)[None, :]
        keep = ki <= qi
        if window is not None:
            keep &= ki > qi - window
        s = s.masked_fill(~keep, NEG)
    return s


def attn_pairs(Sq: int, Sk: int, causal: bool, window) -> int:
    """Unmasked (q, k) pairs of one (b, h) under the kernels' mask."""
    if not causal:
        return Sq * Sk
    i = np.arange(Sq)
    hi = np.minimum(i, Sk - 1)
    lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_names(dtype) -> tuple[str, str]:
    """The forward and the backward kernel that ``dtype`` runs."""
    if dtype == torch.float32:
        return "flash_fwd_3xtf32", "flash_bwd_3xtf32"
    return "flash_fwd_tc", "flash_bwd_tc"


def flash_fwd_work(B, H, KV, Sq, Sk, D, causal, window,
                   itemsize) -> tuple[int, int]:
    """(operations, bytes) of one forward launch: 2 products per
    unmasked pair (4·D flops); q, k, v read at ``itemsize`` (k, v at KV
    heads), o written at ``itemsize`` and lse in fp32."""
    pairs = attn_pairs(Sq, Sk, causal, window) * B * H
    q_el, kv_el = B * H * Sq * D, B * KV * Sk * D
    return 4 * D * pairs, itemsize * (2 * q_el + 2 * kv_el) + 4 * B * H * Sq


def flash_bwd_work(B, H, Sq, Sk, D, causal, window,
                   itemsize) -> tuple[int, int]:
    """(operations, bytes) of one fused backward launch: 5 products per
    unmasked pair (10·D flops); q, dO (Sq rows) and k, v (Sk rows,
    repeated to H heads) read at ``itemsize``, lse and δ in fp32, and
    dq, dk, dv written in fp32."""
    pairs = attn_pairs(Sq, Sk, causal, window) * B * H
    q_el, k_el = B * H * Sq * D, B * H * Sk * D
    return (10 * D * pairs, itemsize * (2 * q_el + 2 * k_el)
            + 4 * 2 * B * H * Sq + 4 * (q_el + 2 * k_el))


def _check_shapes(q, k, v, bq, bk):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash attention takes q (B,H,Sq,D) and k, v "
                         f"(B,KV,Sk,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KV < 1 or H % KV:
        raise ValueError(f"flash attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)} (H % KV must be 0)")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash attention kernels take D <= {MAX_HEAD_DIM}, "
                         f"got {D}")
    check_blocks(Sq, Sk, bq, bk)


def flash_fwd_plain(q, k, v, *, causal=True, window=None, scale=None,
                    bq=128, bk=128, out_dtype=None):
    """Dense masked softmax computing what the kernel computes: returns
    ``(o, lse)``, o in ``out_dtype`` (default q's dtype), lse (B,H,Sq)
    in fp32 (fp64 for fp64 inputs, so a gradcheck can run through it).
    Runs on whatever device the tensors lie on."""
    _check_shapes(q, k, v, bq, bk)
    check_window(window)
    D = q.shape[-1]
    rep = q.shape[1] // k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    cdt = torch.float64 if q.dtype == torch.float64 else torch.float32
    k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    s = masked_scores(q, k, scale, causal, window, cdt)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.to(cdt))
    return o.to(out_dtype or q.dtype), lse


def flash_fwd(q, k, v, *, causal=True, window=None, scale=None, bq=128,
              bk=128, out_dtype=None):
    """Flash attention forward returning ``(o, lse)``: the counterpart of
    ``flash_attention_pallas``, which returns o alone.

    Args:
      q: (B,H,Sq,D); k, v: (B,KV,Sk,D), H % KV == 0, D <= 128.
      causal / window: the kernels' mask (no Sk − Sq offset); window is
        None or >= 1 and only read when causal.
      scale: defaults to D ** -0.5.
      bq, bk: the reference's block sizes; only checked.
      out_dtype: o's dtype, q's by default (the autograd forward asks
        for float32 so that δ = rowsum(dO ⊙ O) uses the unrounded O).

    On bfloat16 CUDA tensors one ``flash_fwd_tc`` launch, on float32
    CUDA tensors one ``flash_fwd_3xtf32`` launch (q, k, v zero-padded to
    rows of a multiple of 16 bytes, o sliced back); on CPU tensors,
    :func:`flash_fwd_plain`; on meta tensors, empty meta outputs and a
    noted launch.
    """
    if meta.is_meta(q):
        _check_shapes(q, k, v, bq, bk)
        win = check_window(window)
        dt = check_cuda("flash_fwd", q, k, v)
        B, H, Sq, D = q.shape
        KV, Sk = k.shape[1], k.shape[2]
        flops, nbytes = flash_fwd_work(B, H, KV, Sq, Sk, D, causal, win,
                                       q.element_size())
        meta.note(flash_names(dt)[0], flops=flops, nbytes=nbytes)
        return (torch.empty(q.shape, dtype=out_dtype or dt, device="meta"),
                torch.empty((B, H, Sq), dtype=torch.float32, device="meta"))
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal=causal, window=window,
                               scale=scale, bq=bq, bk=bk,
                               out_dtype=out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu tensors, got "
                         f"{q.device}")
    _check_shapes(q, k, v, bq, bk)
    win = check_window(window)
    dt = check_cuda("flash_fwd", q, k, v)
    out_dtype = out_dtype or dt
    if out_dtype not in (dt, torch.float32):
        raise TypeError(f"flash_fwd writes o in q's dtype or float32, not "
                        f"{out_dtype}")
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    q, k, v = (pad_head_dim(t) for t in (q, k, v))
    Dp = q.shape[-1]
    o = torch.empty((B, H, Sq, Dp), dtype=out_dtype, device=q.device)
    args = (ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), B, H, KV, Sq, Sk, Dp,
            float(scale), int(bool(causal)), win, stream_of(q))
    if dt == torch.bfloat16:
        name = "flash_fwd_tc"
        err = _library(TC_SOURCE).flash_fwd_tc_launch(
            int(out_dtype == torch.float32), *args)
    else:
        name = "flash_fwd_3xtf32"
        err = _library(KERNEL_SOURCE).flash_fwd_3xtf32_launch(*args)
    launch_status(name, err)
    dispatch.record_launch(name)
    return (o[..., :D] if Dp != D else o), lse

