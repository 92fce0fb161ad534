"""Flash attention forward: online softmax over kv tiles, one launch.

Counterpart of ``src/repro/kernels/flash_attention/kernel.py::
flash_attention_pallas``: the (B,H,S,D) layout, the same keyword
arguments (less ``interpret``), the same mask and the same rule that
``S % min(b, S) == 0`` for the block sizes ``bq`` / ``bk`` (the CUDA
kernel's own tile is 64 × 64 and takes ragged edges, so ``bq`` / ``bk``
only decide which calls are refused, as they do in the reference).

Semantics, shared by the kernel and its plain twin:

  s   = q · kᵀ · scale, masked to NEG = −1e30 where ``causal`` and not
        (ki ≤ qi [and ki > qi − window]) — no Sk − Sq offset, as in the
        TPU kernel (``ref.attention_ref`` has the offset);
  o   = softmax(s) · v in q's dtype (or ``out_dtype``), fp32 inside;
  lse = logsumexp(s) per row, fp32 (B,H,Sq) — what the backward needs.

GQA: query head h reads kv head ``h // (H // KV)``; k/v are never
repeated in memory.  Where it runs follows from the tensors: on bf16
CUDA tensors :func:`flash_fwd` launches the tensor-core kernel
(``csrc/flash_fwd_tc.cu``: wgmma and TMA), on fp32 CUDA tensors the
CUDA-core kernel (``csrc/flash_fwd.cu``), each or it raises; on CPU
tensors it runs :func:`flash_fwd_plain`, a dense masked softmax
computing the same function.  Nothing falls back from one to another.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..rfast_update import dispatch

__all__ = ["flash_fwd", "flash_fwd_plain", "masked_scores", "check_blocks",
           "pad_head_dim", "KERNEL_SOURCE", "TC_SOURCE", "NEG",
           "MAX_HEAD_DIM"]

KERNEL_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"
TC_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd_tc.cu"
NEG = -1e30
MAX_HEAD_DIM = 128
TMA_ALIGN = 16             # bytes: TMA's global address and stride unit

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
            lib.flash_fwd_launch.argtypes = [vp] * 5 + _TAIL
            lib.flash_fwd_launch.restype = i32
        else:
            lib.flash_fwd_tc_launch.argtypes = [i32, vp, vp, vp, vp,
                                                vp] + _TAIL
            lib.flash_fwd_tc_launch.restype = i32
        _libs[source] = lib
    return _libs[source]


def pad_head_dim(t: torch.Tensor) -> torch.Tensor:
    """bf16 ``t`` (..., D) with zero columns appended up to the next
    multiple of 8, contiguous and 16-byte aligned: what TMA reads (its
    row stride must be a multiple of 16 bytes).  Zero columns change no
    product q·k or p·v, so slicing the output back to D gives the
    unpadded result.  Returns ``t`` itself when it needs nothing."""
    D = t.shape[-1]
    pad = -D % (TMA_ALIGN // 2)
    if pad:
        t = torch.nn.functional.pad(t, (0, pad))
    t = t.contiguous()
    if t.data_ptr() % TMA_ALIGN:
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

    On bfloat16 CUDA tensors the tensor-core kernel runs and counts one
    ``flash_fwd_tc`` launch (q, k, v zero-padded to a head dim that is a
    multiple of 8, o sliced back); on float32 CUDA tensors the CUDA-core
    kernel counts one ``flash_fwd``; on CPU tensors,
    :func:`flash_fwd_plain`.
    """
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
    if dt == torch.bfloat16:
        q, k, v = (pad_head_dim(t) for t in (q, k, v))
        Dp = q.shape[-1]
        o = torch.empty((B, H, Sq, Dp), dtype=out_dtype, device=q.device)
        err = _library(TC_SOURCE).flash_fwd_tc_launch(
            int(out_dtype == torch.float32), ptr(q), ptr(k), ptr(v), ptr(o),
            ptr(lse), B, H, KV, Sq, Sk, Dp, float(scale), int(bool(causal)),
            win, stream_of(q))
        launch_status("flash_fwd_tc", err)
        dispatch.record_launch("flash_fwd_tc")
        return (o[..., :D] if Dp != D else o), lse
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty((B, H, Sq, D), dtype=out_dtype, device=q.device)
    err = _library(KERNEL_SOURCE).flash_fwd_launch(
        ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), B, H, KV, Sq, Sk, D,
        float(scale), int(bool(causal)), win, stream_of(q))
    launch_status("flash_fwd", err)
    dispatch.record_launch("flash_fwd")
    return o, lse

