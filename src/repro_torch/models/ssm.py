"""Mamba-1 selective SSM block (falcon-mamba's layer, hymba's SSM heads).

Counterpart of ``ssm_init``, ``selective_scan_ref``, ``_conv_causal``,
``_ssm_inner`` and ``ssm_apply`` in ``src/repro/models/ssm.py``, as plain
functions on tensors in the JAX package's layouts.  The model's scan goes
through :class:`~repro_torch.kernels.ssm_scan.ops.SelectiveScanFn`: the
hand-written CUDA kernels on CUDA tensors (their plain twins on CPU
tensors), the forward scan and a backward scan from the forward's
checkpoints, which compute the gradient JAX takes of its ``lax.scan``
over :func:`selective_scan_ref`.  The reference's model calls
``selective_scan_ref`` itself; both compute the same function from
h0 = 0, which is how ``ssm_apply`` calls it.

``x_proj``'s B and C columns are slices of one projection; the kernel
takes their row strides, so they reach it without a copy.

Under tensor parallelism (``models/sharding.py``) :func:`ssm_apply` runs
on this rank's blocks of the leaves, the reference's ``ssm_inner`` →
``model`` layout: x and z on this rank's ``d_inner / M`` channels
(``sharding.ssm_channels``), the conv, the gate and both scan kernels on
them, ``x_proj`` row-parallel (``sharding.ssm_proj``) and ``out_proj``'s
partial sum left to the caller's ``sharding.parallel_block``.  Prefill
and decode run so too: the decode state (the conv window of the conv's
input and h) is that of the rank's channels, the reference's
``cache_pspecs`` layout of ``conv`` and ``h``.

Decode (``ssm_cache``, ``ssm_decode``, counterparts of the reference's)
carries the conv window and the fp32 state h, and takes one step from h
with :func:`selective_scan_ref` in PyTorch ops, as the reference's decode
runs its ``selective_scan_ref`` in jnp outside any kernel: neither the
TPU kernel nor ``ssm_scan.cu`` takes an initial state.  Prefill
(``ssm_apply(return_state=True)``) runs the kernel, which returns h_last.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import sharding as msh
from .config import ModelConfig
from .layers import dense_init

__all__ = ["ssm_init", "ssm_apply", "ssm_decode", "ssm_cache",
           "selective_scan_ref"]

def ssm_init(cfg: ModelConfig, gen: torch.Generator, *,
             lead: tuple = ()) -> dict:
    """fp32 parameters of shape ``lead + ...`` drawn from ``gen`` on its
    device, in the JAX package's distributions: N(0,1)·d_in^-½
    projections, N(0,1)·K^-½ conv taps, zero conv bias, ``dt_bias`` −4.6
    (softplus⁻¹(0.01)), ``A_log = log(1..N)`` per channel, D ones."""
    d, di, N, dtr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    K, dev = cfg.ssm_conv, gen.device
    A = torch.arange(1, N + 1, dtype=torch.float32,
                     device=dev).expand(*lead, di, N)
    return {
        "in_proj": dense_init(gen, d, 2 * di, lead=lead),
        "conv_w": torch.randn(*lead, K, di, generator=gen,
                              device=dev).mul_(K ** -0.5),
        "conv_b": torch.zeros(*lead, di, device=dev),
        "x_proj": dense_init(gen, di, dtr + 2 * N, lead=lead),
        "dt_proj": dense_init(gen, dtr, di, lead=lead),
        "dt_bias": torch.full((*lead, di), -4.6, device=dev),
        "A_log": torch.log(A),
        "D": torch.ones(*lead, di, device=dev),
        "out_proj": dense_init(gen, di, d, lead=lead),
    }


def selective_scan_ref(u, dt, A, Bc, Cc, D, h0=None):
    """Oracle selective scan, a loop over S.

    u (B,S,di) inputs; dt (B,S,di) timestep; A (di,N); Bc/Cc (B,S,N);
    D (di,); h0 (B,di,N) or None for zeros.  Returns (y (B,S,di),
    h_last (B,di,N)), fp32."""
    Bsz, S, di = u.shape
    N = A.shape[1]
    f32 = torch.float32
    h = (torch.zeros((Bsz, di, N), dtype=f32, device=u.device)
         if h0 is None else h0)
    uf, dtf, Bf, Cf = (a.to(f32) for a in (u, dt, Bc, Cc))
    ys = []
    for t in range(S):
        dA = torch.exp(dtf[:, t, :, None] * A[None])             # (B,di,N)
        dB = dtf[:, t, :, None] * Bf[:, t, None, :]              # (B,di,N)
        h = dA * h + dB * uf[:, t, :, None]
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = torch.stack(ys, 1) if ys else uf.new_zeros((Bsz, 0, di))
    return y + uf * D[None, None], h


def _conv_causal(x, w, b):
    """Depthwise causal conv1d: x (B,S,di), w (K,di)."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None] for i in range(K))
    return y + b[None, None]


def _ssm_inner(cfg: ModelConfig, p: dict, xz: torch.Tensor, conv_fn,
               h0=None):
    """The block between the two projections.  From h0 = 0 (``h0`` None)
    the scan is :class:`SelectiveScanFn` (the kernel on the card); from a
    decode state it is :func:`selective_scan_ref`.  On a rank's blocks
    of the leaves, x and z are its channels and ``x_proj``'s partial
    sums are all-reduced.  Returns ``(y, h, x)``: x the conv's input at
    those channels (after the exchange), of which the decode cache keeps
    the last K − 1 rows."""
    from ..kernels.ssm_scan.ops import SelectiveScanFn
    di = cfg.d_inner
    raw, z = msh.ssm_channels(xz, di)
    x = F.silu(conv_fn(raw))
    proj = msh.ssm_proj(x @ p["x_proj"], di, x.shape[-1])
    dtr, N = cfg.dt_rank, cfg.ssm_state
    dt = F.softplus(proj[..., :dtr] @ p["dt_proj"] + p["dt_bias"])
    Bc = proj[..., dtr:dtr + N]
    Cc = proj[..., dtr + N:]
    # fp32 whatever the weights' dtype: the scan kernels take an fp32 A,
    # and the reference keeps A_log an fp32 leaf of a bf16 tree
    A = -torch.exp(p["A_log"].float())
    if h0 is None:
        y, h = SelectiveScanFn.apply(x, dt, A, Bc, Cc, p["D"])
    else:
        y, h = selective_scan_ref(x, dt, A, Bc, Cc, p["D"], h0)
    y = (y * F.silu(z.to(torch.float32))).to(xz.dtype)
    return y, h, raw


def ssm_apply(cfg: ModelConfig, p: dict, x: torch.Tensor,
              return_state: bool = False):
    """Full-sequence mamba block: x (B,S,D) -> (B,S,D).
    ``return_state`` also returns the decode cache (conv window, h) of
    the block's channels (a rank's, under tensor parallelism)."""
    xz = x @ p["in_proj"]
    y, h, raw = _ssm_inner(
        cfg, p, xz, lambda u: _conv_causal(u, p["conv_w"], p["conv_b"]))
    out = y @ p["out_proj"]
    if return_state:
        K = cfg.ssm_conv
        pad = F.pad(raw, (0, 0, max(0, K - 1 - raw.shape[1]), 0))
        conv = (pad[:, -(K - 1):, :] if K > 1 else
                raw.new_zeros((x.shape[0], 0, raw.shape[-1])))
        return out, {"conv": conv, "h": h}
    return out


def ssm_cache(cfg: ModelConfig, batch: int, dtype, *, lead: tuple = (),
              device=None) -> dict:
    """Zero decode state ``lead + ...``: the conv window (batch, K−1, di)
    in ``dtype`` and h (batch, di, N) in fp32."""
    di, N, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {
        "conv": torch.zeros((*lead, batch, K - 1, di), dtype=dtype,
                            device=device),
        "h": torch.zeros((*lead, batch, di, N), dtype=torch.float32,
                         device=device),
    }


def ssm_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict):
    """One-token decode: x (B,1,D) -> (out (B,1,D), new {"conv", "h"}).
    The state is the block's channels' (a rank's, under tensor
    parallelism: ``out`` is then its partial sum of ``out_proj``'s
    rows)."""
    K = cfg.ssm_conv
    xz = x @ p["in_proj"]

    def conv_fn(u):                                   # u (B,1,di)
        win = torch.cat([cache["conv"], u], dim=1)    # (B,K,di)
        y = torch.einsum("bkd,kd->bd", win, p["conv_w"]) + p["conv_b"]
        return y[:, None, :]

    y, h, raw = _ssm_inner(cfg, p, xz, conv_fn, cache["h"])
    conv = (torch.cat([cache["conv"][:, 1:], raw], dim=1)
            if K > 1 else cache["conv"])
    return y @ p["out_proj"], {"conv": conv, "h": h}
