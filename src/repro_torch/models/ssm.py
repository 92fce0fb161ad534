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

The decode path (``ssm_cache``, ``ssm_decode``) waits for serving and
raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import dense_init

__all__ = ["ssm_init", "ssm_apply", "ssm_decode", "ssm_cache",
           "selective_scan_ref"]

_NOT_PORTED = "is not ported yet (serving, ROADMAP Queue 1 item 6)"


def ssm_init(cfg: ModelConfig, gen: torch.Generator, *,
             lead: tuple = ()) -> dict:
    """fp32 CPU parameters of shape ``lead + ...`` drawn from ``gen``, in
    the JAX package's distributions: N(0,1)·d_in^-½ projections,
    N(0,1)·K^-½ conv taps, zero conv bias, ``dt_bias`` −4.6
    (softplus⁻¹(0.01)), ``A_log = log(1..N)`` per channel, D ones."""
    d, di, N, dtr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    K = cfg.ssm_conv
    A = torch.arange(1, N + 1, dtype=torch.float32).expand(*lead, di, N)
    return {
        "in_proj": dense_init(gen, d, 2 * di, lead=lead),
        "conv_w": torch.randn(*lead, K, di, generator=gen) * K ** -0.5,
        "conv_b": torch.zeros(*lead, di),
        "x_proj": dense_init(gen, di, dtr + 2 * N, lead=lead),
        "dt_proj": dense_init(gen, dtr, di, lead=lead),
        "dt_bias": torch.full((*lead, di), -4.6),
        "A_log": torch.log(A),
        "D": torch.ones(*lead, di),
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


def _ssm_inner(cfg: ModelConfig, p: dict, xz: torch.Tensor, conv_fn):
    from ..kernels.ssm_scan.ops import SelectiveScanFn
    di = cfg.d_inner
    x, z = xz[..., :di], xz[..., di:]
    x = F.silu(conv_fn(x))
    proj = x @ p["x_proj"]
    dtr, N = cfg.dt_rank, cfg.ssm_state
    dt = F.softplus(proj[..., :dtr] @ p["dt_proj"] + p["dt_bias"])
    Bc = proj[..., dtr:dtr + N]
    Cc = proj[..., dtr + N:]
    A = -torch.exp(p["A_log"])
    y, h = SelectiveScanFn.apply(x, dt, A, Bc, Cc, p["D"])
    y = (y * F.silu(z.to(torch.float32))).to(xz.dtype)
    return y, h, x


def ssm_apply(cfg: ModelConfig, p: dict, x: torch.Tensor,
              return_state: bool = False):
    """Full-sequence mamba block: x (B,S,D) -> (B,S,D).
    ``return_state`` also returns the decode cache (conv window, h)."""
    xz = x @ p["in_proj"]
    y, h, _ = _ssm_inner(
        cfg, p, xz, lambda u: _conv_causal(u, p["conv_w"], p["conv_b"]))
    out = y @ p["out_proj"]
    if return_state:
        K, di = cfg.ssm_conv, cfg.d_inner
        raw = xz[..., :di]
        pad = F.pad(raw, (0, 0, max(0, K - 1 - raw.shape[1]), 0))
        conv = (pad[:, -(K - 1):, :] if K > 1 else
                xz.new_zeros((x.shape[0], 0, di)))
        return out, {"conv": conv, "h": h}
    return out


def ssm_cache(cfg: ModelConfig, batch: int, dtype):
    raise NotImplementedError(f"ssm_cache {_NOT_PORTED}")


def ssm_decode(cfg: ModelConfig, p: dict, x, cache):
    raise NotImplementedError(f"ssm_decode {_NOT_PORTED}")
