"""Layer primitives of the dense decoder: init, RMSNorm, SwiGLU, RoPE.

Counterpart of the parts of ``src/repro/models/layers.py`` that
``rfast-100m`` uses, as plain functions on tensors in the JAX package's
layouts (weights ``(d_in, d_out)``, activations ``(B, S, ...)``).
"""
from __future__ import annotations

import torch

from .config import ModelConfig

__all__ = ["dense_init", "norm_init", "norm_apply", "mlp_init", "mlp_apply",
           "rope_cos_sin", "apply_rope"]


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               lead: tuple = (), scale: float | None = None) -> torch.Tensor:
    """N(0, 1)·d_in^-½ weights of shape ``lead + (d_in, d_out)`` (fp32,
    CPU, drawn from ``gen``)."""
    scale = scale if scale is not None else d_in ** -0.5
    return torch.randn(*lead, d_in, d_out, generator=gen) * scale


def norm_init(cfg: ModelConfig, *, lead: tuple = ()) -> dict:
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm={cfg.norm!r} is not ported yet")
    return {"scale": torch.ones(*lead, cfg.d_model)}


def norm_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm with the JAX package's epsilon (1e-6), in fp32."""
    xf = x.to(torch.float32)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
    return (xf * r).to(x.dtype) * p["scale"]


def mlp_init(cfg: ModelConfig, gen: torch.Generator, *,
             lead: tuple = ()) -> dict:
    if cfg.mlp != "swiglu" or cfg.mlp_bias:
        raise NotImplementedError("only the bias-free SwiGLU MLP is ported")
    d, ff = cfg.d_model, cfg.d_ff
    return {"wi": dense_init(gen, d, ff, lead=lead),
            "wo": dense_init(gen, ff, d, lead=lead),
            "wg": dense_init(gen, d, ff, lead=lead)}


def mlp_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(x @ p["wg"]) * (x @ p["wi"])
    return h @ p["wo"]


def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float):
    """positions (...,) -> cos/sin (..., dim/2) in fp32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B,S,H,D); cos/sin (S,D/2): rotate the two halves of D."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)
