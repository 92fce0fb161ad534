"""Layer primitives of the models: init, the three norms, the MLPs,
rotary and sinusoidal positions.

Counterpart of ``src/repro/models/layers.py`` (RMSNorm, LayerNorm and
OLMo's non-parametric LayerNorm; the SwiGLU MLP and whisper's GELU MLP,
either with the biases ``bi``/``bo``; rotary positions and the
absolute sinusoidal ones), as plain functions on tensors in the JAX
package's layouts (weights ``(d_in, d_out)``, activations
``(B, S, ...)``).
"""
from __future__ import annotations

import torch

from .config import ModelConfig

__all__ = ["dense_init", "norm_init", "norm_apply", "mlp_init", "mlp_apply",
           "rope_cos_sin", "apply_rope", "sinusoidal_positions"]


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               lead: tuple = (), scale: float | None = None) -> torch.Tensor:
    """N(0, 1)·d_in^-½ weights of shape ``lead + (d_in, d_out)`` (fp32,
    drawn from ``gen`` on its device: the CPU unless ``gen`` is a CUDA
    generator)."""
    scale = scale if scale is not None else d_in ** -0.5
    return torch.randn(*lead, d_in, d_out, generator=gen,
                       device=gen.device).mul_(scale)


def norm_init(cfg: ModelConfig, *, lead: tuple = (),
              device=None) -> dict:
    d = cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": torch.ones(*lead, d, device=device)}
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(*lead, d, device=device),
                "bias": torch.zeros(*lead, d, device=device)}
    if cfg.norm == "nonparam_ln":      # OLMo: no affine parameters
        return {}
    raise ValueError(cfg.norm)


def norm_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm, LayerNorm or the non-parametric LayerNorm, in fp32 with
    the JAX package's epsilon (1e-6) and its population variance."""
    xf = x.to(torch.float32)
    if cfg.norm == "rmsnorm":
        r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
        return (xf * r).to(x.dtype) * p["scale"]
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + 1e-6)
    if cfg.norm == "layernorm":
        return y.to(x.dtype) * p["scale"] + p["bias"]
    return y.to(x.dtype)               # nonparam_ln


def mlp_init(cfg: ModelConfig, gen: torch.Generator, *,
             lead: tuple = ()) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    p = {"wi": dense_init(gen, d, ff, lead=lead),
         "wo": dense_init(gen, ff, d, lead=lead)}
    if cfg.mlp == "swiglu":
        p["wg"] = dense_init(gen, d, ff, lead=lead)
    if cfg.mlp_bias:
        p["bi"] = torch.zeros(*lead, ff, device=gen.device)
        p["bo"] = torch.zeros(*lead, d, device=gen.device)
    return p


def mlp_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU, or the GELU MLP in the tanh form (``jax.nn.gelu``'s
    default, ``approximate=True``; the erf form differs by 1.5e-4 at 1).
    The output bias ``bo`` is added where ``p`` holds it: a row-parallel
    block (``models.sharding.parallel_block``) adds it once, after its
    ranks' partial sums are reduced."""
    h = x @ p["wi"]
    if cfg.mlp_bias:
        h = h + p["bi"]
    if cfg.mlp == "swiglu":
        h = torch.nn.functional.silu(x @ p["wg"]) * h
    else:
        h = torch.nn.functional.gelu(h, approximate="tanh")
    y = h @ p["wo"]
    if "bo" in p:
        y = y + p["bo"]
    return y


def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float):
    """positions (...,) -> cos/sin (..., dim/2) in fp32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B,S,H,D); cos/sin (S,D/2), or (B,S,D/2) for a position per
    batch row (the serving engine's slots): rotate the two halves of D."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    if cos.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d: int) -> torch.Tensor:
    """positions (...,) -> absolute embeddings (..., d) in fp32: the sines
    of the ``d // 2`` frequencies 10000^(−i / (d/2)), then their cosines."""
    half = d // 2
    log_base = torch.log(torch.tensor(10_000.0, device=positions.device))
    freq = torch.exp(-log_base * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
