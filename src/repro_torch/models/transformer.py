"""Decoder-only transformer with attention, SSM or hybrid mixers: init,
forward, loss.

Counterpart of the decoder-only part of ``src/repro/models/
transformer.py`` (``init_params``, ``_layer_init``, ``_mixer_full``,
``forward``, ``loss_fn``) for the RoPE GQA attention mixer
(``rfast-100m``), the Mamba-1 SSM mixer (``falcon-mamba-7b``, no MLP when
``d_ff`` is 0) and the hybrid of the two (``hymba-1.5b``: the mean of
attention and SSM on the same input).  Parameters are a nested dict in
the JAX package's layout: per-layer weights are stacked on a leading
``n_layers`` axis under ``"layers"``, and a Python loop over that axis
takes the place of ``lax.scan``.

:func:`params_from_jax` takes the JAX ``init_params`` tree (as nested
dicts of numpy arrays) and returns the port's parameters as views into
one flat vector in the JAX ravel order, so a flat ``x0`` from either
package means the same weights.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.paramvec import make_ravel_spec, unravel
from ..kernels.rfast_update.dispatch import resolve_device
from . import attention as attn
from . import ssm as ssm_mod
from .config import ModelConfig
from .layers import dense_init, mlp_apply, mlp_init, norm_apply, norm_init

__all__ = ["init_params", "forward", "loss_fn", "params_from_jax"]


def _check(cfg: ModelConfig) -> None:
    if (cfg.attention != "gqa" or cfg.moe_experts or cfg.enc_dec
            or cfg.frontend or cfg.tie_embeddings
            or (cfg.mixer != "ssm" and not cfg.use_rope)):
        raise NotImplementedError(
            f"{cfg.name}: only decoders with RoPE GQA attention, SSM or "
            "hybrid mixers, an optional dense MLP and an untied head "
            "(rfast-100m, falcon-mamba-7b, hymba-1.5b) are ported yet")


def _layer_init(cfg: ModelConfig, gen: torch.Generator,
                lead: tuple) -> dict[str, Any]:
    p: dict[str, Any] = {"ln1": norm_init(cfg, lead=lead)}
    if cfg.mixer in ("attn", "hybrid"):
        p["attn"] = attn.gqa_init(cfg, gen, lead=lead)
    if cfg.mixer in ("ssm", "hybrid"):
        p["ssm"] = ssm_mod.ssm_init(cfg, gen, lead=lead)
    if cfg.d_ff:
        p["ln2"] = norm_init(cfg, lead=lead)
        p["mlp"] = mlp_init(cfg, gen, lead=lead)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict[str, Any]:
    """fp32 CPU parameters drawn from ``gen``: N(0,1)·0.02 embedding,
    N(0,1)·d_in^-½ dense weights, unit norm scales and the SSM's own
    initial values (the JAX package's distributions; not its numbers)."""
    _check(cfg)
    return {
        "embed": torch.randn(cfg.vocab, cfg.d_model, generator=gen) * 0.02,
        "final_norm": norm_init(cfg),
        "layers": _layer_init(cfg, gen, (cfg.n_layers,)),
        "lm_head": dense_init(gen, cfg.d_model, cfg.vocab),
    }


def params_from_jax(np_tree: dict, *, pad_to: int = 1,
                    device=None) -> tuple[dict, torch.Tensor]:
    """JAX ``init_params`` tree (nested dicts of numpy arrays) ->
    ``(params, flat)``: ``flat`` is the ``(p,)`` fp32 vector in the JAX
    ravel order (sorted key paths, zero tail to a multiple of
    ``pad_to``) on ``device`` (``cuda`` unless the caller asks for
    another), and ``params`` are views into it."""
    device = resolve_device(device)
    spec = make_ravel_spec(np_tree, pad_to=pad_to)
    flat = torch.zeros(spec.p, dtype=torch.float32)
    params = unravel(spec, flat)
    for path in spec.paths:
        src, dst = np_tree, params
        for k in path:
            src, dst = src[k], dst[k]
        dst.copy_(torch.from_numpy(np.array(src, np.float32)))
    flat = flat.to(device)
    return unravel(spec, flat), flat


def _mixer_full(cfg: ModelConfig, lp: dict, h: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    if cfg.mixer == "ssm":
        return ssm_mod.ssm_apply(cfg, lp["ssm"], h)
    a = attn.gqa_apply(cfg, lp["attn"], h, positions, window=cfg.attn_window)
    if cfg.mixer == "hybrid":
        return 0.5 * (a + ssm_mod.ssm_apply(cfg, lp["ssm"], h))
    return a


def _layer(cfg: ModelConfig, lp: dict, x: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    x = x + _mixer_full(cfg, lp, norm_apply(cfg, lp["ln1"], x), positions)
    if "mlp" in lp:
        x = x + mlp_apply(cfg, lp["mlp"], norm_apply(cfg, lp["ln2"], x))
    return x


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    """tokens (B, S) -> (logits (B, S, vocab), aux loss 0)."""
    _check(cfg)
    x = params["embed"][tokens]
    positions = torch.arange(x.shape[1], device=x.device)
    layers = params["layers"]
    for li in range(cfg.n_layers):
        lp = {name: {k: v[li] for k, v in sub.items()}
              for name, sub in layers.items()}
        x = _layer(cfg, lp, x, positions)
    x = norm_apply(cfg, params["final_norm"], x)
    return x @ params["lm_head"], torch.zeros((), device=x.device)


def loss_fn(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy via logsumexp (the JAX package's
    ``ce="lse"``)."""
    logits, aux = forward(cfg, params, tokens)
    lse = torch.logsumexp(logits.to(torch.float32), dim=-1)
    tgt = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (lse - tgt.to(torch.float32)).mean() + aux
