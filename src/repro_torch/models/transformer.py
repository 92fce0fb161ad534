"""Dense decoder-only transformer: init, forward, loss.

Counterpart of the dense-decoder part of ``src/repro/models/
transformer.py`` (``init_params``, ``forward``, ``loss_fn``).  Parameters
are a nested dict in the JAX package's layout: per-layer weights are
stacked on a leading ``n_layers`` axis under ``"layers"``, and a Python
loop over that axis takes the place of ``lax.scan``.

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
from . import attention as attn
from .config import ModelConfig
from .layers import dense_init, mlp_apply, mlp_init, norm_apply, norm_init

__all__ = ["init_params", "forward", "loss_fn", "params_from_jax"]


def _check(cfg: ModelConfig) -> None:
    if (cfg.mixer != "attn" or cfg.attention != "gqa" or cfg.moe_experts
            or cfg.enc_dec or cfg.frontend or cfg.tie_embeddings
            or not cfg.use_rope or not cfg.d_ff):
        raise NotImplementedError(
            f"{cfg.name}: only the dense RoPE GQA decoder with an untied "
            "head (rfast-100m) is ported yet")


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict[str, Any]:
    """fp32 CPU parameters drawn from ``gen``: N(0,1)·0.02 embedding,
    N(0,1)·d_in^-½ dense weights, unit norm scales (the JAX package's
    distributions; not its numbers)."""
    _check(cfg)
    L = (cfg.n_layers,)
    return {
        "embed": torch.randn(cfg.vocab, cfg.d_model, generator=gen) * 0.02,
        "final_norm": norm_init(cfg),
        "layers": {"ln1": norm_init(cfg, lead=L),
                   "attn": attn.gqa_init(cfg, gen, lead=L),
                   "ln2": norm_init(cfg, lead=L),
                   "mlp": mlp_init(cfg, gen, lead=L)},
        "lm_head": dense_init(gen, cfg.d_model, cfg.vocab),
    }


def params_from_jax(np_tree: dict, *, pad_to: int = 1,
                    device="cpu") -> tuple[dict, torch.Tensor]:
    """JAX ``init_params`` tree (nested dicts of numpy arrays) ->
    ``(params, flat)``: ``flat`` is the ``(p,)`` fp32 vector in the JAX
    ravel order (sorted key paths, zero tail to a multiple of
    ``pad_to``), and ``params`` are views into it."""
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


def _layer(cfg: ModelConfig, lp: dict, x: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    h = norm_apply(cfg, lp["ln1"], x)
    x = x + attn.gqa_apply(cfg, lp["attn"], h, positions,
                           window=cfg.attn_window)
    return x + mlp_apply(cfg, lp["mlp"], norm_apply(cfg, lp["ln2"], x))


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
