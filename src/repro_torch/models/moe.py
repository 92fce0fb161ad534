"""Mixture-of-Experts MLP: top-k routing and capacity-bounded dispatch.

Counterpart of ``moe_init``, ``_capacity`` and ``moe_apply`` in
``src/repro/models/moe.py`` (phi-3.5-MoE: 16 routed experts, top-2;
deepseek-v2: 2 shared + 160 routed, top-6).  A fp32 router picks each
token's top-k experts from the softmax of its logits; the gates are
renormalised over the k.  Every expert takes at most ``C`` tokens
(``_capacity``): a token's slot inside its expert is its rank among that
expert's tokens in token order (a *stable* sort of the expert ids, as
``jnp.argsort`` is), and a token past ``C`` is dropped — it adds a zero
at slot ``(0, C − 1)`` and gets no output from that expert.  The
dispatch buffer ``(E, C, d)`` then goes through the stacked experts as
einsums over the expert axis, so each expert's weights are read once,
and every expert multiplies its whole buffer (the reference's dense
capacity buffer).  Shared experts are dense MLPs added to every token.
The Switch load-balance loss is ``coef · E · Σ_e mean(probs_e) ·
(top-1 count_e / T)``; the counts carry no gradient.

:func:`moe_apply` routes all B·S tokens of ``x`` together, as the
reference does.  :func:`moe_apply_rows` routes each batch row alone,
its capacity that of one row: the reference's serving decode is a
``vmap`` of the single-sequence step over slots, so each slot's MoE runs
with T = 1.  Both are one routine over a leading row axis: the keys of
the sort are (row, expert) and the buffer ``(R, E, C, d)``.
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import dense_init, mlp_apply, mlp_init

__all__ = ["moe_init", "moe_apply", "moe_apply_rows"]


def moe_init(cfg: ModelConfig, gen: torch.Generator, *,
             lead: tuple = ()) -> dict:
    """Router ``lead + (d, E)`` at scale 0.02, experts stacked on an E
    axis ``lead + (E, ...)``, shared experts ``lead + (n_shared, ...)``."""
    E = cfg.moe_experts
    p = {"router": dense_init(gen, cfg.d_model, E, lead=lead, scale=0.02),
         "experts": mlp_init(cfg, gen, lead=(*lead, E))}
    if cfg.moe_shared:
        p["shared"] = mlp_init(cfg, gen, lead=(*lead, cfg.moe_shared))
    return p


def _capacity(cfg: ModelConfig, T: int) -> int:
    c = int(cfg.capacity_factor * T * cfg.moe_top_k / cfg.moe_experts)
    return max(8, -(-c // 8) * 8)   # round up to 8


def _route(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x (R, T, d): each of the R rows routes its T tokens alone, with
    capacity ``_capacity(cfg, T)``.  Returns (y (R, T, d) in fp32 of the
    routed experts, aux (R,))."""
    R, T, D = x.shape
    E, K = cfg.moe_experts, cfg.moe_top_k
    dev = x.device
    logits = x.to(torch.float32) @ p["router"]               # (R, T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)     # (R, T, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # Switch-style load-balance loss (top-1 counts, no gradient)
    me = probs.mean(dim=1)                                   # (R, E)
    ce = torch.zeros(R, E, device=dev).scatter_add_(
        1, expert_idx[..., 0], torch.ones(R, T, device=dev)) / T
    aux = cfg.router_aux_coef * E * torch.sum(me * ce, dim=-1)

    # a token's slot in its expert: its rank among the (row, expert)
    # pair's tokens in token order, from a stable sort of the pair keys
    C = _capacity(cfg, T)
    flat_e = expert_idx.reshape(R, T * K)
    key = (flat_e + E * torch.arange(R, device=dev)[:, None]).reshape(-1)
    order = torch.argsort(key, stable=True)
    sorted_k = key[order]
    starts = torch.searchsorted(sorted_k, torch.arange(R * E, device=dev))
    pos_sorted = torch.arange(R * T * K, device=dev) - starts[sorted_k]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    pos = pos.reshape(R, T * K)
    keep = pos < C
    gates = torch.where(keep, gate_vals.reshape(R, T * K), 0.0)

    rows = torch.arange(R, device=dev)[:, None].expand(R, T * K)
    safe_e = torch.where(keep, flat_e, 0)
    safe_p = torch.where(keep, pos, C - 1)
    xk = torch.repeat_interleave(x, K, dim=1)                # (R, T*K, D)
    buf = torch.zeros(R, E, C, D, dtype=x.dtype, device=dev).index_put(
        (rows, safe_e, safe_p), torch.where(keep[..., None], xk, 0)
        .to(x.dtype), accumulate=True)

    # the stacked experts (SwiGLU) as einsums over the expert axis
    ep = p["experts"]
    h = torch.einsum("recd,edf->recf", buf, ep["wi"])
    h = torch.nn.functional.silu(
        torch.einsum("recd,edf->recf", buf, ep["wg"])) * h
    out = torch.einsum("recf,efd->recd", h, ep["wo"])

    yk = out[rows, safe_e, safe_p]                           # (R, T*K, D)
    y = (yk.to(torch.float32) * gates[..., None]).reshape(
        R, T, K, D).sum(dim=2)
    return y, aux


def _shared(cfg: ModelConfig, p: dict, x: torch.Tensor,
            y: torch.Tensor) -> torch.Tensor:
    for i in range(cfg.moe_shared):
        spi = {k: v[i] for k, v in p["shared"].items()}
        y = y + mlp_apply(cfg, spi, x).to(torch.float32)
    return y.to(x.dtype)


def moe_apply(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x (B, S, d) -> (y (B, S, d), aux ()): all B·S tokens routed
    together."""
    B, S, D = x.shape
    y, aux = _route(cfg, p, x.reshape(1, B * S, D))
    return _shared(cfg, p, x, y.reshape(B, S, D)), aux[0]


def moe_apply_rows(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x (B, S, d) -> (y (B, S, d), aux (B,)): each row routed alone, as
    :func:`moe_apply` of that row."""
    y, aux = _route(cfg, p, x)
    return _shared(cfg, p, x, y), aux
