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

Under expert parallelism (``models/sharding.py``) a rank's tree holds a
block of ``E / M`` experts and a column / row block of the shared ones.
It routes every token with the whole router, exactly as above (the same
top-k, slots and drops over all E experts), but fills the buffer of its
own experts only, ``(R, E / M, C, d)``: a token routed to another
rank's expert adds nothing here.  Its ``y`` is then a partial sum
(its experts' outputs plus its shared block's), which
``sharding.parallel_block`` all-reduces, and its router loss the terms
of its own experts (``sharding.router_loss`` sums them).

Where a served batch's rows are split over the ``data`` axes, the
reference's ``prefill_step`` and ``serve_step`` still route the whole
batch in one ``moe_apply`` (GSPMD runs one program): T = B·S tokens,
capacity ``_capacity(cfg, B·S)``, a choice's slot its rank among all
earlier choices of its expert in the whole batch's (row, position,
choice) order.  The port's ranks each hold their rows, so
:func:`moe_apply` inside ``sharding.use_batch_group`` of G ranks (this
rank at index g, its rows after those of ranks 0 … g − 1) counts each
expert's choices on this rank, gathers the counts over the group (one
``all_gather_flat`` of E int64 a layer, on the device) and adds the
counts of ranks 0 … g − 1 to a choice's slot among this rank's tokens:
that is its slot in the whole batch, and it is kept when below the
whole batch's capacity ``C = _capacity(cfg, G·T)``.  The keep and drop
decisions are then exactly the reference's.  An expert's output for a
kept choice does not depend on its slot, so the rank's buffer holds its
kept choices at their slots among its own tokens: ``min(T, C)`` slots
an expert (at most T of a rank's choices go to one expert), a static
size, no host read.  Without a group (a batch that is not split, and
``moe_apply_rows``) C and the buffer are ``_capacity(cfg, T)`` as
before.  The load-balance loss stays the rank's own terms
(``_balance_loss`` of its tokens): neither package's ``prefill_step``
nor ``serve_step`` returns it.
"""
from __future__ import annotations

import torch

from . import sharding as msh
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


def _slots(cfg: ModelConfig, expert_idx: torch.Tensor, C: int,
           offset: torch.Tensor | None = None):
    """expert_idx (R, T, K) -> (pos, keep), (R, T·K) each: a (token,
    choice)'s slot in its expert, its rank among the (row, expert)
    pair's tokens in token order (a stable sort of the pair keys), and
    whether it is inside the capacity ``C``.  ``offset`` (E,) (R = 1
    only): the choices of each expert that come before this rank's in
    the whole batch, which a choice's slot in the whole batch adds to
    ``pos``; ``keep`` is then the whole batch's."""
    R, T, K = expert_idx.shape
    E, dev = cfg.moe_experts, expert_idx.device
    flat_e = expert_idx.reshape(R, T * K)
    key = (flat_e + E * torch.arange(R, device=dev)[:, None]).reshape(-1)
    order = torch.argsort(key, stable=True)
    sorted_k = key[order]
    starts = torch.searchsorted(sorted_k, torch.arange(R * E, device=dev))
    pos_sorted = torch.arange(R * T * K, device=dev) - starts[sorted_k]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    pos = pos.reshape(R, T * K)
    if offset is None:
        return pos, pos < C
    return pos, pos + offset[flat_e] < C


def _offsets(cfg: ModelConfig, expert_idx: torch.Tensor, group):
    """(E,) int64: each expert's choices on the ranks before this one in
    ``group``, from one gather of every rank's counts (on the device: no
    host read)."""
    from ..core.runtime_sharded import all_gather_flat
    E = cfg.moe_experts
    flat = expert_idx.reshape(-1)
    counts = torch.zeros(E, dtype=torch.int64, device=flat.device
                         ).index_add_(0, flat, torch.ones_like(flat))
    every = all_gather_flat(counts, group).reshape(group.size, E)
    return every[:group.index].sum(dim=0)


def _balance_loss(cfg: ModelConfig, probs: torch.Tensor,
                  top1: torch.Tensor, experts: slice) -> torch.Tensor:
    """(R,): the Switch-style load-balance loss's terms of ``experts``
    (all of them, or a rank's block): ``coef · E · mean(probs_e) ·
    (top-1 count_e / T)``, the counts carrying no gradient."""
    R, T, E = probs.shape
    me = probs.mean(dim=1)                                   # (R, E)
    ce = torch.zeros(R, E, device=probs.device).scatter_add_(
        1, top1, torch.ones(R, T, device=probs.device)) / T
    return cfg.router_aux_coef * E * torch.sum((me * ce)[:, experts],
                                               dim=-1)


def _route(cfg: ModelConfig, p: dict, x: torch.Tensor, group=None):
    """x (R, T, d): each of the R rows routes its T tokens alone, with
    capacity ``_capacity(cfg, T)``, to the experts ``p`` holds (all E, or
    a rank's block of them); under a batch ``group`` (R = 1) the row is
    this rank's part of the whole batch's G·T tokens, routed as the
    whole batch routes them, with capacity ``_capacity(cfg, G·T)``.
    Returns (y (R, T, d) in fp32 of those experts, aux (R,) of their
    terms)."""
    R, T, D = x.shape
    E, K = cfg.moe_experts, cfg.moe_top_k
    dev = x.device
    ep = p["experts"]
    n_local = ep["wi"].shape[-3]
    lo = msh.expert_offset(n_local, E)
    logits = x.to(torch.float32) @ p["router"]               # (R, T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)     # (R, T, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    aux = _balance_loss(cfg, probs, expert_idx[..., 0],
                        slice(lo, lo + n_local))
    if group is None:
        C = slots = _capacity(cfg, T)
        pos, keep = _slots(cfg, expert_idx, C)
    else:
        # a kept choice's slot in the whole batch is below C, its slot
        # among this rank's T tokens below T: min(T, C) slots hold them
        C = _capacity(cfg, group.size * T)
        slots = min(T, C)
        pos, keep = _slots(cfg, expert_idx, C,
                           _offsets(cfg, expert_idx, group))
    flat_e = expert_idx.reshape(R, T * K)
    # kept and routed to one of the experts held here
    mine = keep & (flat_e >= lo) & (flat_e < lo + n_local)
    gates = torch.where(mine, gate_vals.reshape(R, T * K), 0.0)

    rows = torch.arange(R, device=dev)[:, None].expand(R, T * K)
    safe_e = torch.where(mine, flat_e - lo, 0)
    safe_p = torch.where(mine, pos, slots - 1)
    xk = torch.repeat_interleave(x, K, dim=1)                # (R, T*K, D)
    buf = torch.zeros(R, n_local, slots, D, dtype=x.dtype,
                      device=dev).index_put(
        (rows, safe_e, safe_p), torch.where(mine[..., None], xk, 0)
        .to(x.dtype), accumulate=True)

    # the stacked experts (SwiGLU) as einsums over the expert axis
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
    together, as a part of the whole batch inside
    ``sharding.use_batch_group`` (aux this rank's terms)."""
    B, S, D = x.shape
    y, aux = _route(cfg, p, x.reshape(1, B * S, D),
                    msh.current_batch_group())
    return _shared(cfg, p, x, y.reshape(B, S, D)), aux[0]


def moe_apply_rows(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x (B, S, d) -> (y (B, S, d), aux (B,)): each row routed alone, as
    :func:`moe_apply` of that row."""
    y, aux = _route(cfg, p, x)
    return _shared(cfg, p, x, y), aux
