"""Decoder-only and enc-dec transformers with attention, SSM or hybrid
mixers and stub modality frontends: init, forward, loss, and the
serving side's KV-cache decode and prefill.

Counterpart of ``src/repro/models/transformer.py`` (``init_params``,
``_layer_init``, ``_enc_layer_init``, ``_mixer_full``, ``_layer_full``,
``_run_encoder``, ``forward``, ``loss_fn``; ``cache_capacity``,
``init_cache``, ``decode_step``, ``decode_step_slots``, ``prefill``,
``prefill_cache``, ``prefill_rows``) for every arch of the JAX
package: the attention mixers GQA (``rfast-100m``, ``llama3-8b``,
``deepseek-7b``, ``olmo-1b``, ``qwen2.5-3b`` with q/k/v biases,
``phi3.5-moe-42b-a6.6b``, ``pixtral-12b``) and MLA
(``deepseek-v2-236b``, whose cache keeps the compressed latent), the
Mamba-1 SSM mixer (``falcon-mamba-7b``, no MLP when ``d_ff`` is 0), the
hybrid of the two (``hymba-1.5b``: the mean of attention and SSM on the
same input), and the enc-dec ``whisper-large-v3``: frames projected by
``frontend_proj`` into a non-causal encoder, cross attention in every
decoder layer, sinusoidal absolute positions (``use_rope=False``) and
the GELU MLP with biases.  A decoder-only frontend (``pixtral-12b``'s
patches) is projected and prepended to the tokens.  MLPs are dense
(SwiGLU or GELU) or MoE (:mod:`.moe`, whose router loss ``forward``
returns summed over layers and ``loss_fn`` adds), with any of the three
norms and an untied head or the tied one (``x @ embed.T``, no
``lm_head`` leaf).  Parameters are a nested dict in the JAX package's
layout: per-layer weights are stacked on a leading ``n_layers`` axis
under ``"layers"`` (``n_enc_layers`` under ``"enc_layers"``), and a
Python loop over that axis takes the place of ``lax.scan``; ``remat``
wraps each layer in ``torch.utils.checkpoint`` where the reference
wraps it in ``jax.checkpoint``.  Decode caches are laid out as the
reference's ``vmap`` over layers builds them: every leaf ``(L, B,
...)`` under ``"layers"``, beside ``idx``, ``slot_pos`` and, for
enc-dec, ``cross_k`` / ``cross_v``.

Decode and prefill run without autograd.  The decode steps update the
cache they are given in place (the reference donates it) and return it;
``decode_step_slots`` is the reference's ``vmap`` of ``decode_step``
over serving slots written as one batched step, a position per row, its
MoE layers routing each row alone (each slot's capacity is that of one
token, as under the vmap).  ``decode_step`` and ``prefill_cache``, like
the reference's, route all B·S tokens together.  As in the reference,
``decode_step_slots`` refuses enc-dec archs and ``prefill_rows`` both
enc-dec and frontend archs; an enc-dec arch given no frontend raises a
``ValueError`` (the reference fails there with a ``TypeError``).  Under
tensor parallelism (``models/sharding.py``) ``forward``, ``init_cache``,
``prefill_cache``, ``decode_step`` and ``decode_step_slots`` run on a
rank's blocks of the weights and of the cache (``sharding.with_cache``;
an enc-dec arch's cross caches and MLA's latent too), the MoE layers on
a rank's experts.

:func:`params_from_jax` takes the JAX ``init_params`` tree (as nested
dicts of numpy arrays) and returns the port's parameters as views into
one flat vector in the JAX ravel order, so a flat ``x0`` from either
package means the same weights.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.utils.checkpoint

from ..core.paramvec import make_ravel_spec, tree_map, unravel
from ..kernels.rfast_update.dispatch import resolve_device
from . import attention as attn
from . import moe as moe_mod
from . import sharding as msh
from . import ssm as ssm_mod
from .config import ModelConfig
from .layers import (dense_init, mlp_apply, mlp_init, norm_apply, norm_init,
                     sinusoidal_positions)

__all__ = ["init_params", "param_shapes", "cast_params", "forward",
           "loss_fn",
           "params_from_jax",
           "cache_capacity", "init_cache", "decode_step",
           "decode_step_slots", "prefill", "prefill_cache", "prefill_rows"]


def _layer_init(cfg: ModelConfig, gen: torch.Generator, lead: tuple, *,
                cross: bool = False) -> dict[str, Any]:
    p: dict[str, Any] = {"ln1": norm_init(cfg, lead=lead,
                                          device=gen.device)}
    if cfg.mixer in ("attn", "hybrid"):
        init = attn.mla_init if cfg.attention == "mla" else attn.gqa_init
        p["attn"] = init(cfg, gen, lead=lead)
    if cfg.mixer in ("ssm", "hybrid"):
        p["ssm"] = ssm_mod.ssm_init(cfg, gen, lead=lead)
    if cross:
        p["ln_cross"] = norm_init(cfg, lead=lead, device=gen.device)
        p["cross"] = attn.cross_init(cfg, gen, lead=lead)
    if cfg.moe_experts:
        p["ln2"] = norm_init(cfg, lead=lead, device=gen.device)
        p["mlp"] = moe_mod.moe_init(cfg, gen, lead=lead)
    elif cfg.d_ff:
        p["ln2"] = norm_init(cfg, lead=lead, device=gen.device)
        p["mlp"] = mlp_init(cfg, gen, lead=lead)
    return p


def _enc_layer_init(cfg: ModelConfig, gen: torch.Generator,
                    lead: tuple) -> dict[str, Any]:
    """Encoder layer: full (non-causal) self-attention + dense MLP."""
    dev = gen.device
    return {"ln1": norm_init(cfg, lead=lead, device=dev),
            "attn": attn.gqa_init(cfg, gen, lead=lead),
            "ln2": norm_init(cfg, lead=lead, device=dev),
            "mlp": mlp_init(cfg, gen, lead=lead)}


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict[str, Any]:
    """fp32 parameters drawn from ``gen`` on its device (the CPU unless
    ``gen`` is a CUDA generator, which draws a full-width model on the
    card without a host copy): N(0,1)·0.02 embedding, N(0,1)·d_in^-½
    dense weights, unit norm scales, zero biases and the SSM's own
    initial values (the JAX package's distributions; not its numbers).
    A tied head has no ``lm_head``: the embedding is the head.  A
    frontend arch has ``frontend_proj`` (frontend_dim, d); an enc-dec
    one the stacked ``enc_layers``, ``enc_norm`` and, in every decoder
    layer, ``ln_cross`` and ``cross``."""
    p = {"embed": torch.randn(cfg.vocab, cfg.d_model, generator=gen,
                              device=gen.device).mul_(0.02),
         "final_norm": norm_init(cfg, device=gen.device),
         "layers": _layer_init(cfg, gen, (cfg.n_layers,),
                               cross=cfg.enc_dec)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab)
    if cfg.frontend:
        p["frontend_proj"] = dense_init(gen, cfg.frontend_dim or cfg.d_model,
                                        cfg.d_model)
    if cfg.enc_dec:
        p["enc_layers"] = _enc_layer_init(cfg, gen, (cfg.n_enc_layers,))
        p["enc_norm"] = norm_init(cfg, device=gen.device)
    return p


class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the meta device: every draw of
    :func:`init_params` on it makes an empty meta tensor and draws
    nothing."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


# leaves the JAX package's init_params makes in fp32 whatever its dtype
FP32_LEAVES = ("router", "A_log", "D")


def cast_params(tree: dict, dtype) -> dict:
    """``tree``'s leaves in ``dtype``, but :data:`FP32_LEAVES` (the MoE
    router, the SSM's A_log and D), which stay as they are, fp32, as the
    JAX package's ``init_params(cfg, key, dtype)`` keeps them."""
    return {k: cast_params(v, dtype) if isinstance(v, dict) else
            v if k in FP32_LEAVES else v.to(dtype) for k, v in tree.items()}


def param_shapes(cfg: ModelConfig, dtype=torch.float32) -> dict[str, Any]:
    """The tree :func:`init_params` makes, as empty meta tensors: the same
    shape code, nothing drawn or allocated, in the dtypes of
    :func:`cast_params`."""
    return cast_params(init_params(cfg, _MetaGenerator()), dtype)


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


def _index(tree: dict, i: int) -> dict:
    """Layer ``i`` of a nested dict of layer-stacked tensors (views)."""
    return tree_map(lambda t: t[i], tree)


def _layers(tree: dict, n: int) -> list[dict]:
    """The ``n`` layers of a nested dict of layer-stacked tensors, as
    views (one ``unbind`` a leaf): under autograd each leaf's gradient
    comes back as one stack of the layers' gradients, where indexing
    layer by layer would give every layer a full-size zero-filled
    gradient of the stack (traffic quadratic in the depth)."""
    per_leaf = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda ts: ts[i], per_leaf) for i in range(n)]


def _stack(trees: list[dict]) -> dict:
    """The nested dicts of ``trees`` stacked on a new leading axis."""
    return tree_map(lambda *ts: torch.stack(ts), *trees)


def _head(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits of ``x``: the ``lm_head``, or the embedding when tied."""
    head = params.get("lm_head")
    return x @ head if head is not None else x @ params["embed"].T


def _attn_full(cfg: ModelConfig, lp: dict, h: torch.Tensor,
               positions: torch.Tensor, return_kv: bool = False):
    """The layer's attention over the whole sequence; with ``return_kv``
    also its cache rows as a dict of (B, S, ...) tensors (GQA: k, v;
    MLA: c, kr)."""
    if cfg.attention == "mla":
        out = attn.mla_apply(cfg, lp["attn"], h, positions,
                             window=cfg.attn_window, return_kv=return_kv)
        names = ("c", "kr")
    else:
        out = attn.gqa_apply(cfg, lp["attn"], h, positions,
                             window=cfg.attn_window, return_kv=return_kv)
        names = ("k", "v")
    if not return_kv:
        return out
    return out[0], dict(zip(names, out[1]))


def _mixer_full(cfg: ModelConfig, lp: dict, h: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """The layer's mixer over the whole sequence; under tensor
    parallelism each block (attention, SSM) in ``parallel_block``'s
    frame on the local leaves."""
    ssm = lambda: msh.parallel_block(("layers", "ssm"), lp["ssm"], h,
                                     lambda p, y: ssm_mod.ssm_apply(cfg, p, y))
    if cfg.mixer == "ssm":
        return ssm()
    a = msh.parallel_block(("layers", "attn"), lp["attn"], h, lambda p, y:
                           _attn_full(cfg, {"attn": p}, y, positions))
    if cfg.mixer == "hybrid":
        return 0.5 * (a + ssm())
    return a


def _mlp(cfg: ModelConfig, lp: dict, x: torch.Tensor, *,
         rows: bool = False):
    """The residual MLP of ``x`` and its router loss: (x', aux), aux 0
    without MoE.  ``rows`` routes each batch row alone (aux (B,)).  Under
    tensor parallelism the block runs in ``parallel_block``'s frame on
    the local leaves (an MoE block on this rank's experts, its aux their
    terms)."""
    if "mlp" not in lp:
        return x, 0.0
    h = norm_apply(cfg, lp["ln2"], x)
    if not cfg.moe_experts:
        return x + msh.parallel_block(("layers", "mlp"), lp["mlp"], h,
                                      lambda p, y: mlp_apply(cfg, p, y)), 0.0
    moe = moe_mod.moe_apply_rows if rows else moe_mod.moe_apply
    y, aux = msh.parallel_block(("layers", "mlp"), lp["mlp"], h,
                                lambda p, y: moe(cfg, p, y))
    return x + y, aux


# the cross attention's leaves that make its k and v (cached in decode)
CROSS_KV_LEAVES = ("wk", "wv", "bk", "bv")


def _cross(cfg: ModelConfig, lp: dict, x: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor) -> torch.Tensor:
    """The residual cross attention of decode's ``x`` over the cache's
    cross k, v; under tensor parallelism in the cross block's
    ``parallel_block`` frame on this rank's block of the caches (its
    heads, or its head-dim slice beside the gathered query and output
    leaves: the block's k and v leaves are not needed)."""
    hc = norm_apply(cfg, lp["ln_cross"], x)
    p = {n: t for n, t in lp["cross"].items() if n not in CROSS_KV_LEAVES}
    return x + msh.parallel_block(msh.CROSS, p, hc, lambda p, y:
                                  attn.cross_decode(cfg, p, y, k, v))


def _cross_full(cfg: ModelConfig, lp: dict, x: torch.Tensor,
                enc: torch.Tensor):
    """``(x', (k, v))``: the residual cross attention of ``x`` over the
    encoder output ``enc``, in the cross block's ``parallel_block`` frame
    on the leaves it runs on, and the k and v it made of ``enc`` (B, F,
    KV, hd): the rank's heads of a column-parallel block, whole in a
    gathered one."""
    def block(p, y):
        k, v = attn.cross_kv(cfg, p, enc)
        return attn.cross_apply(cfg, p, y, k, v), (k, v)
    y, kv = msh.parallel_block(msh.CROSS, lp["cross"],
                               norm_apply(cfg, lp["ln_cross"], x), block)
    return x + y, kv


def _layer(cfg: ModelConfig, lp: dict, x: torch.Tensor,
           positions: torch.Tensor, enc: torch.Tensor | None, tp=None):
    """One decoder layer; ``tp`` is the caller's tensor-parallel layout,
    an argument so that a recompute under ``remat`` (which runs in the
    autograd engine's thread) runs on it too.  The cross attention takes
    its k and v from the encoder output ``enc`` with the block's own
    leaves (:func:`_cross_full`)."""
    with msh.use_tensor_parallel(tp):
        x = x + _mixer_full(cfg, lp, norm_apply(cfg, lp["ln1"], x),
                            positions)
        if enc is not None:
            x, _ = _cross_full(cfg, lp, x, enc)
        return _mlp(cfg, lp, x)


def _enc_layer(cfg: ModelConfig, lp: dict, x: torch.Tensor,
               positions: torch.Tensor, tp=None) -> torch.Tensor:
    """One encoder layer, each block in ``parallel_block``'s frame on the
    encoder's stream; ``tp`` as for :func:`_layer`."""
    with msh.use_tensor_parallel(tp):
        h = norm_apply(cfg, lp["ln1"], x)
        x = x + msh.parallel_block(
            ("enc_layers", "attn"), lp["attn"], h, lambda p, y:
            attn.gqa_apply(cfg, p, y, positions, causal=False))
        return x + msh.parallel_block(
            ("enc_layers", "mlp"), lp["mlp"], norm_apply(cfg, lp["ln2"], x),
            lambda p, y: mlp_apply(cfg, p, y))


def _run(remat: bool, fn, *args):
    """``fn(*args)``, or under activation checkpointing (the reference's
    ``jax.checkpoint``): its activations recomputed in the backward."""
    if not remat:
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def _run_encoder(cfg: ModelConfig, params: dict, frontend,
                 remat: bool = False) -> torch.Tensor:
    """The enc-dec encoder over ``frontend`` (B, F, frontend_dim):
    projected, absolute positions added, ``n_enc_layers`` non-causal
    layers, ``enc_norm``.  (B, F, d); under tensor parallelism with the
    encoder's stream sequence-parallel, this rank's block of the F
    frames (and of their positions)."""
    if frontend is None:
        raise ValueError(
            f"{cfg.name} is enc-dec: its encoder needs the frontend "
            f"(B, F, {cfg.frontend_dim or cfg.d_model}) and none was given")
    enc = ("enc_layers",)
    positions = torch.arange(frontend.shape[1], device=frontend.device)
    e = msh.local_rows(frontend, 1, enc) @ params["frontend_proj"]
    e = e + sinusoidal_positions(msh.local_rows(positions, 0, enc),
                                 cfg.d_model).to(e.dtype)
    tp = msh.current_tensor_parallel()
    for lp in _layers(params["enc_layers"], cfg.n_enc_layers):
        e = _run(remat, _enc_layer, cfg, lp, e, positions, tp)
    return norm_apply(cfg, params["enc_norm"], e)


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor, frontend,
           remat: bool = False):
    """The decoder's input rows: ``(x (B, S, d), positions (S,), n_front,
    enc)``.  A decoder-only frontend's projected rows come first (S =
    n_front + S_text); an enc-dec frontend goes through the encoder
    (``enc`` (B, F, d), else None); without RoPE the absolute positions
    are added.  Under tensor parallelism (``models/sharding.py``) the
    lookup is vocab-parallel and, with sequence parallelism, ``x`` holds
    this rank's block of the whole sequence (the frontend's rows
    included) and the absolute positions added are the block's;
    ``positions`` are the whole sequence's.  ``enc`` is ready for every
    layer's cross attention (``models.sharding.enter_decoder``)."""
    enc, n_front, front = None, 0, (None, None)
    if cfg.frontend and not cfg.enc_dec and frontend is not None:
        front = frontend, params["frontend_proj"]
        n_front = frontend.shape[1]
    x = msh.embed_lookup(params["embed"], tokens, *front)
    if cfg.enc_dec:
        enc = msh.enter_decoder(_run_encoder(cfg, params, frontend, remat))
    positions = torch.arange(n_front + tokens.shape[1], device=x.device)
    if not cfg.use_rope:
        x = x + sinusoidal_positions(msh.local_rows(positions, 0),
                                     cfg.d_model).to(x.dtype)
    return x, positions, n_front, enc


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            frontend=None, *, remat: bool = False, last_only: bool = False):
    """tokens (B, S_text); frontend (B, F, frontend_dim) stub embeddings
    (a decoder-only arch's are prepended to the tokens, an enc-dec
    arch's feed the encoder) -> (logits (B, S_text, vocab), or at the
    last position only with ``last_only``; the MoE layers' router loss
    summed, 0 without MoE).  ``remat`` recomputes each layer's
    activations in the backward.  Under tensor parallelism the logits
    are this rank's vocab block (``last_only``: of the sequence's last
    position on every rank, ``models.sharding.last_position``), and
    under expert parallelism the ranks' router losses are summed
    (``models.sharding.router_loss``)."""
    x, positions, n_front, enc = _embed(cfg, params, tokens, frontend,
                                        remat)
    aux = torch.zeros((), device=x.device)
    tp = msh.current_tensor_parallel()
    for lp in _layers(params["layers"], cfg.n_layers):
        x, a = _run(remat, _layer, cfg, lp, x, positions, enc, tp)
        aux = aux + a
    aux = msh.router_loss(aux)
    x = norm_apply(cfg, params["final_norm"], x)
    if last_only:
        x = msh.last_position(x)
    else:
        x = msh.to_head(x)
        if n_front:
            x = x[:, n_front:]
    return _head(params, x), aux


def loss_fn(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            labels: torch.Tensor, frontend=None, *, remat: bool = False,
            ce: str = "lse") -> torch.Tensor:
    """Mean next-token cross entropy plus the router loss.  ``ce="lse"``
    via logsumexp (no fp32 (B, S, V) log-prob tensor); ``ce="full"``
    the plain fp32 log-softmax, as the JAX package keeps both.  Under
    tensor parallelism the cross entropy is vocab-parallel
    (``models.sharding.vocab_parallel_ce``), or with a replicated head
    and sequence parallelism that of this rank's block of the sequence,
    its sum all-reduced (``models.sharding.seq_parallel_mean``)."""
    logits, aux = forward(cfg, params, tokens, frontend, remat=remat)
    tp = msh.current_tensor_parallel()
    if tp is not None and tp.vocab_parallel:
        return msh.vocab_parallel_ce(logits, labels, ce, tp) + aux
    mean = torch.mean
    if tp is not None and tp.seq_parallel:
        from ..core.runtime_sharded import rank_block
        labels = rank_block(labels, tp.group, 1)
        mean = lambda t: msh.seq_parallel_mean(t, tp)
    labels = labels[..., None].long()
    if ce == "full":
        ll = torch.log_softmax(logits.to(torch.float32), dim=-1)
        return -mean(torch.gather(ll, -1, labels)[..., 0]) + aux
    lse = torch.logsumexp(logits.to(torch.float32), dim=-1)
    tgt = torch.gather(logits, -1, labels)[..., 0]
    return mean(lse - tgt.to(torch.float32)) + aux


# --------------------------------------------------------------------- #
# decode (serve_step)
# --------------------------------------------------------------------- #
def cache_capacity(cfg: ModelConfig, max_len: int) -> int:
    if cfg.mixer == "ssm":
        return 1                                  # no KV cache at all
    return min(cfg.attn_window or max_len, max_len)


def _mixer_cache(cfg: ModelConfig, batch: int, capacity: int, dtype, *,
                 lead: tuple = (), device=None) -> dict:
    c: dict[str, Any] = {}
    if cfg.mixer in ("attn", "hybrid"):
        make = attn.mla_cache if cfg.attention == "mla" else attn.gqa_cache
        c["attn"] = make(cfg, batch, capacity, dtype, lead=lead,
                         device=device)
    if cfg.mixer in ("ssm", "hybrid"):
        c["ssm"] = ssm_mod.ssm_cache(cfg, batch, dtype, lead=lead,
                                     device=device)
    return c


def _cross_caches(kvs: list) -> tuple:
    """``(cross_k, cross_v)``, (L, B, F, KV, hd) each, of every decoder
    layer's cross ``(k, v)`` ``kvs``; under tensor parallelism this
    rank's blocks (``models.sharding.ring_block``: a gathered block's
    whole k and v cut to the rank's head-dim slice)."""
    return tuple(torch.stack([msh.ring_block(t, "cross_k") for t in ts])
                 for ts in zip(*kvs))


@torch.no_grad()
def init_cache(cfg: ModelConfig, params: dict, batch: int, max_len: int,
               dtype=torch.float32, frontend=None) -> dict:
    """Empty decode cache on the parameters' device: ``idx`` () int32,
    ``slot_pos`` (C,) int32 all −1, ``layers`` leaves (L, batch, ...).
    An enc-dec arch runs its encoder over ``frontend`` here and keeps
    ``cross_k`` / ``cross_v`` (L, batch, F, KV, hd) beside the ring; a
    decoder-only arch ignores ``frontend`` (its patch rows enter through
    :func:`prefill_cache`).  Under tensor parallelism the ``layers``
    leaves are this rank's zero blocks of the layout
    (``models.sharding.with_cache``), nothing whole allocated, and the
    cross caches its blocks, made from the whole encoder output
    (``models.sharding.enter_decoder``) with the cross block's leaves as
    the block runs them (``models.sharding.block_params``)."""
    dev = params["embed"].device
    C = cache_capacity(cfg, max_len)
    tp = msh.current_tensor_parallel()
    if tp is not None and tp.cache is None:
        raise ValueError("the tensor-parallel layout has no cache layout "
                         "(models.sharding.with_cache)")
    layers = _mixer_cache(cfg, batch, C, dtype, lead=(cfg.n_layers,),
                          device=dev if tp is None else "meta")
    cache = {"idx": torch.zeros((), dtype=torch.int32, device=dev),
             "slot_pos": torch.full((C,), -1, dtype=torch.int32,
                                    device=dev),
             "layers": layers if tp is None
             else msh.zeros_cache({"layers": layers}, tp, dev)["layers"]}
    if cfg.enc_dec:
        enc = msh.enter_decoder(_run_encoder(cfg, params, frontend))
        cross = msh.block_params(msh.CROSS, {
            n: t for n, t in params["layers"]["cross"].items()
            if n in CROSS_KV_LEAVES})
        cache["cross_k"], cache["cross_v"] = _cross_caches(
            [attn.cross_kv(cfg, _index(cross, li), enc)
             for li in range(cfg.n_layers)])
    return cache


def _ssm_step(cfg: ModelConfig, lp: dict, lc: dict, h: torch.Tensor):
    def step(p, y):
        out, new = ssm_mod.ssm_decode(cfg, p, y, lc["ssm"])
        for k, t in new.items():
            lc["ssm"][k].copy_(t)
        return out
    return msh.parallel_block(("layers", "ssm"), lp["ssm"], h, step)


def _mixer_decode(cfg: ModelConfig, lp: dict, lc: dict, h: torch.Tensor,
                  pos: torch.Tensor, slot_pos: torch.Tensor) -> torch.Tensor:
    """One token through the layer's mixer; ``lc`` (the layer's cache
    views) is written in place.  Under tensor parallelism each block
    runs in ``parallel_block``'s frame on the local leaves and this
    rank's block of the cache."""
    if cfg.mixer == "ssm":
        return _ssm_step(cfg, lp, lc, h)
    dec = attn.mla_decode if cfg.attention == "mla" else attn.gqa_decode
    a = msh.parallel_block(("layers", "attn"), lp["attn"], h, lambda p, y: dec(
        cfg, p, y, lc["attn"], pos, slot_pos, window=cfg.attn_window)[0])
    if cfg.mixer == "hybrid":
        a = 0.5 * (a + _ssm_step(cfg, lp, lc, h))
    return a


def _decode(cfg: ModelConfig, params: dict, layers: dict,
            tokens: torch.Tensor, pos: torch.Tensor,
            slot_pos: torch.Tensor, *, rows: bool,
            cross: tuple | None = None) -> torch.Tensor:
    """tokens (B, 1) at positions ``pos`` (B,) over ``slot_pos`` (B, C)
    -> logits (B, 1, V); the layer caches are written in place.
    ``rows`` routes each row's MoE alone (the slots step); ``cross``
    holds an enc-dec arch's (cross_k, cross_v).  Under tensor
    parallelism the step runs on the local leaves and cache blocks, its
    one-token stream whole on every rank (no sequence parallelism), and
    the logits are this rank's vocab block where the head is
    vocab-parallel."""
    tp = msh.current_tensor_parallel()
    if tp is not None and tp.seq_parallel:
        tp = dataclasses.replace(tp, seq_parallel=False)
    with msh.use_tensor_parallel(tp):
        x = msh.embed_lookup(params["embed"], tokens)
        if not cfg.use_rope:
            x = x + sinusoidal_positions(pos, cfg.d_model)[:, None].to(
                x.dtype)
        for li in range(cfg.n_layers):
            lp = _index(params["layers"], li)
            h = norm_apply(cfg, lp["ln1"], x)
            x = x + _mixer_decode(cfg, lp, _index(layers, li), h, pos,
                                  slot_pos)
            if cross is not None:
                x = _cross(cfg, lp, x, cross[0][li], cross[1][li])
            x, _ = _mlp(cfg, lp, x, rows=rows)
        x = msh.to_head(norm_apply(cfg, params["final_norm"], x))
        return _head(params, x)


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                token: torch.Tensor):
    """token (B, 1) -> (logits (B, 1, V), cache): every row at position
    ``cache["idx"]``; ``cache`` is updated in place and returned.  An
    enc-dec arch's token attends to the cache's cross k and v too."""
    pos = cache["idx"]
    slot_pos = cache["slot_pos"]
    C = slot_pos.shape[0]
    # an index tensor, not a 0-d one (which would be read on the host)
    slot_pos[(pos % C).reshape(1).long()] = pos.reshape(1)
    B = token.shape[0]
    cross = (cache["cross_k"], cache["cross_v"]) if cfg.enc_dec else None
    logits = _decode(cfg, params, cache["layers"], token, pos.expand(B),
                     slot_pos.expand(B, C), rows=False, cross=cross)
    cache["idx"] = pos + 1
    return logits, cache


@torch.no_grad()
def decode_step_slots(cfg: ModelConfig, params: dict, cache: dict,
                      tokens: torch.Tensor):
    """Continuous-batching decode: every batch slot advances its OWN
    position.  Same cache layout as :func:`init_cache` except ``idx`` is
    ``(B,)`` and ``slot_pos`` is ``(B, C)``.  The reference defines it as
    a ``vmap`` of :func:`decode_step` over slots; here one batched step
    writes each row's ring slot ``idx[b] % C``, masks each row by its
    own ``slot_pos`` and routes each row's MoE alone (capacity of one
    token, the expert weights still read once for all rows).  tokens
    (B, 1) -> (logits (B, 1, V), cache), the cache updated in place."""
    if cfg.enc_dec:
        raise ValueError("decode_step_slots serves decoder-only archs; "
                         f"{cfg.name} is enc-dec (cross caches have no "
                         "per-slot position)")
    pos = cache["idx"]
    slot_pos = cache["slot_pos"]
    B, C = slot_pos.shape
    slot_pos[torch.arange(B, device=pos.device), pos % C] = pos
    logits = _decode(cfg, params, cache["layers"], tokens, pos, slot_pos,
                     rows=True)
    cache["idx"] = pos + 1
    return logits, cache


def _ring(true_len: int, S: int, C: int, device):
    """Where the first ``true_len`` of S prefilled positions land in a
    C-slot ring, as decode writes position p at slot p % C: slot c holds
    the largest p < true_len with p % C == c, p_c = q − ((q − c) mod C),
    q = true_len − 1, and stays empty where p_c < 0.  Returns
    (slot_pos (C,) int32, −1 = empty, and ``place``: (B, S, ...) ->
    (B, C, ...) rows in ``dtype``, zeros in the empty slots)."""
    q = int(true_len) - 1
    p_c = q - ((q - torch.arange(C, device=device)) % C)
    valid = p_c >= 0
    rows = p_c.clamp(0, S - 1)

    def place(kv, dtype):
        mask = valid.reshape((1, C) + (1,) * (kv.ndim - 2))
        return torch.where(mask, kv[:, rows], 0).to(dtype)

    return torch.where(valid, p_c, -1).to(torch.int32), place


@torch.no_grad()
def prefill(cfg: ModelConfig, params: dict, cache: dict,
            tokens: torch.Tensor):
    """Token-by-token prefill (test helper): ``(cache, logits (B, S, V))``."""
    logits = []
    for t in range(tokens.shape[1]):
        lg, cache = decode_step(cfg, params, cache, tokens[:, t:t + 1])
        logits.append(lg[:, 0])
    return cache, torch.stack(logits, 1)


@torch.no_grad()
def prefill_cache(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                  max_len: int, dtype=torch.float32, frontend=None):
    """Batched prefill: ONE full forward fills the decode cache.

    Returns (cache with idx = S, last-position logits (B, 1, V)).  A
    decoder-only frontend's rows are prepended to the tokens (S = F +
    S_text; token-wise prefill cannot take them); an enc-dec frontend
    feeds the encoder, whose cross k and v the cache keeps.  The SSM
    layers' scans run the ``ssm_scan`` kernel on the card, which returns
    each layer's h_last.  Under tensor parallelism each block runs in
    ``parallel_block``'s frame (with sequence parallelism on the whole
    prompt, which the model group must divide) and the cache is this
    rank's block of the layout (``models.sharding.with_cache``): a
    column-parallel attention block's k/v are its heads, a gathered
    one's whole, and so are MLA's ``c`` and ``kr`` (its down-projections
    are whole), of which ``models.sharding.ring_block`` keeps the rank's
    block by the leaf's own layout (slots, head dim or latent dim; ``kr``
    whole); the Mamba block's state is its channels'.  The
    cross k and v of an enc-dec arch come from each layer's cross block
    in its frame, so kept as the block's heads or, of a gathered block's
    whole k and v, as the rank's head-dim slice; a decoder-only
    frontend's prefix fills the ring's first F slots as the text does."""
    tp = msh.current_tensor_parallel()
    if tp is not None and tp.cache is None:
        raise ValueError("the tensor-parallel layout has no cache layout "
                         "(models.sharding.with_cache)")
    x, positions, _, enc = _embed(cfg, params, tokens, frontend)
    S = positions.shape[0]
    C = cache_capacity(cfg, max_len)
    slot_pos, place = _ring(S, S, C, x.device)
    caches, crosses = [], []
    for li in range(cfg.n_layers):
        lp = _index(params["layers"], li)
        h = norm_apply(cfg, lp["ln1"], x)
        lc: dict[str, Any] = {}
        if cfg.mixer != "ssm":
            y, kv = msh.parallel_block(
                ("layers", "attn"), lp["attn"], h, lambda p, u: _attn_full(
                    cfg, {"attn": p}, u, positions, return_kv=True))
            lc["attn"] = {k: msh.ring_block(place(t, dtype), k)
                          for k, t in kv.items()}
        if cfg.mixer != "attn":
            sy, lc["ssm"] = msh.parallel_block(
                ("layers", "ssm"), lp["ssm"], h, lambda p, u:
                ssm_mod.ssm_apply(cfg, p, u, return_state=True))
            y = sy if cfg.mixer == "ssm" else 0.5 * (y + sy)
        x = x + y
        if enc is not None:
            x, kv = _cross_full(cfg, lp, x, enc)
            crosses.append(kv)
        x, _ = _mlp(cfg, lp, x)
        caches.append(lc)
    logits = _head(params, norm_apply(cfg, params["final_norm"],
                                      msh.last_position(x)))

    cache = {"idx": torch.tensor(S, dtype=torch.int32, device=x.device),
             "slot_pos": slot_pos, "layers": _stack(caches)}
    if crosses:
        cache["cross_k"], cache["cross_v"] = _cross_caches(crosses)
    return cache, logits


@torch.no_grad()
def prefill_rows(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                 true_len: int, capacity: int, dtype=torch.float32):
    """Bucketized prefill for ONE serving slot: tokens (B, Sb) are
    right-padded to a bucket length and ``true_len`` (1 <= true_len <=
    Sb) marks the valid prefix.

    Causality makes the padding inert where it matters: position i's KV
    row depends only on tokens <= i, so rows at positions < true_len are
    those of an unpadded prefill, and the contaminated tail (>= true_len)
    is never selected below.  ``true_len`` is an argument, so every
    prompt length inside a bucket runs through one cached callable of
    the serving engine (keyed by arch, B, C, Sb and dtype).

    Returns ``(ring_layers, slot_pos (C,), logits (B, V))``:
    ``ring_layers`` leaves are ``(L, B, C, ...)`` decode-cache rows (the
    last min(true_len, C) valid positions at slots pos % C, zeros
    elsewhere), ``slot_pos`` the per-slot absolute positions (−1 =
    empty), and ``logits`` the next-token logits at position
    true_len − 1.
    """
    if cfg.mixer != "attn":
        raise ValueError(
            f"prefill_rows requires an attention mixer; {cfg.name} is "
            f"{cfg.mixer!r} — an SSM carry absorbs the pad tail, so "
            "bucketized prefill cannot recover the true_len state")
    if cfg.enc_dec or cfg.frontend:
        raise ValueError("prefill_rows serves decoder-only text archs; "
                         f"{cfg.name} has enc_dec/frontend stages")
    x, positions, _, _ = _embed(cfg, params, tokens, None)
    S = x.shape[1]
    slot_pos, place = _ring(true_len, S, capacity, x.device)
    rings = []
    for li in range(cfg.n_layers):
        lp = _index(params["layers"], li)
        a, kv = _attn_full(cfg, lp, norm_apply(cfg, lp["ln1"], x),
                           positions, return_kv=True)
        rings.append({k: place(t, dtype) for k, t in kv.items()})
        x, _ = _mlp(cfg, lp, x + a)
    q = int(true_len) - 1
    last = norm_apply(cfg, params["final_norm"], x[:, q:q + 1])
    logits = _head(params, last)[:, 0]
    return {"attn": _stack(rings)}, slot_pos, logits
