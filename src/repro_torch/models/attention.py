"""Grouped-query attention: full sequence (train, prefill) and one-token
decode over a ring KV cache.

Counterpart of ``_sdpa``, ``_causal_mask``, ``gqa_init``, ``_qkv``,
``gqa_apply``, ``gqa_cache`` and ``gqa_decode`` in
``src/repro/models/attention.py``.  As there, scores are an einsum, a
masked softmax and an einsum over grouped heads (no KV repeat is
materialized), so the two packages agree numerically; the port does not
call ``scaled_dot_product_attention``.

The decode cache stores K roped at absolute positions in a ring of ``C``
slots, written at ``pos % C``; ``slot_pos`` holds the absolute position
in each slot (−1 = empty), so a sliding window needs no shifts.
:func:`gqa_decode` takes a position per batch row, ``pos`` (B,) and
``slot_pos`` (B, C): the reference's single sequence is the case of
equal rows, and its ``vmap`` over serving slots the general one.  It
writes the new k, v into the cache in place (the reference donates the
cache to its decode step).
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import apply_rope, dense_init, rope_cos_sin

__all__ = ["gqa_init", "gqa_apply", "gqa_cache", "gqa_decode"]

NEG = -1e30


def _sdpa(q, k, v, mask, scale):
    """q (B,Sq,G,R,dk)  k (B,Sk,G,dk)  v (B,Sk,G,dv)  mask bool, broadcast
    to the scores (B,G,R,Sq,Sk): (B,1,1,Sq,Sk) or (1,1,1,Sq,Sk)."""
    s = torch.einsum("bqgrd,bkgd->bgrqk", q, k) * scale
    s = torch.where(mask, s.to(torch.float32),
                    torch.tensor(NEG, dtype=torch.float32, device=s.device))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bgrqk,bkgd->bqgrd", p, v)


def _causal_mask(Sq: int, Sk: int, window, device) -> torch.Tensor:
    """(Sq,Sk) causal (+ sliding window) mask."""
    qi = torch.arange(Sq, device=device)[:, None]
    ki = torch.arange(Sk, device=device)[None, :]
    m = ki <= qi
    if window:
        m &= ki > qi - window
    return m


def gqa_init(cfg: ModelConfig, gen: torch.Generator, *,
             lead: tuple = ()) -> dict:
    if cfg.qkv_bias:
        raise NotImplementedError("qkv_bias is not ported yet")
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {"wq": dense_init(gen, d, H * hd, lead=lead),
            "wk": dense_init(gen, d, KV * hd, lead=lead),
            "wv": dense_init(gen, d, KV * hd, lead=lead),
            "wo": dense_init(gen, H * hd, d, lead=lead)}


def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, KV, H // KV, hd)
    k = (x @ p["wk"]).reshape(B, S, KV, hd)
    v = (x @ p["wv"]).reshape(B, S, KV, hd)
    return q, k, v


def _rope(cfg: ModelConfig, q, k, cos, sin):
    B, S = q.shape[:2]
    q = apply_rope(q.reshape(B, S, cfg.n_heads, cfg.hd), cos,
                   sin).reshape(q.shape)
    return q, apply_rope(k, cos, sin)


def gqa_apply(cfg: ModelConfig, p: dict, x: torch.Tensor,
              positions: torch.Tensor, *, window=None, return_kv=False):
    """Causal full-sequence attention of ``x`` (B, S, d).  ``return_kv``
    also returns the roped (k, v), (B, S, KV, hd) each, for cache
    filling."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    if cfg.use_rope:
        q, k = _rope(cfg, q, k, *rope_cos_sin(positions, cfg.hd,
                                              cfg.rope_theta))
    mask = _causal_mask(S, S, window, x.device)[None, None, None]
    o = _sdpa(q, k, v, mask, cfg.hd ** -0.5)
    out = o.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


def gqa_cache(cfg: ModelConfig, batch: int, capacity: int, dtype, *,
              lead: tuple = (), device=None) -> dict:
    """Zero ring buffers ``lead + (batch, capacity, KV, hd)`` for k and v."""
    shape = (*lead, batch, capacity, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict,
               pos: torch.Tensor, slot_pos: torch.Tensor, window=None):
    """One-token decode of ``x`` (B, 1, d).  ``pos`` (B,) each row's
    absolute position; ``slot_pos`` (B, C) the absolute position stored
    in each of the row's cache slots (−1 = empty), already including this
    step's write slot.  Writes the roped k and v at slot ``pos % C`` of
    each row of ``cache`` in place and returns ``(out (B, 1, d), cache)``.
    """
    B = x.shape[0]
    q, k_new, v_new = _qkv(cfg, p, x)              # S = 1
    if cfg.use_rope:
        cos, sin = rope_cos_sin(pos, cfg.hd, cfg.rope_theta)    # (B, hd/2)
        q, k_new = _rope(cfg, q, k_new, cos[:, None], sin[:, None])
    k, v = cache["k"], cache["v"]
    C = k.shape[1]
    rows = torch.arange(B, device=x.device)
    slot = pos % C
    k[rows, slot] = k_new[:, 0].to(k.dtype)
    v[rows, slot] = v_new[:, 0].to(v.dtype)
    pos = pos[:, None]
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window:
        valid &= slot_pos > pos - window
    o = _sdpa(q, k, v, valid[:, None, None, None, :], cfg.hd ** -0.5)
    return o.reshape(B, 1, cfg.n_heads * cfg.hd) @ p["wo"], cache
