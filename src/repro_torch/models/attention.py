"""Grouped-query attention, full sequence (train).

Counterpart of ``_sdpa``, ``_causal_mask``, ``gqa_init``, ``_qkv`` and
``gqa_apply`` in ``src/repro/models/attention.py``.  As there, scores are
an einsum, a masked softmax and an einsum over grouped heads (no KV
repeat is materialized), so the two packages agree numerically; the
port does not call ``scaled_dot_product_attention``.
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import apply_rope, dense_init, rope_cos_sin

__all__ = ["gqa_init", "gqa_apply"]

NEG = -1e30


def _sdpa(q, k, v, mask, scale):
    """q (B,Sq,G,R,dk)  k (B,Sk,G,dk)  v (B,Sk,G,dv)  mask (Sq,Sk) bool."""
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


def gqa_apply(cfg: ModelConfig, p: dict, x: torch.Tensor,
              positions: torch.Tensor, *, window=None) -> torch.Tensor:
    """Causal full-sequence attention of ``x`` (B, S, d)."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    if cfg.use_rope:
        cos, sin = rope_cos_sin(positions, cfg.hd, cfg.rope_theta)
        q = apply_rope(q.reshape(B, S, cfg.n_heads, cfg.hd), cos,
                       sin).reshape(q.shape)
        k = apply_rope(k, cos, sin)
    o = _sdpa(q, k, v, _causal_mask(S, S, window, x.device), cfg.hd ** -0.5)
    return o.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"]
