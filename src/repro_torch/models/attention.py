"""Attention mixers: grouped-query (GQA, with optional q/k/v biases),
multi-head latent attention (MLA, deepseek-v2) and the enc-dec cross
attention (whisper), over the full sequence (train, prefill) and
one-token decode over a ring cache.

Counterpart of ``src/repro/models/attention.py``: ``_sdpa``,
``_causal_mask``, ``gqa_init``, ``_qkv``, ``gqa_apply`` (causal, or
the encoder's full mask), ``gqa_cache``, ``gqa_decode``, ``mla_init``,
``_rms``, ``_mla_q``, ``_mla_compress``, ``_mla_attend``,
``mla_apply``, ``mla_cache``, ``mla_decode``, ``cross_init``,
``cross_kv``, ``cross_apply`` and ``cross_decode``.
As there, scores are an einsum, a masked softmax and an einsum over
grouped heads (no KV repeat is materialized), so the two packages agree
numerically; the port does not call ``scaled_dot_product_attention``.
MLA caches the compressed latent ``c`` (B, C, kv_lora_rank) and the
roped key part ``kr`` (B, C, qk_rope_dim), and expands both into keys
and values at every step, as the reference does.

The decode cache stores K roped at absolute positions in a ring of ``C``
slots, written at ``pos % C``; ``slot_pos`` holds the absolute position
in each slot (−1 = empty), so a sliding window needs no shifts.
:func:`gqa_decode` and :func:`mla_decode` take a position per batch
row, ``pos`` (B,) and ``slot_pos`` (B, C): the reference's single
sequence is the case of equal rows, and its ``vmap`` over serving slots
the general one.  They write the new rows into the cache in place (the
reference donates the cache to its decode step).
"""
from __future__ import annotations

import torch

from . import sharding as msh
from .config import ModelConfig
from .layers import apply_rope, dense_init, rope_cos_sin

__all__ = ["gqa_init", "gqa_apply", "gqa_cache", "gqa_decode",
           "mla_init", "mla_apply", "mla_cache", "mla_decode",
           "cross_init", "cross_kv", "cross_apply", "cross_decode"]

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
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dev = gen.device
    p = {"wq": dense_init(gen, d, H * hd, lead=lead),
         "wk": dense_init(gen, d, KV * hd, lead=lead),
         "wv": dense_init(gen, d, KV * hd, lead=lead),
         "wo": dense_init(gen, H * hd, d, lead=lead)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(*lead, H * hd, device=dev)
        p["bk"] = torch.zeros(*lead, KV * hd, device=dev)
        p["bv"] = torch.zeros(*lead, KV * hd, device=dev)
    return p


def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """q (B,S,KV,H/KV,hd), k, v (B,S,KV,hd).  The head counts come from
    the projections' widths, so a tensor-parallel rank's column blocks
    (whole heads, ``models/sharding.py``) give its own heads."""
    B, S, _ = x.shape
    hd = cfg.hd
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    H, KV = q.shape[-1] // hd, k.shape[-1] // hd
    return (q.reshape(B, S, KV, H // KV, hd), k.reshape(B, S, KV, hd),
            v.reshape(B, S, KV, hd))


def _rope(cfg: ModelConfig, q, k, cos, sin):
    B, S, KV, R, hd = q.shape
    q = apply_rope(q.reshape(B, S, KV * R, hd), cos, sin).reshape(q.shape)
    return q, apply_rope(k, cos, sin)


def gqa_apply(cfg: ModelConfig, p: dict, x: torch.Tensor,
              positions: torch.Tensor, *, causal=True, window=None,
              return_kv=False):
    """Full-sequence attention of ``x`` (B, S, d), causal or (the
    encoder's) over every position.  ``return_kv`` also returns the
    roped (k, v), (B, S, KV, hd) each, for cache filling."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    if cfg.use_rope:
        q, k = _rope(cfg, q, k, *rope_cos_sin(positions, cfg.hd,
                                              cfg.rope_theta))
    if causal:
        mask = _causal_mask(S, S, window, x.device)[None, None, None]
    else:
        mask = torch.ones((1, 1, 1, S, S), dtype=torch.bool,
                          device=x.device)
    o = _sdpa(q, k, v, mask, cfg.hd ** -0.5)
    out = o.reshape(B, S, -1) @ p["wo"]
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
    Under tensor parallelism ``cache`` is this rank's block of the ring
    (``models.sharding.ring_write`` / ``ring_attend``; C is
    ``slot_pos``'s), and on a rank's heads (the projections' widths)
    ``out`` is its partial sum of ``wo``'s rows.
    """
    B = x.shape[0]
    q, k_new, v_new = _qkv(cfg, p, x)              # S = 1
    if cfg.use_rope:
        cos, sin = rope_cos_sin(pos, cfg.hd, cfg.rope_theta)    # (B, hd/2)
        q, k_new = _rope(cfg, q, k_new, cos[:, None], sin[:, None])
    k, v = cache["k"], cache["v"]
    slot = pos % slot_pos.shape[-1]
    msh.ring_write(k, k_new[:, 0], slot)
    msh.ring_write(v, v_new[:, 0], slot)
    pos = pos[:, None]
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window:
        valid &= slot_pos > pos - window
    o = msh.ring_attend(q, k, v, valid, cfg.hd ** -0.5, _sdpa)
    return o.reshape(B, 1, -1) @ p["wo"], cache


# --------------------------------------------------------------------- #
# MLA (deepseek-v2)
# --------------------------------------------------------------------- #
def mla_init(cfg: ModelConfig, gen: torch.Generator, *,
             lead: tuple = ()) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    hd, vd, r, rd = cfg.hd, cfg.v_hd, cfg.kv_lora_rank, cfg.qk_rope_dim
    dev = gen.device
    p = {"w_dkv": dense_init(gen, d, r, lead=lead),
         "c_scale": torch.ones(*lead, r, device=dev),
         "w_kr": dense_init(gen, d, rd, lead=lead),
         "k_up": dense_init(gen, r, H * hd, lead=lead),
         "v_up": dense_init(gen, r, H * vd, lead=lead),
         "wo": dense_init(gen, H * vd, d, lead=lead)}
    if cfg.q_lora_rank:
        p["q_a"] = dense_init(gen, d, cfg.q_lora_rank, lead=lead)
        p["q_scale"] = torch.ones(*lead, cfg.q_lora_rank, device=dev)
        p["q_b"] = dense_init(gen, cfg.q_lora_rank, H * (hd + rd), lead=lead)
    else:
        p["wq"] = dense_init(gen, d, H * (hd + rd), lead=lead)
    return p


def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
    return (xf * r).to(x.dtype) * scale


def _mla_q(cfg: ModelConfig, p: dict, x: torch.Tensor, cos, sin):
    """(qn (B,S,H,hd), qr (B,S,H,rd) roped by ``cos``/``sin``: (S, rd/2),
    or (B, S, rd/2) for a position per row).  H comes from the width of
    ``q_b`` (or ``wq``): a tensor-parallel rank's column block holds
    its own whole heads (``models/sharding.py``)."""
    B, S, _ = x.shape
    hd, rd = cfg.hd, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        q = _rms(x @ p["q_a"], p["q_scale"]) @ p["q_b"]
    else:
        q = x @ p["wq"]
    q = q.reshape(B, S, -1, hd + rd)
    return q[..., :hd], apply_rope(q[..., hd:], cos, sin)


def _mla_compress(cfg: ModelConfig, p: dict, x: torch.Tensor, cos, sin):
    """(c (B,S,r), kr (B,S,rd)): the latent the cache keeps and the
    key's roped part, shared by every head."""
    c = _rms(x @ p["w_dkv"], p["c_scale"])
    kr = apply_rope((x @ p["w_kr"])[:, :, None, :], cos, sin)[:, :, 0, :]
    return c, kr


def _mla_attend(cfg: ModelConfig, p: dict, qn, qr, c, kr, mask):
    """qn (B,Sq,H,hd) qr (B,Sq,H,rd); c (B,Sk,r), kr (B,Sk,rd); mask
    bool, broadcast to the scores (B,H,Sq,Sk).  H is the heads of
    ``k_up``'s columns (all of them, or a rank's block)."""
    B, Sk, _ = c.shape
    hd, vd = cfg.hd, cfg.v_hd
    kn = (c @ p["k_up"]).reshape(B, Sk, -1, hd)
    H = kn.shape[2]
    v = (c @ p["v_up"]).reshape(B, Sk, H, vd)
    scale = (hd + cfg.qk_rope_dim) ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", qn, kn)
    s = s + torch.einsum("bqhd,bkd->bhqk", qr, kr)
    s = torch.where(mask, s.to(torch.float32) * scale,
                    torch.tensor(NEG, dtype=torch.float32, device=s.device))
    pr = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", pr, v)
    return o.reshape(B, -1, H * vd) @ p["wo"]


def mla_apply(cfg: ModelConfig, p: dict, x: torch.Tensor,
              positions: torch.Tensor, *, window=None, return_kv=False):
    """Causal full-sequence MLA of ``x`` (B, S, d).  ``return_kv`` also
    returns (c (B, S, r), kr (B, S, rd)) for cache filling."""
    S = x.shape[1]
    cos, sin = rope_cos_sin(positions, cfg.qk_rope_dim, cfg.rope_theta)
    qn, qr = _mla_q(cfg, p, x, cos, sin)
    c, kr = _mla_compress(cfg, p, x, cos, sin)
    mask = _causal_mask(S, S, window, x.device)[None, None]
    out = _mla_attend(cfg, p, qn, qr, c, kr, mask)
    if return_kv:
        return out, (c, kr)
    return out


def mla_cache(cfg: ModelConfig, batch: int, capacity: int, dtype, *,
              lead: tuple = (), device=None) -> dict:
    """Zero rings ``lead + (batch, capacity, r)`` for the latent ``c`` and
    ``lead + (batch, capacity, rd)`` for the roped key part ``kr``."""
    shape = (*lead, batch, capacity)
    return {"c": torch.zeros(*shape, cfg.kv_lora_rank, dtype=dtype,
                             device=device),
            "kr": torch.zeros(*shape, cfg.qk_rope_dim, dtype=dtype,
                              device=device)}


def mla_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict,
               pos: torch.Tensor, slot_pos: torch.Tensor, window=None):
    """One-token MLA decode of ``x`` (B, 1, d), a position per row as
    :func:`gqa_decode` takes it: writes the new c and kr at slot
    ``pos % C`` of each row of ``cache`` in place and returns
    ``(out (B, 1, d), cache)``.  Under tensor parallelism ``cache`` is
    this rank's block of ``c`` and the whole ``kr``
    (``models.sharding.ring_write`` / ``latent_attend``; C is
    ``slot_pos``'s), and on a rank's heads ``out`` is its partial sum of
    ``wo``'s rows."""
    cos, sin = rope_cos_sin(pos, cfg.qk_rope_dim, cfg.rope_theta)
    cos, sin = cos[:, None], sin[:, None]                 # (B, 1, rd/2)
    qn, qr = _mla_q(cfg, p, x, cos, sin)
    c_new, kr_new = _mla_compress(cfg, p, x, cos, sin)
    c, kr = cache["c"], cache["kr"]
    slot = pos % slot_pos.shape[-1]
    msh.ring_write(c, c_new[:, 0], slot, "c")
    msh.ring_write(kr, kr_new[:, 0], slot, "kr")
    pos = pos[:, None]
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window:
        valid &= slot_pos > pos - window
    o = msh.latent_attend(qn, qr, c, kr, p, valid,
                          (cfg.hd + cfg.qk_rope_dim) ** -0.5,
                          lambda *a: _mla_attend(cfg, p, *a))
    return o, cache


# --------------------------------------------------------------------- #
# cross attention (enc-dec)
# --------------------------------------------------------------------- #
def cross_init(cfg: ModelConfig, gen: torch.Generator, *,
               lead: tuple = ()) -> dict:
    return gqa_init(cfg, gen, lead=lead)


def cross_kv(cfg: ModelConfig, p: dict, enc: torch.Tensor):
    """The encoder output ``enc`` (B, F, d) as cross-attention keys and
    values, (B, F, KV, hd) each (with the k/v biases when ``qkv_bias``).
    KV comes from ``wk``'s width, so a tensor-parallel rank's column
    block (whole heads, ``models/sharding.py``) gives its own heads."""
    B, F, _ = enc.shape
    hd = cfg.hd
    KV = p["wk"].shape[-1] // hd
    k = (enc @ p["wk"]).reshape(B, F, KV, hd)
    v = (enc @ p["wv"]).reshape(B, F, KV, hd)
    if cfg.qkv_bias:
        k = k + p["bk"].reshape(KV, hd)
        v = v + p["bv"].reshape(KV, hd)
    return k, v


def _cross_attend(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor, attend) -> torch.Tensor:
    """x (B, S, d) queries over the encoder's k/v through ``attend(q, k,
    v, scale)``; the head counts from ``wq``'s width and k's heads."""
    B, S, _ = x.shape
    hd = cfg.hd
    H, KV = p["wq"].shape[-1] // hd, k.shape[2]
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    o = attend(q.reshape(B, S, KV, H // KV, hd), k, v, hd ** -0.5)
    return o.reshape(B, S, H * hd) @ p["wo"]


def cross_apply(cfg: ModelConfig, p: dict, x: torch.Tensor,
                k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) queries over the fixed encoder k/v (no positions: the
    absolute embeddings were added upstream; every key unmasked).  The
    head counts come from ``wq``'s width and k's heads, as in
    :func:`cross_kv`."""
    mask = torch.ones((1, 1, 1, x.shape[1], k.shape[1]), dtype=torch.bool,
                      device=x.device)
    return _cross_attend(cfg, p, x, k, v, lambda q, k, v, scale:
                         _sdpa(q, k, v, mask, scale))


def cross_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """:func:`cross_apply` of decode's ``x`` over the cache's cross k/v.
    Under tensor parallelism ``k``, ``v`` are this rank's block of the
    cross caches: its heads, on which a rank's column blocks run, or its
    head-dim slice, attended as ``models.sharding.ring_attend`` attends
    a ring by head dim (every key valid) with the block's leaves
    gathered."""
    valid = torch.ones(k.shape[:2], dtype=torch.bool, device=x.device)
    return _cross_attend(cfg, p, x, k, v, lambda q, k, v, scale:
                         msh.ring_attend(q, k, v, valid, scale, _sdpa,
                                         leaf="cross_k"))
