"""Plain oracle for flash attention (causal / sliding-window / full),
with GQA (kv heads broadcast over query-head groups).

Counterpart of ``src/repro/kernels/flash_attention/ref.py``.  Like it,
the causal mask is aligned to the END of the keys (query row i sees keys
up to ``i + Sk − Sq``), unlike the kernels, whose mask has no offset;
the two agree when Sq = Sk.
"""
from __future__ import annotations

import torch

__all__ = ["attention_ref"]


def attention_ref(q, k, v, *, causal=True, window=None, scale=None):
    """q (B,Sq,H,D); k/v (B,Sk,KV,D) with H % KV == 0.  fp32 softmax;
    the output is in q's dtype."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    scale = scale if scale is not None else D ** -0.5
    f32 = torch.float32
    qf = q.to(f32).reshape(B, Sq, KV, rep, D)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qf, k.to(f32)) * scale
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        ki = torch.arange(Sk, device=q.device)[None, :]
        m = ki <= qi
        if window:
            m &= ki > qi - window
        s = s.masked_fill(~m, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v.to(f32))
    return o.reshape(B, Sq, H, D).to(q.dtype)
