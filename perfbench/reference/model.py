"""Plain PyTorch reference of the benchmark's language models.

A frozen, plain copy of the two architectures the benchmark trains, written
from their published descriptions and independent of the program under
test: OLMo-1B's dense block (non-parametric LayerNorm, multi-head attention
with RoPE, SwiGLU MLP, tied embedding) and Hymba-1.5B's hybrid block
(RMSNorm; grouped-query attention over a sliding window and a Mamba-1
selective SSM on the same input, averaged; SwiGLU MLP; untied head).  The
conventions that fix the arithmetic are the configuration's: weights
``(d_in, d_out)``, RoPE rotating the two halves of each head, norm epsilon
1e-6, the mean next-token cross entropy.

Parameters are one flat fp32 vector; :func:`leaves` gives its layout
(sorted key paths, as a nested dict of the model's weights flattens) and
:func:`unflatten` views it as a dict of leaves.  Nothing here imports the
program, JAX or any kernel: the selective scan is a loop over time.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import precision

__all__ = ["leaves", "layout", "unflatten", "init_flat", "loss"]


def _hd(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def _d_inner(cfg: dict) -> int:
    return cfg["ssm_expand"] * cfg["d_model"]


def _dt_rank(cfg: dict) -> int:
    return -(-cfg["d_model"] // 16)


def leaves(cfg: dict) -> list[tuple[tuple[str, ...], tuple[int, ...], str,
                                    float]]:
    """``(path, shape, init, value)`` of every weight, in sorted path
    order.  ``init`` is ``normal`` (N(0, 1)·value), ``const`` (value) or
    ``arange_log`` (log(1..N) per channel, the S4D-real initial A)."""
    d, L, V = cfg["d_model"], cfg["n_layers"], cfg["vocab"]
    H, KV, hd, ff = cfg["n_heads"], cfg["n_kv_heads"], _hd(cfg), cfg["d_ff"]
    out = [(("embed",), (V, d), "normal", 0.02)]
    if cfg["norm"] == "rmsnorm":
        out.append((("final_norm", "scale"), (d,), "const", 1.0))
    lay = [(("attn", "wq"), (L, d, H * hd), "normal", d ** -0.5),
           (("attn", "wk"), (L, d, KV * hd), "normal", d ** -0.5),
           (("attn", "wv"), (L, d, KV * hd), "normal", d ** -0.5),
           (("attn", "wo"), (L, H * hd, d), "normal", (H * hd) ** -0.5),
           (("mlp", "wi"), (L, d, ff), "normal", d ** -0.5),
           (("mlp", "wg"), (L, d, ff), "normal", d ** -0.5),
           (("mlp", "wo"), (L, ff, d), "normal", ff ** -0.5)]
    if cfg["norm"] == "rmsnorm":
        lay += [(("ln1", "scale"), (L, d), "const", 1.0),
                (("ln2", "scale"), (L, d), "const", 1.0)]
    if cfg["mixer"] == "hybrid":
        di, N, K, r = _d_inner(cfg), cfg["ssm_state"], cfg["ssm_conv"], \
            _dt_rank(cfg)
        lay += [(("ssm", "in_proj"), (L, d, 2 * di), "normal", d ** -0.5),
                (("ssm", "conv_w"), (L, K, di), "normal", K ** -0.5),
                (("ssm", "conv_b"), (L, di), "const", 0.0),
                (("ssm", "x_proj"), (L, di, r + 2 * N), "normal", di ** -0.5),
                (("ssm", "dt_proj"), (L, r, di), "normal", r ** -0.5),
                (("ssm", "dt_bias"), (L, di), "const", -4.6),
                (("ssm", "A_log"), (L, di, N), "arange_log", 0.0),
                (("ssm", "D"), (L, di), "const", 1.0),
                (("ssm", "out_proj"), (L, di, d), "normal", di ** -0.5)]
    out += [(("layers",) + p, s, i, v) for p, s, i, v in lay]
    if not cfg["tie_embeddings"]:
        out.append((("lm_head",), (d, V), "normal", d ** -0.5))
    return sorted(out)


def layout(cfg: dict) -> tuple[list[tuple[str, ...]], list[int], int]:
    """``(paths, offsets, p)`` of the flat vector."""
    paths, offsets, o = [], [], 0
    for path, shape, _, _ in leaves(cfg):
        paths.append(path)
        offsets.append(o)
        o += math.prod(shape)
    return paths, offsets, o


def unflatten(cfg: dict, flat: torch.Tensor) -> dict:
    """``{path: view}`` of a ``(p,)`` vector (views: autograd reaches
    ``flat``)."""
    specs = leaves(cfg)
    sizes = [math.prod(s) for _, s, _, _ in specs]
    parts = flat.split(sizes + [flat.shape[0] - sum(sizes)])
    return {path: t.view(shape) for (path, shape, _, _), t
            in zip(specs, parts)}


def init_flat(cfg: dict, gen: torch.Generator, p: int) -> torch.Tensor:
    """The weights drawn from ``gen`` on its device in one ``randn`` over
    the whole vector, each leaf then scaled or set to its constant; a tail
    beyond the model's leaves is zero."""
    flat = torch.randn(p, generator=gen, device=gen.device)
    w = unflatten(cfg, flat)
    for path, shape, init, value in leaves(cfg):
        if init == "normal":
            w[path].mul_(value)
        elif init == "const":
            w[path].fill_(value)
        else:
            n = shape[-1]
            w[path].copy_(torch.log(torch.arange(
                1, n + 1, dtype=torch.float32, device=flat.device)))
    _, _, used = layout(cfg)
    flat[used:].zero_()
    return flat


def _norm(cfg: dict, x: torch.Tensor, scale) -> torch.Tensor:
    if cfg["norm"] == "rmsnorm":
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) * scale
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).pow(2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, heads, hd) rotated by position: first half against the
    second, frequencies theta^(−2i/hd)."""
    S, hd = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                  device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attention(cfg: dict, w: dict, l: int, h: torch.Tensor) -> torch.Tensor:
    """Causal (windowed where the config has a window) grouped-query
    attention: query head j reads key/value head j // (H / KV)."""
    B, S, _ = h.shape
    H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], _hd(cfg)
    mm = precision.matmul
    q = mm(h, w["layers", "attn", "wq"][l]).view(B, S, H, hd)
    k = mm(h, w["layers", "attn", "wk"][l]).view(B, S, KV, hd)
    v = mm(h, w["layers", "attn", "wv"][l]).view(B, S, KV, hd)
    theta = cfg.get("rope_theta", 10000.0)
    q, k = _rope(q, theta), _rope(k, theta)
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    s = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) * hd ** -0.5
    i = torch.arange(S, device=h.device)
    keep = i[None, :] <= i[:, None]
    if cfg.get("attn_window"):
        keep &= i[None, :] > i[:, None] - cfg["attn_window"]
    s = s.masked_fill(~keep, float("-inf"))
    o = mm(torch.softmax(s, -1), v.transpose(1, 2))          # (B, H, S, hd)
    return mm(o.transpose(1, 2).reshape(B, S, H * hd),
              w["layers", "attn", "wo"][l])


def selective_scan(u, dt, A, Bc, Cc, D):
    """h_t = exp(dt_t·A)·h_{t−1} + dt_t·B_t·u_t from h = 0, y_t = h_t·C_t
    + D·u_t.  u, dt (B, S, di); A (di, N); Bc, Cc (B, S, N)."""
    dA = torch.exp(dt[..., None] * A)                      # (B, S, di, N)
    dBu = (dt * u)[..., None] * Bc[:, :, None, :]
    h = torch.zeros_like(dA[:, 0])
    hs = []
    # unbind: one view a step whose gradients come back stacked once
    # (indexing dA[:, t] would give every step a full-size gradient)
    for dA_t, dBu_t in zip(dA.unbind(1), dBu.unbind(1)):
        h = dA_t * h + dBu_t
        hs.append(h)
    y = (torch.stack(hs, 1) * Cc[:, :, None, :]).sum(-1)
    return y + u * D


def _ssm(cfg: dict, w: dict, l: int, h: torch.Tensor) -> torch.Tensor:
    """The Mamba-1 block: in_proj to [x | z], depthwise causal conv and
    SiLU on x, dt / B / C from x_proj (dt through dt_proj and softplus),
    the selective scan, the SiLU(z) gate, out_proj."""
    di, N, r = _d_inner(cfg), cfg["ssm_state"], _dt_rank(cfg)
    p = {k[-1]: t[l] for k, t in w.items() if k[:2] == ("layers", "ssm")}
    mm = precision.matmul
    xz = mm(h, p["in_proj"])
    x, z = xz[..., :di], xz[..., di:]
    K = p["conv_w"].shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    S = x.shape[1]
    x = sum(xp[:, i:i + S] * p["conv_w"][i] for i in range(K)) + p["conv_b"]
    x = F.silu(x)
    proj = mm(x, p["x_proj"])
    dt = F.softplus(mm(proj[..., :r], p["dt_proj"]) + p["dt_bias"])
    y = selective_scan(x, dt, -torch.exp(p["A_log"]), proj[..., r:r + N],
                       proj[..., r + N:], p["D"])
    return mm(y * F.silu(z), p["out_proj"])


def _mlp(w: dict, l: int, h: torch.Tensor) -> torch.Tensor:
    mm = precision.matmul
    g = F.silu(mm(h, w["layers", "mlp", "wg"][l]))
    return mm(g * mm(h, w["layers", "mlp", "wi"][l]),
              w["layers", "mlp", "wo"][l])


def loss(cfg: dict, w: dict, toks: torch.Tensor,
         labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy of ``toks`` (B, S) against
    ``labels`` (B, S)."""
    rms = cfg["norm"] == "rmsnorm"
    x = w["embed",][toks]
    for l in range(cfg["n_layers"]):
        h = _norm(cfg, x, w["layers", "ln1", "scale"][l] if rms else None)
        a = _attention(cfg, w, l, h)
        if cfg["mixer"] == "hybrid":
            a = 0.5 * (a + _ssm(cfg, w, l, h))
        x = x + a
        h = _norm(cfg, x, w["layers", "ln2", "scale"][l] if rms else None)
        x = x + _mlp(w, l, h)
    x = _norm(cfg, x, w["final_norm", "scale"] if rms else None)
    head = w["embed",].T if cfg["tie_embeddings"] else w["lm_head",]
    logits = precision.matmul(x, head)
    tgt = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (torch.logsumexp(logits, -1) - tgt).mean()
