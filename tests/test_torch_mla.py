"""The port's multi-head latent attention against the JAX package's.

tests/test_serve.py's TINY decoder with ``attention="mla"``
(kv_lora_rank 16, qk_rope_dim 8), on the CPU, weights from one JAX tree
with ``c_scale`` and ``q_scale`` drawn at random (init sets them to 1):

* ``mla_apply`` and its cache rows (c, kr) within 1e-5 of JAX's on both
  query paths: ``q_lora_rank`` > 0 (``q_a``, ``q_scale``, ``q_b``) and
  0 (``wq``), causal and with a window;
* ``mla_decode`` with a position per row against the reference's
  single-sequence ``mla_decode`` at each row's position, and
  ``mla_cache``'s layout;
* the mirror of tests/test_serve.py::
  test_incremental_decode_mid_sequence_slot_reuse for ``gqa`` and
  ``mla`` (window 6 so the ring of C = 6 < S = 16 slots is overwritten
  mid-sequence, prompt 4): the port's incremental logits against its
  teacher-forced ``forward`` at that test's 2e-3, and against JAX's
  ``prefill_cache`` + ``decode_step`` at 1e-4.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import transformer as jt
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig
from test_torch_decode import assert_cache_close, rel, tokens
from test_torch_zoo import randomize

TINY = dict(name="serve-tiny", n_layers=1, d_model=32, n_heads=2,
            n_kv_heads=2, d_ff=64, vocab=64)
MLA = dict(TINY, name="serve-tiny-mla", attention="mla", kv_lora_rank=16,
           qk_rope_dim=8)
LAYER_TOL = 1e-5    # tests/test_torch_model.py's tolerance for one layer
TOL = 1e-4          # whole models, of the largest |entry|
TF_TOL = 2e-3       # tests/test_serve.py's teacher-forced rtol and atol


def mla_layer(q_lora_rank: int, window=None, seed=0):
    kw = dict(MLA, q_lora_rank=q_lora_rank, attn_window=window)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    jp = randomize(jax.tree.map(np.asarray, jattn.mla_init(
        jcfg, jax.random.PRNGKey(seed), jnp.float32)),
        np.random.default_rng(seed + 1))
    tp = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
    return jcfg, cfg, {k: jnp.asarray(v) for k, v in jp.items()}, tp


@pytest.mark.parametrize("q_lora_rank", [12, 0])
@pytest.mark.parametrize("window", [None, 5])
def test_mla_apply_matches_jax(q_lora_rank, window):
    jcfg, cfg, jp, tp = mla_layer(q_lora_rank, window)
    assert ("q_a" in tp) == bool(q_lora_rank) and ("wq" in tp) != bool(
        q_lora_rank)
    assert not torch.equal(tp["c_scale"], torch.ones_like(tp["c_scale"]))
    x = np.random.default_rng(2).standard_normal(
        (2, 11, cfg.d_model)).astype(np.float32)
    pos = np.arange(11)
    jout, (jc, jkr) = jattn.mla_apply(jcfg, jp, jnp.asarray(x),
                                      jnp.asarray(pos), window=window,
                                      return_kv=True)
    out, (c, kr) = tattn.mla_apply(cfg, tp, torch.from_numpy(x),
                                   torch.from_numpy(pos), window=window,
                                   return_kv=True)
    assert rel(out, jout) <= LAYER_TOL
    assert rel(c, jc) <= LAYER_TOL and rel(kr, jkr) <= LAYER_TOL
    assert tuple(c.shape) == (2, 11, 16) and tuple(kr.shape) == (2, 11, 8)


def test_mla_init_and_cache_layout_match_jax():
    for q_lora_rank in (12, 0):
        jcfg, cfg, jp, _ = mla_layer(q_lora_rank)
        own = tattn.mla_init(cfg, torch.Generator().manual_seed(0),
                             lead=(3,))
        assert {k: tuple(v.shape) for k, v in own.items()} == \
            {k: (3,) + v.shape for k, v in jp.items()}
        assert torch.equal(own["c_scale"], torch.ones(3, 16))
    jc = jattn.mla_cache(jcfg, 2, 6, jnp.float32)
    c = tattn.mla_cache(cfg, 2, 6, torch.float32, lead=(4,))
    assert {k: tuple(v.shape) for k, v in c.items()} == \
        {k: (4,) + v.shape for k, v in jc.items()}
    assert not any(v.any() for v in c.values())


@pytest.mark.parametrize("q_lora_rank", [12, 0])
def test_mla_decode_matches_jax_per_row(q_lora_rank):
    """The reference's single-sequence mla_decode at each row's position
    against the port's one call with a position per row (window 6, the
    second row's ring wrapped)."""
    jcfg, cfg, jp, tp = mla_layer(q_lora_rank, window=6)
    rng = np.random.default_rng(3)
    C, idx = 6, np.array([4, 13], np.int32)
    ring = {"c": rng.standard_normal((2, C, 16)).astype(np.float32),
            "kr": rng.standard_normal((2, C, 8)).astype(np.float32)}
    sp = np.full((2, C), -1, np.int32)
    for b, n in enumerate(idx):
        for p in range(max(0, n - C), n + 1):
            sp[b, p % C] = p
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    cache = {k: torch.from_numpy(v.copy()) for k, v in ring.items()}
    out, cache = tattn.mla_decode(cfg, tp, torch.from_numpy(x), cache,
                                  torch.from_numpy(idx),
                                  torch.from_numpy(sp), window=6)
    for b in range(2):
        jout, jc = jattn.mla_decode(
            jcfg, jp, jnp.asarray(x[b:b + 1]),
            {k: jnp.asarray(v[b:b + 1]) for k, v in ring.items()},
            jnp.int32(idx[b]), jnp.asarray(sp[b]), window=6)
        assert rel(out[b:b + 1], jout) <= LAYER_TOL
        for k in ("c", "kr"):
            assert rel(cache[k][b:b + 1], jc[k]) <= LAYER_TOL


@functools.cache
def windowed(attention: str):
    """tests/test_serve.py's slot-reuse config of ``attention`` and one
    JAX tree carried into the port."""
    kw = dict(TINY, name=f"serve-tiny-{attention}", attention=attention,
              attn_window=6, kv_lora_rank=16 if attention == "mla" else 0,
              qk_rope_dim=8)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    jp = randomize(jax.tree.map(np.asarray, jt.init_params(
        jcfg, jax.random.PRNGKey(0))), np.random.default_rng(4))
    params, _ = tt.params_from_jax(jp, device="cpu")
    return jcfg, cfg, jax.tree.map(jnp.asarray, jp), params


@pytest.mark.parametrize("attention", ["gqa", "mla"])
def test_incremental_decode_mid_sequence_slot_reuse(attention):
    """Windowed attention with C = 6 < S = 16: ring slots are overwritten
    mid-sequence (position p and p + 6 share a slot), and the incremental
    logits still match the window-masked teacher-forced forward."""
    jcfg, cfg, jp, params = windowed(attention)
    S, Sp = 16, 4
    toks = tokens(cfg, (2, S), seed=5)
    ref = tt.forward(cfg, params, torch.from_numpy(toks))[0]
    cache, logits = tt.prefill_cache(cfg, params,
                                     torch.from_numpy(toks[:, :Sp]), S)
    jcache, jl = jt.prefill_cache(jcfg, jp, jnp.asarray(toks[:, :Sp]), S)
    np.testing.assert_allclose(logits[:, 0], ref[:, Sp - 1], rtol=TF_TOL,
                               atol=TF_TOL)
    assert rel(logits, jl) <= TOL
    for t in range(Sp, S):
        logits, cache = tt.decode_step(cfg, params, cache,
                                       torch.from_numpy(toks[:, t:t + 1]))
        jl, jcache = jt.decode_step(jcfg, jp, jcache,
                                    jnp.asarray(toks[:, t:t + 1]))
        np.testing.assert_allclose(
            logits[:, 0], ref[:, t], rtol=TF_TOL, atol=TF_TOL,
            err_msg=f"{cfg.name}: decode position {t}")
        assert rel(logits, jl) <= TOL, (attention, t)
    assert cache["slot_pos"].tolist() == [12, 13, 14, 15, 10, 11]
    assert_cache_close(cache, jcache)
    names = {"gqa": ["k", "v"], "mla": ["c", "kr"]}[attention]
    assert sorted(cache["layers"]["attn"]) == names


def test_mla_window_masks_the_past():
    """tests/test_arch_smoke.py::test_sliding_window_masks_past for MLA:
    with a window of 6 the last logits do not depend on token 0."""
    _, cfg, _, params = windowed("mla")
    t1 = tokens(cfg, (1, 12), seed=6)
    t2 = t1.copy()
    t2[0, 0] = (t2[0, 0] + 1) % cfg.vocab
    l1 = tt.forward(cfg, params, torch.from_numpy(t1))[0]
    l2 = tt.forward(cfg, params, torch.from_numpy(t2))[0]
    torch.testing.assert_close(l1[0, -1], l2[0, -1], rtol=1e-5, atol=1e-5)
    assert not torch.allclose(l1[0, 1], l2[0, 1], atol=1e-5)
    full = dataclasses.replace(cfg, attn_window=None)
    l3 = tt.forward(full, params, torch.from_numpy(t2))[0]
    assert not torch.allclose(l1[0, -1], l3[0, -1], atol=1e-5)
