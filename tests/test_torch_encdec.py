"""The enc-dec and vision-frontend archs on the port against the JAX package.

``whisper-large-v3`` (an encoder over projected audio frames with
sinusoidal positions and non-causal attention; a decoder with cross
attention over the encoder's k and v, absolute positions, LayerNorm and
the GELU MLP with biases) and ``pixtral-12b`` (projected patches
prepended to the text), at their reduced sizes (2 + 2 layers, d 256, 16
frames or patches; B 2).  Each case is one JAX ``init_params`` tree
carried into the port by ``params_from_jax``, the leaves that init sets
to 0 or 1 (biases, norm scales) drawn at random first (tests/
test_torch_zoo.py's ``model``); frontends are drawn with numpy from a
seed and fed to both packages.

Tolerances are tests/test_torch_zoo.py's: logits, caches and trees
within 1e-4 of JAX's largest |entry|; the loss and the flat gradient at
rtol 1e-4 / atol 1e-5; teacher-forced decode at tests/test_serve.py's
2e-3; rounds within 2e-5 of each field's largest |entry|.

* The parts: ``sinusoidal_positions``, the GELU and SwiGLU MLPs with
  biases (the tanh GELU, ``jax.nn.gelu``'s default), ``gqa_apply`` with
  ``causal=False``, ``cross_kv`` and ``cross_apply``.
* ``forward`` with the frontend, with ``last_only`` and with ``remat``;
  ``loss_fn`` and its gradient with ``ce="lse"`` and ``ce="full"``.
* ``init_cache(frontend=)``'s cross caches, token-wise ``prefill``,
  ``prefill_cache(frontend=)`` and the decode steps after it.
* Two synchronous whisper rounds through the port's ``make_rfast_round``
  with the frontend in the batch, against the reference's.
* What the reference refuses stays refused: an enc-dec forward without a
  frontend, ``ServeEngine`` for both archs, ``decode_step_slots`` for
  enc-dec, ``prefill_rows`` for both.  The train CLI trains pixtral text
  only (as the reference's does) and fails on whisper at the first
  gradient.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import get_topology as j_get_topology
from repro.core.paramvec import make_ravel_spec as j_make_ravel_spec
from repro.core.paramvec import ravel as j_ravel
from repro.core.runtime import edge_arrays as j_edge_arrays
from repro.core.runtime import init_node_state as j_init_node_state
from repro.core.runtime import make_rfast_round as j_make_rfast_round
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jt
from repro_torch.core.paramvec import make_ravel_spec, tree_leaves, unravel
from repro_torch.core.runtime import (edge_arrays, init_node_state,
                                      make_rfast_round)
from repro_torch.core.topology import get_topology
from repro_torch.data.pipeline import LMShardConfig, node_batch
from repro_torch.launch import train
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as tt
from repro_torch.serve import ServeEngine
from test_torch_decode import assert_cache_close, rel, tokens
from test_torch_engine import two_torch_threads  # noqa: F401
from test_torch_zoo import model, structure

ARCHS = ["whisper-large-v3", "pixtral-12b"]
B, S, S_PROMPT = 2, 16, 6
TOL = 1e-4          # of the largest |entry|: fp32 on both sides
TF_TOL = 2e-3       # tests/test_serve.py's teacher-forced rtol and atol
ROUND_TOL = 2e-5    # rounds: of each field's largest |entry|


def frontend(cfg, batch=B, seed=0) -> np.ndarray:
    """Stub frame / patch embeddings (batch, frontend_seq, frontend_dim)."""
    return np.random.default_rng(100 + seed).standard_normal(
        (batch, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32)


_j_forward = jax.jit(jt.forward, static_argnums=(0,),
                     static_argnames=("remat", "last_only"))
_j_init_cache = jax.jit(jt.init_cache, static_argnums=(0, 2, 3, 4))
_j_prefill = jax.jit(jt.prefill, static_argnums=(0,))
_j_prefill_cache = jax.jit(jt.prefill_cache, static_argnums=(0, 3, 4))
_j_decode_step = jax.jit(jt.decode_step, static_argnums=(0,))
_j_decode_slots = jax.jit(jt.decode_step_slots, static_argnums=(0,))


# ------------------------------------------------------------------ #
# configs and parameters
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("arch", ARCHS)
def test_tree_structure_and_count_match_jax(arch):
    jcfg, cfg, jp, params, flat = model(arch)
    want = structure(jp)
    assert structure(params) == want
    own = tt.init_params(cfg, torch.Generator().manual_seed(0))
    assert structure(own) == want
    jflat = np.asarray(j_ravel(j_make_ravel_spec(jp), jp))
    np.testing.assert_array_equal(flat.numpy(), jflat)
    assert sum(t.numel() for t in tree_leaves(own)) == sum(
        np.prod(a.shape) for a in jax.tree.leaves(jp))
    assert ("enc_layers" in own) == cfg.enc_dec
    assert tuple(own["frontend_proj"].shape) == (cfg.frontend_dim,
                                                 cfg.d_model)


# ------------------------------------------------------------------ #
# the parts
# ------------------------------------------------------------------ #
def test_sinusoidal_positions_match_jax():
    pos = np.arange(40)
    for d in (256, 1280):
        want = np.asarray(jlayers.sinusoidal_positions(jnp.asarray(pos), d))
        got = tlayers.sinusoidal_positions(torch.from_numpy(pos), d)
        assert got.dtype == torch.float32 and tuple(got.shape) == (40, d)
        assert rel(got, want) <= 1e-5


@pytest.mark.parametrize("mlp", ["gelu", "swiglu"])
def test_mlp_with_biases_matches_jax(mlp):
    """The tanh GELU (``jax.nn.gelu``'s default): the erf form is 1.5e-4
    off at 1, outside this tolerance."""
    _, cfg, jp, params, _ = model("whisper-large-v3")
    jcfg = dataclasses.replace(j_get_config("whisper-large-v3").reduced(),
                               mlp=mlp)
    cfg = dataclasses.replace(cfg, mlp=mlp)
    rng = np.random.default_rng(1)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.3 for k, s in
         dict(wi=(cfg.d_model, cfg.d_ff), wo=(cfg.d_ff, cfg.d_model),
              wg=(cfg.d_model, cfg.d_ff), bi=(cfg.d_ff,),
              bo=(cfg.d_model,)).items()}
    if mlp == "gelu":
        del p["wg"]
    x = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    want = jlayers.mlp_apply(jcfg, jax.tree.map(jnp.asarray, p),
                             jnp.asarray(x))
    got = tlayers.mlp_apply(cfg, {k: torch.from_numpy(v)
                                  for k, v in p.items()}, torch.from_numpy(x))
    assert rel(got, want) <= TOL
    # the activation alone (identity weights, zero biases), elementwise
    eye = np.eye(cfg.d_model, dtype=np.float32)
    ident = {k: eye if k.startswith("w") else eye[0] * 0 for k in p}
    sq = dataclasses.replace(cfg, d_ff=cfg.d_model)
    want = jlayers.mlp_apply(dataclasses.replace(jcfg, d_ff=cfg.d_model),
                             jax.tree.map(jnp.asarray, ident),
                             jnp.asarray(1.5 * x))
    got = tlayers.mlp_apply(sq, {k: torch.from_numpy(v)
                                 for k, v in ident.items()},
                            torch.from_numpy(1.5 * x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    own = tlayers.mlp_init(cfg, torch.Generator())
    assert sorted(own) == sorted(p)
    assert not own["bi"].any() and not own["bo"].any()


def test_noncausal_gqa_matches_jax():
    """The encoder's self-attention: every position sees every other."""
    jcfg, cfg, jp, params, _ = model("whisper-large-v3")
    x = np.random.default_rng(2).standard_normal(
        (B, 9, cfg.d_model)).astype(np.float32)
    pos = np.arange(9)
    lp = tt._index(params["enc_layers"]["attn"], 0)
    jlp = jax.tree.map(lambda a: a[0], jp["enc_layers"]["attn"])
    want = jattn.gqa_apply(jcfg, jlp, jnp.asarray(x), jnp.asarray(pos),
                           causal=False)
    got = tattn.gqa_apply(cfg, lp, torch.from_numpy(x),
                          torch.from_numpy(pos), causal=False)
    assert rel(got, want) <= TOL
    causal = tattn.gqa_apply(cfg, lp, torch.from_numpy(x),
                             torch.from_numpy(pos))
    assert rel(causal, want) > 100 * TOL


def test_cross_kv_and_apply_match_jax():
    jcfg, cfg, jp, params, _ = model("whisper-large-v3")
    rng = np.random.default_rng(3)
    enc = rng.standard_normal((B, 11, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((B, 4, cfg.d_model)).astype(np.float32)
    lp = tt._index(params["layers"]["cross"], 1)
    jlp = jax.tree.map(lambda a: a[1], jp["layers"]["cross"])
    jk, jv = jattn.cross_kv(jcfg, jlp, jnp.asarray(enc))
    k, v = tattn.cross_kv(cfg, lp, torch.from_numpy(enc))
    assert tuple(k.shape) == (B, 11, cfg.n_kv_heads, cfg.hd)
    assert rel(k, jk) <= TOL and rel(v, jv) <= TOL
    want = jattn.cross_apply(jcfg, jlp, jnp.asarray(x), jk, jv)
    got = tattn.cross_apply(cfg, lp, torch.from_numpy(x), k, v)
    assert rel(got, want) <= TOL
    assert torch.equal(tattn.cross_decode(cfg, lp, torch.from_numpy(x[:, :1]),
                                          k, v),
                       tattn.cross_apply(cfg, lp, torch.from_numpy(x[:, :1]),
                                         k, v))


# ------------------------------------------------------------------ #
# forward, loss and gradient
# ------------------------------------------------------------------ #
FORWARD_CASES = [(a, m) for a in ARCHS
                 for m in ("frontend", "last_only", "remat")] + [
    ("pixtral-12b", "text_only")]


@pytest.mark.parametrize("arch,mode", FORWARD_CASES)
def test_forward_matches_jax(arch, mode):
    jcfg, cfg, jp, params, _ = model(arch)
    toks = tokens(cfg, (B, S))
    front = None if mode == "text_only" else frontend(cfg)
    kw = {"last_only": mode == "last_only", "remat": mode == "remat"}
    jl, jaux = _j_forward(jcfg, jp, jnp.asarray(toks),
                          None if front is None else jnp.asarray(front), **kw)
    tl, taux = tt.forward(cfg, params, torch.from_numpy(toks),
                          None if front is None else torch.from_numpy(front),
                          **kw)
    assert tuple(tl.shape) == (B, 1 if kw["last_only"] else S, cfg.vocab)
    assert torch.isfinite(tl).all()
    assert rel(tl, jl) <= TOL
    assert float(taux) == float(jaux) == 0.0


def _port_loss_grad(cfg, flat, spec, toks, front, **kw):
    lane = flat.clone().requires_grad_(True)
    loss = tt.loss_fn(cfg, unravel(spec, lane),
                      torch.from_numpy(toks[:, :-1]),
                      torch.from_numpy(toks[:, 1:]),
                      torch.from_numpy(front), **kw)
    (g,) = torch.autograd.grad(loss, lane)
    return float(loss.detach()), g


@pytest.mark.parametrize("ce", ["lse", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_flat_grad_match_jax(arch, ce):
    jcfg, cfg, jp, params, flat = model(arch)
    toks = tokens(cfg, (B, S + 1), seed=1)
    front = frontend(cfg, seed=1)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jt.loss_fn(jcfg, p, jnp.asarray(toks[:, :-1]),
                             jnp.asarray(toks[:, 1:]), jnp.asarray(front),
                             ce=ce)))(jp)
    jg = np.asarray(j_ravel(j_make_ravel_spec(jgrads), jgrads))
    loss, g = _port_loss_grad(cfg, flat, make_ravel_spec(params), toks,
                              front, ce=ce)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradient_equals_the_plain_one(arch):
    """``remat`` recomputes each layer in the backward: the same loss
    and gradient, and every leaf but (for pixtral) nothing else gets one;
    a step along it lowers the loss (tests/test_arch_smoke.py)."""
    _, cfg, _, params, flat = model(arch)
    spec = make_ravel_spec(params)
    toks, front = tokens(cfg, (B, S + 1), seed=2), frontend(cfg, seed=2)
    l0, g0 = _port_loss_grad(cfg, flat, spec, toks, front)
    l1, g1 = _port_loss_grad(cfg, flat, spec, toks, front, remat=True)
    assert l0 == pytest.approx(l1, rel=1e-6)
    torch.testing.assert_close(g1, g0, rtol=1e-5, atol=1e-7)
    leaves = tree_leaves(unravel(spec, g0))
    nonzero = sum(bool(t.abs().sum() > 0) for t in leaves)
    assert nonzero >= 0.8 * len(leaves), f"{nonzero}/{len(leaves)}"
    l2, _ = _port_loss_grad(cfg, flat - 1e-2 * g0, spec, toks, front)
    assert l2 < l0 + 1e-3


def test_enc_dec_without_a_frontend_raises():
    """The reference fails there with a TypeError (``None @ ...``)."""
    _, cfg, _, params, _ = model("whisper-large-v3")
    toks = torch.from_numpy(tokens(cfg, (B, S)))
    with pytest.raises(ValueError, match="enc-dec.*frontend"):
        tt.forward(cfg, params, toks)
    with pytest.raises(ValueError, match="enc-dec.*frontend"):
        tt.init_cache(cfg, params, B, S)


# ------------------------------------------------------------------ #
# decode and prefill
# ------------------------------------------------------------------ #
def test_init_cache_cross_caches_and_prefill_match_jax():
    """The encoder runs in ``init_cache``: its cross k and v per layer,
    then token-wise ``prefill`` and one more step, against JAX's."""
    jcfg, cfg, jp, params, _ = model("whisper-large-v3")
    toks, front = tokens(cfg, (B, 8), seed=3), frontend(cfg, seed=3)
    jcache = _j_init_cache(jcfg, jp, B, S, jnp.float32, jnp.asarray(front))
    cache = tt.init_cache(cfg, params, B, S, frontend=torch.from_numpy(front))
    assert tuple(cache["cross_k"].shape) == (
        cfg.n_layers, B, cfg.frontend_seq, cfg.n_kv_heads, cfg.hd)
    assert_cache_close(cache, jcache)
    jcache, jl = _j_prefill(jcfg, jp, jcache, jnp.asarray(toks))
    cache, logits = tt.prefill(cfg, params, cache, torch.from_numpy(toks))
    assert rel(logits, jl) <= TOL
    assert_cache_close(cache, jcache)
    nxt = np.full((B, 1), 3, np.int32)
    jl, jcache = _j_decode_step(jcfg, jp, jcache, jnp.asarray(nxt))
    logits, cache = tt.decode_step(cfg, params, cache, torch.from_numpy(nxt))
    assert rel(logits, jl) <= TOL
    assert_cache_close(cache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_and_decode_step_match_jax(arch):
    """Whisper's cache gets the cross k and v, pixtral's ring the patch
    rows first (idx = F + S_prompt)."""
    jcfg, cfg, jp, params, _ = model(arch)
    toks, front = tokens(cfg, (B, S), seed=4), frontend(cfg, seed=4)
    max_len = S + (0 if cfg.enc_dec else cfg.frontend_seq)
    jcache, jl = _j_prefill_cache(jcfg, jp, jnp.asarray(toks[:, :S_PROMPT]),
                                  max_len, jnp.float32, jnp.asarray(front))
    cache, logits = tt.prefill_cache(cfg, params,
                                     torch.from_numpy(toks[:, :S_PROMPT]),
                                     max_len,
                                     frontend=torch.from_numpy(front))
    assert int(cache["idx"]) == S_PROMPT + (0 if cfg.enc_dec
                                            else cfg.frontend_seq)
    assert ("cross_k" in cache) == cfg.enc_dec
    assert rel(logits, jl) <= TOL
    assert_cache_close(cache, jcache)
    for t in range(S_PROMPT, S):
        jl, jcache = _j_decode_step(jcfg, jp, jcache,
                                    jnp.asarray(toks[:, t:t + 1]))
        logits, cache = tt.decode_step(cfg, params, cache,
                                       torch.from_numpy(toks[:, t:t + 1]))
        assert rel(logits, jl) <= TOL, (arch, t)
    assert_cache_close(cache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_forward(arch):
    """tests/test_arch_smoke.py's batched-prefill checks at a full
    prompt: ``prefill_cache(frontend=)`` then ``decode_step`` over the
    rest, against one ``forward(toks, frontend)``."""
    _, cfg, _, params, _ = model(arch)
    toks = torch.from_numpy(tokens(cfg, (B, S), seed=5))
    front = torch.from_numpy(frontend(cfg, seed=5))
    ref = tt.forward(cfg, params, toks, front)[0]
    max_len = S + (0 if cfg.enc_dec else cfg.frontend_seq)
    cache, logits = tt.prefill_cache(cfg, params, toks[:, :S_PROMPT],
                                     max_len, frontend=front)
    np.testing.assert_allclose(logits[:, 0], ref[:, S_PROMPT - 1],
                               rtol=TF_TOL, atol=TF_TOL)
    for t in range(S_PROMPT, S):
        logits, cache = tt.decode_step(cfg, params, cache, toks[:, t:t + 1])
        np.testing.assert_allclose(
            logits[:, 0], ref[:, t], rtol=TF_TOL, atol=TF_TOL,
            err_msg=f"{cfg.name}: decode position {t}")


def test_batched_prefill_matches_tokenwise():
    """tests/test_arch_smoke.py::test_batched_prefill_matches_tokenwise
    for whisper on the port: ``init_cache(frontend=)`` + token-wise
    ``prefill`` against ``prefill_cache``, and a decode step from each."""
    _, cfg, _, params, _ = model("whisper-large-v3")
    toks = torch.from_numpy(tokens(cfg, (B, 8), seed=6))
    front = torch.from_numpy(frontend(cfg, seed=6))
    c_ref, logits_ref = tt.prefill(
        cfg, params, tt.init_cache(cfg, params, B, S, frontend=front), toks)
    c_new, last = tt.prefill_cache(cfg, params, toks, S, frontend=front)
    np.testing.assert_allclose(last[:, 0], logits_ref[:, -1], rtol=TF_TOL,
                               atol=TF_TOL)
    tok = torch.zeros(B, 1, dtype=torch.int64)
    l1, _ = tt.decode_step(cfg, params, c_ref, tok)
    l2, _ = tt.decode_step(cfg, params, c_new, tok)
    np.testing.assert_allclose(l1, l2, rtol=TF_TOL, atol=TF_TOL)


def test_pixtral_decode_step_slots_matches_jax():
    """The reference's slots step refuses only enc-dec archs: pixtral's
    text decode runs per slot, each at its own depth."""
    jcfg, cfg, jp, params, _ = model("pixtral-12b")
    C = 8
    idx = np.asarray([0, 3, 11], np.int32)
    sp = np.full((3, C), -1, np.int32)
    for b, n in enumerate(idx):
        for p in range(max(0, n - C), n):
            sp[b, p % C] = p
    layers = tt.init_cache(cfg, params, 3, C)["layers"]
    rng = np.random.default_rng(8)
    state = {"idx": idx, "slot_pos": sp, "layers": {"attn": {
        k: rng.standard_normal(tuple(t.shape)).astype(np.float32)
        for k, t in layers["attn"].items()}}}
    jcache = jax.tree.map(jnp.asarray, state)
    cache = jax.tree.map(lambda a: torch.from_numpy(a.copy()), state)
    for t, tok in enumerate(tokens(cfg, (4, 3, 1), seed=9)):
        jl, jcache = _j_decode_slots(jcfg, jp, jcache, jnp.asarray(tok))
        logits, cache = tt.decode_step_slots(cfg, params, cache,
                                             torch.from_numpy(tok))
        assert rel(logits, jl) <= TOL, t
    assert_cache_close(cache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_refuses_what_the_reference_refuses(arch):
    _, cfg, _, params, _ = model(arch)
    with pytest.raises(ValueError, match="decoder-only attention archs"):
        ServeEngine(cfg, params, batch=2, max_len=16)
    with pytest.raises(ValueError, match="decoder-only text archs"):
        tt.prefill_rows(cfg, params, torch.zeros(1, 8, dtype=torch.int64),
                        5, 16)
    if cfg.enc_dec:
        with pytest.raises(ValueError, match="is enc-dec"):
            tt.decode_step_slots(cfg, params, {}, None)


# ------------------------------------------------------------------ #
# training
# ------------------------------------------------------------------ #
N, STEPS, LOSS_PROB, GAMMA = 4, 2, 0.3, 3e-3
SHARD = LMShardConfig(vocab=512, batch_per_node=B, seq_len=S, n_nodes=N,
                      seed=0)
FIELDS = ("x", "z", "rho", "rho_buf")


def _round_inputs(cfg):
    """Per step: every node's (toks, labels, frames) as numpy, the frames
    drawn from (seed, step); and the loss masks."""
    def batches(step):
        toks, labels = zip(*(node_batch(SHARD, i, step) for i in range(N)))
        frames = np.random.default_rng((SHARD.seed, step)).standard_normal(
            (N, B, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32)
        return np.stack(toks), np.stack(labels), frames
    rng = np.random.default_rng(1)
    return batches, rng


def _flat_rows(tree) -> np.ndarray:
    """Stacked pytree -> (rows, p) in the ravel order (sorted key paths)."""
    leaves = jax.tree.leaves(tree)
    return np.concatenate([np.asarray(a, np.float32).reshape(
        leaves[0].shape[0], -1) for a in leaves], axis=1)


@pytest.fixture(scope="module")
def whisper_jax_rounds():
    jcfg, _, jp, _, _ = model("whisper-large-v3")
    batches, rng = _round_inputs(jcfg)
    spec = j_edge_arrays(j_get_topology("binary_tree", N))

    def grad_fn(p, batch, key):
        toks, labels, frames = batch
        return jax.value_and_grad(
            lambda q: jt.loss_fn(jcfg, q, toks, labels, frames))(p)

    jb = lambda step: tuple(jnp.asarray(a) for a in batches(step))
    key = jax.random.PRNGKey(0)
    rf = j_make_rfast_round(spec, grad_fn, gamma=GAMMA, robust=True,
                            impl="jnp")
    st = j_init_node_state(spec, jp, grad_fn, jb(0), key, robust=True)
    losses = []
    for step in range(STEPS):
        mk = (rng.uniform(size=spec.e_pad) >= LOSS_PROB).astype(np.float32)
        st, met = rf(st, jb(step), jax.random.split(key, N), jnp.asarray(mk))
        losses.append(np.asarray(met["losses"]))
    return {f: _flat_rows(getattr(st, f)) for f in FIELDS}, np.stack(losses)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_whisper_sync_rounds_match_jax(whisper_jax_rounds, impl,
                                       two_torch_threads):
    """Two lossy rounds from one tree, each node's batch (toks, labels,
    frames): the port's ``sync_grad_fn`` passes the frames to
    ``loss_fn`` as the reference's ``grad_fn`` does."""
    want, want_losses = whisper_jax_rounds
    _, cfg, _, params, flat = model("whisper-large-v3")
    batches, rng = _round_inputs(cfg)
    tb = lambda step: tuple(torch.from_numpy(a) for a in batches(step))
    spec = edge_arrays(get_topology("binary_tree", N))
    grad_fn = train.sync_grad_fn(cfg, make_ravel_spec(params))
    rf = make_rfast_round(spec, grad_fn, gamma=GAMMA, robust=True,
                          impl=impl, donate=True)
    st = init_node_state(spec, flat.clone(), grad_fn, tb(0), robust=True)
    losses = []
    for step in range(STEPS):
        mk = (rng.uniform(size=spec.e_pad) >= LOSS_PROB).astype(np.float32)
        st, met = rf(st, tb(step), None, torch.from_numpy(mk))
        losses.append(met["losses"].numpy())
    np.testing.assert_allclose(np.stack(losses), want_losses, rtol=1e-4,
                               atol=1e-5)
    for f in FIELDS:
        got = getattr(st, f).numpy()[:, :want[f].shape[1]]
        assert rel(got, want[f]) <= ROUND_TOL, (f, rel(got, want[f]))


def test_train_cli_trains_pixtral_text_only(two_torch_threads):
    """As the reference's ``launch/train.py``: no frontend reaches the
    loss, so ``frontend_proj`` gets a zero gradient."""
    res = train.main(["--arch", "pixtral-12b", "--reduced", "--nodes", "2",
                      "--batch-per-node", "2", "--seq", "16", "--steps", "2",
                      "--loss-prob", "0.2", "--log-every", "1",
                      "--device", "cpu"])
    assert res["rounds"] == 2 and np.isfinite(res["losses"]).all()
    assert res["mass_rel"] <= 1e-4
    _, cfg, _, params, flat = model("pixtral-12b")
    spec = make_ravel_spec(params)
    toks = tokens(cfg, (B, S + 1), seed=10)
    lane = flat.clone().requires_grad_(True)
    loss = tt.loss_fn(cfg, unravel(spec, lane),
                      torch.from_numpy(toks[:, :-1]),
                      torch.from_numpy(toks[:, 1:]))
    (g,) = torch.autograd.grad(loss, lane)
    assert not unravel(spec, g)["frontend_proj"].any()


def test_train_cli_fails_on_whisper_at_the_first_gradient(
        two_torch_threads):
    """The reference's ``train.py`` passes no frontend either: its
    encoder fails on ``None`` (a TypeError), the port's forward raises."""
    with pytest.raises(ValueError, match="enc-dec.*frontend"):
        train.main(["--arch", "whisper-large-v3", "--reduced", "--nodes",
                    "2", "--batch-per-node", "2", "--seq", "16", "--steps",
                    "1", "--device", "cpu"])
