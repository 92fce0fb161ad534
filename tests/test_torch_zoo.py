"""The model zoo's decoders on the port against the JAX package's.

The five decoder-only text archs that the port runs since the zoo was
ported: ``olmo-1b`` (non-parametric LayerNorm, tied head),
``qwen2.5-3b`` (q/k/v biases, tied head, GQA 8:1), ``deepseek-7b``
(MHA), ``phi3.5-moe-42b-a6.6b`` (LayerNorm, 16 experts top-2) and
``deepseek-v2-236b`` (MLA, 2 shared + 160 routed experts top-6), at the
reduced sizes of tests/test_arch_smoke.py (B 2, S 16).  Each case is one
JAX ``init_params`` tree carried into the port by ``params_from_jax``,
with the leaves that init sets to 0 or 1 (the q/k/v biases, the norm
scales and biases, MLA's ``c_scale`` and ``q_scale``) drawn at random
first, so that a dropped term cannot pass.

* The tree keeps JAX's structure (OLMo's empty norm dicts included) and
  the port's own init has JAX's layout.
* Logits within 1e-4 of JAX's largest |logit|, the router loss within
  1e-6; loss (with the router loss) and the flat gradient at
  tests/test_torch_model.py's rtol 1e-4 / atol 1e-5.
* tests/test_arch_smoke.py's checks on the port: finite forward, one
  SGD step that lowers the loss with a gradient in most leaves, three
  decode steps.
* ``prefill_cache`` + ``decode_step``, ``prefill_rows`` and
  ``decode_step_slots`` against JAX's at 1e-4 (logits and cache
  leaves); the teacher-forced check of tests/test_serve.py at its 2e-3,
  the MoE capacity lifted as that test lifts it (capacity-bounded
  routing drops tokens as a function of the sequence length).
* ``decode_step_slots`` of a MoE config at B = 12 slots equals JAX's
  ``vmap`` of ``decode_step``, where routing all rows together would
  drop tokens and differ.
* OLMo's parameters cross-load through both packages' checkpoints
  bitwise; the training and serving CLIs run every zoo arch.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as j_get_config
from repro.core.paramvec import make_ravel_spec as j_make_ravel_spec
from repro.core.paramvec import ravel as j_ravel
from repro.core.paramvec import unravel as j_unravel
from repro.models import transformer as jt
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.checkpoint import ckpt
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.paramvec import (make_ravel_spec, ravel, tree_leaves,
                                       unravel)
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig
from test_torch_decode import assert_cache_close, rel, tokens
from test_torch_engine import two_torch_threads  # noqa: F401

ZOO = ["olmo-1b", "qwen2.5-3b", "deepseek-7b", "phi3.5-moe-42b-a6.6b",
       "deepseek-v2-236b"]
B, S, S_PROMPT = 2, 16, 6
TOL = 1e-4          # of the largest |entry|: fp32 on both sides
TF_TOL = 2e-3       # tests/test_serve.py's teacher-forced rtol and atol
# leaves that init sets to 0 or 1: drawn at random before comparing
RANDOMIZED = ("bq", "bk", "bv", "bi", "bo", "bias", "scale", "c_scale",
              "q_scale")


def randomize(tree, rng, key=None):
    if isinstance(tree, dict):
        return {k: randomize(tree[k], rng, k) for k in sorted(tree)}
    if key in RANDOMIZED:
        base = 1.0 if key.endswith("scale") else 0.0
        return (base + 0.3 * rng.standard_normal(tree.shape)).astype(
            np.float32)
    return np.asarray(tree)


def lift(cfg):
    """tests/test_serve.py's lifted capacity (MoE only)."""
    return dataclasses.replace(cfg, capacity_factor=100.0) \
        if cfg.moe_experts else cfg


@functools.cache
def model(arch: str, lifted: bool = False):
    """(jcfg, cfg, JAX params, port params, flat) from one JAX tree with
    its 0/1 leaves randomized."""
    jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    if lifted:
        jcfg, cfg = lift(jcfg), lift(cfg)
    jp = jax.jit(lambda k: jt.init_params(jcfg, k))(jax.random.PRNGKey(0))
    np_tree = randomize(jax.tree.map(np.asarray, jp),
                        np.random.default_rng(7))
    params, flat = tt.params_from_jax(np_tree, device="cpu")
    return jcfg, cfg, jax.tree.map(jnp.asarray, np_tree), params, flat


def structure(tree):
    """Nested dict of leaf shapes (empty dicts kept)."""
    if isinstance(tree, dict):
        return {k: structure(v) for k, v in tree.items()}
    return tuple(tree.shape)


_j_forward = jax.jit(jt.forward, static_argnums=(0,))
_j_prefill_cache = jax.jit(jt.prefill_cache, static_argnums=(0, 3))
_j_decode_step = jax.jit(jt.decode_step, static_argnums=(0,))
_j_decode_slots = jax.jit(jt.decode_step_slots, static_argnums=(0,))
_j_prefill_rows = jax.jit(jt.prefill_rows, static_argnums=(0, 4))


def test_every_decoder_only_text_arch_is_ported():
    """Every arch of the reference is ported since the enc-dec and
    frontend archs were: the port's ``ARCHS`` is the reference's list in
    its order, every config equals JAX's, and an unknown arch raises the
    reference's ``KeyError``."""
    from repro.configs import ARCHS as J_ARCHS
    assert ARCHS == J_ARCHS
    assert set(ZOO) < set(ARCHS)
    for a in ARCHS:
        assert get_config(a) == ModelConfig(
            **dataclasses.asdict(j_get_config(a)))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("whisper-large-v2")


# ------------------------------------------------------------------ #
# parameters, forward, loss and gradient
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("arch", ZOO)
def test_tree_structure_matches_jax(arch):
    jcfg, cfg, jp, params, flat = model(arch)
    want = structure(jp)
    assert structure(params) == want
    own = tt.init_params(cfg, torch.Generator().manual_seed(0))
    assert structure(own) == want
    assert ("lm_head" in own) == (not cfg.tie_embeddings)
    jflat = np.asarray(j_ravel(j_make_ravel_spec(jp), jp))
    np.testing.assert_array_equal(flat.numpy(), jflat)
    if cfg.norm == "nonparam_ln":        # OLMo: no norm parameters
        assert own["final_norm"] == {} == params["layers"]["ln1"]


def test_unravel_keeps_empty_subtrees():
    """An empty dict holds no leaf but belongs to the tree: unravel
    rebuilds it where JAX's unravel does."""
    t = {"a": {}, "b": {"w": torch.arange(3.0), "n": {}},
         "final_norm": {}}
    spec = make_ravel_spec(t, pad_to=4)
    assert spec.empty == (("a",), ("b", "n"), ("final_norm",))
    back = unravel(spec, ravel(spec, t))
    assert structure(back) == structure(t)
    assert torch.equal(back["b"]["w"], t["b"]["w"])
    jt_ = {"a": {}, "b": {"w": jnp.arange(3.0), "n": {}},
           "final_norm": {}}
    jspec = j_make_ravel_spec(jt_, pad_to=4)
    assert structure(j_unravel(jspec, j_ravel(jspec, jt_))) == \
        structure(back)
    # the model's gradient keeps them: OLMo's tree from a gradient lane
    _, cfg, _, params, flat = model("olmo-1b")
    spec = make_ravel_spec(params)
    g = unravel(spec, torch.zeros_like(flat))
    assert g["final_norm"] == {} and g["layers"]["ln2"] == {}
    assert structure(g) == structure(params)


@pytest.mark.parametrize("arch", ZOO)
def test_forward_shapes_finite_and_logits_match_jax(arch):
    jcfg, cfg, jp, params, _ = model(arch)
    toks = tokens(cfg, (B, S))
    jl, jaux = _j_forward(jcfg, jp, jnp.asarray(toks))
    tl, taux = tt.forward(cfg, params, torch.from_numpy(toks))
    assert tuple(tl.shape) == (B, S, cfg.vocab)
    assert torch.isfinite(tl).all() and np.isfinite(float(taux))
    assert rel(tl, jl) <= TOL
    assert abs(float(taux) - float(jaux)) <= 1e-6
    assert (float(taux) > 0) == bool(cfg.moe_experts)


def _port_loss_grad(cfg, flat, spec, toks):
    lane = flat.clone().requires_grad_(True)
    loss = tt.loss_fn(cfg, unravel(spec, lane),
                      torch.from_numpy(toks[:, :-1]),
                      torch.from_numpy(toks[:, 1:]))
    (g,) = torch.autograd.grad(loss, lane)
    return float(loss.detach()), g


@pytest.mark.parametrize("arch", ZOO)
def test_loss_and_flat_grad_match_jax(arch):
    jcfg, cfg, jp, params, flat = model(arch)
    toks = tokens(cfg, (B, S + 1), seed=1)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jt.loss_fn(jcfg, p, jnp.asarray(toks[:, :-1]),
                             jnp.asarray(toks[:, 1:]))))(jp)
    jg = np.asarray(j_ravel(j_make_ravel_spec(jgrads), jgrads))
    loss, g = _port_loss_grad(cfg, flat, make_ravel_spec(params), toks)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ZOO)
def test_train_step_lowers_the_loss(arch):
    """tests/test_arch_smoke.py::test_train_step_no_nans on the port."""
    _, cfg, _, params, flat = model(arch)
    spec = make_ravel_spec(params)
    toks = tokens(cfg, (B, S + 1), seed=2)
    l0, g = _port_loss_grad(cfg, flat, spec, toks)
    assert np.isfinite(l0) and torch.isfinite(g).all()
    leaves = tree_leaves(unravel(spec, g))
    nonzero = sum(bool(t.abs().sum() > 0) for t in leaves)
    assert nonzero >= 0.8 * len(leaves), f"{nonzero}/{len(leaves)}"
    l1, _ = _port_loss_grad(cfg, flat - 1e-2 * g, spec, toks)
    assert l1 < l0 + 1e-3


# ------------------------------------------------------------------ #
# decode and prefill
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("arch", ZOO)
def test_decode_step_shapes(arch):
    _, cfg, _, params, _ = model(arch)
    cache = tt.init_cache(cfg, params, B, 32)
    tok = torch.zeros(B, 1, dtype=torch.int64)
    for i in range(3):
        logits, cache = tt.decode_step(cfg, params, cache, tok)
        assert tuple(logits.shape) == (B, 1, cfg.vocab)
        assert torch.isfinite(logits).all()
        assert int(cache["idx"]) == i + 1


@pytest.mark.parametrize("arch", ZOO)
def test_teacher_forced_decode_matches_forward(arch):
    """tests/test_serve.py::_teacher_forced_check on the port, the MoE
    capacity lifted as tests/test_serve.py lifts it."""
    _, cfg, _, params, _ = model(arch, lifted=True)
    toks = torch.from_numpy(tokens(cfg, (B, S), seed=3))
    ref = tt.forward(cfg, params, toks)[0]
    cache, logits = tt.prefill_cache(cfg, params, toks[:, :S_PROMPT], S)
    np.testing.assert_allclose(logits[:, 0], ref[:, S_PROMPT - 1],
                               rtol=TF_TOL, atol=TF_TOL)
    for t in range(S_PROMPT, S):
        logits, cache = tt.decode_step(cfg, params, cache, toks[:, t:t + 1])
        np.testing.assert_allclose(
            logits[:, 0], ref[:, t], rtol=TF_TOL, atol=TF_TOL,
            err_msg=f"{cfg.name}: decode position {t}")


@pytest.mark.parametrize("arch", ZOO)
def test_prefill_cache_and_decode_step_match_jax(arch):
    jcfg, cfg, jp, params, _ = model(arch)
    toks = tokens(cfg, (B, S), seed=4)
    jcache, jl = _j_prefill_cache(jcfg, jp, jnp.asarray(toks[:, :S_PROMPT]),
                                  S)
    cache, logits = tt.prefill_cache(cfg, params,
                                     torch.from_numpy(toks[:, :S_PROMPT]), S)
    assert rel(logits, jl) <= TOL
    assert_cache_close(cache, jcache)
    for t in range(S_PROMPT, S):
        jl, jcache = _j_decode_step(jcfg, jp, jcache,
                                    jnp.asarray(toks[:, t:t + 1]))
        logits, cache = tt.decode_step(cfg, params, cache,
                                       torch.from_numpy(toks[:, t:t + 1]))
        assert rel(logits, jl) <= TOL, (arch, t)
    assert_cache_close(cache, jcache)


@pytest.mark.parametrize("arch", ZOO)
def test_prefill_rows_matches_jax(arch):
    jcfg, cfg, jp, params, _ = model(arch)
    Sb, true_len, C = 8, 5, 16
    toks = tokens(cfg, (1, Sb), seed=5)
    toks[:, true_len:] = 0                      # the bucket's padding
    jring, jsp, jl = _j_prefill_rows(jcfg, jp, jnp.asarray(toks),
                                     jnp.int32(true_len), C)
    ring, sp, logits = tt.prefill_rows(cfg, params, torch.from_numpy(toks),
                                       true_len, C)
    np.testing.assert_array_equal(sp.numpy(), np.asarray(jsp))
    assert rel(logits, jl) <= TOL
    assert_cache_close(ring, jring)


def slot_cache(cfg, n_slots: int, C: int, idx: list[int], seed: int):
    """A serving cache of the arch's layout with random ring rows, slot b
    at position idx[b] with its ring holding the positions before it
    (numpy leaves)."""
    rng = np.random.default_rng(seed)
    layers = tt.init_cache(cfg, {"embed": torch.zeros(1)}, n_slots,
                           C)["layers"]
    sp = np.full((n_slots, C), -1, np.int32)
    for b, n in enumerate(idx):
        for p in range(max(0, n - C), n):
            sp[b, p % C] = p
    return {"idx": np.asarray(idx, np.int32), "slot_pos": sp,
            "layers": {"attn": {
                k: rng.standard_normal(tuple(t.shape)).astype(np.float32)
                for k, t in layers["attn"].items()}}}


def run_slots(jcfg, cfg, jp, params, state, toks):
    """``len(toks)`` slot steps through both packages; the largest
    relative logit error and both final caches."""
    jcache = jax.tree.map(jnp.asarray, state)
    cache = jax.tree.map(lambda a: torch.from_numpy(a.copy()), state)
    worst = 0.0
    for t in range(len(toks)):
        jl, jcache = _j_decode_slots(jcfg, jp, jcache, jnp.asarray(toks[t]))
        logits, cache = tt.decode_step_slots(cfg, params, cache,
                                             torch.from_numpy(toks[t]))
        assert tuple(logits.shape) == (len(toks[t]), 1, cfg.vocab)
        worst = max(worst, rel(logits, jl))
    return worst, cache, jcache


@pytest.mark.parametrize("arch", ZOO)
def test_decode_step_slots_matches_jax(arch):
    """Three slots at positions 0, 3 and 11 (its ring already wrapped),
    seven steps: every slot at its own depth, the rings wrapping."""
    jcfg, cfg, jp, params, _ = model(arch)
    state = slot_cache(cfg, 3, 8, [0, 3, 11], seed=6)
    worst, cache, jcache = run_slots(jcfg, cfg, jp, params, state,
                                     tokens(cfg, (7, 3, 1), seed=7))
    assert worst <= TOL
    assert_cache_close(cache, jcache)
    assert cache["idx"].tolist() == [7, 10, 18]


MOE12 = dict(name="moe-slots", n_layers=2, d_model=32, n_heads=4,
             n_kv_heads=2, d_ff=48, vocab=64, moe_experts=4, moe_top_k=2)


def test_decode_step_slots_routes_each_slot_alone_as_the_vmap_does():
    """12 slots at mixed positions through a 4-expert top-2 MoE: JAX's
    ``vmap`` of ``decode_step`` gives each slot the capacity of one
    token (8), so no slot drops a token; routing the 24 choices of all
    slots together (capacity 8 for T = 12) would drop some and differ."""
    jcfg, cfg = JModelConfig(**MOE12), ModelConfig(**MOE12)
    jp = jax.jit(lambda k: jt.init_params(jcfg, k))(jax.random.PRNGKey(0))
    params, _ = tt.params_from_jax(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    idx = [0, 1, 2, 3, 5, 6, 7, 9, 10, 12, 14, 15]
    state = slot_cache(cfg, 12, 16, idx, seed=8)
    toks = tokens(cfg, (3, 12, 1), seed=9)
    worst, cache, jcache = run_slots(jcfg, cfg, jp, params, state, toks)
    assert worst <= TOL
    assert_cache_close(cache, jcache)
    # all rows routed together: one capacity for the batch
    c0 = jax.tree.map(lambda a: torch.from_numpy(a.copy()), state)
    pos, sp = c0["idx"], c0["slot_pos"]
    sp[torch.arange(12), pos % 16] = pos
    with torch.no_grad():
        together = tt._decode(cfg, params, c0["layers"],
                              torch.from_numpy(toks[0]), pos, sp,
                              rows=False)
    jl, _ = _j_decode_slots(jcfg, jp, jax.tree.map(jnp.asarray, state),
                            jnp.asarray(toks[0]))
    assert rel(together, jl) > 100 * TOL


# ------------------------------------------------------------------ #
# checkpoints and the CLIs
# ------------------------------------------------------------------ #
def test_olmo_checkpoint_cross_loads_both_ways(tmp_path):
    """The reference's ``save_checkpoint`` of OLMo's tree (empty norm
    dicts) loads in the port bitwise, and the port's file loads back in
    the reference bitwise."""
    _, cfg, jp, _, _ = model("olmo-1b")
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_checkpoint(jdir, 3, jp)
    like = tt.init_params(cfg, torch.Generator().manual_seed(0))
    got = ckpt.load_checkpoint(jdir, like)
    assert structure(got) == structure(jp)
    for (path, want) in jax.tree_util.tree_flatten_with_path(jp)[0]:
        t = got
        for k in path:
            t = t[k.key]
        np.testing.assert_array_equal(t.numpy(), np.asarray(want))
    ckpt.save_checkpoint(pdir, 3, got)
    back = jckpt.load_checkpoint(pdir, jp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("arch", ZOO)
def test_train_cli_runs_each_zoo_arch(arch, two_torch_threads):
    from repro_torch.launch import train
    common = ["--arch", arch, "--reduced", "--nodes", "2",
              "--batch-per-node", "2", "--seq", "16", "--device", "cpu"]
    sync = train.main(common + ["--steps", "2", "--loss-prob", "0.2",
                                "--log-every", "1"])
    assert sync["rounds"] == 2 and np.isfinite(sync["losses"]).all()
    assert sync["mass_rel"] <= 1e-4
    if arch == "deepseek-v2-236b":
        res = train.main(common + ["--steps", "2", "--scenario",
                                   "straggler", "--log-every", "1"])
        assert res["waves"] > 0 and np.isfinite(res["losses"]).all()


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-v2-236b"])
def test_serve_cli_serves_each_zoo_arch(arch, two_torch_threads):
    """The two archs of tests/test_serve.py's DECODER_ARCHS that the port
    refused before the zoo: served end to end by the CLI."""
    from repro_torch.launch import serve
    res = serve.main(["--arch", arch, "--reduced", "--batch", "2",
                      "--requests", "6", "--max-prompt", "6",
                      "--max-gen", "3", "--buckets", "4,8",
                      "--device", "cpu"])
    reqs = res["report"]["requests"]
    assert len(reqs) == 6 and all(r.done for r in reqs)
