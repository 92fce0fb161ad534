"""The port's MoE MLP against ``src/repro/models/moe.py``.

Small configs on the CPU (4 experts, top-2, d 32, SwiGLU experts), the
weights from one JAX ``moe_init`` tree and the inputs from numpy:

* ``moe_apply`` (output and router loss) within 1e-5 of JAX's, with
  capacity drops (T ≫ C: some expert gets more than C tokens), with a
  shared expert, and at tests/test_serve.py's lifted capacity.
* The slot a token takes in its expert follows a *stable* sort of the
  expert ids (``jnp.argsort`` is stable): the same experts and gates
  with the ties taken in another order drop other tokens and differ.
* The router loss and the gradients of a loss of the output and the
  router loss (router, every expert leaf, shared expert, input) at
  tests/test_torch_model.py's rtol 1e-4 / atol 1e-5.
* ``moe_apply_rows`` is ``moe_apply`` of each row alone, as JAX's
  ``vmap`` of ``moe_apply`` over rows gives it.
* ``_capacity`` and the parameter layout are JAX's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig

BASE = dict(name="moe-tiny", n_layers=1, d_model=32, n_heads=4,
            n_kv_heads=4, d_ff=48, vocab=64, moe_experts=4, moe_top_k=2)
TOL = 1e-5          # fp32 on both sides, one layer
CASES = {
    # T = 64 tokens, C = 16: some expert takes more than 16 and drops
    "drops": dict(capacity_factor=0.5),
    "shared": dict(moe_shared=1, capacity_factor=0.5),
    "lifted": dict(capacity_factor=100.0),
}


def configs(case):
    kw = dict(BASE, **CASES[case])
    return JModelConfig(**kw), ModelConfig(**kw)


def setup(case, shape=(2, 32), seed=0):
    jcfg, cfg = configs(case)
    jp = jmoe.moe_init(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    np_p = jax.tree.map(np.asarray, jp)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), np_p)
    x = np.random.default_rng(seed + 1).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, tp, x


def rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def test_capacity_and_layout_match_jax():
    for case in CASES:
        jcfg, cfg = configs(case)
        for T in (1, 12, 64, 1000):
            assert tmoe._capacity(cfg, T) == jmoe._capacity(jcfg, T)
    jcfg, cfg, jp, _, _ = setup("shared")
    own = tmoe.moe_init(cfg, torch.Generator().manual_seed(0), lead=(3,))
    shapes = jax.tree.map(lambda a: (3,) + a.shape, jp)
    assert jax.tree.map(lambda t: tuple(t.shape), own) == shapes
    # the router at scale 0.02, the experts at d_in^-1/2
    big = tmoe.moe_init(dataclasses.replace(cfg, d_model=256),
                        torch.Generator().manual_seed(1))
    assert abs(float(big["router"].std()) - 0.02) < 2e-3
    assert abs(float(big["experts"]["wi"].std()) - 256 ** -0.5) < 3e-3


@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_jax(case):
    jcfg, cfg, jp, tp, x = setup(case)
    jy, jaux = jmoe.moe_apply(jcfg, jp, jnp.asarray(x))
    y, aux = tmoe.moe_apply(cfg, tp, torch.from_numpy(x))
    assert tuple(y.shape) == x.shape and aux.shape == ()
    assert rel(y, jy) <= TOL
    assert abs(float(aux) - float(jaux)) <= 1e-7


def _dropped(cfg, p, x):
    """The number of (token, choice) pairs past their expert's capacity,
    from the router alone."""
    T = x.shape[0] * x.shape[1]
    probs = torch.softmax(torch.from_numpy(x).reshape(T, -1) @ p["router"],
                          -1)
    idx = torch.topk(probs, cfg.moe_top_k, -1).indices.reshape(-1)
    counts = torch.bincount(idx, minlength=cfg.moe_experts)
    return int((counts - tmoe._capacity(cfg, T)).clamp(min=0).sum())


def test_capacity_drops_happen_and_match_jax():
    """T ≫ C: tokens are dropped, and the port drops JAX's tokens (a
    dropped choice contributes nothing, so y differs from the lifted
    capacity's exactly where JAX's does)."""
    jcfg, cfg, jp, tp, x = setup("drops", shape=(4, 64))
    assert _dropped(cfg, tp, x) > 0
    jy, _ = jmoe.moe_apply(jcfg, jp, jnp.asarray(x))
    y, _ = tmoe.moe_apply(cfg, tp, torch.from_numpy(x))
    assert rel(y, jy) <= TOL
    big = dataclasses.replace(cfg, capacity_factor=100.0)
    jbig = dataclasses.replace(jcfg, capacity_factor=100.0)
    yl, _ = tmoe.moe_apply(big, tp, torch.from_numpy(x))
    jyl, _ = jmoe.moe_apply(jbig, jp, jnp.asarray(x))
    changed = (y - yl).abs().amax(-1) > 1e-6
    jchanged = np.abs(np.asarray(jy) - np.asarray(jyl)).max(-1) > 1e-6
    assert changed.any() and np.array_equal(changed.numpy(), jchanged)


def test_only_a_stable_sort_agrees(monkeypatch):
    """Within an expert the tokens take slots in token order.  The same
    routing with each expert's ties taken in reverse order (what an
    unstable sort may do) keeps other tokens under the capacity and
    gives another output."""
    jcfg, cfg, jp, tp, x = setup("drops", shape=(4, 64))
    jy, _ = jmoe.moe_apply(jcfg, jp, jnp.asarray(x))
    real = torch.argsort

    def reversed_ties(key, stable=False, **kw):
        n = key.shape[-1]
        return real(key * n + (n - 1 - torch.arange(n)), stable=True, **kw)

    monkeypatch.setattr(tmoe.torch, "argsort", reversed_ties)
    y_rev, _ = tmoe.moe_apply(cfg, tp, torch.from_numpy(x))
    monkeypatch.undo()
    y, _ = tmoe.moe_apply(cfg, tp, torch.from_numpy(x))
    assert rel(y, jy) <= TOL
    assert rel(y_rev, jy) > 100 * TOL


@pytest.mark.parametrize("case", ["drops", "shared"])
def test_aux_loss_and_gradients_match_jax(case):
    jcfg, cfg, jp, tp, x = setup(case)
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe.moe_apply(jcfg, p, xx)
        return jnp.sum(y * w) + 10.0 * aux

    jl, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jp, jnp.asarray(x))
    leaves = jax.tree.map(lambda t: t.requires_grad_(True), tp)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_apply(cfg, leaves, xt)
    loss = torch.sum(y * torch.from_numpy(w)) + 10.0 * aux
    flat = jax.tree.leaves(leaves)
    grads = torch.autograd.grad(loss, flat + [xt])
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4,
                               atol=1e-5)
    for g, jg in zip(grads[:-1], jax.tree.leaves(jgp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx),
                               rtol=1e-4, atol=1e-5)
    # the router loss alone: its gradient reaches only the router, and
    # the top-1 counts carry none
    _, aux = tmoe.moe_apply(cfg, leaves, torch.from_numpy(x))
    g_aux = torch.autograd.grad(aux, flat, allow_unused=True)
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(leaves)[0]]
    for n, g in zip(names, g_aux):
        assert (g is not None and bool(g.abs().sum() > 0)) == \
            (n == "['router']"), n
    jg_aux = jax.grad(lambda p: jmoe.moe_apply(jcfg, p, jnp.asarray(x))[1])(
        jp)["router"]
    np.testing.assert_allclose(g_aux[names.index("['router']")].numpy(),
                               np.asarray(jg_aux), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("case", ["drops", "shared"])
def test_moe_apply_rows_is_each_row_alone(case):
    """Rows routed alone, as JAX's vmap of moe_apply over (1, S, d)
    rows; routing the rows together differs once a capacity binds."""
    jcfg, cfg, jp, tp, x = setup(case, shape=(6, 24), seed=2)
    jy, jaux = jax.vmap(lambda r: jmoe.moe_apply(jcfg, jp, r[None]))(
        jnp.asarray(x))
    y, aux = tmoe.moe_apply_rows(cfg, tp, torch.from_numpy(x))
    assert tuple(aux.shape) == (6,)
    assert rel(y, np.asarray(jy)[:, 0]) <= TOL
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), rtol=1e-5,
                               atol=1e-7)
    for b in range(6):
        yb, ab = tmoe.moe_apply(cfg, tp, torch.from_numpy(x[b:b + 1]))
        assert torch.allclose(y[b:b + 1], yb, rtol=1e-6, atol=1e-6)
        assert abs(float(ab) - float(aux[b])) <= 1e-7
    together, _ = tmoe.moe_apply(cfg, tp, torch.from_numpy(x))
    assert rel(together, np.asarray(jy)[:, 0]) > 100 * TOL
