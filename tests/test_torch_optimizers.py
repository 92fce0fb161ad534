"""Port optim/optimizers.py vs the JAX package's.

``sgd``, ``momentum`` and ``adamw`` take 20 steps on a nested dict of
parameters, fed the same gradients on both sides (made with numpy from a
seed), at a constant rate and on a schedule; the parameters and the
optimizer state must agree within 1e-6 relative to their largest entry
(fp32 on both sides).  Then the reference's descent-on-a-quadratic check
(tests/test_substrate.py) on the port's optimizers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as j_optim
from repro_torch import optim as t_optim

SHAPES = {"w": (3, 4), "b": (4,), "nested": {"s": (2,)}}


def _tree(rng, shapes=SHAPES):
    return {k: (_tree(rng, v) if isinstance(v, dict)
                else rng.normal(0, 1, v).astype(np.float32))
            for k, v in shapes.items()}


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [np.asarray(tree)]


def _close(got, want, tol=1e-6):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        scale = max(float(np.abs(b).max()), 1.0)
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale)


OPTS = [
    ("sgd", dict(lr=0.1), dict(lr=0.1, weight_decay=0.01)),
    ("momentum", dict(lr=0.05), dict(lr=0.05, beta=0.9, weight_decay=1e-4)),
    ("adamw", dict(lr=0.01), dict(lr=0.01, b1=0.8, b2=0.9, eps=1e-6,
                                  weight_decay=0.1)),
]


@pytest.mark.parametrize("schedule", [False, True], ids=["const", "sched"])
@pytest.mark.parametrize("name,base,kw", OPTS, ids=[o[0] for o in OPTS])
def test_optimizer_matches_reference(name, base, kw, schedule):
    for args in (base, kw):
        args = dict(args)
        if schedule:
            lr = args.pop("lr")
            j_opt = getattr(j_optim, name)(
                j_optim.warmup_cosine(lr, 5, 20), **args)
            t_opt = getattr(t_optim, name)(
                t_optim.warmup_cosine(lr, 5, 20), **args)
        else:
            j_opt = getattr(j_optim, name)(**args)
            t_opt = getattr(t_optim, name)(**args)
        rng = np.random.default_rng(0)
        p0 = _tree(rng)
        jp, tp = _map(jnp.asarray, p0), _map(torch.from_numpy, p0)
        js, ts = j_opt.init(jp), t_opt.init(tp)
        for step in range(20):
            g = _tree(rng)
            jp, js = j_opt.update(_map(jnp.asarray, g), js, jp,
                                  jnp.asarray(step))
            tp, ts = t_opt.update(_map(torch.from_numpy, g), ts, tp,
                                  torch.tensor(step))
            _close(tp, jp)
            _close(ts, js)


def test_update_leaves_its_arguments_untouched():
    opt = t_optim.momentum(0.1, 0.9, weight_decay=0.1)
    p = {"x": torch.ones(3)}
    g = {"x": torch.full((3,), 2.0)}
    st = opt.init(p)
    new, st2 = opt.update(g, st, p, 0)
    assert torch.equal(p["x"], torch.ones(3))
    assert torch.equal(st["x"], torch.zeros(3))
    # the buffer folds weight decay in: m = β·m + g + wd·p
    torch.testing.assert_close(st2["x"], torch.full((3,), 2.1))
    torch.testing.assert_close(new["x"], torch.full((3,), 1 - 0.21))


@pytest.mark.parametrize("opt_fn", [
    lambda: t_optim.sgd(0.1), lambda: t_optim.momentum(0.1, 0.9),
    lambda: t_optim.adamw(0.05)], ids=["sgd", "momentum", "adamw"])
def test_optimizers_descend_quadratic(opt_fn):
    opt = opt_fn()
    params = {"x": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for step in range(800):
        g = {"x": 2.0 * params["x"]}                 # ∇ Σ x²
        params, state = opt.update(g, state, params, step)
    assert float(torch.sum(params["x"] ** 2)) < 1e-3


def test_reference_optimizers_take_the_same_first_step():
    """One step from the same point, written out by hand: AdamW's bias
    correction uses t = step + 1 and adds wd·p inside the step."""
    lr, b1, b2, eps, wd = 0.01, 0.9, 0.95, 1e-8, 0.1
    p, g = np.float32(2.0), np.float32(0.5)
    m, v = (1 - b1) * g, (1 - b2) * g * g
    want = p - lr * ((m / (1 - b1)) / (np.sqrt(v / (1 - b2)) + eps)
                     + wd * p)
    opt = t_optim.adamw(lr, b1, b2, eps, wd)
    tp = {"x": torch.tensor([p])}
    new, _ = opt.update({"x": torch.tensor([g])}, opt.init(tp), tp, 0)
    jopt = j_optim.adamw(lr, b1, b2, eps, wd)
    jp = {"x": jnp.asarray([p])}
    jnew, _ = jopt.update({"x": jnp.asarray([g])}, jopt.init(jp), jp,
                          jnp.asarray(0))
    assert float(new["x"][0]) == pytest.approx(float(want), rel=1e-6)
    assert float(jnew["x"][0]) == pytest.approx(float(want), rel=1e-6)
