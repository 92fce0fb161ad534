"""Port transformer vs the JAX transformer on reduced rfast-100m.

JAX's init weights are carried into the port with ``params_from_jax``;
the flat vectors must be bitwise equal, logits agree at atol 1e-5, and
loss and flat gradient at rtol 1e-4 / atol 1e-5 (fp32 on both sides;
only the order of sums differs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.paramvec import make_ravel_spec as j_make_ravel_spec
from repro.core.paramvec import ravel as j_ravel
from repro.models import transformer as jt
from repro_torch.configs import get_config
from repro_torch.core.paramvec import (ModelGradProvider, make_ravel_spec,
                                       ravel, unravel)
from repro_torch.core.simulator import event_generator
from repro_torch.models import transformer as tt

PAD = 1000      # leaves a zero tail: the reduced p_model is a multiple of 128


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = j_get_config("rfast-100m").reduced(), \
        get_config("rfast-100m").reduced()
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    params, flat = tt.params_from_jax(np_tree, pad_to=PAD, device="cpu")
    r = np.random.default_rng(1)
    toks = r.integers(0, cfg.vocab, (3, 17)).astype(np.int32)
    return jcfg, cfg, jparams, params, flat, toks


def test_ravel_order_matches_jax(setup):
    jcfg, cfg, jparams, params, flat, _ = setup
    jflat = np.asarray(j_ravel(j_make_ravel_spec(jparams, pad_to=PAD),
                               jparams))
    np.testing.assert_array_equal(flat.numpy(), jflat)
    spec = make_ravel_spec(params, pad_to=PAD)
    np.testing.assert_array_equal(ravel(spec, params).numpy(), jflat)
    # unravel gives views: writing the flat vector moves the weights
    buf = flat.clone()
    views = unravel(spec, buf)
    buf[0] = 7.0
    assert float(views["embed"][0, 0]) == 7.0
    # the port's own init has the JAX layout (same leaves, same order)
    own = make_ravel_spec(tt.init_params(cfg, torch.Generator()
                                         .manual_seed(0)), pad_to=PAD)
    jspec = j_make_ravel_spec(jparams, pad_to=PAD)
    assert own.shapes == jspec.shapes and own.p == jspec.p


def test_node_stacked_rows_ravel_as_jax_does(setup):
    """``(N, p)`` rows <-> a tree of ``(N, *shape)`` leaves (the
    reference's synchronous state): row i is JAX's ravel of node i's
    tree, the pad tail zero, and unravel's leaves are views."""
    jcfg, cfg, jparams, params, flat, _ = setup
    jspec = j_make_ravel_spec(jparams, pad_to=PAD)
    stacked = jax.tree.map(lambda l: jnp.stack([l, 2 * l, -l]), jparams)
    spec = make_ravel_spec(params, pad_to=PAD)
    rows = ravel(spec, jax.tree.map(lambda l: torch.from_numpy(
        np.asarray(l)), stacked))
    assert rows.shape == (3, spec.p)
    for i in range(3):
        np.testing.assert_array_equal(rows[i].numpy(), np.asarray(j_ravel(
            jspec, jax.tree.map(lambda l: l[i], stacked))))
    tree = unravel(spec, rows)
    assert tree["embed"].shape == (3,) + tuple(params["embed"].shape)
    rows[1, 0] = 5.0
    assert float(tree["embed"][1, 0, 0]) == 5.0


def test_params_from_jax_needs_a_gpu_unless_cpu_is_asked_for(setup):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    np_tree = jax.tree.map(np.asarray, setup[2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.params_from_jax(np_tree)
    assert tt.params_from_jax(np_tree, device="cpu")[1].device.type == "cpu"


def test_port_init_distributions(setup):
    _, cfg, _, _, _, _ = setup
    p = tt.init_params(cfg, torch.Generator().manual_seed(3))
    assert abs(float(p["embed"].std()) - 0.02) < 2e-3
    wq = p["layers"]["attn"]["wq"]
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert torch.equal(p["final_norm"]["scale"], torch.ones(cfg.d_model))


def test_logits_match_jax(setup):
    jcfg, cfg, jparams, params, _, toks = setup
    jl, _ = jt.forward(jcfg, jparams, jnp.asarray(toks[:, :-1]))
    tl, _ = tt.forward(cfg, params, torch.from_numpy(toks[:, :-1]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=0)


def test_loss_and_flat_grad_match_jax(setup):
    jcfg, cfg, jparams, params, flat, toks = setup
    jspec = j_make_ravel_spec(jparams, pad_to=PAD)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jt.loss_fn(jcfg, p, jnp.asarray(toks[:, :-1]),
                             jnp.asarray(toks[:, 1:])))(jparams)
    jg = np.asarray(j_ravel(jspec, jgrads))

    spec = make_ravel_spec(params, pad_to=PAD)
    lane = flat.clone().requires_grad_(True)
    loss = tt.loss_fn(cfg, unravel(spec, lane), torch.from_numpy(toks[:, :-1]),
                      torch.from_numpy(toks[:, 1:]))
    (g,) = torch.autograd.grad(loss, lane)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4, atol=1e-5)
    assert spec.p > spec.p_model and not g[spec.p_model:].any()

    # the engine's adapter gives the same flat gradient
    t = torch.from_numpy(toks).long()
    gfn = ModelGradProvider(
        spec=spec, n_nodes=1,
        loss_fn=lambda prm, b, _g: tt.loss_fn(cfg, prm, b[:, :-1], b[:, 1:]),
        batch_fn=lambda i, gen: t).grad_fn()
    np.testing.assert_array_equal(gfn(0, flat, event_generator(0, 0, 0))
                                  .numpy(), g.numpy())
