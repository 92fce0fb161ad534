"""Port run_rfast vs JAX run_rfast(mode="wavefront") on the reduced LM.

Same weights (carried over with ``params_from_jax``), same schedule and
the same token batches fed in on both sides, so the comparison is
key-free.  Backends and tolerance as in tests/test_torch_engine.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import get_topology
from repro.core.paramvec import ModelGradProvider as JModelGradProvider
from repro.core.paramvec import make_ravel_spec as j_spec
from repro.core.paramvec import ravel as j_ravel
from repro.core.scenario import get_scenario
from repro.models import transformer as jt
from repro_torch.configs import get_config
from repro_torch.core.paramvec import ModelGradProvider, make_ravel_spec
from repro_torch.models import transformer as tt
from test_torch_engine import TOL, _runs


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_engine_matches_jax_reduced_lm(impl):
    """The reduced LM through both engines with the same token batches
    fed in (node i always trains on toks[i]) and the same weights."""
    jcfg = j_get_config("rfast-100m").reduced(n_layers=1, max_d_model=64,
                                              vocab=128)
    cfg = get_config("rfast-100m").reduced(n_layers=1, max_d_model=64,
                                           vocab=128)
    n = 4
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    jspec = j_spec(jparams, pad_to=128)
    params, flat = tt.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      pad_to=128, device="cpu")
    spec = make_ravel_spec(params, pad_to=128)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (n, 2, 9))
    jt_toks, tt_toks = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)
    jprov = JModelGradProvider(
        spec=jspec, n_nodes=n,
        value_and_grad=lambda prm, b, _k: jax.value_and_grad(
            lambda q: jt.loss_fn(jcfg, q, b[:, :-1], b[:, 1:]))(prm),
        batch_fn=lambda i, k: jt_toks[i])
    tprov = ModelGradProvider(
        spec=spec, n_nodes=n,
        loss_fn=lambda prm, b, _g: tt.loss_fn(cfg, prm, b[:, :-1], b[:, 1:]),
        batch_fn=lambda i, gen: tt_toks[i])

    topo = get_topology("binary_tree", n)
    sched = get_scenario("straggler", n).realize(topo, 3 * n,
                                                 seed=0).schedule
    x0 = np.asarray(j_ravel(jspec, jparams))
    np.testing.assert_array_equal(x0, flat.numpy())
    jsnaps, tsnaps, _ = _runs(topo, sched, jprov, tprov,
                              np.tile(x0, (n, 1)), 0.05, impl,
                              eval_every=n)
    assert len(jsnaps) == len(tsnaps) == 3
    for c, (js, ts) in enumerate(zip(jsnaps, tsnaps)):
        for f in ("x", "z", "g_prev", "rho", "rho_buf"):
            np.testing.assert_allclose(ts[f], js[f], **TOL,
                                       err_msg=f"chunk {c} field {f}")
