"""The synchronous regime of the port's train driver against the JAX one.

Reduced rfast-100m with JAX's ``init_params(PRNGKey(0))`` weights carried
into the port with ``params_from_jax``, the reference's ``node_batch``
batches, loss masks from ``default_rng(1)`` (loss_prob 0.3), momentum 0.5
and ``warmup_cosine``: three rounds of the port's ``plain`` and
``kernel`` backends against JAX's ``jnp`` and ``pallas``.  Per-round
losses and the final flat x, z, ρ and ρ̃ agree within 1e-4, the
tolerance tests/test_torch_model.py holds the flat gradient to (fp32 on
both sides; only the order of sums differs).  The same holds over the
model families: rfast-100m without loss, and reduced hymba-1.5b (hybrid
attention + Mamba heads, its scan through ``SelectiveScanFn``) with and
without loss, against JAX's ``jnp`` rounds.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import get_topology as j_get_topology
from repro.core.runtime import edge_arrays as j_edge_arrays
from repro.core.runtime import init_node_state as j_init_node_state
from repro.core.runtime import make_rfast_round as j_make_rfast_round
from repro.models import transformer as jt
from repro.optim.schedules import warmup_cosine as j_warmup_cosine
from repro_torch.configs import get_config
from repro_torch.core.paramvec import make_ravel_spec
from repro_torch.core.runtime import (edge_arrays, init_node_state,
                                      make_rfast_round)
from repro_torch.core.topology import get_topology
from repro_torch.data.pipeline import LMShardConfig, node_batch
from repro_torch.launch import train
from repro_torch.models.transformer import params_from_jax
from repro_torch.optim.schedules import warmup_cosine
from test_torch_engine import two_torch_threads  # noqa: F401

N, STEPS, LOSS_PROB, MOMENTUM, GAMMA = 4, 3, 0.3, 0.5, 3e-3
SHARD = LMShardConfig(vocab=512, batch_per_node=2, seq_len=16, n_nodes=N,
                      seed=0)
FIELDS = ("x", "z", "rho", "rho_buf")


def _masks(e_pad):
    rng = np.random.default_rng(1)
    return [(rng.uniform(size=e_pad) >= LOSS_PROB).astype(np.float32)
            for _ in range(STEPS)]


def _flat_rows(tree) -> np.ndarray:
    """Stacked pytree -> (lead, p) in the ravel order (sorted key paths)."""
    leaves = jax.tree.leaves(tree)
    lead = leaves[0].shape[0]
    return np.concatenate([np.asarray(l, np.float32).reshape(lead, -1)
                           for l in leaves], axis=1)


@pytest.fixture(scope="module")
def jax_runs():
    cfg = j_get_config("rfast-100m").reduced()
    assert cfg.vocab == SHARD.vocab
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    spec = j_edge_arrays(j_get_topology("binary_tree", N))

    def grad_fn(p, batch, key):
        toks, labels = batch
        return jax.value_and_grad(
            lambda q: jt.loss_fn(cfg, q, toks, labels))(p)

    def batches_at(step):
        toks, labels = zip(*(node_batch(SHARD, i, step) for i in range(N)))
        return jnp.asarray(np.stack(toks)), jnp.asarray(np.stack(labels))

    gamma = j_warmup_cosine(GAMMA, warmup=max(1, STEPS // 20), total=STEPS)
    key = jax.random.PRNGKey(0)
    runs = {}
    for impl in ("jnp", "pallas"):
        rf = j_make_rfast_round(spec, grad_fn, gamma=gamma, robust=True,
                                momentum=MOMENTUM, impl=impl)
        st = j_init_node_state(spec, params, grad_fn, batches_at(0), key,
                               robust=True, momentum=MOMENTUM)
        losses = []
        for step, mk in enumerate(_masks(spec.e_pad)):
            st, met = rf(st, batches_at(step), jax.random.split(key, N),
                         jnp.asarray(mk))
            losses.append(np.asarray(met["losses"]))
        runs[impl] = ({f: _flat_rows(getattr(st, f)) for f in FIELDS},
                      np.stack(losses))
    return jax.tree.map(np.asarray, params), runs


def _port_run(arch, np_params, impl, robust):
    """The port's rounds from JAX's weights: (final state, losses)."""
    cfg = get_config(arch).reduced()
    _, x0 = params_from_jax(np_params, device="cpu")
    spec = edge_arrays(get_topology("binary_tree", N))
    rspec = make_ravel_spec(np_params)
    grad_fn = train.sync_grad_fn(cfg, rspec)
    gamma = warmup_cosine(GAMMA, warmup=max(1, STEPS // 20), total=STEPS)
    momentum = MOMENTUM if robust else 0.0
    rf = make_rfast_round(spec, grad_fn, gamma=gamma, robust=robust,
                          momentum=momentum, impl=impl, donate=True)
    st = init_node_state(spec, x0, grad_fn,
                         train.sync_batches(SHARD, 0, "cpu"), robust=robust,
                         momentum=momentum)
    losses = []
    for step, mk in enumerate(_masks(spec.e_pad)):
        st, met = rf(st, train.sync_batches(SHARD, step, "cpu"), None,
                     torch.from_numpy(mk) if robust else None)
        losses.append(met["losses"].numpy())
    return st, losses


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_sync_rounds_match_jax(jax_runs, impl):
    np_params, runs = jax_runs
    st, losses = _port_run("rfast-100m", np_params, impl, robust=True)
    for j_impl, (want, want_losses) in runs.items():
        np.testing.assert_allclose(np.stack(losses), want_losses,
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"losses vs {j_impl}")
        for f in FIELDS:
            np.testing.assert_allclose(getattr(st, f).numpy(), want[f],
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"{impl} vs {j_impl}: {f}")


@functools.lru_cache(maxsize=None)
def _jax_jnp_run(arch, robust):
    """JAX's ``jnp`` rounds of reduced ``arch`` from ``init_params(
    PRNGKey(0))``: (numpy params, final flat fields, losses)."""
    cfg = j_get_config(arch).reduced()
    # init, init state and rounds jitted (the round through the
    # reference's own donate=True): the same functions, compiled once
    # rather than run op by op
    params = jax.jit(lambda k: jt.init_params(cfg, k))(jax.random.PRNGKey(0))
    spec = j_edge_arrays(j_get_topology("binary_tree", N))

    def grad_fn(p, batch, key):
        toks, labels = batch
        return jax.value_and_grad(
            lambda q: jt.loss_fn(cfg, q, toks, labels))(p)

    def batches_at(step):
        toks, labels = zip(*(node_batch(SHARD, i, step) for i in range(N)))
        return jnp.asarray(np.stack(toks)), jnp.asarray(np.stack(labels))

    momentum = MOMENTUM if robust else 0.0
    gamma = j_warmup_cosine(GAMMA, warmup=max(1, STEPS // 20), total=STEPS)
    key = jax.random.PRNGKey(0)
    rf = j_make_rfast_round(spec, grad_fn, gamma=gamma, robust=robust,
                            momentum=momentum, impl="jnp", donate=True)
    st = jax.jit(lambda p, b, k: j_init_node_state(
        spec, p, grad_fn, b, k, robust=robust, momentum=momentum))(
        params, batches_at(0), key)
    losses = []
    for step, mk in enumerate(_masks(spec.e_pad)):
        st, met = rf(st, batches_at(step), jax.random.split(key, N),
                     jnp.asarray(mk) if robust else None)
        losses.append(np.asarray(met["losses"]))
    return (jax.tree.map(np.asarray, params),
            {f: _flat_rows(getattr(st, f)) for f in FIELDS},
            np.stack(losses))


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("arch,robust", [("rfast-100m", False),
                                         ("hymba-1.5b", False),
                                         ("hymba-1.5b", True)])
def test_sync_rounds_match_jax_over_model_families(arch, robust, impl):
    np_params, want, want_losses = _jax_jnp_run(arch, robust)
    st, losses = _port_run(arch, np_params, impl, robust=robust)
    np.testing.assert_allclose(np.stack(losses), want_losses, rtol=1e-4,
                               atol=1e-4, err_msg="losses")
    for f in FIELDS:
        np.testing.assert_allclose(getattr(st, f).numpy(), want[f],
                                   rtol=1e-4, atol=1e-4, err_msg=f)


def test_schedule_matches_jax_in_fp32():
    for warmup, total in ((1, 3), (5, 100)):
        j = j_warmup_cosine(GAMMA, warmup=warmup, total=total)
        t = warmup_cosine(GAMMA, warmup=warmup, total=total)
        for s in range(total + 2):
            got = t(s)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got),
                                       float(j(jnp.asarray(s, jnp.int32))),
                                       rtol=1e-6)


ARGS = ["--reduced", "--nodes", "4", "--steps", "3", "--seq", "16",
        "--batch-per-node", "2", "--log-every", "1", "--device", "cpu"]


@pytest.mark.parametrize("extra", [[], ["--loss-prob", "0.3", "--momentum",
                                        "0.5", "--impl", "plain"],
                                   ["--arch", "hymba-1.5b"],
                                   ["--arch", "falcon-mamba-7b",
                                    "--loss-prob", "0.3"]])
def test_train_main_runs_sync_rounds(extra, tmp_path):
    path = tmp_path / "m.jsonl"
    res = train.main(ARGS + extra + ["--metrics", str(path)])
    assert res["mode"] == "sync" and res["steps"] == res["rounds"] == 3
    assert len(res["losses"]) == 3
    assert all(math.isfinite(v) for v in res["losses"])
    assert res["mass_rel"] < 1e-4
    assert res["memory"] == {}          # CUDA allocator readings only
    assert len(path.read_text().splitlines()) == 3


@pytest.mark.parametrize("extra,msg", [
    (["--scenario", "straggler", "--param-shards", "2", "--ckpt", "ck"],
     "no mid-schedule resume"),
    (["--scenario", "straggler", "--loss-prob", "0.2"], "--loss-prob"),
    (["--scenario", "straggler", "--momentum", "0.9"], "--momentum"),
    (["--publish-dir", "pub"], "--scenario"),
    (["--param-shards", "2"], "--scenario")])
def test_train_argument_errors(extra, msg, capsys):
    with pytest.raises(SystemExit):
        train.main(ARGS + extra)
    assert msg in capsys.readouterr().err
