"""Port core/baselines.py vs the JAX package's.

* Each of the six runners against the reference on LogisticProblem with
  batch 0 (key-free: the port's generators cannot reproduce JAX's keys)
  under the straggler scenario: the iterate handed to ``eval_fn`` at
  every eval agrees to 1e-4 relative to its largest entry (fp32 on both
  sides, sums in another order), at the same virtual times.
* AD-PSGD's and OSGP's host tables — partner draws, mix gate, ring
  slots; edge tables, stamp slots, delivered sends — are the reference's:
  with a zero gradient the iterate after every event is a function of
  those tables and x0 alone, and it agrees event by event (1e-5) from
  distinct random rows, under loss and a crash window.
* Mirrors of tests/test_baselines.py: Metropolis weights, AD-PSGD's
  staleness semantics, the uniform ``eval_fn`` contract, and D-PSGD's
  bias under heterogeneity.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import baselines as jb
from repro.data import make_logistic_problem as j_make
from repro_torch.core import baselines as tb
from repro_torch.core.scenario import NetworkScenario
from repro_torch.core.topology import (directed_ring, exponential,
                                       undirected_ring)
from repro_torch.data import make_logistic_problem
from test_torch_engine import quad

N = 5
KW = dict(m=500, d=12, batch=0, heterogeneous=True, seed=1)


def _collect(box):
    def eval_fn(x, t):
        box.append((np.array(x, copy=True), t))
        return {"t": t}
    return eval_fn


def _both(call, jgfn, tgfn, x0, tol=1e-4):
    jbox, tbox = [], []
    jx, jm = call(jb, jgfn, jnp.asarray(x0), _collect(jbox), {})
    tx, tm = call(tb, tgfn, torch.from_numpy(x0), _collect(tbox),
                  {"device": "cpu"})
    assert len(jbox) == len(tbox) > 0 and len(jm) == len(tm)
    for (a, ta), (b, tb_) in zip(tbox, jbox):
        assert ta == tb_
        scale = max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale)
    for m, r in zip(tm, jm):
        assert m == r
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                               atol=tol * max(float(np.abs(jx).max()), 1e-30))


def mod(b):
    """The core package (topologies, scenarios) on runner ``b``'s side."""
    return jcore if b is jb else tcore


def _runner_calls():
    d_topo, u_topo = (lambda m: m.directed_ring(N)), (
        lambda m: m.undirected_ring(N))
    sc = lambda b: mod(b).get_scenario("straggler", N)
    return {
        "push_pull_sync": lambda b, g, x, e, kw: b.run_push_pull_sync(
            d_topo(mod(b)), g, x, 2e-3, 40, scenario=sc(b), eval_every=10,
            eval_fn=e, **kw),
        "sab": lambda b, g, x, e, kw: b.run_sab(
            mod(b).exponential(N), g, x, 2e-3, 40, scenario=sc(b),
            eval_every=8, eval_fn=e, **kw),
        "ring_allreduce": lambda b, g, x, e, kw: b.run_ring_allreduce(
            N, g, x[0], 2e-3, 40, scenario=sc(b), eval_every=10, eval_fn=e,
            **kw),
        "dpsgd": lambda b, g, x, e, kw: b.run_dpsgd(
            u_topo(mod(b)), g, x, 2e-3, 40, scenario=sc(b), eval_every=10,
            eval_fn=e, **kw),
        "adpsgd": lambda b, g, x, e, kw: b.run_adpsgd(
            u_topo(mod(b)), g, x, 2e-3, 200, scenario=sc(b), eval_every=50,
            eval_fn=e, seed=3, **kw),
        "osgp": lambda b, g, x, e, kw: b.run_osgp(
            d_topo(mod(b)), g, x, 2e-3, 200, scenario=sc(b), eval_every=50,
            eval_fn=e, seed=3, **kw),
    }


@pytest.fixture(scope="module")
def logistic():
    return j_make(N, **KW), make_logistic_problem(N, device="cpu", **KW)


@pytest.mark.parametrize("name", list(_runner_calls()))
def test_runner_matches_reference_on_logistic(name, logistic):
    jp, tp = logistic
    x0 = np.random.default_rng(4).normal(0, 0.1, (N, tp.p)).astype(
        np.float32)
    _both(_runner_calls()[name], jp.grad_fn(), tp.grad_fn(), x0)


@pytest.mark.parametrize("name,sc", [
    ("adpsgd", dict(loss=0.3, latency=0.8)),
    ("adpsgd", dict(latency=0.4, failures=((2, 10.0, 30.0),))),
    ("osgp", dict(loss=0.3, latency=0.8)),
    ("osgp", dict(compute_time=(1, 1, 1, 1, 3.0), latency=0.6)),
])
def test_async_host_tables_match_reference(name, sc):
    """Zero gradient: each event's mixing is fixed by the host tables."""
    zero_j = lambda i, x, key: jnp.zeros_like(x)
    zero_t = lambda i, x, gen: torch.zeros_like(x)
    x0 = np.random.default_rng(7).normal(0, 1, (N, 6)).astype(np.float32)
    topo = "undirected_ring" if name == "adpsgd" else "exponential"

    def call(b, g, x, e, kw):
        return getattr(b, f"run_{name}")(
            mod(b).get_topology(topo, N), g, x, 0.1, 120, eval_every=1,
            eval_fn=e, seed=2, scenario=mod(b).NetworkScenario(**sc), **kw)
    _both(call, zero_j, zero_t, x0, tol=1e-5)


def test_metropolis_doubly_stochastic():
    topo = undirected_ring(8)
    Wm = tb.metropolis_weights(topo)
    np.testing.assert_allclose(Wm.sum(0), 1.0, atol=1e-12)
    np.testing.assert_allclose(Wm.sum(1), 1.0, atol=1e-12)
    assert np.all(Wm >= 0)
    np.testing.assert_array_equal(
        Wm, jb.metropolis_weights(jcore.undirected_ring(8)))
    np.testing.assert_array_equal(
        tb.metropolis_weights(exponential(8)),
        jb.metropolis_weights(jcore.exponential(8)))


@pytest.mark.parametrize("staleness", [0, 1, 3])
def test_adpsgd_staleness_semantics(staleness):
    """The gradient at event k is evaluated at the active node's row of
    the global state as of ``staleness`` events ago (mixing off with
    loss=1, dynamics linear in x, a host-side loop as the reference)."""
    n, p, K, gamma = 3, 4, 200, 0.05
    topo = undirected_ring(n)
    sc = NetworkScenario(loss=1.0)
    gfn = lambda i, x, gen: x  # noqa: E731
    x0 = np.random.default_rng(0).normal(0, 1, (n, p)).astype(np.float32)
    x, _ = tb.run_adpsgd(topo, gfn, torch.from_numpy(x0), gamma, K,
                         scenario=sc, staleness=staleness, seed=0,
                         device="cpu")
    sched = sc.realize(topo, K, seed=0).schedule
    xr = x0.copy()
    hist = [x0.copy()]
    for k, a in enumerate(sched.agent):
        src = hist[max(0, k - staleness)]      # state `staleness` events ago
        xr = xr.copy()
        xr[a] = xr[a] - gamma * src[a]
        hist.append(xr)
    np.testing.assert_allclose(x.numpy(), xr, rtol=1e-5, atol=1e-6)


def test_eval_fn_receives_bare_iterate_everywhere():
    n, p = 5, 4
    _, gfn = quad(n, p)
    topo_d, topo_u = directed_ring(n), undirected_ring(n)
    x0 = torch.zeros(n, p)
    seen = {}

    def spy(tag, want_shape):
        def eval_fn(x, t):
            assert torch.is_tensor(x) and tuple(x.shape) == want_shape, tag
            assert isinstance(t, float)
            seen[tag] = True
            return {"loss": 0.0, "t": t}
        return eval_fn

    kw = dict(device="cpu")
    tb.run_push_pull_sync(topo_d, gfn, x0, 0.05, 12, eval_every=6,
                          eval_fn=spy("pps", (n, p)), **kw)
    tb.run_sab(topo_d, gfn, x0, 0.05, 12, eval_every=6,
               eval_fn=spy("sab", (n, p)), **kw)
    tb.run_dpsgd(topo_u, gfn, x0, 0.05, 12, eval_every=6,
                 eval_fn=spy("dpsgd", (n, p)), **kw)
    tb.run_ring_allreduce(n, gfn, torch.zeros(p), 0.05, 12, eval_every=6,
                          eval_fn=spy("ring", (p,)), **kw)
    tb.run_adpsgd(topo_u, gfn, x0, 0.05, 40, eval_every=20,
                  eval_fn=spy("adpsgd", (n, p)), **kw)
    tb.run_osgp(topo_d, gfn, x0, 0.05, 40, eval_every=20,
                eval_fn=spy("osgp", (n, p)), **kw)
    assert set(seen) == {"pps", "sab", "dpsgd", "ring", "adpsgd", "osgp"}


def test_dpsgd_biased_under_heterogeneity():
    """D-PSGD's fixed point shifts under heterogeneous data and unequal
    curvatures (Remark 7): a neighbourhood of x*, not x* itself."""
    n, p = 5, 4
    rng = np.random.default_rng(3)
    C = torch.from_numpy(rng.normal(0, 1, (n, p)).astype(np.float32))
    S = torch.from_numpy(rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32))
    x_star = (S * C).sum(0) / S.sum(0)
    gfn = lambda i, x, gen: S[i] * (x - C[i])  # noqa: E731
    x, _ = tb.run_dpsgd(undirected_ring(n), gfn, torch.zeros(n, p), 0.05,
                        3000, device="cpu")
    err = float(torch.linalg.vector_norm(x.mean(0) - x_star))
    assert 1e-4 < err < 1.0
