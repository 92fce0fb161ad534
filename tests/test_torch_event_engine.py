"""Port run_rfast(mode="event") vs the JAX package's event engine, and
vs the port's own wavefront engine.

* Port event vs JAX event on key-free objectives (the quadratic of
  tests/test_simulator.py with noise 0, and LogisticProblem with
  batch 0), the same Schedule realized by the JAX package's scenario
  code and the same x0: every field, the snapshot histories included,
  after every eval chunk.  Tolerance 1e-4 (fp32 on both sides; the
  reference sums over every edge with masks, the port over the agent's
  own edges).
* Port event vs port wavefront (``plain``, and ``kernel`` with its plain
  commit on CPU tensors) on stochastic objectives — a reduced
  ``LMProblem`` and LogisticProblem with minibatches: event ``k`` at
  agent ``a`` and the wavefront lane of event ``k`` draw from the same
  generator, so the trajectories agree to 1e-4 (the mirror of
  tests/test_wavefront.py::test_wavefront_matches_event_serial).
* Lemma 3 on the event state, and the argument checks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_topology, round_robin_schedule
from repro.core.scenario import get_scenario
from repro.core.simulator import run_rfast as jax_run_rfast
from repro.data import make_logistic_problem as j_make_logistic
from repro_torch.configs import get_config
from repro_torch.core import baselines
from repro_torch.core.simulator import (run_rfast, run_sweep, tracked_mass,
                                        zeros_state)
from repro_torch.data import make_lm_problem, make_logistic_problem
from repro_torch.kernels.rfast_update import dispatch
from test_torch_engine import FIELDS, _snap, quad

TOL = dict(rtol=1e-4, atol=1e-4)
STATE = ("x", "v", "z", "g_prev", "rho", "rho_buf")


def _event_runs(topo, sched, jfn, tfn, x0, gamma, eval_every):
    jsnaps, tsnaps = [], []
    jax_run_rfast(topo, sched, jfn, jnp.asarray(x0), gamma, mode="event",
                  eval_every=eval_every,
                  eval_fn=lambda s, t: jsnaps.append(_snap(s)) or {})
    dispatch.clear()
    state, metrics = run_rfast(
        topo, sched, tfn, torch.from_numpy(x0), gamma, mode="event",
        eval_every=eval_every, device="cpu",
        eval_fn=lambda s, t: tsnaps.append(_snap(s)) or {"t": t})
    assert dispatch.stats()["launches"] == 0
    assert [m["k"] for m in metrics] == list(
        range(eval_every, sched.K + 1, eval_every))
    assert [m["t"] for m in metrics] == [
        float(sched.times[k - 1]) for k in range(eval_every, sched.K + 1,
                                                 eval_every)]
    assert state.k == sched.K
    assert len(jsnaps) == len(tsnaps) == sched.K // eval_every
    for c, (js, ts) in enumerate(zip(jsnaps, tsnaps)):
        for f in FIELDS:
            np.testing.assert_allclose(ts[f], js[f], **TOL,
                                       err_msg=f"chunk {c} field {f}")
    return state


@pytest.mark.parametrize("topo_name,scen,n", [
    ("binary_tree", "straggler", 7), ("directed_ring", "packet_loss", 5),
    ("exponential", "crash_recovery", 7), ("undirected_ring", "uniform", 4),
])
def test_event_engine_matches_jax_quadratic(topo_name, scen, n):
    p, K = 6, 20 * n
    topo = get_topology(topo_name, n)
    sched = get_scenario(scen, n).realize(topo, K, seed=1).schedule
    jfn, tfn = quad(n, p)
    x0 = np.random.default_rng(2).normal(0, 1, (n, p)).astype(np.float32)
    state = _event_runs(topo, sched, jfn, tfn, x0, 0.05, eval_every=5 * n)
    # Lemma 3: the tracked mass is the sum of the last sampled gradients
    np.testing.assert_allclose(tracked_mass(state).numpy(),
                               state.g_prev.sum(0).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_event_engine_matches_jax_round_robin():
    n, p = 5, 4
    topo = get_topology("directed_ring", n)
    sched = round_robin_schedule(topo, 10)
    jfn, tfn = quad(n, p)
    x0 = np.random.default_rng(0).normal(0, 1, (n, p)).astype(np.float32)
    _event_runs(topo, sched, jfn, tfn, x0, 0.05, eval_every=25)


def test_event_engine_matches_jax_logistic():
    n = 7
    kw = dict(m=700, d=16, batch=0, heterogeneous=True, seed=1)
    jp = j_make_logistic(n, **kw)
    tp = make_logistic_problem(n, device="cpu", **kw)
    topo = get_topology("binary_tree", n)
    sched = get_scenario("straggler", n).realize(topo, 140, seed=3).schedule
    x0 = np.zeros((n, tp.p), np.float32)
    state = _event_runs(topo, sched, jp.grad_fn(), tp, x0, 2e-3,
                        eval_every=35)
    assert float(tp.mean_loss(state.x.mean(0))) < float(
        tp.mean_loss(torch.zeros(tp.p)))


def _event_vs_wavefront(topo, sched, prob, x0, gamma, eval_every, impl):
    snaps = {}
    for mode, im in (("event", "plain"), ("wavefront", impl)):
        box = []
        dispatch.clear()
        st, metrics = run_rfast(
            topo, sched, prob, x0, gamma, mode=mode, impl=im, seed=3,
            eval_every=eval_every, device="cpu",
            eval_fn=lambda s, t: box.append(_snap(s)) or {})
        assert dispatch.stats()["launches"] == 0
        assert ("waves" in metrics[0]) == (mode == "wavefront")
        snaps[mode] = box
    assert len(snaps["event"]) == len(snaps["wavefront"])
    for c, (e, w) in enumerate(zip(snaps["event"], snaps["wavefront"])):
        for f in STATE:
            np.testing.assert_allclose(w[f], e[f], **TOL,
                                       err_msg=f"chunk {c} field {f}")


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_event_matches_wavefront_on_stochastic_lm(impl):
    n = 4
    cfg = get_config("rfast-100m").reduced(n_layers=1, max_d_model=64,
                                           vocab=128)
    prob = make_lm_problem(cfg, n, batch_per_node=2, seq_len=8, seed=0,
                           device="cpu")
    topo = get_topology("binary_tree", n)
    sched = get_scenario("straggler", n).realize(topo, 3 * n,
                                                 seed=1).schedule
    _event_vs_wavefront(topo, sched, prob, prob.x0_flat, 0.05, n, impl)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("topo_name,scen", [("binary_tree", "packet_loss"),
                                            ("exponential", "straggler")])
def test_event_matches_wavefront_on_minibatch_logistic(topo_name, scen,
                                                       impl):
    n = 7
    prob = make_logistic_problem(n, m=700, d=12, batch=8, seed=0,
                                 device="cpu")
    topo = get_topology(topo_name, n)
    sched = get_scenario(scen, n).realize(topo, 200, seed=2).schedule
    _event_vs_wavefront(topo, sched, prob, torch.zeros(prob.p), 2e-3, 50,
                        impl)


def test_event_mode_chunk_callbacks():
    n, p, K = 4, 3, 30
    topo = get_topology("binary_tree", n)
    sched = get_scenario("uniform", n).realize(topo, K, seed=0).schedule
    _, tfn = quad(n, p)
    seen = []
    st, metrics = run_rfast(topo, sched, tfn, torch.zeros(p), 0.05,
                            mode="event", eval_every=8, device="cpu",
                            chunk_cb=lambda s, k: seen.append((s.k, k)))
    assert metrics == [] and seen == [(8, 8), (16, 16), (24, 24), (30, 30)]
    assert st.k == K and st.v_hist.shape[0] == int(sched.D) + 2


def test_event_mode_rejects_the_kernel_and_unknown_modes():
    topo = get_topology("binary_tree", 4)
    sched = get_scenario("uniform", 4).realize(topo, 8, seed=0).schedule
    _, tfn = quad(4, 3)
    x0 = torch.zeros(3)
    with pytest.raises(ValueError, match="requires mode='wavefront'"):
        run_rfast(topo, sched, tfn, x0, 0.1, mode="event", impl="kernel",
                  device="cpu")
    with pytest.raises(ValueError, match="mode must be"):
        run_rfast(topo, sched, tfn, x0, 0.1, mode="serial", device="cpu")
    with pytest.raises(ValueError, match="impl must be"):
        run_rfast(topo, sched, tfn, x0, 0.1, mode="event", impl="jnp",
                  device="cpu")


def test_entry_points_default_to_cuda():
    """Without a GPU every constructor and runner raises unless it is
    given device='cpu'."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    topo = get_topology("binary_tree", 4)
    sched = get_scenario("uniform", 4).realize(topo, 8, seed=0).schedule
    _, tfn = quad(4, 3)
    cfg = get_config("rfast-100m").reduced(n_layers=1, max_d_model=64,
                                           vocab=128)
    calls = [
        lambda: zeros_state(topo, 3, 4),
        lambda: make_lm_problem(cfg, 4),
        lambda: make_logistic_problem(4, m=40, d=3),
        lambda: run_rfast(topo, sched, tfn, torch.zeros(3), 0.1,
                          mode="event"),
        lambda: run_sweep(topo, [sched], tfn, torch.zeros(3), 0.1),
        lambda: baselines.run_push_pull_sync(topo, tfn, torch.zeros(3), 0.1,
                                             2),
        lambda: baselines.run_ring_allreduce(4, tfn, torch.zeros(3), 0.1, 2),
        lambda: baselines.run_dpsgd(topo, tfn, torch.zeros(3), 0.1, 2),
        lambda: baselines.run_adpsgd(topo, tfn, torch.zeros(3), 0.1, 4),
        lambda: baselines.run_osgp(topo, tfn, torch.zeros(3), 0.1, 4),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert zeros_state(topo, 3, 4, device="cpu").x.device.type == "cpu"
