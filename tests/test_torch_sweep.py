"""Port run_sweep (the fleet sweep) vs the JAX package's, and vs the
port's own run_rfast lane by lane.

* Per lane against JAX ``run_sweep`` on the key-free quadratic of
  tests/test_simulator.py (noise 0): two lanes of different topology,
  scenario and seed (the mirror of tests/test_sweep.py's
  ``test_run_sweep_matches_run_rfast_fast``), every chunk, both commit
  backends (``kernel`` runs its plain commit on CPU tensors).  1e-4:
  fp32 on both sides.
* Lane s against the port's ``run_rfast(seed=seeds[s])`` on stochastic
  objectives (LogisticProblem with minibatches): the fleet draws each
  lane's gradients from that lane's own generators, so the lanes agree
  to 1e-5 relative to each field's largest entry.  One fleet is chosen
  so that its lanes fill different numbers of slots in a wave: there a
  wave's real lanes are not its first ``sizes[w]`` slots.
* Padded waves, lanes and ρ rows commit nothing (the mirror of
  ``test_padded_waves_and_lanes_commit_zero_delta``), and the argument
  checks of ``test_run_sweep_validation``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_topology as j_get_topology
from repro.core import run_sweep as j_run_sweep
from repro.core.scenario import get_scenario as j_get_scenario
from repro_torch.core.plan import build_comm_plan
from repro_torch.core.scenario import get_scenario
from repro_torch.core.schedule import build_wavefront_plan, pad_plan
from repro_torch.core.simulator import (_wave_step, init_packed, run_rfast,
                                        run_sweep, sweep_plan, wave_inputs)
from repro_torch.core.topology import get_topology
from repro_torch.data import make_logistic_problem
from repro_torch.kernels.rfast_update import dispatch
from test_torch_engine import _snap, quad

STATE = ("x", "v", "z", "g_prev", "rho", "rho_buf")


def _rel_close(got, want, tol, msg=""):
    for f in STATE:
        a, b = getattr(got, f), getattr(want, f)
        a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
        b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
        scale = max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale,
                                   err_msg=f"{msg}{f}")


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_run_sweep_matches_jax_sweep(impl):
    n, p, K = 5, 4, 160
    jfn, tfn = quad(n, p)
    names = ["binary_tree", "directed_ring"]
    scens, seeds = ["uniform", "packet_loss"], [0, 4]
    jtopos = [j_get_topology(t, n) for t in names]
    scheds = [j_get_scenario(sc, n).realize(t, K, seed=s).schedule
              for sc, t, s in zip(scens, jtopos, seeds)]
    jstates, jm = j_run_sweep(
        jtopos, scheds, jfn, jnp.zeros((n, p)), 0.02, seeds=seeds,
        eval_every=40, eval_fn=lambda s, t: {"snap": _snap(s), "t": t})
    dispatch.clear()
    tstates, tm = run_sweep(
        [get_topology(t, n) for t in names], scheds, tfn, torch.zeros(n, p),
        0.02, seeds=seeds, eval_every=40, impl=impl, device="cpu",
        eval_fn=lambda s, t: {"snap": _snap(s), "t": t})
    assert dispatch.stats()["launches"] == 0
    for s in range(2):
        assert [m["k"] for m in tm[s]] == [m["k"] for m in jm[s]] == [
            40, 80, 120, 160]
        assert [m["t"] for m in tm[s]] == [m["t"] for m in jm[s]]
        for c, (a, b) in enumerate(zip(tm[s], jm[s])):
            for f in STATE + ("v_hist", "rho_hist"):
                np.testing.assert_allclose(
                    a["snap"][f], b["snap"][f], rtol=1e-4, atol=1e-4,
                    err_msg=f"lane {s} chunk {c} field {f}")
        _rel_close(tstates[s], jstates[s], 1e-4, f"lane {s}: ")


def _fleet_vs_runs(topos, scheds, prob, seeds, gamma, eval_every, impl):
    loss = lambda st, t: {"loss": float(prob.mean_loss(st.x.mean(0))),
                          "t": t}
    states, metrics = run_sweep(topos, scheds, prob, torch.zeros(prob.p),
                                gamma, seeds=seeds, eval_every=eval_every,
                                eval_fn=loss, impl=impl, device="cpu")
    lane_waves = 0
    for s, (topo, sched, seed) in enumerate(zip(topos, scheds, seeds)):
        ref, rm = run_rfast(topo, sched, prob, torch.zeros(prob.p), gamma,
                            seed=seed, eval_every=eval_every, eval_fn=loss,
                            impl=impl, device="cpu")
        _rel_close(states[s], ref, 1e-5, f"lane {s}: ")
        assert [m["t"] for m in metrics[s]] == [m["t"] for m in rm]
        np.testing.assert_allclose([m["loss"] for m in metrics[s]],
                                   [m["loss"] for m in rm], rtol=1e-5)
        lane_waves += sum(m["waves"] for m in rm)
    fleet_waves = sum(m["waves"] for m in metrics[0])
    assert all(sum(m["waves"] for m in ms) == fleet_waves for ms in metrics)
    return fleet_waves, lane_waves


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_lane_s_is_run_rfast_with_seed_s(impl):
    n = 7
    prob = make_logistic_problem(n, m=700, d=12, batch=8, heterogeneous=True,
                                 device="cpu")
    topo = get_topology("binary_tree", n)
    scens = ["straggler", "packet_loss", "uniform"]
    scheds = [get_scenario(sc, n).realize(topo, 140, seed=s).schedule
              for s, sc in enumerate(scens)]
    dispatch.clear()
    fleet_waves, lane_waves = _fleet_vs_runs(
        [topo] * 3, scheds, prob, [0, 1, 2], 2e-3, 35, impl)
    assert dispatch.stats()["launches"] == 0
    assert 0 < fleet_waves < lane_waves


def test_fleet_waves_whose_real_lanes_are_not_a_prefix():
    """Lane s's real slots of a fleet wave sit at [s·B, s·B + size_s):
    where lane 0 fills fewer than B slots and lane 1 fills some, the
    wave's real lanes are not its first sizes[w] slots."""
    n, K = 7, 120
    topos = [get_topology("exponential", n), get_topology("binary_tree", n)]
    scheds = [get_scenario("uniform", n).realize(topos[0], K,
                                                 seed=0).schedule,
              get_scenario("straggler", n).realize(topos[1], K,
                                                   seed=5).schedule]
    sp = sweep_plan([build_comm_plan(t) for t in topos], scheds, 40)
    real = sp.fleet.agent != sp.fleet.n
    B = sp.fleet.width // 2
    ragged = [w for w in range(sp.fleet.n_waves)
              if real[w, :B].sum() < B and real[w, B:].any()]
    assert ragged, "the fleet must hold a wave with a gap before lane 1"
    assert any(not real[w, :sp.fleet.sizes[w]].all() for w in ragged)
    np.testing.assert_array_equal(real.sum(1), sp.fleet.sizes)
    waves = wave_inputs(sp.fleet, sp.ko, "cpu", [0, 5])
    assert sum(w.agent.shape[0] for w in waves) == 2 * K
    assert sorted(int(k) for w in waves for k in w.k_h) == sorted(
        list(range(K)) * 2)
    for w in waves:
        np.testing.assert_array_equal(w.node_h, w.agent_h % n)
        np.testing.assert_array_equal(w.seed_h, np.where(
            w.agent_h < n, 0, 5))
    prob = make_logistic_problem(n, m=700, d=12, batch=8, device="cpu")
    for impl in ("plain", "kernel"):
        _fleet_vs_runs(topos, scheds, prob, [0, 5], 2e-3, 40, impl)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("seed,scen", [(0, "uniform"), (7, "packet_loss")])
def test_padded_waves_lanes_and_rho_rows_are_inert(seed, scen, impl):
    n, p, K = 7, 5, 150
    topo = get_topology("binary_tree", n)
    prob = make_logistic_problem(n, m=700, d=p - 1, batch=8, device="cpu")
    gfn = prob.grad_fn()
    sched = get_scenario(scen, n).realize(topo, K, seed=seed).schedule
    plan = build_comm_plan(topo)
    H = int(sched.D) + 2
    wf = build_wavefront_plan(sched, plan, H)
    x0 = torch.from_numpy(np.random.default_rng(seed).normal(
        0, 0.1, (n, p)).astype(np.float32))

    def run(wplan, e_a=None):
        st = init_packed(plan, x0, gfn, H, seed=seed)
        if e_a is not None:          # the ρ layout padded to e_a rows
            pad = e_a - st.rho_hist.shape[1]
            zr = torch.zeros(pad, p)
            st = st._replace(
                rho2=torch.cat([st.rho2[:wf.e_a], zr, st.rho2[wf.e_a:], zr]),
                rho_hist=torch.cat([st.rho_hist, torch.zeros(H, pad, p)], 1))
        for w in wave_inputs(wplan, plan.ko, "cpu", (seed,)):
            if w.agent.shape[0]:
                _wave_step(st, w, grad_fn=gfn, gamma=0.002, ko=plan.ko,
                           impl=impl)
        return st

    base = run(wf)
    out = run(pad_plan(wf, width=wf.width + 2, n_waves=wf.n_waves + 3))
    for a, b in zip(out, base):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    e_a, e_a2 = wf.e_a, wf.e_a + 3
    out2 = run(pad_plan(wf, e_a=e_a2), e_a=e_a2)
    torch.testing.assert_close(out2.nodes, base.nodes, rtol=0, atol=0)
    torch.testing.assert_close(out2.rho2[:e_a], base.rho2[:e_a], rtol=0,
                               atol=0)
    torch.testing.assert_close(out2.rho2[e_a2:e_a2 + e_a], base.rho2[e_a:],
                               rtol=0, atol=0)
    torch.testing.assert_close(out2.rho_hist[:, :e_a], base.rho_hist,
                               rtol=0, atol=0)
    # the pad rows themselves hold exactly zero (nothing was written)
    assert not out2.rho2[e_a:e_a2].any() and not out2.rho2[e_a2 + e_a:].any()
    assert not out2.rho_hist[:, e_a:].any()


def test_run_sweep_validation():
    n, p, K = 5, 4, 60
    _, tfn = quad(n, p)
    topo = get_topology("binary_tree", n)
    sched = get_scenario("uniform", n).realize(topo, K, seed=0).schedule
    x0 = torch.zeros(n, p)
    kw = dict(device="cpu")
    with pytest.raises(ValueError, match="node count"):
        run_sweep([topo, get_topology("binary_tree", n + 2)], [sched, sched],
                  tfn, x0, 0.02, **kw)
    short = get_scenario("uniform", n).realize(topo, K - 10,
                                               seed=0).schedule
    with pytest.raises(ValueError, match="event count"):
        run_sweep(topo, [sched, short], tfn, x0, 0.02, **kw)
    with pytest.raises(ValueError, match="seeds for"):
        run_sweep(topo, [sched, sched], tfn, x0, 0.02, seeds=[0], **kw)
    with pytest.raises(ValueError, match="at least one lane"):
        run_sweep(topo, [], tfn, x0, 0.02, **kw)
    with pytest.raises(ValueError, match="topologies for"):
        run_sweep([topo] * 3, [sched, sched], tfn, x0, 0.02, **kw)
    with pytest.raises(ValueError, match="per-lane x0"):
        run_sweep(topo, [sched, sched], tfn, torch.zeros(3, n, p), 0.02,
                  **kw)
    with pytest.raises(ValueError, match="impl must be"):
        run_sweep(topo, [sched], tfn, x0, 0.02, impl="pallas", **kw)
