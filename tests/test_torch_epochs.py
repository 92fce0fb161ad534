"""The port's epochized engine (dynamic membership) against the JAX one.

* ``migrate_state`` against JAX's ``migrate_state`` on the same numpy
  state (random fields, fake in-flight mass), at the ``root_failover``
  boundary (the sole root departs) and at the ``churn`` joiner: every
  field within 1e-6 (fp32 on both sides; only the order of a sum
  differs), plus the reference test's invariants (tests/test_epochs.py:
  surplus conserved, a departed root zeroed, nothing left in flight,
  ``v_hist[0] == v``, a joiner adopting the root's x).
* ``run_epochs`` against JAX's ``run_epochs`` on the key-free quadratic
  (``churn`` on binary_tree n 4, K 80: three epochs; ``root_failover``
  on robust_tree n 4, K 160: two), both commit backends: every field
  within 1e-5 of its largest entry, the metrics' ``k`` and ``t``
  identical.
* A one-epoch (static) trace through ``run_epochs`` is bitwise the
  port's ``run_rfast`` on a stochastic objective; every event of every
  epoch draws the generator of its global event index; a
  ``run_sweep_epochs`` lane is bitwise ``run_epochs``, and a mesh whose
  lane axis is wider than 1 is refused (tests/test_torch_mesh_sweep.py
  holds the param-sharded mesh to JAX).
* The re-election claim of tests/test_epochs.py at its own sizes
  (logistic, robust_tree n 8, 150 rounds): after the crash the
  epochized run keeps descending, the frozen plan stalls.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_scenario as j_get_scenario
from repro.core import get_topology as j_get_topology
from repro.core import migrate_state as j_migrate_state
from repro.core import run_epochs as j_run_epochs
from repro.core.simulator import RFASTState as JState
from repro.core.simulator import pack_state as j_pack_state
from repro_torch.core.plan import as_comm_plan
from repro_torch.core.scenario import get_scenario, realize_epochs_batch
from repro_torch.core.simulator import (RFASTState, event_generator,
                                        migrate_state, pack_state,
                                        run_epochs, run_rfast,
                                        run_sweep_epochs)
from repro_torch.core.topology import get_topology
from repro_torch.data import make_logistic_problem
from test_torch_engine import quad, two_torch_threads  # noqa: F401

FIELDS = ("x", "v", "z", "g_prev", "rho", "rho_buf", "v_hist", "rho_hist")


def _random_state(n, e_a, p, H, seed=0):
    """The same random state as a JAX and a port RFASTState."""
    rng = np.random.default_rng(seed)
    shapes = dict(x=(n, p), v=(n, p), z=(n, p), g_prev=(n, p), rho=(e_a, p),
                  rho_buf=(e_a, p), v_hist=(H, n, p), rho_hist=(H, e_a, p))
    arrs = {f: rng.normal(0, 1, s).astype(np.float32)
            for f, s in shapes.items()}
    return (JState(k=jnp.asarray(7, jnp.int32),
                   **{f: jnp.asarray(a) for f, a in arrs.items()}),
            RFASTState(k=7, **{f: torch.from_numpy(a.copy())
                               for f, a in arrs.items()}))


def _close(got, want, tol, fields=FIELDS):
    for f in fields:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
        assert a.shape == b.shape, f
        scale = max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale,
                                   err_msg=f)


def _surplus(s):
    return float(s.z.sum() + (s.rho - s.rho_buf).sum() - s.g_prev.sum())


def test_migrate_state_matches_jax_at_root_failover():
    n, p, H = 8, 5, 6
    sc = get_scenario("root_failover", n)
    ep0, ep1 = sc.realize_epochs(get_topology("robust_tree", n), 1200,
                                 seed=1).epochs
    jep0, jep1 = j_get_scenario("root_failover", n).realize_epochs(
        j_get_topology("robust_tree", n), 1200, seed=1).epochs
    assert ep1.departed[0] and ep1.root != 0
    e0 = max(1, as_comm_plan(ep0.topology).n_edges_a)
    jst, st = _random_state(n, e0, p, H)
    jmig = j_migrate_state(jst, jep0.topology, jep1, H=H)
    mig = migrate_state(st, ep0.topology, ep1, H=H)
    _close(mig, jmig, 1e-6)
    assert mig.k == 0 and int(jmig.k) == 0
    # the state migrated was not touched
    _close(st, jst, 0.0)
    # mass conserved, departed root zeroed, nothing in flight, v in slot 0
    assert abs(_surplus(mig) - _surplus(st)) < 1e-3
    assert float(mig.z[0].abs().sum()) == 0.0
    assert float(mig.g_prev[0].abs().sum()) == 0.0
    assert float(mig.rho.abs().sum()) == float(mig.rho_buf.abs().sum()) == 0
    assert torch.equal(mig.v_hist[0], mig.v)
    assert float(mig.v_hist[1:].abs().sum()) == 0.0


def test_migrate_state_matches_jax_at_a_churn_join():
    n, p, H = 7, 5, 6
    eps = get_scenario("churn", n).realize_epochs(
        get_topology("robust_tree", n), 1400, seed=0).epochs
    jeps = j_get_scenario("churn", n).realize_epochs(
        j_get_topology("robust_tree", n), 1400, seed=0).epochs
    e0, e1 = eps[0], eps[1]
    assert e1.joined.any()
    j = int(np.nonzero(e1.joined)[0][0])
    jst, st = _random_state(n, max(1, as_comm_plan(e0.topology).n_edges_a),
                            p, H, seed=3)
    # a node that has not joined yet holds z = g_prev (its init), so its
    # zeroed tracking carries no surplus away
    jst = jst._replace(z=jst.z.at[j].set(jst.g_prev[j]))
    st.z[j] = st.g_prev[j]
    mig = migrate_state(st, e0.topology, e1, H=H)
    _close(mig, j_migrate_state(jst, jeps[0].topology, jeps[1], H=H), 1e-6)
    assert torch.equal(mig.x[j], st.x[e1.root])
    assert torch.equal(mig.v[j], st.x[e1.root])
    assert float(mig.z[j].abs().sum()) == 0.0
    assert float(mig.g_prev[j].abs().sum()) == 0.0
    assert abs(_surplus(mig) - _surplus(st)) < 1e-3


def test_pack_state_pads_the_rho_layout_as_jax_does():
    jst, st = _random_state(3, 2, 4, 5)
    packed = pack_state(st, e_a=4)
    jpacked = j_pack_state(jst, e_a=4)
    for a, b in zip(packed, jpacked):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="e_a=1"):
        pack_state(st, e_a=1)


@pytest.mark.parametrize("sc_name,topo_name,K", [
    ("churn", "binary_tree", 80), ("root_failover", "robust_tree", 160)])
@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_run_epochs_matches_jax(sc_name, topo_name, K, impl):
    n, p = 4, 6
    jfn, tfn = quad(n, p)
    jet = j_get_scenario(sc_name, n).realize_epochs(
        j_get_topology(topo_name, n), K, seed=0)
    et = get_scenario(sc_name, n).realize_epochs(
        get_topology(topo_name, n), K, seed=0)
    assert len(et.epochs) == {"churn": 3, "root_failover": 2}[sc_name]
    x0 = np.random.default_rng(5).normal(0, 1, (n, p)).astype(np.float32)
    ev = lambda s, t: {"t": t}
    jst, jm = j_run_epochs(jet, jfn, jnp.asarray(x0), 0.05, eval_every=20,
                           eval_fn=ev)
    st, m = run_epochs(et, tfn, torch.from_numpy(x0), 0.05, eval_every=20,
                       eval_fn=ev, impl=impl, device="cpu")
    _close(st, jst, 1e-5)
    assert [e["k"] for e in m] == [e["k"] for e in jm]
    assert [e["t"] for e in m] == [e["t"] for e in jm]
    # evaluation lands on every epoch boundary
    assert {ep.k0 for ep in et.epochs[1:]} <= {e["k"] for e in m}


def _logistic(n):
    return make_logistic_problem(n, m=700, d=16, batch=8, heterogeneous=True,
                                 seed=0, device="cpu")


@pytest.mark.parametrize("sc_name", ["uniform", "straggler"])
def test_single_epoch_is_bitwise_run_rfast(sc_name):
    n, K = 7, 400
    prob = _logistic(n)
    topo = get_topology("binary_tree", n)
    sc = get_scenario(sc_name, n)
    et = sc.realize_epochs(topo, K, seed=3)
    assert len(et.epochs) == 1
    ev = lambda s, t: {"m": float(s.x.abs().sum()), "t": t}
    st_o, ms_o = run_rfast(topo, sc.realize(topo, K, seed=3).schedule, prob,
                           torch.zeros(prob.p), 5e-3, seed=3, eval_every=100,
                           eval_fn=ev, device="cpu")
    st_e, ms_e = run_epochs(et, prob, torch.zeros(prob.p), 5e-3, seed=3,
                            eval_every=100, eval_fn=ev, device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(st_o, f), getattr(st_e, f)), f
    assert ms_o == ms_e


def test_every_epoch_draws_its_global_event_generators():
    n, K, seed = 4, 80, 2
    topo = get_topology("binary_tree", n)
    et = get_scenario("churn", n).realize_epochs(topo, K, seed=seed)
    assert len(et.epochs) == 3 and et.epochs[2].k0 > 0
    drawn = set()

    def gfn(i, x, gen):
        drawn.add((i, gen.initial_seed()))
        return x

    run_epochs(et, gfn, torch.zeros(3), 0.1, seed=seed, device="cpu")
    want = {(i, event_generator(seed, -1, i).initial_seed())
            for i in range(n)}
    for ep in et.epochs:
        for k, a in enumerate(ep.trace.schedule.agent.tolist()):
            want.add((a, event_generator(seed, ep.k0 + k, a).initial_seed()))
    assert drawn == want


def test_sweep_epochs_lane_is_bitwise_run_epochs():
    n, K = 8, 900
    prob = _logistic(n)
    topo = get_topology("robust_tree", n)
    traces = realize_epochs_batch(topo, K, scenario="root_failover",
                                  seeds=(0, 1))
    ev = lambda s, t: {"m": float(s.x.abs().sum()), "t": t}
    sts, mss = run_sweep_epochs(traces, prob, torch.zeros(prob.p), 5e-3,
                                seeds=[0, 1], eval_every=300, eval_fn=ev,
                                device="cpu")
    for s in (0, 1):
        st, ms = run_epochs(traces[s], prob, torch.zeros(prob.p), 5e-3,
                            seed=s, eval_every=300, eval_fn=ev, device="cpu")
        for f in FIELDS:
            assert torch.equal(getattr(sts[s], f), getattr(st, f)), (s, f)
        assert mss[s] == ms


def test_sweep_epochs_rejects_a_mesh():
    """A lane-parallel mesh: run_sweep_epochs shards the parameter axis
    only (the reference's error), before any rank is asked for."""
    from repro_torch.launch.mesh import SweepMesh
    et = get_scenario("churn", 4).realize_epochs(
        get_topology("binary_tree", 4), 80, seed=0)
    mesh = SweepMesh(axis_names=("data", "model"),
                     shape={"data": 2, "model": 1}, ranks=(0, 1), rank=0,
                     groups={})
    with pytest.raises(ValueError, match="parameter axis only"):
        run_sweep_epochs([et], lambda i, x, g: x, torch.zeros(2), 0.1,
                         mesh=mesh, device="cpu")


def test_root_failover_epochized_converges_frozen_stalls():
    """tests/test_epochs.py's headline claim at its own sizes."""
    n, rounds, gamma = 8, 150, 2e-3
    K = rounds * n
    prob = make_logistic_problem(n, m=2800, d=64, batch=16,
                                 heterogeneous=True, seed=0, device="cpu")
    topo = get_topology("robust_tree", n)
    sc = get_scenario("root_failover", n)
    x0 = torch.zeros(prob.p)
    ev = lambda s, t: {"loss": prob.mean_loss(s.x.mean(0)), "t": t}
    et = sc.realize_epochs(topo, K, seed=0)
    assert len(et.epochs) == 2 and et.epochs[1].root != 0
    every = max(100, K // 40)
    _, ms_e = run_epochs(et, prob, x0, gamma, seed=0, eval_every=every,
                         eval_fn=ev, device="cpu")
    _, ms_f = run_rfast(topo, sc.realize(topo, K, seed=0).schedule, prob,
                        x0, gamma, seed=0, eval_every=every, eval_fn=ev,
                        device="cpu")
    post_e = [m["loss"] for m in ms_e if m["t"] > 40.0]
    post_f = [m["loss"] for m in ms_f if m["t"] > 40.0]
    assert ms_e[-1]["loss"] < 0.7 * post_e[0]
    assert max(post_f) < 1.05 * min(post_f)
    assert ms_f[-1]["loss"] > 1.5 * ms_e[-1]["loss"]


def test_run_epochs_needs_a_gpu_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    et = get_scenario("churn", 4).realize_epochs(
        get_topology("binary_tree", 4), 80, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_epochs(et, lambda i, x, g: x, torch.zeros(2), 0.1)
