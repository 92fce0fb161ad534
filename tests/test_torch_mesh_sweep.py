"""The port's mesh-mapped fleet sweep against the JAX package's engines.

* The reference's matrix (tests/helpers/mesh_sweep_equiv.py: n 5, K 24,
  S 5, p 7, the 20260809 draw of topology × scenario × seed) on ONE
  spawn of 4 gloo ranks that builds the meshes (4, 1), (2, 2) and
  (1, 4) in turn: lane padding (S 5 → 8 and 6) and the shard padding of
  p 7 (→ 8) are both covered.  Every lane's x, v, z, g_prev, ρ, ρ̃,
  v_hist and ρ_hist, from every rank that holds it and gathered to full
  width (``gather_lane_state``), within 2e-5 of JAX's UNSHARDED
  ``run_sweep`` on the same lanes, run here where JAX sees one device,
  with both commit backends (``kernel`` runs its plain commit on CPU
  tensors).  At (1, 4) every non-empty wave gathers once, and the run
  issues no other collective.
* In the same spawn, ``run_sweep_epochs`` at (1, 4) (robust_tree 6,
  ``churn``, K 60, seeds [7, 9]) against JAX's unsharded
  ``run_sweep_epochs``, and the lane-parallel mesh it refuses.
* RF206 in the same spawn: the engine audit's 1 x 2 mesh body is clean,
  and a body that gathers the lane group's node state is reported.
* The trivial mesh in this process against JAX's
  ``run_sweep(mesh=make_sweep_mesh())``, and the reference's
  validation errors.

The objectives are key-free (the quadratic of tests/test_simulator.py
with noise 0): the per-event JAX keys cannot be matched.  The ranks
import this module by name, so JAX is imported inside the tests only.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.runtime_sharded import (clear_collectives,
                                              collective_stats)
from repro_torch.core.scenario import get_scenario
from repro_torch.core.simulator import (gather_lane_state, run_sweep,
                                        run_sweep_epochs)
from repro_torch.core.topology import get_topology
from repro_torch.launch.mesh import make_sweep_mesh
from repro_torch.launch.multihost import spawn_local

FIELDS = ("x", "v", "z", "g_prev", "rho", "rho_buf", "v_hist", "rho_hist")
N, K, S, P = 5, 24, 5, 7
MESHES = [(4, 1), (2, 2), (1, 4)]
EPOCH_N, EPOCH_K, EPOCH_SEEDS = 6, 60, [7, 9]
TOL = 2e-5


def _quad(n, p, seed=0):
    """f_i = ½ s_i |x − c_i|² as numpy arrays (key-free)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (n, p)).astype(np.float32),
            rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32))


def _quad_torch(n, p, seed=0):
    C, Sc = (torch.from_numpy(a) for a in _quad(n, p, seed))
    return lambda i, x, gen: Sc[i] * (x - C[i])


def _quad_jax(n, p, seed=0):
    import jax.numpy as jnp
    C, Sc = (jnp.asarray(a) for a in _quad(n, p, seed))
    return lambda i, x, key: Sc[i] * (x - C[i])


def _draw():
    """The reference helper's lane draw: topology names, scenario names,
    schedule seeds and lane seeds, in its order of draws."""
    rng = np.random.default_rng(20260809)
    topo_names = ["binary_tree", "line", "robust_tree"]
    sc_names = ["uniform", "packet_loss", "churn"]
    tn = [topo_names[rng.integers(len(topo_names))] for _ in range(S)]
    scn, sseeds = [], []
    for _ in range(S):
        scn.append(sc_names[rng.integers(len(sc_names))])
        sseeds.append(int(rng.integers(1 << 16)))
    seeds = [int(rng.integers(1 << 16)) for _ in range(S)]
    return tn, scn, sseeds, seeds


def _lanes(get_topo, get_sc):
    tn, scn, sseeds, seeds = _draw()
    topos = [get_topo(t, N) for t in tn]
    scheds = [get_sc(sc, N).realize(t, K, seed=ss).schedule
              for sc, t, ss in zip(scn, topos, sseeds)]
    return topos, scheds, seeds


def _traces(get_topo, get_sc):
    topo = get_topo("robust_tree", EPOCH_N)
    sc = get_sc("churn", EPOCH_N)
    return [sc.realize_epochs(topo, EPOCH_K, seed=s) for s in range(2)]


def _snap(st):
    return {f: getattr(st, f).detach().numpy().copy() for f in FIELDS}


def _mesh_rank():
    """One rank of the 4-rank spawn: every mesh of the matrix, both
    commit backends, then the epochized (1, 4) run."""
    import torch.distributed as dist
    rank = dist.get_rank()
    topos, scheds, seeds = _lanes(get_topology, get_scenario)
    gfn = _quad_torch(N, P)
    out = {"rank": rank, "lanes": {}, "gathers": {}}
    for d, m in MESHES:
        mesh = make_sweep_mesh(lanes=d, param_shards=m)
        for impl in ("plain", "kernel"):
            clear_collectives()
            sts, ms = run_sweep(topos, scheds, gfn, torch.zeros(P), 0.01,
                                seeds=seeds, eval_every=K // 2, impl=impl,
                                device="cpu", mesh=mesh, verify_plans=True,
                                eval_fn=lambda st, t: {"t": t})
            own = [s for s, st in enumerate(sts) if st is not None]
            waves = sum(mm["waves"] for mm in ms[own[0]]) if own else 0
            out["gathers"][(d, m, impl)] = (
                collective_stats()["by_name"].get(
                    "all_gather_flat", {"calls": 0})["calls"],
                waves, len(own), [len(ms[s]) for s in own])
            for s in own:
                out["lanes"][(d, m, impl, s)] = _snap(
                    gather_lane_state(sts[s], mesh, P))
    traces = _traces(get_topology, get_scenario)
    mesh = make_sweep_mesh(lanes=1, param_shards=4)
    egot, _ = run_sweep_epochs(
        traces, _quad_torch(EPOCH_N, P, 1), torch.zeros(P), 0.01,
        seeds=EPOCH_SEEDS, device="cpu", mesh=mesh)
    out["epoch_widths"] = sorted({int(st.x.shape[-1]) for st in egot})
    out["epochs"] = [_snap(gather_lane_state(st, mesh, P)) for st in egot]
    try:
        run_sweep_epochs(traces, _quad_torch(EPOCH_N, P, 1), torch.zeros(P),
                         0.01, device="cpu", mesh=make_sweep_mesh(lanes=2))
        out["lane_parallel_epochs"] = "accepted"
    except ValueError as e:
        out["lane_parallel_epochs"] = str(e)
    out["audit"] = _audit_rank()
    return out


def _audit_rank():
    """RF206 in the group: ``audit_engines`` (its 1 x 2 mesh on ranks 0
    and 1), then the mutation that gathers the group's node state."""
    from repro_torch.analysis import torchlint as tl
    from repro_torch.core.plan import build_comm_plan
    from repro_torch.core.runtime_sharded import all_gather_flat
    diags, audited, _ = tl.audit_engines(device="cpu")
    mesh = make_sweep_mesh(lanes=1, param_shards=2)
    if mesh.coords is None:
        return [d.code for d in diags], audited, None
    topo = get_topology("binary_tree", N)
    sched = get_scenario("uniform", N).realize(topo, K, seed=0).schedule
    loop = tl.wave_loop("m", [build_comm_plan(topo)], [sched],
                        _quad_torch(N, 8), 8, mesh=mesh, impl="plain",
                        device="cpu")
    group = mesh.group("model")
    bad = tl.audit_collectives(
        lambda st: (all_gather_flat(st.nodes, group), loop.run(st))[1],
        loop.state, subject="m", state_bytes_threshold=loop.state_bytes)
    return [d.code for d in diags], audited, [
        (d.code, d.data["bytes"], loop.state_bytes) for d in bad]


def _close(got: dict, want, what):
    for f in FIELDS:
        np.testing.assert_allclose(got[f], np.asarray(getattr(want, f)),
                                   rtol=TOL, atol=TOL,
                                   err_msg=f"{what} field {f}")


@pytest.fixture(scope="module")
def spawned():
    return spawn_local(_mesh_rank, 4, timeout_s=60.0, join_s=240.0)


@pytest.fixture(scope="module")
def jax_fleet():
    from repro.core.scenario import get_scenario as j_get_scenario
    from repro.core.simulator import run_sweep as j_run_sweep
    from repro.core.topology import get_topology as j_get_topology
    jtopos, jscheds, seeds = _lanes(j_get_topology, j_get_scenario)
    ref, _ = j_run_sweep(jtopos, jscheds, _quad_jax(N, P), np.zeros(P,
                                                                 np.float32),
                         0.01, seeds=seeds, eval_every=K // 2)
    return jscheds, ref


def test_the_ranks_draw_the_reference_lanes(jax_fleet):
    jscheds, _ = jax_fleet
    _, scheds, _ = _lanes(get_topology, get_scenario)
    for a, b in zip(scheds, jscheds):
        for f in ("agent", "stamp_v", "stamp_rho", "times"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("d,m", MESHES)
def test_mesh_sweep_matches_unsharded_jax(spawned, jax_fleet, d, m, impl):
    _, ref = jax_fleet
    held = {s: 0 for s in range(S)}
    for out in spawned:
        for (d_, m_, impl_, s), snap in out["lanes"].items():
            if (d_, m_, impl_) == (d, m, impl):
                _close(snap, ref[s], f"mesh ({d},{m}) {impl} rank "
                       f"{out['rank']} lane {s}")
                held[s] += 1
    # each lane on its group's M ranks, never on another group's
    assert held == {s: m for s in range(S)}


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_param_shards_gather_once_a_wave(spawned, impl):
    for out in spawned:
        calls, waves, own, chunks = out["gathers"][(1, 4, impl)]
        # a wave's one gather and nothing else: eval_fn and the return
        # see the rank's slice
        assert waves > 0 and own == S and chunks == [2] * S
        assert calls == waves
        # S 5 -> 8 lanes: rank g holds lanes 2g, 2g + 1 (5..7 are pads)
        calls, waves, own, _ = out["gathers"][(4, 1, impl)]
        assert calls == 0 and own == [2, 2, 1, 0][out["rank"]]


def test_sweep_epochs_param_mesh_matches_unsharded_jax(spawned):
    from repro.core.scenario import get_scenario as j_get_scenario
    from repro.core.simulator import run_sweep_epochs as j_run_sweep_epochs
    from repro.core.topology import get_topology as j_get_topology
    traces = _traces(j_get_topology, j_get_scenario)
    ref, _ = j_run_sweep_epochs(traces, _quad_jax(EPOCH_N, P, 1),
                                np.zeros(P, np.float32), 0.01,
                                seeds=EPOCH_SEEDS)
    assert any(len(t.epochs) > 1 for t in traces)
    for out in spawned:
        assert out["epoch_widths"] == [2]        # p 7 -> p_pad 8, 2 a rank
        for s, snap in enumerate(out["epochs"]):
            _close(snap, ref[s], f"epochs (1,4) rank {out['rank']} lane {s}")
        assert "parameter axis only" in out["lane_parallel_epochs"]


def test_trivial_mesh_matches_jax_trivial_mesh():
    from repro.core.scenario import get_scenario as j_get_scenario
    from repro.core.simulator import run_sweep as j_run_sweep
    from repro.core.topology import get_topology as j_get_topology
    from repro.launch.mesh import make_sweep_mesh as j_make_sweep_mesh
    n, k, p, seeds = 5, 20, 6, [3, 5, 8]
    jtopo = j_get_topology("binary_tree", n)
    scheds = [j_get_scenario("uniform", n).realize(jtopo, k, seed=s)
              .schedule for s in range(3)]
    ref, _ = j_run_sweep(jtopo, scheds, _quad_jax(n, p), np.zeros(p,
                                                                 np.float32),
                         0.01, seeds=seeds, mesh=j_make_sweep_mesh())
    topo = get_topology("binary_tree", n)
    mesh = make_sweep_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.coords == {
        "data": 0, "model": 0}
    got, _ = run_sweep(topo, scheds, _quad_torch(n, p), torch.zeros(p), 0.01,
                       seeds=seeds, mesh=mesh, device="cpu")
    plain, _ = run_sweep(topo, scheds, _quad_torch(n, p), torch.zeros(p),
                         0.01, seeds=seeds, device="cpu")
    for s in range(3):
        _close(_snap(got[s]), ref[s], f"trivial mesh lane {s}")
        for f in FIELDS:         # the 1 x 1 mesh is the unsharded run
            assert torch.equal(getattr(got[s], f), getattr(plain[s], f))


def test_mesh_validation():
    n, p = 5, 6
    topo = get_topology("binary_tree", n)
    scheds = [get_scenario("uniform", n).realize(topo, 20, seed=0).schedule]
    bad = make_sweep_mesh(lane_axis="rows", param_axis="cols")
    with pytest.raises(ValueError, match="lane axis"):
        run_sweep(topo, scheds, _quad_torch(n, p), torch.zeros(p), 0.01,
                  mesh=bad, device="cpu")
    with pytest.raises(ValueError, match="devices"):
        make_sweep_mesh(lanes=2)
    with pytest.raises(ValueError, match="param_shards"):
        make_sweep_mesh(param_shards=0)


def test_rf206_audits_the_1x2_mesh_body(spawned):
    """In the 4-rank group the engine audit adds the 1 x 2 mesh (ranks 0
    and 1, one gather a wave): clean; the body that gathers the lane
    group's node state (1 lane, 5 nodes, 4 rows, p_pad 8) is RF206."""
    for out in spawned:
        codes, audited, bad = out["audit"]
        assert codes == []
        assert "mesh_wave_loop[1x1,plain]" in audited
        if out["rank"] < 2:
            assert "mesh_wave_loop[1x2,plain]" in audited
            assert bad == [("RF206", N * 4 * 8 * 4, N * 4 * 8 * 4)]
        else:
            assert "mesh_wave_loop[1x2,plain]" not in audited and bad is None
