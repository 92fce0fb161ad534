"""The port's plan linter gives the reference's diagnostics, and the
port's engines and train driver lint their plans with it.

``repro_torch.analysis.planlint`` is a verbatim copy of the reference's
and runs over the port's planner copies.  The oracle is the reference's
``repro.analysis.planlint`` (pure numpy); tolerance throughout is exact
equality:

* the catalog: the port's twelve codes are the reference's, the RF1xx
  entries field for field;
* CLEAN — transform compositions and the flatten round trip stay clean
  over the port's planners (hypothesis), and the registry matrix and
  the ``--plans`` CLI check what the reference's check, count for count;
* MUTATION — each of the reference's RF101–RF106 mutations, applied to
  a plan built by each package, gives equal ``to_json()`` lists;
* WIRING — ``verify_plans=True`` on the four engines leaves the final
  state bitwise equal, a corrupted CommPlan raises the reference's code
  before any gradient is taken, and ``train.py --verify-plans`` trains
  the same losses.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.analysis import CODES as J_CODES
from repro.analysis import PlanInvariantError as JPlanInvariantError
from repro.analysis import planlint as j_lint
from repro.core import plan as j_plan
from repro.core import scenario as j_scenario
from repro.core import schedule as j_schedule
from repro.core import topology as j_topology
from repro_torch.analysis import CODES, PlanInvariantError
from repro_torch.analysis import planlint as t_lint
from repro_torch.core import plan as t_plan
from repro_torch.core import scenario as t_scenario
from repro_torch.core import schedule as t_schedule
from repro_torch.core import topology as t_topology
from repro_torch.core.simulator import (run_epochs, run_rfast, run_sweep,
                                        run_sweep_epochs)
from test_torch_engine import two_torch_threads  # noqa: F401

N = 7
K = 96
PORT = (t_topology, t_plan, t_scenario, t_schedule, t_lint)
REF = (j_topology, j_plan, j_scenario, j_schedule, j_lint)


def codes(diags):
    return sorted({d.code for d in diags})


def as_json(diags):
    return [d.to_json() for d in diags]


def _wf_setup(pkg, topo_name="binary_tree", scenario="uniform", seed=0,
              n=N):
    topo_m, plan_m, scen_m, sched_m, _ = pkg
    topo = topo_m.get_topology(topo_name, n)
    sched = scen_m.get_scenario(scenario, n).realize(topo, K,
                                                     seed=seed).schedule
    comm = plan_m.build_comm_plan(topo)
    H = int(sched.D) + 2
    return topo, sched, comm, H, sched_m.build_wavefront_plan(sched, comm, H)


def _fleet_setup(pkg, seed=0, n=N):
    """tests/test_analysis.py's two heterogeneous lanes through the sweep
    plumbing: pad_comm_plan -> build_wavefront_plan(e_a=) -> stack ->
    flatten."""
    topo_m, plan_m, scen_m, sched_m, _ = pkg
    topos = [topo_m.get_topology(t, n) for t in ("binary_tree", "line")]
    comms = [plan_m.build_comm_plan(t) for t in topos]
    kw = max(c.kw for c in comms)
    ka = max(c.ka for c in comms)
    ko = max(c.ko for c in comms)
    padded = [plan_m.pad_comm_plan(c, kw=kw, ka=ka, ko=ko) for c in comms]
    scheds = [scen_m.get_scenario("uniform", n).realize(
        t, K, seed=seed + s).schedule for s, t in enumerate(topos)]
    e_a = max(max(1, c.n_edges_a) for c in padded)
    H = max(int(s.D) + 2 for s in scheds)
    wfs = [sched_m.build_wavefront_plan(s, c, H, e_a=e_a)
           for s, c in zip(scheds, padded)]
    stacked = sched_m.stack_plans(wfs)
    return H, stacked, sched_m.flatten_plans(stacked)


# ------------------------------------------------------------------ #
# catalog
# ------------------------------------------------------------------ #
def test_catalog_codes_equal_the_reference():
    assert list(CODES) == list(J_CODES)
    assert sorted(CODES) == [f"RF10{i}" for i in range(1, 7)] \
        + [f"RF20{i}" for i in range(1, 7)]
    for code, info in CODES.items():
        ref = J_CODES[code]
        assert (info.code, info.title, info.motivation) == \
            (ref.code, ref.title, ref.motivation)
        if code.startswith("RF1"):
            assert dataclasses.asdict(info) == dataclasses.asdict(ref)
        else:
            assert info.owner == "torchlint" and info.invariant


def test_planlint_is_the_reference_verbatim():
    from pathlib import Path
    root = Path(__file__).resolve().parents[1] / "src"
    port = (root / "repro_torch/analysis/planlint.py").read_text()
    ref = (root / "repro/analysis/planlint.py").read_text()
    assert port.split("\n", 2)[2] == ref


# ------------------------------------------------------------------ #
# clean plans stay clean (property layer, the port's planners)
# ------------------------------------------------------------------ #
@settings(max_examples=8, deadline=None)
@given(
    topo_name=st.sampled_from(["binary_tree", "line", "directed_ring",
                               "undirected_ring", "exponential",
                               "robust_tree"]),
    scenario=st.sampled_from(["uniform", "straggler", "packet_loss"]),
    seed=st.integers(min_value=0, max_value=10_000),
)
def test_transform_compositions_stay_clean(topo_name, scenario, seed):
    """pad/slice/concat over any realized plan of the port: zero
    diagnostics, and the composed plan still matches its schedule."""
    topo, sched, comm, H, wf = _wf_setup(PORT, topo_name, scenario, seed)
    e_a = max(1, comm.n_edges_a)
    assert t_lint.lint_comm_plan(comm, topo) == []
    assert t_lint.lint_wavefront_plan(
        wf, comm=comm, schedule=sched, H=H) == []
    pp = t_schedule.pad_plan(wf, width=wf.width + 2,
                             n_waves=wf.n_waves + 3, e_a=e_a + 4)
    assert t_lint.lint_wavefront_plan(
        pp, comm=comm, schedule=sched, H=H) == []
    mid = max(1, pp.n_waves // 2)
    rejoined = t_schedule.concat_plans([
        t_schedule.slice_plan(pp, 0, mid),
        t_schedule.slice_plan(pp, mid, pp.n_waves)])
    assert t_lint.lint_wavefront_plan(
        rejoined, comm=comm, schedule=sched, H=H) == []


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000))
def test_flatten_roundtrip_bit_for_bit(seed):
    """unflatten_plans(flatten_plans(stacked)) == stacked exactly for the
    port's fleet, every table but the aggregate event_start/sizes."""
    H, stacked, flat = _fleet_setup(PORT, seed)
    back = t_lint.unflatten_plans(flat, stacked.agent.shape[0])
    for f in t_schedule._WAVE_FIELDS:
        if f in ("event_start", "sizes"):
            continue
        np.testing.assert_array_equal(np.asarray(getattr(stacked, f)),
                                      np.asarray(getattr(back, f)),
                                      err_msg=f)
    assert t_lint.lint_flatten(stacked, flat) == []
    assert t_lint.lint_wavefront_plan(flat, H=H) == []


# ------------------------------------------------------------------ #
# mutation parity: the reference's mutation on each package's plan
# ------------------------------------------------------------------ #
def _rf101(pkg):
    topo, sched, comm, H, wf = _wf_setup(pkg)
    ag = np.asarray(wf.agent)
    w = next(w for w in range(wf.n_waves) if (ag[w] != N).sum() >= 2)
    l0, l1 = np.nonzero(ag[w] != N)[0][:2]
    arrs = {}
    for f in pkg[3]._WAVE_FIELDS:
        a = np.array(getattr(wf, f))
        if a.ndim >= 2:
            a[w, l1] = a[w, l0]
            arrs[f] = a
    return pkg[4].lint_wavefront_plan(dataclasses.replace(wf, **arrs),
                                      comm=comm, schedule=sched, H=H)


def _rf102(pkg):
    topo, sched, comm, H, wf = _wf_setup(pkg)
    rs = np.array(wf.rslot_v)
    w, ln, c = [x[0] for x in np.nonzero(np.asarray(wf.w_in) != 0)]
    rs[w, ln, c] = (rs[w, ln, c] + 1) % H
    return pkg[4].lint_wavefront_plan(dataclasses.replace(wf, rslot_v=rs),
                                      comm=comm, schedule=sched, H=H)


def _rf103(pkg):
    topo, sched, comm, H, wf = _wf_setup(pkg)
    ag = np.array(wf.agent)
    w = next(w for w in range(wf.n_waves) if (ag[w] != N).any())
    ag[w, np.nonzero(ag[w] != N)[0][0]] = N + 3
    return pkg[4].lint_wavefront_plan(dataclasses.replace(wf, agent=ag),
                                      comm=comm, schedule=sched, H=H)


def _rf104(pkg):
    _, stacked, flat = _fleet_setup(pkg)
    agf = np.array(flat.agent)
    wv, sl = [x[0] for x in np.nonzero((agf != flat.n) & (agf % N < N - 1))]
    agf[wv, sl] += 1
    return pkg[4].lint_flatten(stacked, dataclasses.replace(flat, agent=agf))


def _rf105(pkg):
    topo, _, comm, _, _ = _wf_setup(pkg)
    we = np.array(comm.w_edge)
    we[0] += 0.25
    return pkg[4].lint_comm_plan(dataclasses.replace(comm, w_edge=we), topo)


def _rf106(pkg):
    et = pkg[2].get_scenario("churn", N).realize_epochs(
        pkg[0].get_topology("robust_tree", N), 1400, seed=0)
    assert pkg[4].lint_epoch_trace(et) == []
    eps = list(et.epochs)
    eps[1] = dataclasses.replace(eps[1], joined=np.zeros(N, bool))
    return pkg[4].lint_epoch_trace(dataclasses.replace(et, epochs=tuple(eps)))


@pytest.mark.parametrize("code,mutate", [
    ("RF101", _rf101), ("RF102", _rf102), ("RF103", _rf103),
    ("RF104", _rf104), ("RF105", _rf105), ("RF106", _rf106)])
def test_mutation_gives_the_reference_diagnostics(code, mutate):
    port, ref = mutate(PORT), mutate(REF)
    assert codes(port) == [code], port
    assert as_json(port) == as_json(ref)


# ------------------------------------------------------------------ #
# the registry matrix and the CLI
# ------------------------------------------------------------------ #
def test_run_plan_matrix_quick_subset_equals_the_reference():
    from repro.analysis.runner import run_plan_matrix as j_matrix
    from repro_torch.analysis.runner import run_plan_matrix as t_matrix
    kw = dict(n=5, K=64, K_epochs=600, seeds=(0,),
              scenarios=("uniform", "churn"),
              topologies=("binary_tree", "robust_tree"))
    (td, ts), (jd, js) = t_matrix(**kw), j_matrix(**kw)
    assert td == [] and jd == [], as_json(td) + as_json(jd)
    assert ts == js
    assert ts["wavefront_plans"] > 0 and ts["fleets"] > 0
    assert ts["epoch_traces"] > 0


def test_plans_cli_checks_what_the_reference_checks(tmp_path):
    from repro.analysis.__main__ import main as j_main
    from repro_torch.analysis.__main__ import main as t_main
    t_json, j_json = tmp_path / "port.json", tmp_path / "ref.json"
    assert t_main(["--plans", "--quick", "--json", str(t_json)]) == 0
    assert j_main(["--plans", "--quick", "--json", str(j_json)]) == 0
    port, ref = json.loads(t_json.read_text()), json.loads(j_json.read_text())
    assert port["summary"]["checked"] == ref["summary"]["checked"]
    assert port["summary"]["diagnostics"] == 0
    assert port["config"]["passes"] == ["planlint"]


# ------------------------------------------------------------------ #
# wiring: verify_plans on the engines and the train driver
# ------------------------------------------------------------------ #
def _quad(n, p=4, seed=0):
    C = torch.as_tensor(np.random.default_rng(seed).normal(size=(n, p)),
                        dtype=torch.float32)
    return (lambda i, x, gen: x - C[i]), torch.zeros(n, p)


def _fields(st):
    return [t.clone() for t in st[1:]]


def _bitwise(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("mode", ["wavefront", "event"])
def test_run_rfast_verify_plans_is_the_same_run(mode):
    n = 5
    gfn, x0 = _quad(n)
    topo = t_topology.get_topology("binary_tree", n)
    sched = t_scenario.get_scenario("uniform", n).realize(topo, 80,
                                                          seed=0).schedule
    runs = [_fields(run_rfast(topo, sched, gfn, x0, 1e-2, seed=0,
                              eval_every=20, mode=mode, device="cpu",
                              verify_plans=v)[0]) for v in (True, False)]
    _bitwise(*runs)


def test_run_sweep_verify_plans_is_the_same_run():
    n = 5
    gfn, x0 = _quad(n)
    topos = [t_topology.get_topology(t, n) for t in ("binary_tree", "line")]
    scheds = [t_scenario.get_scenario("uniform", n).realize(
        t, 80, seed=s).schedule for s, t in enumerate(topos)]
    runs = [[f for st in run_sweep(topos, scheds, gfn, x0, 1e-2,
                                   seeds=[0, 1], eval_every=20,
                                   device="cpu", verify_plans=v)[0]
             for f in _fields(st)] for v in (True, False)]
    _bitwise(*runs)


def test_epoch_engines_verify_plans_is_the_same_run():
    gfn, x0 = _quad(N)
    traces = [t_scenario.get_scenario("churn", N).realize_epochs(
        t_topology.get_topology("robust_tree", N), 400, seed=s)
        for s in (0, 1)]
    assert len(traces[0].epochs) > 1
    runs = [_fields(run_epochs(traces[0], gfn, x0, 1e-2, seed=0,
                               eval_every=50, device="cpu",
                               verify_plans=v)[0]) for v in (True, False)]
    _bitwise(*runs)
    runs = [[f for st in run_sweep_epochs(traces, gfn, x0, 1e-2,
                                          seeds=[0, 1], eval_every=50,
                                          device="cpu", verify_plans=v)[0]
             for f in _fields(st)] for v in (True, False)]
    _bitwise(*runs)


def _corrupt(pkg, n):
    topo = pkg[0].get_topology("binary_tree", n)
    comm = pkg[1].build_comm_plan(topo)
    we = np.array(comm.w_edge)
    we[0] += 0.25
    sched = pkg[2].get_scenario("uniform", n).realize(topo, 40,
                                                      seed=0).schedule
    return dataclasses.replace(comm, w_edge=we), sched


@pytest.mark.parametrize("mode", ["wavefront", "event"])
def test_corrupt_comm_plan_raises_the_reference_code_before_any_wave(mode):
    import jax.numpy as jnp
    from repro.core import run_rfast as j_run_rfast
    n = 5
    calls = []
    gfn, x0 = _quad(n)
    counted = lambda i, x, gen: calls.append(i) or gfn(i, x, gen)
    bad, sched = _corrupt(PORT, n)
    with pytest.raises(PlanInvariantError) as ei:
        run_rfast(bad, sched, counted, x0, 1e-2, mode=mode, device="cpu",
                  verify_plans=True)
    assert calls == []           # raised before the init gradient
    assert "run_rfast(verify_plans)" in str(ei.value)
    j_bad, j_sched = _corrupt(REF, n)
    with pytest.raises(JPlanInvariantError) as ej:
        j_run_rfast(j_bad, j_sched, lambda i, x, key: x, jnp.zeros((n, 4)),
                    1e-2, mode=mode, verify_plans=True)
    assert codes(ei.value.diagnostics) == codes(ej.value.diagnostics) \
        == ["RF105"]


TRAIN = ["--reduced", "--seq", "16", "--batch-per-node", "2", "--nodes",
         "4", "--steps", "4", "--log-every", "2", "--device", "cpu"]


@pytest.mark.parametrize("scenario", ["uniform", "churn"])
def test_train_verify_plans_trains_the_same_losses(scenario):
    from repro_torch.launch import train
    args = TRAIN + ["--scenario", scenario]
    verified = train.main(args + ["--verify-plans"])
    plain = train.main(args)
    assert verified["losses"] == plain["losses"]
    assert verified["waves"] == plain["waves"] > 0
