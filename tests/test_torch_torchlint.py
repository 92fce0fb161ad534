"""repro_torch.analysis.torchlint: the program audit is clean over the
port's engines, and each RF2xx code fires alone on its minimal mutation.

The reference's jaxpr audits fail under this container's jax (ROADMAP
Queue 3), so nothing here uses them as an oracle: the mutations are the
reference's (tests/test_analysis.py), carried to aten ops —

* RF201: a gradient that calls ``.item()`` inside the wave loop;
* RF202: a float64 constant in the gradient;
* RF203: a materialized (B, k, p) stack above a lowered threshold;
* RF204: an engine that returns a copy of its state;
* RF205: ``buckets=None`` on the serving cache, a churning cache key,
  and a kernel launched once too often;
* RF206: a mesh body that gathers its lane group's whole node state
  (the 1 x 2 mesh's audit runs in tests/test_torch_mesh_sweep.py's
  spawn).

On the CPU the kernel route is skipped (a wrapper follows its tensors)
and listed; ``tests/test_torch_gpu.py`` audits it on the card.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.analysis import torchlint as tl
from repro_torch.core.plan import build_comm_plan
from repro_torch.core.scenario import get_scenario
from repro_torch.core.simulator import PackedState
from repro_torch.core.topology import get_topology
from test_torch_engine import two_torch_threads  # noqa: F401

N, P, K = 5, 8, 48


def codes(diags):
    return sorted({d.code for d in diags})


def _loop(grad_fn):
    topo = get_topology("binary_tree", N)
    sched = get_scenario("uniform", N).realize(topo, K, seed=0).schedule
    return tl.wave_loop("m", [build_comm_plan(topo)], [sched], grad_fn, P,
                        impl="plain", device="cpu")


C = torch.as_tensor(np.random.default_rng(0).normal(size=(N, P)),
                    dtype=torch.float32)


def _audit_loop(grad_fn, **kw):
    loop = _loop(grad_fn)
    _, records = tl.trace_ops(loop.run, loop.state, in_loop=True)
    return tl.audit_ops(records, subject="m", **kw)


def test_audit_engines_clean_on_the_cpu():
    diags, audited, skipped = tl.audit_engines(n=5, p=8, K=48,
                                               device="cpu")
    assert codes(diags) == [], [d.to_json() for d in diags]
    assert audited == ["rfast_scan", "rfast_scan[inplace]",
                       "wave_loop[plain]", "fleet_wave_loop[plain]",
                       "run_epochs[wave body]", "wave_loop[inplace]",
                       "fleet_wave_loop[inplace]", "commit_grid[cpu]",
                       "mesh_wave_loop[1x1,plain]"]
    assert [s["subject"] for s in skipped] == [
        "wave_loop[kernel]", "fleet_wave_loop[kernel]",
        "commit_grid[dispatch]", "mesh_wave_loop[1x1,kernel]"]


def test_clean_wave_loop_records_the_engine_gathers():
    loop = _loop(lambda i, x, gen: x - C[i])
    _, records = tl.trace_ops(loop.run, loop.state, in_loop=True)
    assert tl.audit_ops(records, subject="m",
                        broadcast_elems_threshold=1) == []
    gathers = [r for r in records if r.name == "aten.index"
               and len(r.outputs[0][0]) == 3]
    assert gathers and all(r.allocated for r in gathers)
    # every (s, k, p) gather reads a larger source (v_hist, rho_hist, rho2)
    assert all(np.prod(r.outputs[0][0]) <= r.in_elems for r in gathers)
    assert loop.waves > 0


def test_rf201_host_read_in_the_wave_loop():
    diags = _audit_loop(lambda i, x, gen: x - C[i] * (1 + 0 * x.sum().item()))
    assert codes(diags) == ["RF201"]
    assert diags[0].data == {"op": "aten._local_scalar_dense",
                             "count": diags[0].data["count"]}
    assert diags[0].data["count"] > 0
    # the same read outside the wave loop is no RF201
    _, records = tl.trace_ops(lambda: torch.ones(3).sum().item())
    assert tl.audit_ops(records, subject="m") == []


def test_rf202_float64_constant():
    C64 = C.to(torch.float64)
    diags = _audit_loop(lambda i, x, gen: x - C64[i])
    assert codes(diags) == ["RF202"]
    assert diags[0].data["dtype"] == "float64"


def test_rf203_materialized_stack():
    x = torch.ones(32)
    stack = lambda: torch.stack([x.expand(4, 32)] * 8)   # (B, k, p)
    _, records = tl.trace_ops(stack)
    assert codes(tl.audit_ops(records, subject="m",
                              broadcast_elems_threshold=64)) == ["RF203"]
    # same program, default threshold: too small to flag
    assert tl.audit_ops(records, subject="m") == []
    # a contiguous() of an expanded view materializes too; the view alone
    # does not
    _, records = tl.trace_ops(
        lambda: x[None, None].expand(8, 4, 32).contiguous())
    assert codes(tl.audit_ops(records, subject="m",
                              broadcast_elems_threshold=64)) == ["RF203"]
    _, records = tl.trace_ops(lambda: x[None, None].expand(8, 4, 32))
    assert tl.audit_ops(records, subject="m",
                        broadcast_elems_threshold=64) == []


def test_rf204_engine_returns_a_copy():
    loop = _loop(lambda i, x, gen: x - C[i])
    assert tl.audit_inplace(loop.run, loop.state, subject="m") == []
    copying = lambda st: PackedState(*(t.clone() for t in loop.run(st)))
    diags = tl.audit_inplace(copying, loop.state, subject="m")
    assert codes(diags) == ["RF204"]
    assert {d.data["field"] for d in diags} == set(PackedState._fields)


def test_rf205_serve_cache_clean_and_unbucketized_mutation():
    diags, audited = tl.audit_serve_cache(device="cpu")
    assert diags == [] and audited == ["serve_engine[cache]"]
    diags, _ = tl.audit_serve_cache(buckets=None, device="cpu")
    assert codes(diags) == ["RF205"]
    assert "cache key varies" in diags[0].message


def test_rf205_cache_churn_and_kernel_launches():
    from repro_torch.kernels.rfast_update import dispatch
    from repro_torch.serve import cache
    state = {"i": 0}

    def churn():
        state["i"] += 1
        cache.lookup(("k", state["i"]), lambda: (lambda: None))()

    assert codes(tl.audit_dispatch(churn, subject="m", cache=cache)) \
        == ["RF205"]
    steady = lambda: cache.lookup(("k",), lambda: (lambda: None))()
    assert tl.audit_dispatch(steady, subject="m", cache=cache) == []

    launch3 = lambda: [dispatch.record_launch("commit_grid")
                       for _ in range(3)]
    assert tl.audit_launches(launch3, subject="m", expect_launches=3) == []
    diags = tl.audit_launches(launch3, subject="m", expect_launches=2)
    assert codes(diags) == ["RF205"] and len(diags) == 2


def test_rf206_state_sized_collective_in_the_mesh_body():
    """The reference's RF206 mutation on the port's 1 x 1 mesh: a body
    that gathers the group's whole packed node state is reported; the
    designed flow (one node slot, the iterates) stays below the line."""
    from repro_torch.core.runtime_sharded import all_gather_flat
    from repro_torch.launch.mesh import make_sweep_mesh
    mesh = make_sweep_mesh()
    topo, topo_b = get_topology("binary_tree", N), get_topology("line", N)
    scheds = [get_scenario(sc, N).realize(t, K, seed=0).schedule
              for sc, t in (("uniform", topo), ("straggler", topo_b))]
    loop = tl.wave_loop("m", [build_comm_plan(t) for t in (topo, topo_b)],
                        scheds, lambda i, x, gen: x - C[i], P, mesh=mesh,
                        impl="plain", device="cpu")
    assert loop.state_bytes == 2 * N * 4 * P * 4 and loop.waves > 0
    audit = lambda run: tl.audit_collectives(
        run, loop.state, subject="m", state_bytes_threshold=loop.state_bytes)
    assert audit(loop.run) == []
    group = mesh.group("model")
    # MUTATION: the "accidentally replicated" body
    diags = audit(lambda st: (all_gather_flat(st.nodes, group),
                              loop.run(st))[1])
    assert codes(diags) == ["RF206"]
    assert diags[0].data["name"] == "all_gather_flat"
    assert diags[0].data["bytes"] == loop.state_bytes
    assert audit(lambda st: (all_gather_flat(st.nodes[:, 0], group),
                             loop.run(st))[1]) == []


def test_cli_programs_on_the_cpu(tmp_path):
    from repro_torch.analysis.__main__ import main
    out = tmp_path / "report.json"
    assert main(["--programs", "--device", "cpu", "--json", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["config"]["passes"] == ["torchlint"]
    assert rep["summary"]["diagnostics"] == 0
    assert "serve_engine[cache]" in rep["summary"]["audited_programs"]
    assert len(rep["summary"]["skipped_programs"]) == 4


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no GPU")
def test_cli_defaults_to_the_card_and_raises_without_one():
    from repro_torch.analysis.__main__ import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--programs"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.audit_engines()


def test_codes_catalog_cli(capsys):
    from repro_torch.analysis.__main__ import main
    assert main(["--codes"]) == 0
    cat = json.loads(capsys.readouterr().out)
    assert [c["code"] for c in cat] == [f"RF10{i}" for i in range(1, 7)] \
        + [f"RF20{i}" for i in range(1, 7)]
    assert {c["owner"] for c in cat} == {"planlint", "torchlint"}
