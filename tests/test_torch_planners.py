"""The port's numpy planner copies give the JAX package's tables exactly.

``repro_torch.core.{topology,plan,schedule,scenario}`` are copies (the
port imports nothing of the JAX package); the same arguments must give
``assert_array_equal`` tables on both sides.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import plan as j_plan
from repro.core import scenario as j_scenario
from repro.core import schedule as j_schedule
from repro.core import topology as j_topology
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.core import plan as t_plan
from repro_torch.core import scenario as t_scenario
from repro_torch.core import schedule as t_schedule
from repro_torch.core import topology as t_topology
from repro_torch.configs import get_config
from repro_torch.data.pipeline import LMShardConfig, node_batch

TOPOS = ["binary_tree", "directed_ring", "exponential"]
SCENS = ["uniform", "straggler", "packet_loss", "crash_recovery"]


def _eq_fields(a, b, where):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f"{where}.{f.name}")
            assert x.dtype == y.dtype, f"{where}.{f.name}"
        elif dataclasses.is_dataclass(x):
            _eq_fields(x, y, f"{where}.{f.name}")
        else:
            assert x == y, f"{where}.{f.name}"


def _both(topo_name, scen_name, n, K):
    out = []
    for topo_m, plan_m, scen_m, sched_m in (
            (j_topology, j_plan, j_scenario, j_schedule),
            (t_topology, t_plan, t_scenario, t_schedule)):
        topo = topo_m.get_topology(topo_name, n)
        plan = plan_m.build_comm_plan(topo)
        trace = scen_m.get_scenario(scen_name, n).realize(topo, K, seed=3)
        H = int(trace.schedule.D) + 2
        wf = sched_m.build_wavefront_plan(trace.schedule, plan, H,
                                          break_every=2 * n)
        tables = sched_m.grid_gather_tables(
            wf.agent, wf.rslot_rho, wf.hist_epos, wf.rho_gidx,
            e_a_flat=wf.e_a, ko=plan.ko)
        out.append((topo, plan, trace, wf, tables))
    return out


@pytest.mark.parametrize("n", [4, 7])
@pytest.mark.parametrize("scen", SCENS)
@pytest.mark.parametrize("topo", TOPOS)
def test_planner_tables_identical(topo, scen, n):
    (jt, jp, jtr, jwf, jtab), (tt, tp, ttr, twf, ttab) = _both(
        topo, scen, n, K=6 * n)
    np.testing.assert_array_equal(jt.W, tt.W)
    np.testing.assert_array_equal(jt.A, tt.A)
    assert jt.edges_W() == tt.edges_W() and jt.edges_A() == tt.edges_A()
    _eq_fields(jp, tp, "CommPlan")
    _eq_fields(jtr, ttr, "ScenarioTrace")      # Schedule + send outcomes
    _eq_fields(jwf, twf, "WavefrontPlan")
    for a, b in zip(jtab, ttab):
        np.testing.assert_array_equal(a, b)


def test_config_and_pipeline_copies_identical():
    from repro.configs import get_config as j_get_config
    from repro.data.pipeline import LMShardConfig as JShard
    from repro.data.pipeline import node_batch as j_node_batch
    for red in (False, True):
        j, t = j_get_config("rfast-100m"), get_config("rfast-100m")
        if red:
            j, t = j.reduced(), t.reduced()
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.param_count() == t.param_count()
    assert isinstance(j, JModelConfig)
    kw = dict(vocab=512, batch_per_node=2, seq_len=8, n_nodes=3, seed=5)
    for node, step in ((0, 0), (2, 7)):
        for a, b in zip(j_node_batch(JShard(**kw), node, step),
                        node_batch(LMShardConfig(**kw), node, step)):
            np.testing.assert_array_equal(a, b)
