"""The port's train entry point: dynamic scenarios, checkpoints, publishing.

Reduced rfast-100m on the CPU.  ``churn`` (binary tree, 3 epochs) and
``root_failover`` (robust tree, 2 epochs: the sole root departs) train
through ``run_epochs`` with finite, falling losses and the Lemma-3
residual of the final state within 1e-4.  As in tests/test_train_e2e.py,
an async run's final checkpoint leaves nothing to redo; a synchronous
run resumed from its step-2 checkpoint is bitwise the uninterrupted one
(without ``--loss-prob``: the reference re-seeds the loss-mask
generator on resume).  ``--publish-dir`` publishes the consensus
average at every chunk boundary, and ``--ckpt`` with a dynamic scenario
is rejected with the reference's message.
"""
import math
import os

import numpy as np
import pytest

from repro_torch.checkpoint import latest_step
from repro_torch.launch import train
from test_torch_engine import two_torch_threads  # noqa: F401

COMMON = ["--reduced", "--seq", "16", "--batch-per-node", "2",
          "--device", "cpu"]


@pytest.mark.parametrize("scenario,topology,epochs", [
    ("churn", "binary_tree", 3), ("root_failover", "robust_tree", 2)])
def test_dynamic_scenario_trains_through_epochs(scenario, topology, epochs,
                                                tmp_path):
    pub = str(tmp_path / "pub")
    res = train.main(COMMON + ["--nodes", "4", "--steps", "12",
                               "--log-every", "4", "--scenario", scenario,
                               "--topology", topology, "--publish-dir", pub,
                               "--gamma", "0.01"])
    assert res["mode"] == "async-dynamic" and res["scenario"] == scenario
    assert res["epochs"] == len(res["epoch_table"]) == epochs
    assert res["events"] == 48
    assert sum(e["events"] for e in res["epoch_table"]) == 48
    assert all(math.isfinite(v) for v in res["losses"])
    assert res["losses"][-1] < res["losses"][0]
    assert res["mass_rel"] < 1e-4
    # published at every chunk boundary, the epoch boundaries included
    assert len(res["published"]) >= 2
    assert {e["k0"] for e in res["epoch_table"][1:]} <= set(res["published"])
    assert latest_step(pub) == res["published"][-1] == 48
    if scenario == "root_failover":
        assert res["epoch_table"][1]["root"] != 0


def test_async_resume_leaves_nothing_to_redo(tmp_path):
    ck = str(tmp_path / "ck")
    args = COMMON + ["--nodes", "2", "--steps", "10", "--gamma", "0.02",
                     "--log-every", "2", "--scenario", "straggler",
                     "--ckpt", ck]
    out = train.main(args)
    assert out["mode"] == "async" and out["events"] == 20
    assert out["losses"][-1] < out["losses"][0], out["losses"]
    assert latest_step(ck) == 20
    # the final checkpoint resumes at the right event: nothing to redo
    out2 = train.main(args)
    assert out2["losses"] == out2["losses"][:1]
    # --loss-prob belongs to the sync regime
    with pytest.raises(SystemExit):
        train.main(args + ["--loss-prob", "0.1"])


def test_sync_resume_is_the_uninterrupted_run(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    base = COMMON + ["--nodes", "2", "--log-every", "1", "--ckpt-every",
                     "2"]
    full = train.main(base + ["--steps", "4", "--ckpt", a])
    assert sorted(os.listdir(a)) == ["LATEST.json", "step_0000000002.npz",
                                     "step_0000000004.npz"]
    half = train.main(base + ["--steps", "2", "--ckpt", b])
    assert half["losses"] == full["losses"][:2]
    rest = train.main(base + ["--steps", "4", "--ckpt", b])
    assert rest["start"] == 2 and rest["losses"] == full["losses"][2:]
    with np.load(os.path.join(a, "step_0000000004.npz")) as x, \
            np.load(os.path.join(b, "step_0000000004.npz")) as y:
        assert x.files == y.files and ".step" in x.files
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_ckpt_with_a_dynamic_scenario_is_rejected(capsys):
    with pytest.raises(SystemExit):
        train.main(COMMON + ["--scenario", "churn", "--ckpt", "ck"])
    assert ("--ckpt resume is not supported for dynamic (membership) "
            "scenarios") in capsys.readouterr().err


def test_list_scenarios(capsys):
    res = train.main(["--list-scenarios"])
    assert res["mode"] == "list" and len(res["scenarios"]) == 9
    out = capsys.readouterr().out
    assert "churn  [dynamic" in out and "uniform\n" in out
