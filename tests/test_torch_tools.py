"""The port's counterparts of the reference's examples (``tools/``), each
run on the CPU at a reduced K: ``straggler_robustness`` (R-FAST, Ring-
AllReduce and OSGP on one straggler scenario's clock), ``topology_zoo``
(five topologies, then a root failover through the epochized engine) and
``train_rfast`` (the train entry point's smoke run, and its command lines).
"""
import importlib.util
import math
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_straggler_robustness_at_reduced_k(capsys):
    out = _tool("straggler_robustness").main(["--device", "cpu",
                                              "--events", "960"])
    t = out["vtime_to_target"]
    for name in ("rfast", "ring_allreduce", "osgp"):
        assert all(math.isfinite(m["loss"]) for m in out[name])
        assert out[name][-1]["loss"] < out[name][0]["loss"]
    # every algorithm reaches the target on the same clock, and the
    # barrier pays the 4x straggler every round
    assert math.isfinite(t["rfast"]) and t["ring_allreduce"] > t["rfast"]
    assert "Ring-AllReduce" in capsys.readouterr().out


def test_topology_zoo_at_reduced_k():
    out = _tool("topology_zoo").main(["--device", "cpu", "--events", "700"])
    zoo = out["topologies"]
    assert list(zoo) == ["binary_tree", "line", "directed_ring",
                         "exponential", "mesh2d"]
    assert zoo["binary_tree"]["roots"] == [0]
    assert all(r["loss"] < 0.6 and r["acc"] > 0.5 for r in zoo.values())
    # the sole root departs: a second epoch re-elects a survivor
    assert len(out["epochs"]) >= 2
    assert out["epochs"][0]["root"] == 0 and out["epochs"][-1]["root"] != 0
    assert out["epochs"][-1]["active"] == 6
    assert out["survivors"]["loss"] < 0.6


def test_train_rfast_smoke_and_its_command_lines(tmp_path):
    mod = _tool("train_rfast")
    assert mod.main(["--device", "cpu", "--steps", "2", "--ckpt",
                     str(tmp_path / "ck")]) == 0
    full = mod.command(["--full", "--scenario", "straggler"])
    assert full[full.index("--scenario") + 1] == "straggler"
    assert "--loss-prob" not in full and "--device" not in full
    assert full[full.index("--steps") + 1] == "300"
    assert full[full.index("--ckpt") + 1].endswith(
        str(Path("build") / "rfast_ckpt_straggler_full"))
    smoke = mod.command([])
    assert "--reduced" in smoke and smoke[smoke.index("--loss-prob") + 1] \
        == "0.1"


@pytest.fixture(autouse=True)
def _two_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)
