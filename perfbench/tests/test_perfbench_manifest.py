"""``BENCHMARK.json`` keeps the benchmark's contract, and every cell finds
its files by name."""
import json
import math
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E_SOURCES = {"host_clock", "device_trace"}
SOURCES = E2E_SOURCES | {"program_span", "program_counter"}


@pytest.fixture(scope="module")
def manifest():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys_and_command(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_and_units(manifest):
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in manifest[group]:
            assert NAME.match(entry["name"]), entry["name"]
            for key in ("why", "layer", "source"):
                if key in entry:
                    v = entry[key]
                    assert 1 <= len(v) <= 200 and "\n" not in v \
                        and "\t" not in v
    for group in ("configs", "workloads"):
        ns = [e["name"] for e in manifest[group]]
        assert len(ns) == len(set(ns))
    metric_names = [e["name"] for g in ("end_to_end", "per_layer")
                    for e in manifest[g]]
    assert len(metric_names) == len(set(metric_names))
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_every_cell_finds_its_files(manifest):
    configs = {c["name"]: c for c in manifest["configs"]}
    used = set()
    pairs = set()
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert w["config"] in configs
        used.add(w["config"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        limits = json.loads((BENCH / "limits" / f"{w['name']}.json")
                            .read_text())
        for k in ("loss_gap", "grad_gap", "change_gap"):
            assert math.isfinite(limits[k]["limit"])
    assert used == set(configs)
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        model = json.loads((ROOT / c["file"]).read_text())
        assert model["model"]["name"] == c["name"]
        assert set(c["reduced"]) == set(model["reduced"])
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)
            assert not re.search(r"(_dim|_rank|d_model|d_ff|heads|state|"
                                 r"expand|vocab)", k)


def test_four_chip_cells_are_at_most_a_quarter(manifest):
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(manifest["workloads"]) // 4)


def test_bounds(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in E2E_SOURCES
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_metrics_have_readers_and_arrows(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    cells = [w["name"] for w in manifest["workloads"]]

    def reports(metric, cell):
        return "workloads" not in metric or cell in metric["workloads"]

    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in cells
            assert reports(e2e[m["moves"]], cell)
        if re.search(r"_roofline$", m["name"]) or "mfu" in m["name"]:
            assert m["unit"] == "%"

    def has(metric, cell):
        if "workloads" in metric:
            return cell in metric["workloads"]
        return reports(e2e[metric["moves"]], cell)

    for cell in cells:
        assert sum(reports(m, cell) for m in manifest["end_to_end"]) >= 2
        assert any(has(m, cell) for m in manifest["per_layer"])
