"""Whole runs of every cell on the CPU at a tiny cut: the program's plain
paths against the plain reference.  Sound runs are correct; the control
(the reference in TF32 in the program's place) and every planted fault are
not.  The card-only case runs the same tiny cut through the kernels."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from bench import cell, judge  # noqa: E402
from reference import model  # noqa: E402

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
TINY = {"olmo": {"d_model": 64, "n_heads": 4, "n_kv_heads": 4,
                 "head_dim": 16, "d_ff": 96, "vocab": 97},
        "hymba": {"d_model": 64, "n_heads": 4, "n_kv_heads": 2,
                  "head_dim": 16, "d_ff": 96, "vocab": 97,
                  "attn_window": 8}}
# tight enough for the tiny cut: its fp32 readings lie near 1e-6
TINY_LIMITS = {"loss_gap": {"limit": 1e-6}, "grad_gap": {"limit": 1e-5},
               "change_gap": {"limit": 1e-5}}


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread, as the command runs: the tiny cuts gain nothing
    from more, and a test run's parallel workers would oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shrink(name: str) -> dict:
    traffic = {"batch": 2, "seq": 16}
    if "async" in name:
        traffic["events"] = 300
    return {"model": TINY["hymba" if "hymba" in name else "olmo"],
            "traffic": traffic}


def run(name, monkeypatch, device="cpu", **kw):
    load = cell.load_cell
    monkeypatch.setattr(cell, "load_cell", lambda n, r: dict(
        load(n, r), limits=TINY_LIMITS))
    return cell.run_cell(name, 2**33 + 7, 0.3, kw.pop("trace", False),
                         root=ROOT, device=device, shrink=shrink(name), **kw)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_well_formed(name, monkeypatch):
    r = run(name, monkeypatch)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert r["attempted"] > 0 and r["failed"] == 0
    m = r["metrics"]
    assert m["setup_s"]["value"] > 0 and "peak_mem_gib" in m
    assert "train_tokens_per_s" in m and "mfu" in m
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(r, allow_nan=False)


@pytest.mark.parametrize("name", CELLS)
def test_control_in_tf32_is_not_correct(name, monkeypatch):
    r = run(name, monkeypatch, control="tf32")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(name, fault, monkeypatch):
    r = run(name, monkeypatch, fault=fault)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name, metric", [
    ("olmo1b-l2.sync.b4s2048", "outside_grad_pct"),
    ("hymba15b-l2.async.n3.b4s512", "device_idle_pct")])
def test_traced_run_reads_the_per_layer_metrics(name, metric, monkeypatch):
    r = run(name, monkeypatch, trace=True)
    assert r["correct"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert r["device"]["window_s"] > 0
    assert metric in r["metrics"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("arch", ["olmo-1b-l2", "hymba-1.5b-l2"])
def test_reference_loss_and_gradient_match_the_port(arch):
    sys.path.insert(0, str(ROOT / "src"))
    from bench import program
    from repro_torch.core.paramvec import make_ravel_spec, unravel
    from repro_torch.models import transformer
    cfg = json.loads((BENCH / "configs" / f"{arch}.json").read_text())
    cfg = dict(cfg["model"], **TINY["hymba" if "hymba" in arch else "olmo"])
    mcfg = program.port_config(cfg)
    spec = program.port_layout(cfg, [(p, s) for p, s, _, _ in
                                     model.leaves(cfg)])
    assert spec == make_ravel_spec(transformer.param_shapes(mcfg))
    gen = torch.Generator().manual_seed(3)
    x = model.init_flat(cfg, gen, spec.p)
    toks = torch.randint(0, cfg["vocab"], (2, 20), generator=gen)
    labels = torch.randint(0, cfg["vocab"], (2, 20), generator=gen)
    grads = []
    for f in (lambda v: model.loss(cfg, model.unflatten(cfg, v), toks,
                                   labels),
              lambda v: transformer.loss_fn(mcfg, unravel(spec, v), toks,
                                            labels)):
        v = x.clone().requires_grad_(True)
        loss = f(v)
        grads.append((loss.detach(), torch.autograd.grad(loss, v)[0]))
    (l0, g0), (l1, g1) = grads
    assert torch.allclose(l0, l1, rtol=1e-6)
    # fp32 sums in another order: within 1e-5 of the gradient's largest
    assert (g0 - g1).abs().max() <= 1e-5 * g0.abs().max()


def test_judge_reads_infinity_for_missing_numbers():
    a, b = cell.program.Observed(), cell.program.Observed()
    b.losses = [1.0]
    gaps = judge.gaps(a, b)
    assert all(math.isinf(v) for v in gaps.values())


def test_loaded_modules_hold_no_jax():
    code = (
        "import sys, json; from pathlib import Path\n"
        f"sys.path[:0] = [{str(BENCH)!r}, {str(ROOT / 'src')!r}]\n"
        "import torch; torch.set_num_threads(1)\n"
        "from bench import cell\n"
        f"cell.run_cell({CELLS[1]!r}, 5, 0.2, False, root=Path({str(ROOT)!r}),"
        f" device='cpu', shrink={shrink(CELLS[1])!r})\n"
        "print(json.dumps(sorted(cell.top_level_modules())))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=ROOT,
                         env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-2000:]
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_command_refuses_a_machine_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cmd = [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=240,
                         cwd=ROOT)
    assert out.returncode != 0 and not out.stdout.strip()


def test_command_refuses_a_checkout_without_the_program(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cmd = [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=240,
                         cwd=tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_tiny_cut_through_the_kernels(name, cuda, monkeypatch):
    r = run(name, monkeypatch, device="cuda")
    assert r["correct"], r["checks"]
    r = run(name, monkeypatch, device="cuda", control="tf32")
    assert not r["correct"], r["checks"]
