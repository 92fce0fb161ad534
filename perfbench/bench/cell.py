"""One run of one cell: set-up, the measured window, the comparison.

A cell is a ``workloads`` entry of ``BENCHMARK.json``: a configuration
(``perfbench/configs/<config>.json``) under a traffic mix
(``perfbench/traffic/<traffic>.json``), compared within the limits of
``perfbench/limits/<cell>.json``.  Every end-to-end metric is computed
here from the window; every per-layer metric is a reader of its own,
``perfbench/metrics/<metric>.py``, called on the traced window.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

from reference import model, precision, rfast

from . import counts, faults, inputs, judge, program
from .trace import read_profile

__all__ = ["BENCH_DIR", "load_cell", "reader", "run_cell",
           "top_level_modules"]

BENCH_DIR = Path(__file__).resolve().parents[1]


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path) -> dict:
    """The manifest's entries and files of cell ``name``, found by name."""
    manifest = _read(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    return {"manifest": manifest, "cell": cell,
            "config": _read(root / conf["file"]),
            "traffic": _read(BENCH_DIR / "traffic"
                             / f"{cell['traffic']}.json"),
            "limits": _read(BENCH_DIR / "limits" / f"{name}.json")}


def _applies(metric: dict, cell: str, e2e_in_cell: set | None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    list, else every cell (end to end, ``e2e_in_cell`` None) or every
    cell that reports the end-to-end metric it moves (per layer)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_in_cell is None or metric["moves"] in e2e_in_cell


def reader(name: str):
    """The ``read`` function of per-layer metric ``name``'s file."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _rows_norms(rows, offsets, sizes) -> np.ndarray:
    return np.concatenate([program.leaf_norms(r[None], offsets, sizes)
                           for r in rows])


def _reference(cfg, traffic, net, x0, seed, cdf, schedule, offsets,
               sizes) -> program.Observed:
    """The plain reference's :class:`program.Observed` over the same
    inputs: the paper init and the checked steps (rounds, or the first
    chunk of events)."""
    B, S = traffic["batch"], traffic["seq"]
    sync = traffic["mode"] == "sync"

    clock = [0, 0.0]

    def grad(node, x, step):
        # sync steps are rounds (0 the init); async ones events (−1 the
        # init), whose batches are step k + 1's
        t = time.perf_counter()
        toks, labels = inputs.token_batch(seed, step if sync else step + 1,
                                          node, B, S, cdf)
        lane = x.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = model.loss(cfg, model.unflatten(cfg, lane), toks, labels)
            (g,) = torch.autograd.grad(loss, lane)
        clock[0] += 1
        clock[1] += time.perf_counter() - t
        return loss.detach(), g

    obs = program.Observed()
    W, A = net
    checked = traffic["checked_steps" if sync else "chunk_events"]

    def observe(step, state):
        if step == (1 if sync else checked):
            obs.grad = _rows_norms(state["g"], offsets, sizes)
        if step == checked:
            obs.change = _rows_norms([x - x0 for x in state["x"]], offsets,
                                     sizes)

    if sync:
        ne = max(len(rfast.edges(W)), len(rfast.edges(A)))
        masks = [inputs.round_masks(seed, r, ne, ne, traffic["loss_prob"])
                 for r in range(1, checked + 1)]
        losses = rfast.sync_rounds(W.tolist(), A.tolist(), x0, grad,
                                   traffic["gamma"], masks, checked,
                                   observe=observe)
        obs.losses = [v for step in losses for v in step]
    else:
        obs.losses = rfast.async_events(
            W.tolist(), A.tolist(), x0, grad, traffic["gamma"],
            schedule.agent.tolist(), schedule.stamp_v, schedule.stamp_rho,
            checked, observe=observe)
    obs.note = f"{clock[0]} gradients in {clock[1]:.3f} s"
    return obs


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             root: Path, device: str = "cuda", t_start: float | None = None,
             control: str | None = None, fault: str | None = None,
             shrink: dict | None = None, log=None) -> dict:
    """One run of cell ``name``; returns the result line's object.

    ``control="tf32"`` puts the reference in TF32 in the program's place
    (no window); ``fault`` plants one of :data:`faults.FAULTS` in the
    program; ``shrink`` (``{"model": {...}, "traffic": {...}}``) replaces
    sizes of the configuration and the traffic, for the CPU tests.
    ``log(text)`` takes the run's notes."""
    log = log or (lambda text: None)
    t_start = time.perf_counter() if t_start is None else t_start
    phases = {}
    mark = [t_start]

    def phase(what):
        now = time.perf_counter()
        phases[what] = now - mark[0]
        mark[0] = now

    c = load_cell(name, root)
    phase("import")
    shrink = shrink or {}
    cfg = dict(c["config"]["model"], **shrink.get("model", {}))
    traffic = dict(c["traffic"], **shrink.get("traffic", {}))
    dev = torch.device(device)
    precision.fp32()
    if dev.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.ones(1, device=dev).sum().item()
    phase("device")

    mcfg = program.port_config(cfg)
    spec = program.port_layout(cfg, [(p, s) for p, s, _, _ in
                                     model.leaves(cfg)])
    phase("program")
    offsets = spec.offsets
    sizes = [int(np.prod(s)) for s in spec.shapes]
    x0 = model.init_flat(cfg, inputs.generator(seed, "weights",
                                               device=dev), spec.p)
    net = inputs.binary_tree(traffic["nodes"])
    cdf = inputs.zipf_cdf(cfg["vocab"], traffic["zipf"], dev)
    schedule = None
    if traffic["mode"] == "async":
        sc = traffic["scenario"]
        schedule = inputs.realize_schedule(
            *net, traffic["events"], seed=seed, **sc)
        inputs.check_schedule(schedule, *net)
    phase("inputs")

    prof_box = {}

    def on_window(start: bool) -> None:
        if start:
            phase("steps")
            prof_box["open"] = time.perf_counter()
        if not trace:
            return
        if start:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            span = torch.profiler.record_function("perfbench.window")
            span.__enter__()
            prof_box.update(prof=prof, span=span)
        else:
            prof_box["span"].__exit__(None, None, None)
            prof_box["prof"].stop()

    win = None
    if control is None:
        run = program.run_sync if traffic["mode"] == "sync" else \
            program.run_async
        extra = {} if schedule is None else {"schedule": schedule}
        with faults.planted(fault):
            obs_p, win = run(mcfg, spec, net, traffic, x0, seed, seconds,
                             cdf=cdf, device=dev, offsets=offsets,
                             sizes=sizes, on_window=on_window, **extra)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    _free(dev)
    t_ref = time.perf_counter()
    ref_args = (cfg, traffic, net, x0, seed, cdf, schedule, offsets, sizes)
    if control is not None:
        with precision.tf32():
            obs_p = _reference(*ref_args)
        _free(dev)
    obs_r = _reference(*ref_args)
    log(f"reference {time.perf_counter() - t_ref:.3f} s ({obs_r.note})")
    values = judge.gaps(obs_p, obs_r)
    correct, checks = judge.judge(values, c["limits"])

    result = {"correct": correct}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": 1, "memory_peak_bytes": int(peak)}
    metrics = {}
    if win is not None:
        setup_s = prof_box["open"] - t_start
        log("setup split (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in phases.items()))
        e2e = _end_to_end(cfg, traffic, win, setup_s, peak)
        manifest = c["manifest"]
        mine = {m["name"] for m in manifest["end_to_end"]
                if _applies(m, name, None)}
        if not trace:
            metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                       for m in manifest["end_to_end"] if m["name"] in mine}
        else:
            t = read_profile(prof_box.pop("prof"))
            ctx = types.SimpleNamespace(trace=t, window=win, cfg=cfg,
                                        traffic=traffic, p=spec.p)
            for m in manifest["per_layer"]:
                if _applies(m, name, mine):
                    v = reader(m["name"])(ctx)
                    if v is not None:
                        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            dev_info.update(busy_s=t.busy_s, window_s=t.window_s)
            result["breakdown"] = t.breakdown()
        result.update(attempted=win.units, failed=0)
    else:
        result.update(attempted=0, failed=0)
    result.update(metrics=metrics, device=dev_info, checks=checks)
    return result


def _end_to_end(cfg, traffic, win, setup_s, peak) -> dict:
    """Every end-to-end metric this harness knows, from the window."""
    tokens = win.grads * traffic["batch"] * traffic["seq"]
    flops = win.grads * counts.grad_flops(cfg, traffic["batch"],
                                          traffic["seq"])
    out = {"setup_s": setup_s,
           "train_tokens_per_s": tokens / win.seconds,
           "mfu": 100.0 * flops / win.seconds / counts.FP32_FLOP_PER_S,
           "peak_mem_gib": peak / 2**30}
    return out


def top_level_modules() -> set[str]:
    """Top-level names of every loaded module."""
    return {m.split(".")[0] for m in list(sys.modules)}
