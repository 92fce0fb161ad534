#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Needs one CUDA card of compute capability 9.0 and the CUDA toolkit
(``nvcc`` on PATH or under ``/usr/local/cuda``).  Exits non-zero, and
prints no result, without a card or outside a checkout of the repo.
Every phase prints one JSON line; any failing phase raises and ends the
run.  Phases:

1. device   — name, capability, ``nvidia-smi`` name and power limit;
2. build    — the kernels, built from ``csrc/`` with ``nvcc`` (one
   process per source, all at once) into ``build/kernels/``;
3. kernels  — each kernel against its plain PyTorch version on the card
   (commit_grid: ragged and sentinel-clamp cases in fp32 and bf16, and
   the main path's shape with the row counts of the train run below);
4. train    — the port's ``launch.train.main`` at full width rfast-100m
   (4 nodes, binary tree, uniform scenario, 4 steps: K = 16 events),
   with the launch counters zeroed just before it and read just after;
5. backends — ``impl="kernel"`` vs ``impl="plain"`` on the card at two
   layers (full width and vocab), same seed and schedule;
6. timing   — each kernel and its plain version at the main path's
   shape, median of CUDA-event times, beside the bandwidth bound.

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
FP32_TOL = 1e-5              # tests/test_kernels.py's commit_grid tolerance
BF16_TOL = 3e-2              # tests/test_kernels.py's bf16 tolerance
TRAIN_ARGS = ["--arch", "rfast-100m", "--nodes", "4", "--topology",
              "binary_tree", "--scenario", "uniform", "--steps", "4",
              "--batch-per-node", "4", "--seq", "128", "--seed", "0"]


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn()`` in ms, one event pair per call."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# --------------------------------------------------------------------- #
# commit_grid cases
# --------------------------------------------------------------------- #
def grid_case(P, dtype, *, B=5, ka=3, ko=2, clamp=False, seed=0):
    """Random sources and gather tables on the card (the layout of
    tests/test_kernels.py's cases); ``clamp`` puts drop-sentinel and
    negative rows in the tables."""
    import torch
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    a = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)
    ri = lambda hi, *s: torch.randint(0, hi, s, generator=g, device=dev,
                                      dtype=torch.int32)
    Nz, Nri, Nr = 4 * B, 40, 16
    kw = dict(idx_z=ri(Nz, B), idx_g=ri(Nz, B), idx_ri=ri(Nri, B, ka),
              idx_rb=ri(Nr, B, ka), idx_ro=ri(Nr, B, ko),
              a_self=torch.rand(B, generator=g, device=dev),
              mask=ri(2, B, ka).float(),
              a_out=torch.rand(B, ko, generator=g, device=dev),
              z_src=a(Nz, P), g_new=a(B, P), go_src=a(Nz, P),
              ri_src=a(Nri, P), rb_src=a(Nr, P), ro_src=a(Nr, P))
    if clamp:
        kw["idx_ri"][:, -1] = 10_000
        kw["idx_rb"][:, -1] = 2 * Nr
        kw["idx_ro"][0] = -5
        kw["mask"][:, -1] = 0.0
    return kw


def main_path_case(res_p: int, seed: int = 0):
    """commit_grid's inputs at the train run's widest wave: its real
    gather tables over sources with the run's row counts (nodes (n·4),
    ρ history (H·E), ρ/ρ̃ (2E)) at the run's flat width."""
    import numpy as np
    import torch
    from repro_torch.core.plan import build_comm_plan
    from repro_torch.core.scenario import get_scenario
    from repro_torch.core.schedule import (build_wavefront_plan,
                                           grid_gather_tables)
    from repro_torch.core.topology import get_topology

    n, K = 4, 16
    topo = get_topology("binary_tree", n)
    plan = build_comm_plan(topo)
    sched = get_scenario("uniform", n).realize(topo, K, seed=0).schedule
    H = int(sched.D) + 2
    wf = build_wavefront_plan(sched, plan, H, break_every=K)
    w = int(np.argmax(wf.sizes))
    s = int(wf.sizes[w])
    tabs = grid_gather_tables(wf.agent[w, :s], wf.rslot_rho[w, :s],
                              wf.hist_epos[w, :s], wf.rho_gidx[w, :s],
                              e_a_flat=wf.e_a, ko=plan.ko)
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = lambda r: torch.randn(r, res_p, generator=g, device=dev)
    nodes, hist, rho2 = rows(4 * n), rows(H * wf.e_a), rows(2 * wf.e_a)
    it = lambda t: torch.as_tensor(np.ascontiguousarray(t, np.int32),
                                   device=dev)
    ft = lambda t: torch.as_tensor(np.ascontiguousarray(t, np.float32),
                                   device=dev)
    kw = dict(idx_z=it(tabs[0]), idx_g=it(tabs[1]), idx_ri=it(tabs[2]),
              idx_rb=it(tabs[3]), idx_ro=it(tabs[4]),
              a_self=ft(wf.a_self[w, :s]), mask=ft(wf.a_val[w, :s]),
              a_out=ft(wf.out_wt[w, :s]), z_src=nodes, g_new=rows(s),
              go_src=nodes, ri_src=hist, rb_src=rho2, ro_src=rho2)
    # bytes the function must move: every distinct source row once
    # (z/g_prev share the node array, ρ̃/ρ-out the ρ array), the lane
    # gradients, the tables, and every output row once
    clip = lambda t, hi: np.clip(np.asarray(t), 0, hi - 1)
    uniq = (len(np.unique(np.concatenate([tabs[0], tabs[1]])))
            + len(np.unique(clip(tabs[2], H * wf.e_a)))
            + len(np.unique(np.concatenate(
                [clip(tabs[3], 2 * wf.e_a).ravel(),
                 clip(tabs[4], 2 * wf.e_a).ravel()]))))
    ka, ko = tabs[2].shape[1], tabs[4].shape[1]
    out_rows = s * (1 + ka + ko)
    small = sum(int(t.numel() * t.element_size()) for k, t in kw.items()
                if not k.endswith("src") and k != "g_new")
    nbytes = (uniq + s + out_rows) * res_p * 4 + small
    flops = s * res_p * (4 * ka + 2 * ko + 4)
    return kw, dict(B=s, ka=ka, ko=ko, Pf=res_p,
                    rows={"nodes": 4 * n, "rho_hist": H * wf.e_a,
                          "rho2": 2 * wf.e_a},
                    bytes=nbytes, flops=flops)


def compare_grid(kw, tol) -> float:
    """Kernel vs plain on the same inputs: the max abs error; raises
    unless every output is finite and within ``tol`` (atol = rtol)."""
    import torch
    from repro_torch.kernels.rfast_update.grid import (commit_grid,
                                                       commit_grid_plain)
    err = 0.0
    for g, w in zip(commit_grid(**kw), commit_grid_plain(**kw)):
        check(g.shape == w.shape and g.dtype == w.dtype, "output layout")
        check(bool(torch.isfinite(g).all()), "finite kernel output")
        check(torch.allclose(g.float(), w.float(), rtol=tol, atol=tol),
              f"commit_grid within {tol}")
        if g.numel():
            err = max(err, float((g.float() - w.float()).abs().max()))
    return err


# --------------------------------------------------------------------- #
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    from repro_torch.kernels.rfast_update import dispatch, grid

    # 1. device ----------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    emit("device", name=name, capability=list(cap), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    check(cap == (9, 0), f"compute capability 9.0, got {cap}")

    # 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build([grid.KERNEL_SOURCE])
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log(grid.KERNEL_SOURCE)
             .splitlines() if "registers" in ln or "spill" in ln]
    emit("build", seconds=build_s, libraries=[str(p.relative_to(ROOT))
                                              if p.is_relative_to(ROOT)
                                              else str(p)
                                              for p in libs.values()],
         ptxas=ptxas)

    # 3. kernels vs plain --------------------------------------------------
    for P in (37, 100_001):
        for dt, tol in ((torch.float32, FP32_TOL), (torch.bfloat16,
                                                    BF16_TOL)):
            for clamp in (False, True):
                err = compare_grid(grid_case(P, dt, clamp=clamp), tol)
                emit("kernels", kernel="commit_grid", Pf=P, dtype=str(dt),
                     clamp=clamp, max_abs_err=err, tol=tol)
    from repro_torch.configs import get_config
    from repro_torch.core.paramvec import make_ravel_spec
    from repro_torch.models.transformer import init_params
    cfg = get_config("rfast-100m")
    p_run = make_ravel_spec(init_params(cfg, torch.Generator()
                                        .manual_seed(0)), pad_to=128).p
    kw, shape = main_path_case(p_run)
    main_err = compare_grid(kw, FP32_TOL)
    emit("kernels", kernel="commit_grid", main_path=True, dtype="float32",
         max_abs_err=main_err, tol=FP32_TOL,
         **{k: v for k, v in shape.items() if k not in ("bytes", "flops")})
    del kw
    torch.cuda.empty_cache()

    # 4. train at full width -----------------------------------------------
    from repro_torch.launch import train
    torch.cuda.reset_peak_memory_stats()
    dispatch.clear()
    t0 = time.perf_counter()
    res = train.main(TRAIN_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dispatch.stats()["by_kernel"]
    emit("train", p=res["p"], events=res["events"], waves=res["waves"],
         loss_init=res["losses"][0], loss_final=res["losses"][-1],
         losses=res["losses"], packed_state_gb=res["packed_bytes"] / 1e9,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         wall_s=wall, launches=launches, lemma3_rel=res["mass_rel"],
         device=name, nvidia_smi=smi)
    check(all(math.isfinite(v) for v in res["losses"]), "finite losses")
    check(res["waves"] > 0 and launches.get("commit_grid", 0)
          == res["waves"], "one commit_grid launch per wave")
    check(res["mass_rel"] <= 1e-4, "Lemma-3 residual <= 1e-4")
    torch.cuda.empty_cache()

    # 5. backends: kernel vs plain at two layers -----------------------------
    from repro_torch.core.scenario import get_scenario
    from repro_torch.core.simulator import run_rfast
    from repro_torch.core.topology import get_topology
    from repro_torch.data.objectives import make_lm_problem
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    prob = make_lm_problem(cfg2, 4, batch_per_node=4, seq_len=128, seed=0,
                           device="cuda")
    topo = get_topology("binary_tree", 4)
    sched = get_scenario("uniform", 4).realize(topo, 16, seed=0).schedule
    finals, backend_launches = {}, {}
    for impl in ("kernel", "plain"):
        dispatch.clear()
        st, _ = run_rfast(topo, sched, prob, prob.x0_flat, 3e-3, seed=0,
                          impl=impl, device="cuda")
        backend_launches[impl] = dispatch.launches("commit_grid")
        finals[impl] = (st.x.clone(), st.z.clone())
        del st
        torch.cuda.empty_cache()
    rel = [float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))
           for a, b in zip(finals["kernel"], finals["plain"])]
    emit("backends", n_layers=2, p=prob.p, x_rel=rel[0], z_rel=rel[1],
         tol=1e-5, commit_grid_launches=backend_launches)
    check(max(rel) <= 1e-5, "kernel and plain backends agree to 1e-5")
    check(backend_launches["kernel"] > 0 and backend_launches["plain"] == 0,
          "only the kernel backend launches commit_grid")
    del finals, prob
    torch.cuda.empty_cache()

    # 6. timing at the main path's shape --------------------------------------
    kw, shape = main_path_case(p_run, seed=1)
    ms = cuda_ms(lambda: grid.commit_grid(**kw), reps=10)
    plain_ms = cuda_ms(lambda: grid.commit_grid_plain(**kw), reps=5)
    t_bytes = shape["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = shape["flops"] / FP32_FLOP_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    formula = grid.commit_grid_bytes(shape["B"], shape["ka"], shape["ko"],
                                     shape["Pf"], 4)
    emit("timing", kernel="commit_grid", ms=ms, plain_ms=plain_ms,
         bytes=shape["bytes"], formula_bytes=formula, flops=shape["flops"],
         bound_ms=bound_ms, bound_by=bound_by,
         achieved_gb_s=shape["bytes"] / ms / 1e6,
         bound_share=bound_ms / ms, library_ms=None, device=name,
         nvidia_smi=smi, **{k: shape[k] for k in ("B", "ka", "ko", "Pf")})
    del kw

    print(json.dumps({"kernels": [{
        "name": "commit_grid", "route": "cuda",
        "source": str(grid.KERNEL_SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/rfast_update/grid.py:192",
        "launches": launches.get("commit_grid", 0),
        "max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}]}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
