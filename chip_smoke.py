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
   process per source, all at once) into ``build/kernels/``; for the four
   flash kernels (fp32 ``flash_fwd_3xtf32`` / ``flash_bwd_3xtf32``, bf16
   ``flash_fwd_tc`` / ``flash_bwd_tc``), their registers, spills and
   shared memory per instantiation, and the tensor-core instructions
   (``HGMMA``, ``HMMA``) and TMA loads in their SASS; for the scan's
   ``ssm_scan`` and ``ssm_scan_bwd``, their registers, spills and static
   shared memory per instantiation and the backward's dynamic shared
   memory at the checkpoint spacing the autograd function uses;
3. kernels  — each kernel against its plain PyTorch version on the card
   (commit_grid: ragged and sentinel-clamp cases in fp32 and bf16, and
   the main path's shape with the row counts of the train run below);
4. train    — the port's ``launch.train.main`` at full width rfast-100m
   (4 nodes, binary tree, uniform scenario, 4 steps: K = 16 events),
   with the launch counters zeroed just before it and read just after;
5. backends — ``impl="kernel"`` vs ``impl="plain"`` on the card at two
   layers (full width and vocab), same seed and schedule;
6. timing   — each kernel and its plain version at the main path's
   shape, median of CUDA-event times, beside the bandwidth bound;
7. flash kernels — each flash kernel against its plain twin on the card
   at small odd cases (D 32/48/64/128, GQA 1/4/5, causal / full / window,
   Sq != Sk, ragged S): in fp32 ``flash_fwd_3xtf32`` and the fused
   ``flash_bwd_3xtf32`` (3xTF32 on the tensor cores), in bf16
   ``flash_fwd_tc`` and the fused ``flash_bwd_tc`` (dO in bf16), at
   those cases and at head dims the wrappers pad: D % 4 != 0 (35) in
   both, D % 8 != 0 (36) and D % 16 != 0 (40) in bf16;
8. flash path — the flash attention op and its autograd function at full
   attention width (llama3-8b, hymba-1.5b, rfast-100m; fp32 and bf16
   each), forward and forward+backward, against the plain twins, with
   the launch counters zeroed just before and read after (fp32: 1
   ``flash_fwd_3xtf32``, then 1 each of ``flash_fwd_3xtf32`` and
   ``flash_bwd_3xtf32``; bf16: the same of ``flash_fwd_tc`` and
   ``flash_bwd_tc``);
9. flash timing — each flash kernel, its plain twin and PyTorch's
   ``scaled_dot_product_attention`` at the llama3-8b and hymba-1.5b
   shapes, in fp32 and bf16 (both sides read a dO of the inputs' dtype),
   beside the bound (fp32: operations at the 3xTF32 rate, with the
   CUDA-core bound beside it).  The library call is timed forward and
   backward through autograd, with its backend and its errors against
   the plain twins: in bf16 the backend PyTorch picks with GQA; in fp32
   also the efficient backend forced on k, v repeated to H heads (the
   repeat outside the timed window), the faster call within the fp32
   tolerance being the yardstick;
10. node kernels — ``rfast_update_node`` and ``rfast_commit_node``
   against their plain twins (P 1, 37, 4097, 100,001 in fp32 and bf16,
   slot counts (Kw, Ka, Ko) (1, 2, 1) and (2, 3, 2), random weights and
   0/1 masks), then the ops ``rfast_update(outputs="full")`` and
   ``rfast_commit(oracle=True)`` at full width (P = p of rfast-100m,
   fp32) with the launch counters zeroed just before and read after;
11. sync train — ``launch.train.main`` with no ``--scenario`` at full
   width rfast-100m (4 nodes, binary tree, ``--impl kernel``), 3 rounds
   with no loss, then 3 rounds with ``--loss-prob 0.2 --momentum 0.9``,
   the counters zeroed before each and read after, and the allocator
   read before each call, after its init and after its first round;
12. round routes — the protocol round's ``kernel``, ``kernel`` with
   ``oracle=True`` and ``plain`` routes from one state at two layers of
   full width, 4 lossy rounds each, with their launches;
13. node timing — each node kernel and its plain twin at full width,
   and ``commit_grid`` at the round's shape (B = 4 nodes; its bound
   counts the rows the round keeps, not the pad slots it drops), median
   of CUDA-event times, beside the bandwidth bound;
14. scan kernels — ``ssm_scan`` against its plain twin ``ssm_scan_plain``
   (y, h_last and the checkpoints at the autograd function's spacing;
   1e-4 fp32, 3e-2 bf16), unsplit and with its time axis split in 3, and
   ``ssm_scan_bwd`` against ``ssm_scan_bwd_plain`` (the six gradients,
   with and without a gradient of h_last, within the same tolerances
   relative to each gradient's largest entry) at tests/test_kernels.py's
   scan cases, at ragged di (200, 3200), S (1, 100, 129) and N (4, 16),
   and at hymba-1.5b's train shape (B 4, S 128, di 3200, N 16), with dt
   drawn as the model feeds it and B, C as column slices of one
   projection; then ``SelectiveScanFn``'s gradients (both kernels)
   against plain autograd of the ref at that shape (1e-4 relative);
15. hymba sync train — ``launch.train``'s synchronous regime on full-width
   hymba-1.5b cut to 2 of its 32 layers (4 nodes, binary tree,
   ``--impl kernel``): 3 rounds, then 3 rounds with ``--loss-prob 0.2
   --momentum 0.9``; the counters zeroed before each and read after
   (``ssm_scan`` = ``ssm_scan_bwd`` = layers × gradients, ``commit_grid``
   = rounds), the allocator read before each call, after its init and
   after round 1;
16. scan timing — at hymba-1.5b's train shape and at the op widths of
   hymba-1.5b (S 4096, di 3200) and falcon-mamba-7b (S 4096, di 8192):
   the forward (without checkpoints, as before; with them, as the
   autograd function runs it; at the op widths unsplit and at the split
   ``scan_segments`` chooses), the backward kernel, and their plain twins
   (the backward's at the op widths once), median of CUDA-event times,
   beside the bounds (bytes at 3.35 TB/s; fp32 operations; exponentials
   at the MUFU rate of 16 per clock per SM at the card's maximum SM
   clock; the backward's with its checkpoints every
   ``SCAN_BOUND_CKPT_EVERY`` steps, and beside it at the kernel's
   ``CKPT_EVERY``); a kernel timed as 20 launches in a CUDA graph per
   event pair (and the forward as one call, host work included, as
   ``call_ms``), and ``SelectiveScanFn`` forward + backward (both
   kernels, through autograd) as one SSM layer's gradient pays it.

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
TF32_FLOP_PER_S = 495e12     # H100 SXM TF32 tensor cores, dense
TF32X3_FLOP_PER_S = TF32_FLOP_PER_S / 3   # fp32 products in 3xTF32
FP32_TOL = 1e-5              # tests/test_kernels.py's commit_grid tolerance
BF16_TOL = 3e-2              # tests/test_kernels.py's bf16 tolerance
BF16_FLOP_PER_S = 989e12     # H100 SXM bf16 tensor cores, fp32 accumulate
FLASH_FWD_TOL = 2e-5         # tests/test_kernels.py's flash tolerances:
FLASH_GRAD_TOL = 2e-4        # fp32 forward, fp32 gradients,
FLASH_BF16_TOL = 2e-2        # and bf16
# (B, H, KV, Sq, Sk, D, causal, window); bq = bk = 8 divides every S
FLASH_SMALL = [
    (1, 4, 4, 128, 128, 32, True, None),
    (2, 8, 2, 256, 256, 64, False, None),
    (1, 5, 1, 192, 192, 128, True, 128),
    (1, 10, 2, 128, 256, 64, True, None),     # Sq < Sk, GQA 5
    (1, 4, 1, 256, 128, 32, True, None),      # Sq > Sk
    (1, 5, 5, 200, 200, 64, True, 5),         # window below one tile
    (2, 4, 4, 200, 200, 48, True, 100),       # ragged window, D = 48
    (1, 3, 1, 104, 104, 35, True, 50),        # D % 4 != 0: padded to 36
]
# bf16 only: a head dim the tensor-core kernels take by padding
# (D % 8 != 0) and one with a half-filled 16-column k-step (D % 16 != 0)
FLASH_SMALL_BF16 = [
    (1, 4, 2, 136, 136, 36, True, None),      # D = 36
    (2, 4, 2, 136, 72, 40, True, 96),         # D = 40, Sq > Sk, window
]
# attention widths of src/repro/configs/{llama3_8b,hymba_1_5b,rfast_100m}.py
# (hymba's attn_window 1024); rfast-100m at the train phase's batch and
# sequence
FLASH_FULL = [
    ("llama3-8b", dict(B=1, S=4096, H=32, KV=8, D=128, window=None)),
    ("hymba-1.5b", dict(B=1, S=4096, H=25, KV=5, D=64, window=1024)),
    ("rfast-100m", dict(B=4, S=128, H=12, KV=4, D=64, window=None)),
]
TRAIN_ARGS = ["--arch", "rfast-100m", "--nodes", "4", "--topology",
              "binary_tree", "--scenario", "uniform", "--steps", "4",
              "--batch-per-node", "4", "--seq", "128", "--seed", "0"]
SYNC_ARGS = ["--arch", "rfast-100m", "--nodes", "4", "--topology",
             "binary_tree", "--steps", "3", "--batch-per-node", "4",
             "--seq", "128", "--seed", "0", "--log-every", "1"]
SYNC_RUNS = [("sync", []),
             ("lossy+momentum", ["--loss-prob", "0.2", "--momentum", "0.9"])]
# (Kw, Ka, Ko): the binary tree's slot counts, and wider ones
NODE_SLOTS = [(1, 2, 1), (2, 3, 2)]
ROUTE_TOL = 1e-5             # the round routes agree to this, relative
SCAN_FP32_TOL = 1e-4         # tests/test_kernels.py's scan tolerances:
SCAN_BF16_TOL = 3e-2         # fp32 and bf16
SCAN_GRAD_TOL = 1e-4         # SelectiveScanFn vs plain autograd, relative
MUFU_PER_CLOCK_SM = 16       # sm_90 exponentials per clock per SM
# the checkpoint spacing the scan gradient's own bound counts: the kernel
# reads checkpoints every CKPT_EVERY = 8 steps only to fit its shared
# memory, so the 8x more checkpoint bytes are a cost of its design, not
# part of the least work (its bound at T = 8 is reported beside)
SCAN_BOUND_CKPT_EVERY = 64
H100_SMS = 132
# (B, S, di, N): tests/test_kernels.py:228-232, then ragged di, S and N
SCAN_SMALL = [(1, 64, 16, 8), (2, 128, 64, 16), (1, 256, 32, 16)] + [
    (2, S, di, N) for di in (200, 3200) for S in (1, 100, 129)
    for N in (4, 16)]
# (name, (B, S, di, N), dt_rank): hymba-1.5b's train shape (4 x 128
# tokens per gradient, d_inner 3200), and the op widths of hymba-1.5b and
# falcon-mamba-7b (d_inner 8192) at S 4096; src/repro/configs/
SCAN_TRAIN = ("hymba-1.5b train", (4, 128, 3200, 16), 100)
SCAN_TIMED = [SCAN_TRAIN, ("hymba-1.5b op", (1, 4096, 3200, 16), 100),
              ("falcon-mamba-7b op", (1, 4096, 8192, 16), 256)]
HYMBA_LAYERS = 2             # of hymba-1.5b's 32, at full width
HYMBA_ARGS = ["--arch", "hymba-1.5b", "--nodes", "4", "--topology",
              "binary_tree", "--steps", "3", "--batch-per-node", "4",
              "--seq", "128", "--seed", "0", "--log-every", "1", "--impl",
              "kernel"]


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


def graph_ms(fn, launches: int = 20, reps: int = 5) -> float:
    """Median device time of one ``fn()`` in ms: ``launches`` calls
    captured in a CUDA graph and replayed between one event pair, so the
    host's time per call (a wrapper's checks, its ctypes call), which
    :func:`cuda_ms` brackets too, is not in it."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    del graph
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
# flash attention cases
# --------------------------------------------------------------------- #
def flash_inputs(B, H, KV, Sq, Sk, D, dtype, seed=0):
    """q (B,H,Sq,D), k, v (B,KV,Sk,D) and a cotangent of q's shape in
    ``dtype``, random on the card."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
    return (a(B, H, Sq, D), a(B, KV, Sk, D), a(B, KV, Sk, D),
            a(B, H, Sq, D))


def max_err(got, want) -> float:
    return float((got.detach().float() - want.float()).abs().max())


def within(got, want, tol) -> bool:
    """Finite and within ``tol`` (atol = rtol) of ``want``."""
    import torch
    got = got.detach()
    return bool(torch.isfinite(got).all()) and torch.allclose(
        got.float(), want.float(), rtol=tol, atol=tol)


def held(got, want, tol, what) -> float:
    """Max abs error of ``got`` against ``want``; raises unless finite,
    of the same shape and dtype, and within ``tol`` (atol = rtol)."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: layout {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    check(within(got, want, tol), f"{what}: finite and within {tol}")
    return max_err(got, want)


def attn_pairs(Sq, Sk, causal, window) -> int:
    """Unmasked (q, k) pairs of one (b, h) under the kernels' mask."""
    import numpy as np
    if not causal:
        return Sq * Sk
    i = np.arange(Sq)
    hi = np.minimum(i, Sk - 1)
    lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_names(dtype):
    """The forward and the backward kernel that ``dtype`` runs."""
    import torch
    if dtype == torch.float32:
        return "flash_fwd_3xtf32", "flash_bwd_3xtf32"
    return "flash_fwd_tc", "flash_bwd_tc"


def flash_work(B, H, KV, S, D, window, dtype):
    """Operations and bytes each flash kernel's function needs: the
    forward does 2 products per unmasked pair (4·D flops), the fused
    backward 5 (10·D).  Bytes count each input once at the dtype its
    kernel reads it (q, k, v and dO in ``dtype``; k/v at KV heads for the
    forward, repeated to H for the backward; lse and δ in fp32) and each
    output once (o in ``dtype``; lse and the gradients in fp32)."""
    import torch
    it = torch.tensor([], dtype=dtype).element_size()
    pairs = attn_pairs(S, S, True, window) * B * H
    q_el, kv_el, row = B * H * S * D, B * KV * S * D, B * H * S
    fwd_name, bwd_name = flash_names(dtype)
    return {fwd_name: (4 * D * pairs, it * (2 * q_el + 2 * kv_el) + 4 * row),
            bwd_name: (10 * D * pairs,
                       it * (4 * q_el) + 4 * 2 * row + 12 * q_el)}


def bound(flops, nbytes, peak):
    """The least time in ms for ``flops`` at ``peak`` FLOP/s and
    ``nbytes`` at the HBM rate, and which of the two bounds it."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations"


def ptxas_entries(source):
    """ptxas's report for each kernel instantiation of ``source``'s build:
    registers, spill bytes and static shared memory."""
    import re
    from repro_torch.kernels import _build
    entries, cur = [], None
    for ln in _build.build_log(source).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = {"entry": m.group(1)}
            entries.append(cur)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur["spill_store_bytes"], cur["spill_load_bytes"] = map(
                int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            cur["smem_bytes"] = int(m.group(1)) if m else 0
    return entries


def tc_report(kname, source, dims):
    """What the compiler made of one flash kernel: ptxas's registers and
    spill bytes for each instantiation, the dynamic shared memory one
    block asks for at each head dim of ``dims``, and the count of
    tensor-core instructions (HGMMA: wgmma; HMMA: mma.sync) and of TMA
    loads (UTMALDG) in its SASS."""
    import ctypes
    from repro_torch.kernels import _build
    smem = getattr(_build.load(source), f"{kname}_smem")
    smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
    text = _build.sass(source)
    return {"ptxas": ptxas_entries(source),
            "dynamic_smem_bytes": {f"D<={d}": smem(d) for d in dims},
            "sass": {op: text.count(op) for op in ("HGMMA", "HMMA",
                                                   "UTMALDG")}}


def flash_small_case(case, dtype, fwd_tol, grad_tol):
    """Both flash kernels of ``dtype`` against their plain twins on one
    small case: fp32 runs ``flash_fwd_3xtf32`` and ``flash_bwd_3xtf32``,
    bf16 ``flash_fwd_tc`` and ``flash_bwd_tc`` (dO in the inputs' dtype),
    held to ``flash_fwd_plain`` and ``flash_bwd_plain``.  Returns the
    errors and the launches."""
    import torch
    from repro_torch.kernels.flash_attention import backward as fb
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rfast_update import dispatch
    B, H, KV, Sq, Sk, D, causal, window = case
    fwd_name, bwd_name = flash_names(dtype)
    q, k, v, do = flash_inputs(B, H, KV, Sq, Sk, D, dtype)
    kw = dict(causal=causal, window=window, bq=8, bk=8)
    dispatch.clear()
    o, lse = fk.flash_fwd(q, k, v, **kw)
    o_w, lse_w = fk.flash_fwd_plain(q, k, v, **kw)
    err = {fwd_name: held(o, o_w, fwd_tol, f"{fwd_name} {case}"),
           "lse": held(lse, lse_w, FLASH_FWD_TOL, f"{fwd_name} lse {case}")}
    rep = H // KV
    kr, vr = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    o32, _ = fk.flash_fwd_plain(q, k, v, out_dtype=torch.float32, **kw)
    delta = (do.float() * o32).sum(-1)
    bkw = dict(kw, scale=D ** -0.5)
    got = fb.flash_bwd(q, kr, vr, do, lse_w, delta, **bkw)
    want = fb.flash_bwd_plain(q, kr, vr, do, lse_w, delta, **bkw)
    err[bwd_name] = max(held(g, w, grad_tol, f"{bwd_name} {n} {case}")
                        for g, w, n in zip(got, want, ("dq", "dk", "dv")))
    torch.cuda.synchronize()
    return err, dispatch.stats()["by_kernel"]


def flash_full_run(cfg, dtype, seed=0):
    """The flash path at one full width: the op forward, then forward +
    backward through the autograd function (k/v repeated to H heads in
    the graph; the cotangent in ``dtype``), each held against the plain
    twins.  Returns the errors by kernel and the launches each step
    made."""
    import torch
    from repro_torch.kernels.flash_attention import backward as fb
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rfast_update import dispatch
    B, S, H, KV, D, window = (cfg[x] for x in ("B", "S", "H", "KV", "D",
                                                "window"))
    fwd_tol = FLASH_FWD_TOL if dtype == torch.float32 else FLASH_BF16_TOL
    grad_tol = FLASH_GRAD_TOL if dtype == torch.float32 else FLASH_BF16_TOL
    fwd_name, bwd_name = flash_names(dtype)
    q, k, v, do = flash_inputs(B, H, KV, S, S, D, dtype, seed)
    steps = {}
    before = dict(dispatch.stats()["by_kernel"])
    delta_of = lambda: {n: c - before.get(n, 0) for n, c in
                        dispatch.stats()["by_kernel"].items()
                        if c != before.get(n, 0)}
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True, window=window,
                        impl="kernel").transpose(1, 2)
    torch.cuda.synchronize()
    steps["forward"] = delta_of()
    o_w, lse_w = fk.flash_fwd_plain(q, k, v, causal=True, window=window)
    err = {fwd_name: held(o, o_w, fwd_tol, "flash path forward")}
    del o, o_w

    before = dict(dispatch.stats()["by_kernel"])
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    rep = H // KV
    out = fb.flash_attention_vjp(leaves[0],
                                 leaves[1].repeat_interleave(rep, 1),
                                 leaves[2].repeat_interleave(rep, 1),
                                 True, window)
    out.backward(do)
    torch.cuda.synchronize()
    steps["forward+backward"] = delta_of()
    kr, vr = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    o32, _ = fk.flash_fwd_plain(q, kr, vr, causal=True, window=window,
                                out_dtype=torch.float32)
    err[fwd_name] = max(err[fwd_name],
                        held(out, o32.to(dtype), fwd_tol,
                             "flash path forward (autograd)"))
    dof = do.float()
    delta = (dof * o32).sum(-1)
    kw = dict(scale=D ** -0.5, causal=True, window=window)
    dq = fb.flash_dq_plain(q, kr, vr, dof, lse_w, delta, **kw)
    e_dq = held(leaves[0].grad, dq.to(dtype), grad_tol, "flash path dq")
    del dq
    dk, dv = fb.flash_dkv_plain(q, kr, vr, dof, lse_w, delta, **kw)
    group = lambda t: t.view(B, KV, rep, S, D).sum(2).to(dtype)
    e_dkv = max(held(leaves[1].grad, group(dk), grad_tol, "flash path dk"),
                held(leaves[2].grad, group(dv), grad_tol, "flash path dv"))
    err[bwd_name] = max(e_dq, e_dkv)
    return err, steps


def sdpa_calls(q, k, v, do, window, o_w, grads_w):
    """PyTorch's ``scaled_dot_product_attention`` on the flash op's inputs,
    each call forward (``fwd_ms``) and backward through autograd
    (``bwd_ms``), with its backend and its errors against the plain twins
    ``o_w`` and ``grads_w`` (dq, and dk, dv at H heads).  ``gqa``: k, v
    at KV heads with ``enable_gqa`` and the backend PyTorch picks; in
    fp32 also ``repeated_kv``: k, v repeated to H heads, the repeat made
    before the timed window, with the efficient backend forced (it takes
    no GQA).  Both use hymba's window as a boolean mask."""
    import contextlib
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    B, H, S, D = q.shape
    KV = k.shape[1]
    rep = H // KV
    fp32 = q.dtype == torch.float32
    fwd_tol = FLASH_FWD_TOL if fp32 else FLASH_BF16_TOL
    grad_tol = FLASH_GRAD_TOL if fp32 else FLASH_BF16_TOL
    if window:
        i = torch.arange(S, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        kw = dict(attn_mask=mask, is_causal=False)
    else:
        mask, kw = None, dict(is_causal=True)
    group = lambda t: t.view(B, KV, rep, S, D).sum(2)
    calls = {"gqa": ((q, k, v), dict(enable_gqa=True), None,
                     (grads_w[0], group(grads_w[1]), group(grads_w[2])))}
    if fp32:
        kr, vr = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
        calls["repeated_kv"] = ((q, kr, vr), {},
                                SDPBackend.EFFICIENT_ATTENTION, grads_w)
    out = {}
    for name, (ins, extra, forced, want) in calls.items():
        backend = forced.name if forced else SDPBackend(
            torch._fused_sdp_choice(*ins, mask, 0.0, kw["is_causal"],
                                    **extra)).name
        call = lambda *a: F.scaled_dot_product_attention(*a, **kw, **extra)
        with sdpa_kernel(forced) if forced else contextlib.nullcontext():
            o = call(*ins)
            row = dict(backend=backend, fwd_err=max_err(o, o_w),
                       fwd_ok=within(o, o_w, fwd_tol))
            del o
            row["fwd_ms"] = cuda_ms(lambda: call(*ins), reps=10)
            leaves = [t.detach().requires_grad_() for t in ins]
            o_lib = call(*leaves)
            grads = torch.autograd.grad(o_lib, leaves, do, retain_graph=True)
            row["bwd_err"] = max(max_err(g, w) for g, w in zip(grads, want))
            row["bwd_ok"] = all(within(g, w, grad_tol)
                                for g, w in zip(grads, want))
            del grads
            row["bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
                o_lib, leaves, do, retain_graph=True), reps=10)
            del o_lib, leaves
        out[name] = row
        torch.cuda.empty_cache()
    return out


def flash_timing(name, cfg, dtype, smi, device):
    """CUDA-event medians of both flash kernels of ``dtype``, their plain
    twins and PyTorch's attention calls at one full width, beside the
    bound.  The kernels and the library read one cotangent, in
    ``dtype``.  ``library_ms`` is the fastest call within the tolerance
    (bf16: the one call)."""
    import torch
    from repro_torch.kernels.flash_attention import backward as fb
    from repro_torch.kernels.flash_attention import kernel as fk
    B, S, H, KV, D, window = (cfg[x] for x in ("B", "S", "H", "KV", "D",
                                                "window"))
    fwd_name, bwd_name = flash_names(dtype)
    q, k, v, do = flash_inputs(B, H, KV, S, S, D, dtype, seed=2)
    kw = dict(causal=True, window=window)
    rows = {fwd_name: dict(
        ms=cuda_ms(lambda: fk.flash_fwd(q, k, v, **kw), reps=10),
        plain_ms=cuda_ms(lambda: fk.flash_fwd_plain(q, k, v, **kw), reps=5))}

    rep = H // KV
    kr, vr = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    o32, lse = fk.flash_fwd_plain(q, k, v, out_dtype=torch.float32, **kw)
    delta = (do.float() * o32).sum(-1)
    bkw = dict(kw, scale=D ** -0.5)
    rows[bwd_name] = dict(
        ms=cuda_ms(lambda: fb.flash_bwd(q, kr, vr, do, lse, delta, **bkw),
                   reps=10),
        plain_ms=cuda_ms(lambda: fb.flash_bwd_plain(q, kr, vr, do, lse,
                                                    delta, **bkw), reps=5))
    grads_w = fb.flash_bwd_plain(q, kr, vr, do, lse, delta, **bkw)
    del kr, vr
    lib = sdpa_calls(q, k, v, do, window, o32.to(dtype), grads_w)
    del grads_w, o32
    for kname, key in ((fwd_name, "fwd"), (bwd_name, "bwd")):
        ok = {c: r for c, r in lib.items()
              if r[f"{key}_ok"] or dtype != torch.float32}
        best = min(ok, key=lambda c: ok[c][f"{key}_ms"]) if ok else None
        rows[kname].update(
            library_ms=ok[best][f"{key}_ms"] if best else None,
            library=None if best is None else
            f"scaled_dot_product_attention ({best}, {ok[best]['backend']})"
            + (" backward (dq, dk, dv)" if key == "bwd" else ""))
    work = flash_work(B, H, KV, S, D, window, dtype)
    # fp32 products run as 3xTF32 on the tensor cores
    peak = TF32X3_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S
    for kname, row in rows.items():
        flops, nbytes = work[kname]
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes, peak)
        if dtype == torch.float32:
            row["cuda_core_bound_ms"] = bound(flops, nbytes,
                                              FP32_FLOP_PER_S)[0]
        emit("flash_timing", kernel=kname, config=name, dtype=str(dtype),
             flops=flops, bytes=nbytes, bound_share=row["bound_ms"]
             / row["ms"], tflop_s=flops / row["ms"] / 1e9, sdpa=lib,
             device=device, nvidia_smi=smi, **row)
    return rows


# --------------------------------------------------------------------- #
# per-node kernels and the protocol round
# --------------------------------------------------------------------- #
def node_case(P, dtype, kw, ka, ko, *, seed=0, dev="cuda"):
    """Random operands of the full update on ``dev``: sources in
    ``dtype``, weights in [0, 1), 0/1 masks, device scalars."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    a = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)
    u = lambda *s: torch.rand(*s, generator=g, device=dev)
    return dict(x=a(P), z=a(P), g_new=a(P), g_old=a(P), v_in=a(kw, P),
                w_in=u(kw), rho_in=a(ka, P), rho_buf=a(ka, P),
                mask=(u(ka) < 0.5).float(), rho_out=a(ko, P), a_out=u(ko),
                gamma=u(()) * 0.1, w_self=u(()), a_self=u(()))


def node_flops(kw, ka, ko, *, full) -> int:
    """fp32 operations per element: recv and the ρ̃ blend 7 per in-slot,
    z½ and z' 4, ρ_out 2 per out-slot; the full update adds v (2), the
    self weight (1) and 2 per consensus slot."""
    return 7 * ka + 4 + 2 * ko + (3 + 2 * kw if full else 0)


COMMIT_KEYS = ("z", "g_new", "g_old", "rho_in", "rho_buf", "mask",
               "rho_out", "a_out", "a_self")


def compare_node(case, tol):
    """Both node kernels against their plain twins on ``case``: the max
    abs error of each; raises unless finite and within ``tol``."""
    from repro_torch.kernels.rfast_update import kernel as nk
    commit = {k: case[k] for k in COMMIT_KEYS}
    return {
        "rfast_update_node": max(
            held(g, w, tol, "rfast_update_node") for g, w in
            zip(nk.rfast_update_node(**case),
                nk.rfast_update_node_plain(**case))),
        "rfast_commit_node": max(
            held(g, w, tol, "rfast_commit_node") for g, w in
            zip(nk.rfast_commit_node(**commit),
                nk.rfast_commit_node_plain(**commit)))}


def round_grid_case(spec, p, *, seed=0, dev="cuda"):
    """``commit_grid``'s arguments at the protocol round's shape, wired
    by :func:`~repro_torch.core.protocol.round_commit_args` (the plan's
    node tables, B = N lanes, all delivered) over random (N, p) and
    (E_pad, p) state; and the bytes and operations the round needs of
    it: each distinct source row of a real edge read once, and the rows
    the round keeps (z' of every node, ρ_out'/ρ̃' of real edges) written
    once.  The pad slots' outputs, which the round drops, are not
    counted."""
    import numpy as np
    import torch
    from repro_torch.core.protocol import (ProtocolState, device_tables,
                                           round_commit_args)
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = lambda r: torch.randn(r, p, generator=g, device=dev)
    n, e = spec.n, spec.e_pad
    t = device_tables(spec)(torch.device(dev))
    state = ProtocolState(step=0, x=None, z=rows(n), g_prev=rows(n),
                          rho=rows(e), rho_buf=rows(e), mail_v=None, m=None)
    kw = round_commit_args(t, state, rows(n), t.ones)
    real_in = spec.in_a_epos[spec.in_a_val > 0]
    real_out = spec.out_a_epos[spec.out_a_val > 0]
    read = (3 * n + len(np.unique(np.concatenate([real_in, real_out])))
            + len(np.unique(real_in)))
    written = n + len(real_in) + len(real_out)
    nbytes = (read + written) * p * 4
    return kw, dict(B=n, ka=spec.ka, ko=spec.ko, Pf=p, bytes=nbytes,
                    rows_read=read, rows_written=written,
                    flops=p * (4 * n + 4 * len(real_in)
                               + 2 * len(real_out)))


def state_rel(a, b) -> float:
    """Largest norm-relative difference over x, z, ρ and ρ̃."""
    import torch
    return max(float(torch.linalg.vector_norm(u - w)
                     / torch.linalg.vector_norm(w).clamp_min(1e-30))
               for u, w in zip(a, b))


# --------------------------------------------------------------------- #
# selective scan
# --------------------------------------------------------------------- #
def sm_clock_hz() -> float:
    """The card's maximum SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def scan_inputs(Bsz, S, di, N, dtype, *, dt_rank=3, seed=0):
    """The scan's operands on the card as the model makes them: u
    N(0,1), dt = softplus(N(0,1) − 4.6), A = −(1..N) per channel, B and
    C column slices of one (B, S, dt_rank + 2N) projection, D N(0,1);
    u/dt/B/C in ``dtype``."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = lambda *s: torch.randn(*s, generator=g, device="cuda")
    u = a(Bsz, S, di).to(dtype)
    dt = torch.nn.functional.softplus(a(Bsz, S, di) - 4.6).to(dtype)
    A = -torch.arange(1, N + 1, dtype=torch.float32,
                      device="cuda").expand(di, N).contiguous()
    proj = a(Bsz, S, dt_rank + 2 * N).to(dtype)
    return (u, dt, A, proj[..., dt_rank:dt_rank + N],
            proj[..., dt_rank + N:], a(di))


def scan_bound(Bsz, S, di, N, itemsize, clock_hz):
    """The least time for the scan: the largest of its bytes at
    3.35 TB/s (each input read once, each output written once), its fp32
    operations at 67 TFLOP/s (per (b, t, d, n) dt·A, the three of the h
    update, h·C and its share of the n sum; per (b, t, d) dt·u and the
    D·u multiply-add) and its exponentials (one per (b, t, d, n)) at the
    MUFU rate.  Returns (ms, "bytes" | "operations", terms)."""
    from repro_torch.kernels.ssm_scan.kernel import ssm_scan_bytes
    nbytes = ssm_scan_bytes(Bsz, S, di, N, itemsize)
    flops, exps = Bsz * S * di * (6 * N + 3), Bsz * S * di * N
    terms = {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "fp32_ms": flops / FP32_FLOP_PER_S * 1e3,
             "mufu_ms": exps / (MUFU_PER_CLOCK_SM * H100_SMS * clock_hz)
             * 1e3}
    ms = max(terms.values())
    return ms, "bytes" if terms["bytes_ms"] == ms else "operations", dict(
        terms, bytes=nbytes, flops=flops, exps=exps)


def scan_bwd_bound(Bsz, S, di, N, itemsize, n_ckpt, clock_hz):
    """The least time for the scan's backward, as :func:`scan_bound`: its
    bytes (u, dt, B, C, gy, the ``n_ckpt`` checkpoints a batch row, gh, A
    and D read; the six gradients written) at 3.35 TB/s, its fp32
    operations (per (b, t, d, n): the rerun's dt·A and h update, 4; the
    sweep's G = gy·C + carry, gy·h, G·dt·u, G·B into du, dA·h_{t−1}, its
    product with G, that into ddt and into dA, dA·G for the next step, 13;
    the d sums of dB and dC, 2; per (b, t, d): dt·u twice, du's and ddt's
    multiply-adds and dD's, 9) at 67 TFLOP/s, and its exponentials (one
    per (b, t, d, n): the rerun's, kept for the sweep) at the MUFU rate."""
    from repro_torch.kernels.ssm_scan.backward import ssm_scan_bwd_bytes
    nbytes = ssm_scan_bwd_bytes(Bsz, S, di, N, itemsize, n_ckpt)
    flops, exps = Bsz * S * di * (19 * N + 9), Bsz * S * di * N
    terms = {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "fp32_ms": flops / FP32_FLOP_PER_S * 1e3,
             "mufu_ms": exps / (MUFU_PER_CLOCK_SM * H100_SMS * clock_hz)
             * 1e3}
    ms = max(terms.values())
    return ms, "bytes" if terms["bytes_ms"] == ms else "operations", dict(
        terms, bytes=nbytes, flops=flops, exps=exps)


def compare_scan(args, tol, what, segments=(1, 3), fwd=None) -> float:
    """The forward kernel (``fwd``, by default the checkout's
    ``ssm_scan``) against its plain twin on ``args``, unsplit and split:
    the max abs error over y, h_last and the checkpoints at the autograd
    function's spacing (y and h_last where ``fwd`` returns no
    checkpoints); raises unless finite and within ``tol``."""
    from repro_torch.kernels.ssm_scan import kernel as sk
    fwd = fwd or sk.ssm_scan
    want = sk.ssm_scan_plain(*args, ckpt_every=sk.CKPT_EVERY)
    return max(held(g, w, tol, f"{what} {n} ({nseg} segments)")
               for nseg in segments
               for g, w, n in zip(
                   fwd(*args, ckpt_every=sk.CKPT_EVERY, segments=nseg),
                   want, ("y", "h_last", "checkpoints")))


def compare_scan_bwd(args, tol, what, seed=0, bwd=None):
    """The backward kernel (``bwd``, by default the checkout's
    ``ssm_scan_bwd``) against its plain twin on ``args`` and random
    cotangents, with and without a gradient of h_last: returns (the
    largest error relative to each gradient's largest entry, the largest
    absolute error); raises unless finite and within ``tol`` relative."""
    import torch
    from repro_torch.kernels.ssm_scan import backward as sb
    from repro_torch.kernels.ssm_scan import kernel as sk
    bwd = bwd or sb.ssm_scan_bwd
    Bsz, S, di = args[0].shape
    N = args[2].shape[1]
    _, _, ckpt = sk.ssm_scan_plain(*args, ckpt_every=sk.CKPT_EVERY)
    g = torch.Generator(device="cuda").manual_seed(seed)
    gy = torch.randn(Bsz, S, di, generator=g, device="cuda")
    gh = torch.randn(Bsz, di, N, generator=g, device="cuda")
    rel = absolute = 0.0
    for h in (gh, None):
        got = bwd(*args, gy, h, ckpt, ckpt_every=sk.CKPT_EVERY)
        want = sb.ssm_scan_bwd_plain(*args, gy, h, ckpt,
                                     ckpt_every=sk.CKPT_EVERY)
        for name, a, w, x in zip(("du", "ddt", "dA", "dB", "dC", "dD"), got,
                                 want, args):
            check(a.dtype == w.dtype == x.dtype,
                  f"{what} {name}: in its input's dtype {x.dtype}")
            scale = max(1.0, float(w.float().abs().max()))
            absolute = max(absolute, float((a.float() - w.float()).abs()
                                           .max()))
            err = held(a.float() / scale, w.float() / scale, tol,
                       f"{what} {name} ({'with' if h is not None else 'no'}"
                       f" gh)")
            rel = max(rel, err)
    return rel, absolute


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
    from repro_torch.kernels.flash_attention import backward as fa_bwd
    from repro_torch.kernels.flash_attention import kernel as fa_fwd
    from repro_torch.kernels.rfast_update import dispatch, grid
    from repro_torch.kernels.rfast_update import kernel as node_k
    from repro_torch.kernels.ssm_scan import backward as scan_b
    from repro_torch.kernels.ssm_scan import kernel as scan_k
    sources = [grid.KERNEL_SOURCE, fa_fwd.KERNEL_SOURCE, fa_bwd.KERNEL_SOURCE,
               fa_fwd.TC_SOURCE, fa_bwd.TC_SOURCE, node_k.KERNEL_SOURCE,
               scan_k.KERNEL_SOURCE, scan_b.KERNEL_SOURCE]

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
    libs = _build.build(sources)
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for src in sources
             for ln in _build.build_log(src).splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    emit("build", seconds=build_s, libraries=[str(p.relative_to(ROOT))
                                              if p.is_relative_to(ROOT)
                                              else str(p)
                                              for p in libs.values()],
         ptxas=ptxas)
    # the flash kernels: registers, spills and shared memory per
    # instantiation, and tensor-core instructions in the SASS (HGMMA:
    # wgmma; HMMA: mma.sync); the bf16 forward's tiles arrive by TMA
    for kname, src, dims in (
            ("flash_fwd_3xtf32", fa_fwd.KERNEL_SOURCE, (32, 64, 128)),
            ("flash_bwd_3xtf32", fa_bwd.KERNEL_SOURCE, (32, 64, 128)),
            ("flash_fwd_tc", fa_fwd.TC_SOURCE, (64, 128)),
            ("flash_bwd_tc", fa_bwd.TC_SOURCE, (64, 128))):
        report = tc_report(kname, src, dims)
        emit("build_tc", kernel=kname, **report)
        ops = report["sass"]
        check(ops["HGMMA"] > 0 and ops["UTMALDG"] > 0
              if kname == "flash_fwd_tc" else ops["HGMMA"] + ops["HMMA"] > 0,
              f"{kname} runs on the tensor cores (and the bf16 forward's "
              f"tiles arrive by TMA): {ops}")
    # the scan's two kernels: registers, spills, static shared memory per
    # instantiation; the backward's dynamic shared memory per block
    for kname, src in (("ssm_scan", scan_k.KERNEL_SOURCE),
                       ("ssm_scan_bwd", scan_b.KERNEL_SOURCE)):
        entries = ptxas_entries(src)
        emit("build_scan", kernel=kname, ptxas=entries,
             **({"dynamic_smem_bytes": {
                 f"T={scan_k.CKPT_EVERY}, N={n}": scan_b.bwd_smem_bytes(
                     scan_k.CKPT_EVERY, n) for n in (4, 8, 16)}}
                if kname == "ssm_scan_bwd" else {}))
        check(len(entries) == 6 and all(
            e.get("spill_store_bytes", 0) == 0 for e in entries),
            f"{kname}: six instantiations (fp32, bf16 x 1, 2, 4 lanes), "
            f"none spilling: {entries}")

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
    torch.cuda.empty_cache()

    # 7. flash kernels vs plain at small odd cases --------------------------
    for case in FLASH_SMALL + FLASH_SMALL_BF16:
        for dt, fwd_tol, grad_tol in ((torch.float32, FLASH_FWD_TOL,
                                       FLASH_GRAD_TOL),
                                      (torch.bfloat16, FLASH_BF16_TOL,
                                       FLASH_BF16_TOL)):
            if dt == torch.float32 and case in FLASH_SMALL_BF16:
                continue
            err, small_launches = flash_small_case(case, dt, fwd_tol,
                                                   grad_tol)
            emit("flash_kernels", case=dict(zip(
                ("B", "H", "KV", "Sq", "Sk", "D", "causal", "window"),
                case)), dtype=str(dt), max_abs_err=err, fwd_tol=fwd_tol,
                grad_tol=grad_tol, launches=small_launches)
            fwd_name, bwd_name = flash_names(dt)
            check(small_launches == {fwd_name: 1, bwd_name: 1},
                  f"one launch of each {dt} flash kernel at {case}: "
                  f"{small_launches}")

    # 8. the flash path at full attention width -----------------------------
    dispatch.clear()
    flash_err, runs = {}, {}
    for cfg_name, cfg in FLASH_FULL:
        for dt in (torch.float32, torch.bfloat16):
            err, steps = flash_full_run(cfg, dt)
            runs[dt] = runs.get(dt, 0) + 1
            emit("flash_path", config=cfg_name, dtype=str(dt), **cfg,
                 max_abs_err=err, launches=steps)
            fwd_name, bwd_name = flash_names(dt)
            check(steps == {"forward": {fwd_name: 1},
                            "forward+backward": {fwd_name: 1,
                                                 bwd_name: 1}},
                  f"flash launches per step at {cfg_name} {dt}: {steps}")
            if cfg_name == "llama3-8b":
                flash_err.update(err)
            torch.cuda.empty_cache()
    flash_launches = dispatch.stats()["by_kernel"]
    emit("flash_path", runs={str(d): n for d, n in runs.items()},
         launches=flash_launches)
    n32, n16 = runs[torch.float32], runs[torch.bfloat16]
    check(flash_launches == {"flash_fwd_3xtf32": 2 * n32,
                             "flash_bwd_3xtf32": n32,
                             "flash_fwd_tc": 2 * n16,
                             "flash_bwd_tc": n16}, "flash path launches")

    # 9. flash timing at the llama3-8b and hymba-1.5b widths ----------------
    flash_rows = {}
    for cfg_name, cfg in FLASH_FULL[:2]:
        for dt in (torch.float32, torch.bfloat16):
            rows = flash_timing(cfg_name, cfg, dt, smi, name)
            if cfg_name == "llama3-8b":
                flash_rows.update(rows)
            torch.cuda.empty_cache()

    # 10. node kernels vs plain, then their ops at full width --------------
    for P in (1, 37, 4097, 100_001):
        for dt, tol in ((torch.float32, FP32_TOL), (torch.bfloat16,
                                                    BF16_TOL)):
            for slots in NODE_SLOTS:
                err = compare_node(node_case(P, dt, *slots), tol)
                emit("node_kernels", P=P, dtype=str(dt),
                     kw_ka_ko=list(slots), max_abs_err=err, tol=tol)
    node_case_full = node_case(p_run, torch.float32, *NODE_SLOTS[0], seed=1)
    node_err = compare_node(node_case_full, FP32_TOL)
    emit("node_kernels", P=p_run, dtype="float32",
         kw_ka_ko=list(NODE_SLOTS[0]), max_abs_err=node_err, tol=FP32_TOL)
    from repro_torch.kernels.rfast_update import ops as node_ops
    dispatch.clear()
    full = node_ops.rfast_update(**node_case_full, impl="kernel")
    commit = node_ops.rfast_commit(
        **{k: node_case_full[k] for k in COMMIT_KEYS}, impl="kernel",
        oracle=True)
    torch.cuda.synchronize()
    node_op_launches = dispatch.stats()["by_kernel"]
    op_err = max(held(g, w, FP32_TOL, "ops.rfast_update") for g, w in zip(
        full + commit, node_k.rfast_update_node_plain(**node_case_full)
        + node_k.rfast_commit_node_plain(
            **{k: node_case_full[k] for k in COMMIT_KEYS})))
    emit("node_ops", P=p_run, launches=node_op_launches, max_abs_err=op_err)
    check(node_op_launches == {"rfast_update_node": 1,
                               "rfast_commit_node": 1},
          f"one launch per node op: {node_op_launches}")
    # its ten full-width rows go before the train: phase 13 makes them anew
    del full, commit, node_case_full
    torch.cuda.empty_cache()

    # 11. sync train at full width -------------------------------------------
    sync_launches = {}
    for tag, extra in SYNC_RUNS:
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        dispatch.clear()
        t0 = time.perf_counter()
        sres = train.main(SYNC_ARGS + extra)
        torch.cuda.synchronize()
        swall = time.perf_counter() - t0
        sync_launches[tag] = dispatch.stats()["by_kernel"]
        emit("sync_train", run=tag, args=extra, p=sres["p"],
             rounds=sres["rounds"], losses=sres["losses"],
             state_gb=sres["state_bytes"] / 1e9,
             max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
             memory_gb={k: {m: b / 1e9 for m, b in v.items()}
                        for k, v in sres["memory"].items()},
             resident_before_gb=resident / 1e9,
             wall_s=swall, launches=sync_launches[tag],
             lemma3_rel=sres["mass_rel"], device=name, nvidia_smi=smi)
        check(all(math.isfinite(v) for v in sres["losses"]),
              f"{tag}: finite losses")
        check(sync_launches[tag] == {"commit_grid": sres["rounds"]},
              f"{tag}: one commit_grid launch per round, no other: "
              f"{sync_launches[tag]}")
        check(sres["mass_rel"] <= 1e-4, f"{tag}: Lemma-3 residual <= 1e-4")
        torch.cuda.empty_cache()

    # 12. round routes at two layers of full width ---------------------------
    from repro_torch.core.protocol import ProtocolState
    from repro_torch.core.runtime import make_rfast_round
    import numpy as np
    plan4, st0, grad_fn, batches = train.sync_setup(
        cfg2, 4, "binary_tree", batch_per_node=4, seq=128, seed=0,
        device="cuda", robust=True, momentum=0.9)
    mrng = np.random.default_rng(1)
    masks = [torch.from_numpy((mrng.uniform(size=plan4.e_pad) >= 0.3)
                              .astype(np.float32)).cuda() for _ in range(4)]
    route_finals, route_launches = {}, {}
    for rname, impl, oracle in (("kernel", "kernel", False),
                                ("oracle", "kernel", True),
                                ("plain", "plain", False)):
        st = ProtocolState(st0.step, *(None if t is None else t.clone()
                                       for t in st0[1:]))
        rf = make_rfast_round(plan4, grad_fn, gamma=3e-3, robust=True,
                              momentum=0.9, impl=impl, oracle=oracle,
                              donate=True)
        dispatch.clear()
        for r, mk in enumerate(masks):
            st, _ = rf(st, batches(r), None, mk)
        torch.cuda.synchronize()
        route_launches[rname] = dispatch.stats()["by_kernel"]
        route_finals[rname] = (st.x, st.z, st.rho, st.rho_buf)
        del st
        torch.cuda.empty_cache()
    route_rel = {r: state_rel(route_finals[r], route_finals["plain"])
                 for r in ("kernel", "oracle")}
    emit("round_routes", n_layers=2, p=st0.x.shape[1], rounds=len(masks),
         rel_vs_plain=route_rel, tol=ROUTE_TOL, launches=route_launches)
    check(max(route_rel.values()) <= ROUTE_TOL,
          f"round routes agree to {ROUTE_TOL}")
    check(route_launches == {
        "kernel": {"commit_grid": len(masks)},
        "oracle": {"rfast_commit_node": 4 * len(masks)},
        "plain": {}}, f"round route launches: {route_launches}")
    del route_finals, st0
    torch.cuda.empty_cache()

    # 13. node kernel timing at full width, commit_grid at the round shape --
    node_case_full = node_case(p_run, torch.float32, *NODE_SLOTS[0], seed=1)
    commit_full = {k: node_case_full[k] for k in COMMIT_KEYS}
    node_rows = {
        "rfast_update_node": dict(
            ms=cuda_ms(lambda: node_k.rfast_update_node(**node_case_full),
                       reps=10),
            plain_ms=cuda_ms(lambda: node_k.rfast_update_node_plain(
                **node_case_full), reps=5),
            nbytes=node_k.rfast_update_node_bytes(*NODE_SLOTS[0], p_run, 4),
            flops=p_run * node_flops(*NODE_SLOTS[0], full=True)),
        "rfast_commit_node": dict(
            ms=cuda_ms(lambda: node_k.rfast_commit_node(**commit_full),
                       reps=10),
            plain_ms=cuda_ms(lambda: node_k.rfast_commit_node_plain(
                **commit_full), reps=5),
            nbytes=node_k.rfast_commit_node_bytes(*NODE_SLOTS[0][1:], p_run,
                                                  4),
            flops=p_run * node_flops(*NODE_SLOTS[0], full=False))}
    for kname, row in node_rows.items():
        row["bound_ms"], row["bound_by"] = bound(row["flops"], row["nbytes"],
                                                 FP32_FLOP_PER_S)
        emit("node_timing", kernel=kname, P=p_run, kw_ka_ko=list(
            NODE_SLOTS[0]), bytes=row["nbytes"], flops=row["flops"],
            achieved_gb_s=row["nbytes"] / row["ms"] / 1e6,
            bound_share=row["bound_ms"] / row["ms"], library_ms=None,
            device=name, nvidia_smi=smi,
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                   "bound_by")})
    del node_case_full, commit_full
    torch.cuda.empty_cache()
    kw, rshape = round_grid_case(plan4, p_run)
    round_ms = cuda_ms(lambda: grid.commit_grid(**kw), reps=10)
    round_plain_ms = cuda_ms(lambda: grid.commit_grid_plain(**kw), reps=5)
    round_bound, round_by = bound(rshape["flops"], rshape["bytes"],
                                  FP32_FLOP_PER_S)
    emit("round_timing", kernel="commit_grid", ms=round_ms,
         plain_ms=round_plain_ms, bytes=rshape["bytes"],
         formula_bytes=grid.commit_grid_bytes(rshape["B"], rshape["ka"],
                                              rshape["ko"], p_run, 4),
         flops=rshape["flops"], bound_ms=round_bound, bound_by=round_by,
         achieved_gb_s=rshape["bytes"] / round_ms / 1e6,
         bound_share=round_bound / round_ms, library_ms=None, device=name,
         nvidia_smi=smi, **{k: rshape[k] for k in (
             "B", "ka", "ko", "Pf", "rows_read", "rows_written")})
    del kw
    torch.cuda.empty_cache()

    # 14. the scan kernels vs their plain twins, and the autograd function
    from repro_torch.kernels.ssm_scan.ops import SelectiveScanFn
    from repro_torch.kernels.ssm_scan.ref import selective_scan_ref
    for case in SCAN_SMALL + [SCAN_TRAIN[1]]:
        for dt, tol in ((torch.float32, SCAN_FP32_TOL),
                        (torch.bfloat16, SCAN_BF16_TOL)):
            sargs = scan_inputs(*case, dt)
            err = compare_scan(sargs, tol, f"ssm_scan {case}")
            rel, _ = compare_scan_bwd(sargs, tol, f"ssm_scan_bwd {case}")
            emit("scan_kernel", case=dict(zip(("B", "S", "di", "N"), case)),
                 dtype=str(dt), max_abs_err=err, bwd_max_rel_err=rel,
                 tol=tol)
    sargs = scan_inputs(*SCAN_TRAIN[1], torch.float32, dt_rank=SCAN_TRAIN[2],
                        seed=1)
    scan_err = compare_scan(sargs, SCAN_FP32_TOL,
                            "ssm_scan at the train shape")
    scan_bwd_rel, scan_bwd_err = compare_scan_bwd(
        sargs, SCAN_FP32_TOL, "ssm_scan_bwd at the train shape", seed=4)
    del sargs
    leaves = [t.detach().requires_grad_() for t in scan_inputs(
        *SCAN_TRAIN[1], torch.float32, dt_rank=SCAN_TRAIN[2], seed=2)]
    gg = torch.Generator(device="cuda").manual_seed(3)
    gy = torch.randn(leaves[0].shape, generator=gg, device="cuda")
    gh = torch.randn(leaves[0].shape[0], *leaves[2].shape, generator=gg,
                     device="cuda")
    scan_loss = lambda y, h: (y * gy).sum() + (h * gh).sum()
    dispatch.clear()
    got = torch.autograd.grad(scan_loss(*SelectiveScanFn.apply(*leaves)),
                              leaves)
    fn_launches = dispatch.stats()["by_kernel"]
    want = torch.autograd.grad(scan_loss(*selective_scan_ref(*leaves)),
                               leaves)
    grad_rel = {n: float(torch.linalg.vector_norm(g - w)
                         / torch.linalg.vector_norm(w).clamp_min(1e-30))
                for n, g, w in zip(("u", "dt", "A", "B", "C", "D"), got, want)}
    emit("scan_grad", case=dict(zip(("B", "S", "di", "N"), SCAN_TRAIN[1])),
         y_max_abs_err=scan_err, bwd_max_abs_err=scan_bwd_err,
         bwd_max_rel_err=scan_bwd_rel, grad_rel=grad_rel,
         launches=fn_launches, tol=SCAN_GRAD_TOL)
    check(fn_launches == {"ssm_scan": 1, "ssm_scan_bwd": 1},
          f"SelectiveScanFn runs one ssm_scan and one ssm_scan_bwd: "
          f"{fn_launches}")
    check(all(math.isfinite(v) and v <= SCAN_GRAD_TOL
              for v in grad_rel.values()),
          f"SelectiveScanFn gradients within {SCAN_GRAD_TOL}: {grad_rel}")
    del leaves, got, want, gy, gh
    torch.cuda.empty_cache()

    # 15. hymba-1.5b sync train at full width, 2 layers --------------------
    cfg_h = dataclasses.replace(get_config("hymba-1.5b"),
                                n_layers=HYMBA_LAYERS)
    hymba_launches = {}
    for tag, extra in SYNC_RUNS:
        args = train.parse_args(HYMBA_ARGS + extra)
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        dispatch.clear()
        t0 = time.perf_counter()
        hres = train._train_sync(args, cfg_h, torch.device("cuda"))
        torch.cuda.synchronize()
        hwall = time.perf_counter() - t0
        hymba_launches[tag] = dispatch.stats()["by_kernel"]
        grads = args.nodes * (1 + hres["rounds"])
        emit("hymba_sync_train", run=tag, args=extra, n_layers=HYMBA_LAYERS,
             p=hres["p"], rounds=hres["rounds"], losses=hres["losses"],
             state_gb=hres["state_bytes"] / 1e9,
             max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
             memory_gb={k: {m: b / 1e9 for m, b in v.items()}
                        for k, v in hres["memory"].items()},
             resident_before_gb=resident / 1e9, wall_s=hwall,
             gradients=grads, launches=hymba_launches[tag],
             lemma3_rel=hres["mass_rel"], device=name, nvidia_smi=smi)
        check(all(math.isfinite(v) for v in hres["losses"]),
              f"hymba {tag}: finite losses")
        check(hymba_launches[tag] == {"ssm_scan": HYMBA_LAYERS * grads,
                                      "ssm_scan_bwd": HYMBA_LAYERS * grads,
                                      "commit_grid": hres["rounds"]},
              f"hymba {tag}: ssm_scan and ssm_scan_bwd once per layer per "
              f"gradient and commit_grid once per round: "
              f"{hymba_launches[tag]}")
        check(hres["mass_rel"] <= 1e-4, f"hymba {tag}: Lemma-3 <= 1e-4")
        torch.cuda.empty_cache()

    # 16. scan timing at the train shape and at two op widths --------------
    clock_hz = sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    every = scan_k.CKPT_EVERY
    scan_rows, bwd_rows = {}, {}
    for sname, shape, dt_rank in SCAN_TIMED:
        sargs = scan_inputs(*shape, torch.float32, dt_rank=dt_rank, seed=5)
        Bsz, S, di, N = shape
        long = S > 1024
        rule = scan_k.scan_segments(Bsz, S, di, N, sms)
        split = {nseg: graph_ms(lambda: scan_k.ssm_scan(*sargs,
                                                        segments=nseg))
                 for nseg in sorted({1, rule})}
        row = dict(
            ms=split[rule],
            plain_ms=cuda_ms(lambda: scan_k.ssm_scan_plain(*sargs),
                             reps=2 if long else 5, warmup=1 if long else 2))
        row["bound_ms"], row["bound_by"], terms = scan_bound(*shape, 4,
                                                             clock_hz)
        scan_rows[sname] = row
        more = {
            # one call as a caller pays it, the wrapper's host work included
            "call_ms": cuda_ms(lambda: scan_k.ssm_scan(*sargs), reps=20),
            # as the autograd function runs it: with the checkpoints
            "ckpt_ms": graph_ms(lambda: scan_k.ssm_scan(
                *sargs, ckpt_every=every)),
            "segments": rule, "ms_by_segments": split}
        _, _, ckpt = scan_k.ssm_scan(*sargs, ckpt_every=every)
        gg = torch.Generator(device="cuda").manual_seed(6)
        bargs = (*sargs, torch.randn(Bsz, S, di, generator=gg, device="cuda"),
                 torch.randn(Bsz, di, N, generator=gg, device="cuda"), ckpt)
        n_ck = scan_k.n_checkpoints(S, every)
        brow = dict(
            ms=graph_ms(lambda: scan_b.ssm_scan_bwd(*bargs,
                                                    ckpt_every=every)),
            # the twin once at the op widths (two Python loops over S)
            plain_ms=cuda_ms(lambda: scan_b.ssm_scan_bwd_plain(
                *bargs, ckpt_every=every), reps=1 if long else 3,
                warmup=0 if long else 1))
        # the gradient's own bound, its checkpoints at the spacing the least
        # work needs; and as the kernel reads them, at CKPT_EVERY
        brow["bound_ms"], brow["bound_by"], bterms = scan_bwd_bound(
            *shape, 4, scan_k.n_checkpoints(S, SCAN_BOUND_CKPT_EVERY),
            clock_hz)
        at_every, _, every_terms = scan_bwd_bound(*shape, 4, n_ck, clock_hz)
        bwd_rows[sname] = brow
        # one SSM layer's scan in a gradient: both kernels through autograd
        # (at hymba's op width the forward splits: the shape a train at
        # --batch-per-node 1 --seq 4096 gives the scan)
        leaves = [t.detach().requires_grad_() for t in sargs]
        more["fwd_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
            SelectiveScanFn.apply(*leaves)[0].sum(), leaves),
            reps=5 if long else 10)
        del leaves
        emit("scan_timing", kernel="ssm_scan", shape=sname, **more,
             case=dict(zip(("B", "S", "di", "N"), shape)), dtype="float32",
             bound_share=row["bound_ms"] / row["ms"],
             achieved_gb_s=terms["bytes"] / row["ms"] / 1e6,
             sm_clock_max_mhz=clock_hz / 1e6, library_ms=None,
             device=name, nvidia_smi=smi, **row, **terms)
        emit("scan_timing", kernel="ssm_scan_bwd", shape=sname,
             case=dict(zip(("B", "S", "di", "N"), shape)), dtype="float32",
             ckpt_every=every, bound_ckpt_every=SCAN_BOUND_CKPT_EVERY,
             bound_share=brow["bound_ms"] / brow["ms"],
             bound_ms_at_ckpt_every=at_every,
             bound_share_at_ckpt_every=at_every / brow["ms"],
             bytes_at_ckpt_every=every_terms["bytes"],
             achieved_gb_s=every_terms["bytes"] / brow["ms"] / 1e6,
             library_ms=None, device=name, nvidia_smi=smi, **brow, **bterms)
        del sargs, bargs, ckpt
    torch.cuda.empty_cache()

    kernels = [{
        "name": "commit_grid", "route": "cuda",
        "source": str(grid.KERNEL_SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/rfast_update/grid.py:192",
        "launches": launches.get("commit_grid", 0)
        + sum(v.get("commit_grid", 0) for v in sync_launches.values())
        + sum(v.get("commit_grid", 0) for v in hymba_launches.values()),
        "launches_by_path": {"async_train": launches.get("commit_grid", 0),
                             **{f"sync_train_{t}": v.get("commit_grid", 0)
                                for t, v in sync_launches.items()},
                             **{f"hymba_sync_train_{t}":
                                v.get("commit_grid", 0)
                                for t, v in hymba_launches.items()}},
        "max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "round_shape": {"ms": round_ms, "plain_ms": round_plain_ms,
                        "bound_ms": round_bound}}]
    for kname, src, rep in (
            ("flash_fwd_3xtf32", fa_fwd.KERNEL_SOURCE,
             "src/repro/kernels/flash_attention/kernel.py:85"),
            ("flash_bwd_3xtf32", fa_bwd.KERNEL_SOURCE,
             "src/repro/kernels/flash_attention/backward.py:135, "
             "src/repro/kernels/flash_attention/backward.py:156"),
            ("flash_fwd_tc", fa_fwd.TC_SOURCE,
             "src/repro/kernels/flash_attention/kernel.py:85"),
            ("flash_bwd_tc", fa_bwd.TC_SOURCE,
             "src/repro/kernels/flash_attention/backward.py:135, "
             "src/repro/kernels/flash_attention/backward.py:156")):
        kernels.append({"name": kname, "route": "cuda",
                        "source": str(src.relative_to(ROOT)),
                        "replaces": rep,
                        "launches": flash_launches.get(kname, 0),
                        "max_abs_err": flash_err[kname],
                        **flash_rows[kname]})
    for kname, rep, nl in (
            ("rfast_update_node",
             "src/repro/kernels/rfast_update/kernel.py:143",
             node_op_launches.get("rfast_update_node", 0)),
            ("rfast_commit_node",
             "src/repro/kernels/rfast_update/kernel.py:113",
             route_launches["oracle"].get("rfast_commit_node", 0))):
        row = node_rows[kname]
        kernels.append({"name": kname, "route": "cuda",
                        "source": str(node_k.KERNEL_SOURCE.relative_to(ROOT)),
                        "replaces": rep, "launches": nl,
                        "max_abs_err": node_err[kname],
                        **{k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                               "bound_by")},
                        "library_ms": None})
    train_row = scan_rows[SCAN_TRAIN[0]]
    kernels.append({
        "name": "ssm_scan", "route": "cuda",
        "source": str(scan_k.KERNEL_SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:62",
        "launches": sum(v.get("ssm_scan", 0)
                        for v in hymba_launches.values()),
        "launches_by_path": {f"hymba_sync_train_{t}": v.get("ssm_scan", 0)
                             for t, v in hymba_launches.items()},
        "max_abs_err": scan_err, **train_row, "library_ms": None,
        "op_widths": {k: v for k, v in scan_rows.items()
                      if k != SCAN_TRAIN[0]}})
    kernels.append({
        "name": "ssm_scan_bwd", "route": "cuda",
        "source": str(scan_b.KERNEL_SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/models/ssm.py:42 (the gradient of "
                    "selective_scan_ref: lax.scan autodiff, no Pallas "
                    "kernel)",
        "launches": sum(v.get("ssm_scan_bwd", 0)
                        for v in hymba_launches.values()),
        "launches_by_path": {f"hymba_sync_train_{t}":
                             v.get("ssm_scan_bwd", 0)
                             for t, v in hymba_launches.items()},
        "max_abs_err": scan_bwd_err, **bwd_rows[SCAN_TRAIN[0]],
        "library_ms": None,
        "op_widths": {k: v for k, v in bwd_rows.items()
                      if k != SCAN_TRAIN[0]}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
