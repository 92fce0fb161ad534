"""The program's spans in a traced window (``bench.spans``): self time,
the backward's thread, idle gaps and host syncs on a hand-built trace,
the per-layer numbers read from them, the harness's own readings left
as they were, and a traced CPU run through ``trace_spans.py``."""
import json
import sys
import types
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

import trace_spans  # noqa: E402
from bench import cell, spans, trace  # noqa: E402
from test_perfbench_runs import CELLS, TINY_LIMITS, shrink  # noqa: E402

MAIN, AUTOGRAD = 1, 2


def _ev(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _launch(ts, c, tid=MAIN, name="cudaLaunchKernel"):
    return _ev("cuda_runtime", name, ts, 2, tid=tid, correlation=c)


# A sync round in a 1000 µs window: mix, one gradient (forward, backward
# from the autograd thread), commit, scatter, then the benchmark's feed.
HARNESS = [
    _ev("user_annotation", "perfbench.window", 0, 1000),
    _ev("user_annotation", "perfbench.grad", 115, 475),
    _ev("cpu_op", "aten::copy_", 795, 90),
    _ev("cpu_op", "MmBackward0", 320, 170, tid=AUTOGRAD),
    _launch(30, 1), _ev("kernel", "mix_kernel", 40, 20, correlation=1),
    _launch(150, 2), _ev("kernel", "gemm", 160, 100, correlation=2),
    _launch(160, 9),
    _ev("kernel", "ssm_scan_fwd_kernel", 170, 10, correlation=9),
    _ev("cuda_runtime", "cudaStreamSynchronize", 200, 5),
    _launch(210, 4, name="cudaMemcpyAsync"),
    _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 212, 2,
        correlation=4),
    _launch(320, 3, tid=AUTOGRAD),
    _ev("kernel", "gemm_bwd", 330, 150, correlation=3),
    _launch(330, 10, tid=AUTOGRAD),
    _ev("kernel", "ssm_scan_bwd_kernel", 340, 10, correlation=10),
    _ev("cuda_runtime", "cudaMemcpy", 400, 5, tid=AUTOGRAD),
    _launch(595, 5), _ev("gpu_memcpy", "Memcpy DtoD", 600, 2,
                         correlation=5),
    _launch(620, 6), _ev("kernel", "commit_grid_kernel", 650, 40,
                         correlation=6),
    _launch(715, 7), _ev("gpu_memcpy", "Memcpy DtoD", 720, 80,
                         correlation=7),
    _launch(940, 8), _ev("kernel", "feed_kernel", 950, 40, correlation=8),
]
PROGRAM = [
    _ev("user_annotation", "rfast.round", 10, 890),
    _ev("user_annotation", "rfast.mix", 20, 80),
    _ev("user_annotation", "rfast.grad", 110, 490),
    _ev("user_annotation", "rfast.grad.fwd", 120, 180),
    _ev("user_annotation", "rfast.grad.bwd", 310, 270),
    _ev("user_annotation", "rfast.commit", 610, 90),
    _ev("user_annotation", "rfast.scatter", 710, 180),
]
BUSY_US = 20 + 100 + 150 + 2 + 40 + 80 + 40


def test_program_spans_by_hand():
    sp = spans.program_spans(HARNESS + PROGRAM)
    assert {n: v["count"] for n, v in sp.items()} == {
        n: 1 for n in spans.GRAD + ("rfast.round", "rfast.mix",
                                    "rfast.commit", "rfast.scatter")}
    dev = {n: v["device_s"] * 1e6 for n, v in sp.items()}
    # self time: the gradient's own is the copy after its benchmark span;
    # the backward's kernels came from the autograd thread
    assert dev == pytest.approx({
        "rfast.round": 0, "rfast.mix": 20, "rfast.grad": 2,
        "rfast.grad.fwd": 100 + 10 + 2, "rfast.grad.bwd": 150 + 10,
        "rfast.commit": 40, "rfast.scatter": 80})
    # each gap where it starts: 0–40 and 990–1000 fall in no span
    idle = {n: v["idle_s"] * 1e6 for n, v in sp.items()}
    assert idle == pytest.approx({
        "rfast.round": 48, "rfast.mix": 100, "rfast.grad": 0,
        "rfast.grad.fwd": 70, "rfast.grad.bwd": 120, "rfast.commit": 30,
        "rfast.scatter": 150})
    # a stream sync and a blocking copy; the async copy is not one
    assert {n: v["syncs"] for n, v in sp.items() if v["syncs"]} == {
        "rfast.grad.fwd": 1, "rfast.grad.bwd": 1}


def test_readings_by_hand():
    t = trace.summarize(HARNESS + PROGRAM)
    assert t.busy_s == pytest.approx(BUSY_US * 1e-6)
    r = spans.readings(spans.program_spans(HARNESS + PROGRAM), t.window_s,
                       t.busy_s)
    assert r == pytest.approx({
        "grad_fwd_ms": 0.112, "grad_bwd_ms": 0.160, "grad_host_syncs": 2.0,
        "engine_mix_pct": 2.0, "engine_commit_pct": 4.0,
        "engine_scatter_pct": 8.0, "idle_in_grad_pct": 19.0,
        "idle_in_engine_pct": 32.8})
    assert r["idle_in_grad_pct"] + r["idle_in_engine_pct"] <= \
        100 * (1 - t.busy_s / t.window_s)


def test_nothing_to_read_reads_nothing():
    assert spans.program_spans(HARNESS) == {}
    assert spans.program_spans(PROGRAM) == {}      # no window
    assert spans.readings({}, 1e-3, 5e-4) == {}
    # a span on another thread than the window's is not the program's
    other = [dict(e, tid=AUTOGRAD) for e in PROGRAM]
    assert spans.program_spans(HARNESS + other) == {}
    # no device record (a CPU run): counts only
    sp = spans.program_spans([e for e in HARNESS + PROGRAM
                              if e["cat"] not in trace.DEVICE_CATS])
    assert spans.readings(sp, 1e-3, 0.0) == {"grad_host_syncs": 2.0}


@pytest.mark.parametrize("name", ["olmo1b-l2.sync.b4s2048",
                                  "hymba15b-l2.async.n3.b4s512"])
def test_harness_readings_unchanged_by_program_spans(name):
    """The trace's device records and every per-layer metric of the
    harness read the same with and without the program's spans; only
    the labels of idle gaps in no operation but a program span move."""
    a = trace.summarize(HARNESS)
    b = trace.summarize(HARNESS + PROGRAM)
    for f in ("window_s", "busy_s", "by_name", "grad_spans",
              "grad_device_s"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.breakdown()["device_ops"] == b.breakdown()["device_ops"]
    c = cell.load_cell(name, ROOT)
    win = types.SimpleNamespace(seconds=1e-3, units=1, grads=1,
                                commit_launches=1, commit_rows=31)
    e2e = {m["name"] for m in c["manifest"]["end_to_end"]
           if cell._applies(m, name, None)}
    read = 0
    for m in c["manifest"]["per_layer"]:
        if not cell._applies(m, name, e2e):
            continue
        ctx = [types.SimpleNamespace(trace=t, window=win,
                                     cfg=c["config"]["model"],
                                     traffic=c["traffic"], p=1 << 20)
               for t in (a, b)]
        fn = cell.reader(m["name"])
        va, vb = fn(ctx[0]), fn(ctx[1])
        assert va == vb, m["name"]
        read += va is not None
    assert read >= 6
    assert sum(a.idle_by_host.values()) == \
        pytest.approx(sum(b.idle_by_host.values()))
    assert a.idle_by_host["aten::copy_"] == b.idle_by_host["aten::copy_"]
    assert b.idle_by_host["rfast.mix"] == pytest.approx(100e-6)
    assert b.idle_by_host["rfast.grad.bwd"] == pytest.approx(120e-6)
    assert a.idle_by_host["MmBackward0"] == pytest.approx(120e-6)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS)
def test_traced_cpu_run_counts_the_program_spans(name, one_thread,
                                                 monkeypatch):
    load = cell.load_cell
    monkeypatch.setattr(cell, "load_cell", lambda n, r: dict(
        load(n, r), limits=TINY_LIMITS))
    out = trace_spans.traced(name, 2**33 + 11, 0.3, root=ROOT,
                             device="cpu", shrink=shrink(name))
    json.dumps(out, allow_nan=False)
    assert out["correct"]
    sp, win = out["spans"], out["window"]
    assert win["grads"] > 0
    # every gradient of the window, each with its forward and backward
    for n in spans.GRAD:
        assert sp[n]["count"] == win["grads"], n
    unit = "rfast.round" if ".sync." in name else "rfast.wave"
    waves = sp[unit]["count"]
    if unit == "rfast.round":
        assert waves == win["units"]
    else:       # a wave is one or more events
        assert 0 < waves <= win["units"]
    for n in ("rfast.mix", "rfast.commit", "rfast.scatter"):
        assert sp[n]["count"] == waves, n
    # the CPU has no device records and waits on no card
    assert out["busy_s"] == 0
    assert out["readings"] == {"grad_host_syncs": 0.0}
    assert "outside_grad_pct" in out["metrics"]
    assert cell.program.run_sync.__name__ == "run_sync"
    assert trace.summarize.__name__ == "summarize"
