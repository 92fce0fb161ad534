"""The traced run's reading of the profiler.

``torch.profiler`` records the window (CPU and CUDA activity); the trace
is written to a temporary file, read once into a :class:`Trace` and
deleted.  The window is the benchmark's span ``perfbench.window``; the
gradients are its spans ``perfbench.grad``.  Device time is every kernel,
copy and fill on the card; a device operation belongs to a gradient when
the host launched it inside that gradient's span.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

__all__ = ["Trace", "read_profile"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SHORT_GAP_US = 50.0


class Trace:
    """A window's device time: ``window_s``, ``busy_s`` (the union of
    device operations), ``by_name`` ({name: (seconds, count)}), the
    gradients' spans (``grad_spans``, wall seconds each) and their device
    seconds (``grad_device_s``), and idle time by what the host was doing
    (``idle_by_host``: {label: seconds})."""

    def __init__(self):
        self.window_s = 0.0
        self.busy_s = 0.0
        self.by_name: dict[str, list] = {}
        self.grad_spans: list[float] = []
        self.grad_device_s = 0.0
        self.idle_by_host: dict[str, float] = {}

    def kernel(self, part: str) -> tuple[float, int]:
        """(seconds, launches) of the device operations whose name holds
        ``part``."""
        s = n = 0
        for name, (sec, cnt) in self.by_name.items():
            if part in name:
                s, n = s + sec, n + cnt
        return s, n

    def breakdown(self) -> dict:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], v[0]] for n, v in top],
                "idle_gaps": [[n[:120], v] for n, v in gaps]}


def read_profile(prof) -> Trace:
    """Export ``prof``'s trace to a temporary file, read it, delete it."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return summarize(events)


def _union(intervals):
    """Merged [start, end) intervals of a sorted list."""
    out = []
    for a, b in intervals:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: list[dict]) -> Trace:
    """Reduce chrome-trace events (times in µs) to a :class:`Trace`."""
    t = Trace()
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == "perfbench.window"]
    if not win:
        return t
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    t.window_s = (w1 - w0) * 1e-6
    launch = {}
    host = defaultdict(list)
    dev, grads = [], []
    for e in events:
        cat, ph = e.get("cat"), e.get("ph")
        if ph != "X":
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            a, b = max(ts, w0), min(ts + dur, w1)
            if b > a:
                dev.append((a, b, e.get("name", "?"),
                            e.get("args", {}).get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launch[c] = ts
        elif cat in ("cpu_op", "user_annotation"):
            host[e.get("tid")].append((ts, ts + dur, e.get("name", "?")))
            if e.get("name") == "perfbench.grad" and w0 <= ts < w1:
                grads.append((ts, min(ts + dur, w1)))
    dev.sort()
    by = defaultdict(lambda: [0.0, 0])
    for a, b, name, _ in dev:
        by[name][0] += (b - a) * 1e-6
        by[name][1] += 1
    t.by_name = dict(by)
    busy = _union([[a, b] for a, b, _, _ in dev])
    t.busy_s = sum(b - a for a, b in busy) * 1e-6
    grads.sort()
    t.grad_spans = [(b - a) * 1e-6 for a, b in grads]
    starts = [a for a, _ in grads]
    for a, b, _, c in dev:
        lt = launch.get(c)
        if lt is None:
            continue
        j = bisect.bisect_right(starts, lt) - 1
        if j >= 0 and lt <= grads[j][1]:
            t.grad_device_s += (b - a) * 1e-6
    t.idle_by_host = _idle_by_host(busy, w0, w1, host)
    return t


def _innermost(ops, points):
    """The innermost of the nested host operations ``ops`` (start, end,
    name) running at each of the sorted ``points`` (None where none
    runs)."""
    ops = sorted(ops, key=lambda o: (o[0], -o[1]))
    out, stack, i = [], [], 0
    for a in points:
        while i < len(ops) and ops[i][0] <= a:
            while stack and stack[-1][1] < ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] < a:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def _idle_by_host(busy, w0, w1, host) -> dict[str, float]:
    """Idle seconds of the card in the window, each gap of at least
    ``SHORT_GAP_US`` labelled by what the host was doing at its start:
    the innermost operation of the thread that holds the window's span,
    or, where that is one of the benchmark's own spans, of another thread
    (the autograd engine's) that is inside an operation then.  Shorter
    gaps are summed under one label."""
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    out = defaultdict(float)
    long_gaps = []
    for a, b in gaps:
        if b - a < SHORT_GAP_US:
            out[f"gaps under {SHORT_GAP_US:.0f} us"] += (b - a) * 1e-6
        else:
            long_gaps.append((a, b))
    if not long_gaps:
        return dict(out)
    main = next((tid for tid, ops in host.items()
                 if any(o[2] == "perfbench.window" for o in ops)), None)
    points = [a for a, _ in long_gaps]
    labels = {tid: _innermost(ops, points) for tid, ops in host.items()}
    for j, (a, b) in enumerate(long_gaps):
        label = labels[main][j] if main in labels else None
        if label is None or label.startswith("perfbench."):
            other = [labels[t][j] for t in labels
                     if t != main and labels[t][j] is not None]
            label = other[0] if other else label
        out[label or "host outside any op"] += (b - a) * 1e-6
    return dict(out)
