"""The program's own spans in a traced window.

The port marks the phases of its training engines with ``rfast.*`` spans
(``repro_torch.spans``): a round or a wave, its mix, each node's gradient
with its forward and backward, the commit and the row scatter.  They are
opened on the thread that holds the benchmark's ``perfbench.window``; the
backward's kernels are launched from the autograd engine's thread while
that thread waits inside ``rfast.grad.bwd``.  So every reading here takes
the innermost ``rfast.*`` span of the window's thread at a moment, which
makes each span's numbers its self time:

- ``count``: the spans that start in the window;
- ``device_s``: device seconds (in the window) of every kernel, copy and
  fill whose launching runtime call, on any thread, fell in the span;
- ``idle_s``: the card's idle seconds in the window, every gap counted
  where it starts;
- ``syncs``: the runtime calls in the span that make the host wait for
  the card (:data:`SYNC_CALLS`; ``cudaMemcpyAsync`` is not one).

:func:`readings` turns them into eight per-layer numbers.  The harness's
:class:`bench.trace.Trace` does not keep the events this needs, so
``tools/trace_spans.py`` runs a cell and reads them here.
"""
from __future__ import annotations

from .trace import DEVICE_CATS, _innermost, _union

__all__ = ["PREFIX", "SYNC_CALLS", "GRAD", "ENGINE", "program_spans",
           "readings"]

PREFIX = "rfast."
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})
GRAD = ("rfast.grad", "rfast.grad.fwd", "rfast.grad.bwd")
ENGINE = ("rfast.round", "rfast.wave", "rfast.mix", "rfast.commit",
          "rfast.scatter")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def _at(spans, points):
    """The innermost of ``spans`` (start, end, name) at each of
    ``points``, in any order (None where no span runs)."""
    order = sorted(range(len(points)), key=points.__getitem__)
    out = [None] * len(points)
    for j, name in zip(order, _innermost(spans, [points[j] for j in order])):
        out[j] = name
    return out


def program_spans(events: list[dict]) -> dict:
    """``{name: {count, device_s, idle_s, syncs}}`` of every ``rfast.*``
    span on the window's thread, from chrome-trace ``events`` (times in
    µs); ``{}`` without a window or without such spans."""
    X = [e for e in events if e.get("ph") == "X"]
    win = next((e for e in X if e.get("cat") == "user_annotation"
                and e.get("name") == "perfbench.window"), None)
    if win is None:
        return {}
    w0 = float(win["ts"])
    w1 = w0 + float(win["dur"])
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
              e["name"]) for e in X
             if e.get("cat") == "user_annotation"
             and e.get("tid") == win.get("tid")
             and e.get("name", "").startswith(PREFIX)]
    out = {name: {"count": 0, "device_s": 0.0, "idle_s": 0.0, "syncs": 0}
           for _, _, name in spans}
    for a, _, name in spans:
        out[name]["count"] += w0 <= a < w1
    if not out:
        return out

    launch, dev, syncs = {}, [], []
    for e in X:
        ts, cat = float(e["ts"]), e.get("cat")
        if cat in DEVICE_CATS:
            a, b = max(ts, w0), min(ts + float(e.get("dur", 0.0)), w1)
            if b > a:
                dev.append((a, b, e.get("args", {}).get("correlation")))
        elif cat in RUNTIME_CATS:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launch[c] = ts
            if e.get("name") in SYNC_CALLS and w0 <= ts < w1:
                syncs.append(ts)

    ops = [(b - a, launch[c]) for a, b, c in dev if c in launch]
    for (us, _), name in zip(ops, _at(spans, [t for _, t in ops])):
        if name is not None:
            out[name]["device_s"] += us * 1e-6

    gaps, prev = [], w0
    for a, b in _union(sorted([a, b] for a, b, _ in dev)) + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    for (a, b), name in zip(gaps, _at(spans, [a for a, _ in gaps])):
        if name is not None:
            out[name]["idle_s"] += (b - a) * 1e-6

    for name in _at(spans, syncs):
        if name is not None:
            out[name]["syncs"] += 1
    return out


def readings(spans: dict, window_s: float, busy_s: float) -> dict:
    """The per-layer numbers of a traced window's program ``spans`` (from
    :func:`program_spans`) with its ``window_s`` and ``busy_s``
    (:class:`bench.trace.Trace`'s); a number is left out where there is
    nothing to read (no such span, or no device record at all):

    - ``grad_fwd_ms``, ``grad_bwd_ms``: device ms of ``rfast.grad.fwd``,
      ``rfast.grad.bwd`` over the gradients (``rfast.grad`` spans);
    - ``grad_host_syncs``: sync calls in ``rfast.grad`` and its children,
      a gradient;
    - ``engine_mix_pct``, ``engine_commit_pct``, ``engine_scatter_pct``:
      device seconds of ``rfast.mix``, ``.commit``, ``.scatter`` over the
      window, in %;
    - ``idle_in_grad_pct``, ``idle_in_engine_pct``: idle seconds of the
      :data:`GRAD` and :data:`ENGINE` spans over the window, in %."""
    def total(names, key):
        return sum(spans[n][key] for n in names if n in spans)

    n = spans.get("rfast.grad", {}).get("count", 0)
    out = {}
    if n:
        out["grad_host_syncs"] = total(GRAD, "syncs") / n
    if not window_s or not busy_s:
        return out
    for part in ("fwd", "bwd"):
        s = total([f"rfast.grad.{part}"], "device_s")
        if n and s:
            out[f"grad_{part}_ms"] = 1e3 * s / n
    for part in ("mix", "commit", "scatter"):
        if f"rfast.{part}" in spans:
            out[f"engine_{part}_pct"] = \
                100.0 * total([f"rfast.{part}"], "device_s") / window_s
    if n:
        out["idle_in_grad_pct"] = 100.0 * total(GRAD, "idle_s") / window_s
    if any(k in spans for k in ENGINE):
        out["idle_in_engine_pct"] = \
            100.0 * total(ENGINE, "idle_s") / window_s
    return out
