"""Split a cell's traced window by the program's own spans.

    python3 perfbench/trace_spans.py --workload <cell> --seed <n> \\
        [--seconds 30] [--root DIR] [--sync-sites]

from the root of a checkout, on a machine with the card.  The cell runs
as ``perfbench/run.py --trace 1`` runs it (``bench.cell.run_cell``), and
the profiler's events are also read by ``bench.spans``, which the
harness's ``Trace`` does not keep.  The last line of standard output is
one JSON object: ``correct``, the harness's per-layer ``metrics``,
``busy_s``, ``window_s``, the ``breakdown``, the program's ``spans``
({name: {count, device_s, idle_s, syncs}}), their ``readings``
(``bench.spans.readings``) and the traced ``window``: its seconds, units,
gradients and tokens a second, the profiler's cost included.

``--root DIR`` runs the program and the harness of another checkout (a
parent commit unpacked apart, with this ``perfbench/`` laid over it).
``--sync-sites`` runs the cell untraced under
``torch.cuda.set_sync_debug_mode("warn")`` instead and reports, for each
source line that made the host wait for the card, how many times it did
(set-up, window and reference together).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402


def _say(text: str) -> None:
    print(text, file=sys.stderr, flush=True)


def traced(workload: str, seed: int, seconds: float, **run) -> dict:
    """One traced run of ``workload`` (``run``: ``bench.cell.run_cell``'s
    keywords, ``root`` among them) with the program's spans read."""
    from bench import cell, program, spans, trace

    kept = {}
    saved = (trace.summarize, program.run_sync, program.run_async)

    def keep_spans(events):
        kept["spans"] = spans.program_spans(events)
        return saved[0](events)

    def keeping(run_fn):
        def keep_window(*a, **kw):
            obs, kept["window"] = run_fn(*a, **kw)
            return obs, kept["window"]
        return keep_window

    trace.summarize = keep_spans
    program.run_sync, program.run_async = map(keeping, saved[1:])
    try:
        r = cell.run_cell(workload, seed, seconds, True, **run)
    finally:
        trace.summarize, program.run_sync, program.run_async = saved
    win, sp, dev = kept["window"], kept["spans"], r["device"]
    traffic = dict(cell.load_cell(workload, run["root"])["traffic"],
                   **run.get("shrink", {}).get("traffic", {}))
    return {
        "cell": workload, "seed": seed, "correct": r["correct"],
        "metrics": {k: v["value"] for k, v in r["metrics"].items()},
        "busy_s": dev["busy_s"], "window_s": dev["window_s"],
        "breakdown": r["breakdown"], "spans": sp,
        "readings": spans.readings(sp, dev["window_s"], dev["busy_s"]),
        "window": {"seconds": win.seconds, "units": win.units,
                   "grads": win.grads,
                   "tokens_per_s": win.grads * traffic["batch"]
                   * traffic["seq"] / win.seconds},
        "card": dev["kind"]}


def sync_sites(workload: str, seed: int, seconds: float, **run) -> dict:
    """{``file:line``: times} of every host wait on the card in one
    untraced run of ``workload``."""
    import torch
    from bench import cell

    sites = collections.Counter()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            r = cell.run_cell(workload, seed, seconds, False, **run)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for w in caught:
        if "synchroniz" in str(w.message):
            sites[f"{w.filename}:{w.lineno}"] += 1
    return {"cell": workload, "seed": seed, "correct": r["correct"],
            "sync_sites": dict(sites.most_common())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--root", default=".")
    ap.add_argument("--sync-sites", action="store_true")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "perfbench"), str(root / "src")]
    import torch

    if not torch.cuda.is_available():
        _say("needs a CUDA card")
        return 3
    torch.set_num_threads(1)
    how = sync_sites if args.sync_sites else traced
    out = how(args.workload, args.seed, args.seconds, root=root,
              t_start=T_START, log=_say)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
