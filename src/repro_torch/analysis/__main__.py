"""CLI: ``python -m repro_torch.analysis [--all|--plans|--programs|--codes]
[--quick] [--json F] [--device D]``.

Counterpart of ``python -m repro.analysis``.  Exit status 0 means every
pass ran clean; 1 means at least one diagnostic fired.  The JSON report
goes to stdout (or ``--json FILE``); the human summary goes to stderr so
pipelines can consume stdout raw.  The plan pass runs on the host; the
program pass runs the engines on ``--device`` (``cuda`` by default,
which raises without a GPU; ``--device cpu`` runs it on the CPU, where
the kernel route is skipped and listed).

    PYTHONPATH=src python -m repro_torch.analysis --plans
    PYTHONPATH=src python -m repro_torch.analysis --all --quick --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys

from .diagnostics import CODES
from .runner import catalog, run_all


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Plan-invariant linter (RF1xx) and program auditor "
                    "(RF2xx) for the port's R-FAST engines.")
    scope = ap.add_mutually_exclusive_group()
    scope.add_argument("--all", action="store_true",
                       help="run both passes over the full registry "
                            "matrix (default)")
    scope.add_argument("--plans", action="store_true",
                       help="planlint only (RF101-RF106)")
    scope.add_argument("--programs", action="store_true",
                       help="torchlint only (RF201-RF205)")
    scope.add_argument("--codes", action="store_true",
                       help="print the diagnostic-code catalog and exit")
    ap.add_argument("--quick", action="store_true",
                    help="reduced matrix (3 scenarios x 3 topologies)")
    ap.add_argument("--json", metavar="FILE", default=None,
                    help="write the JSON report here instead of stdout")
    ap.add_argument("--n", type=int, default=7,
                    help="nodes per topology (default 7)")
    ap.add_argument("--events", type=int, default=96,
                    help="schedule length K per realization (default 96)")
    ap.add_argument("--epoch-events", type=int, default=1200,
                    help="K for dynamic-membership epoch traces "
                         "(default 1200)")
    ap.add_argument("--seeds", default="0",
                    help="comma-separated realization seeds (default 0)")
    ap.add_argument("--device", default=None,
                    help="device of the program pass: cuda (default) or "
                         "cpu")
    ap.add_argument("--verbose", action="store_true",
                    help="progress lines on stderr")
    args = ap.parse_args(argv)

    if args.codes:
        print(json.dumps(catalog(), indent=2))
        return 0

    say = (lambda m: print(f"[analysis] {m}", file=sys.stderr)) \
        if args.verbose else None
    seeds = tuple(int(s) for s in args.seeds.split(",") if s != "")
    report = run_all(n=args.n, K=args.events,
                     K_epochs=args.epoch_events, seeds=seeds,
                     quick=args.quick, plans=not args.programs,
                     programs=not args.plans, device=args.device,
                     progress=say)

    doc = json.dumps(report, indent=2)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(doc + "\n")
    else:
        print(doc)

    n_diag = report["summary"]["diagnostics"]
    checked = report["summary"]["checked"]
    passes = "+".join(report["config"]["passes"])
    print(f"[analysis] {passes}: {n_diag} diagnostic(s); "
          f"checked {checked.get('comm_plans', 0)} comm plans, "
          f"{checked.get('wavefront_plans', 0)} wavefront plans, "
          f"{checked.get('transform_plans', 0)} transformed plans, "
          f"{checked.get('fleets', 0)} fleets, "
          f"{checked.get('epoch_traces', 0)} epoch traces; "
          f"audited {len(report['summary']['audited_programs'])} "
          f"programs ({len(report['summary']['skipped_programs'])} "
          "skipped on this device); "
          f"skipped {len(checked.get('skipped', []))} "
          "incompatible combos", file=sys.stderr)
    for d in report["diagnostics"]:
        info = CODES.get(d["code"])
        title = f" ({info.title})" if info else ""
        print(f"[analysis] {d['code']}{title} [{d['subject']}] "
              f"{d['message']}", file=sys.stderr)
    return 1 if n_diag else 0


if __name__ == "__main__":
    raise SystemExit(main())
