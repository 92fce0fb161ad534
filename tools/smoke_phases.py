"""Seconds of each phase group of a ``chip_smoke.py`` run, from its log.

Every JSON line that ``chip_smoke.py`` prints carries ``t_s``, the
seconds since the script started.  A group ends at its last record (the
marker below); its seconds are the gap from the previous group's end.

    python3 chip_smoke.py > smoke.log
    python3 tools/smoke_phases.py smoke.log
"""
from __future__ import annotations

import json
import sys

# (phases, the record that ends them)
GROUPS = [("1-2 device, build", "build_scan"),
          ("3-16 kernels, train, flash, node, scan", "scan_timing"),
          ("17 event oracle", "event_oracle"),
          ("18 fleets", "fleet_wave_timing"),
          ("19 baselines", "baselines"),
          ("20 epochs", "epochs_logistic"),
          ("21 checkpoints", "ckpt_async"),
          ("22-24 serving", "serve_hymba"),
          ("25-26 zoo", "zoo_train_olmo"),
          ("27-28 whisper, pixtral", "pixtral_serve"),
          ("29 analysis", "analysis_cli"),
          ("30 mesh", "mesh_done"),
          ("31 launch", "launch_done"),
          ("32-36 ranks", "tp_spawn"),
          ("32-36 checks", "tp_serve_done")]


def records(path: str) -> list[dict]:
    out = []
    with open(path) as fh:
        for line in fh:
            if line.startswith('{"phase"'):
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    return [r for r in out if "t_s" in r]


def phase_seconds(recs: list[dict]) -> dict:
    """``{group: seconds}`` in script order, and ``"32-36 by phase"``:
    the spawn's own seconds of each of phases 32-36."""
    out, i, prev = {}, 0, 0.0
    for name, marker in GROUPS:
        while i < len(recs) and recs[i]["phase"] != marker:
            i += 1
        if i == len(recs):
            raise ValueError(f"no {marker!r} record after t_s {prev}")
        while i + 1 < len(recs) and recs[i + 1]["phase"] == marker:
            i += 1
        out[name] = round(recs[i]["t_s"] - prev, 1)
        prev = recs[i]["t_s"]
        if marker == "tp_spawn":
            out["32-36 by phase"] = {k: round(v, 1) for k, v in
                                     recs[i]["phase_s"].items()}
    out["last t_s"] = prev
    return out


if __name__ == "__main__":
    print(json.dumps(phase_seconds(records(sys.argv[1]))))
