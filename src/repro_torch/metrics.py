# Copy of src/repro/metrics.py, kept verbatim so the port imports nothing of the
# JAX package.
"""JSONL metrics logging + step timing — the observability substrate.

Every record carries the step, a monotonic timestamp, and arbitrary
scalar fields; readers get pandas-free helpers for quick analysis.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Iterator


class MetricsLogger:
    """Append-only JSONL logger with buffered writes."""

    def __init__(self, path: str, flush_every: int = 10):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)
        self._buf: list[str] = []
        self._flush_every = flush_every
        self._t0 = time.monotonic()

    def log(self, step: int, **fields: Any) -> None:
        rec = {"step": int(step), "t": round(time.monotonic() - self._t0, 4)}
        for k, v in fields.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        self._buf.append(json.dumps(rec))
        if len(self._buf) >= self._flush_every:
            self.flush()

    def flush(self) -> None:
        if self._buf:
            self._f.write("\n".join(self._buf) + "\n")
            self._buf.clear()

    def close(self) -> None:
        self.flush()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_metrics(path: str) -> Iterator[dict]:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


class StepTimer:
    """Rolling steps/sec + ETA."""

    def __init__(self, window: int = 20):
        self._times: list[float] = []
        self._window = window

    def tick(self) -> None:
        self._times.append(time.monotonic())
        if len(self._times) > self._window:
            self._times.pop(0)

    @property
    def steps_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / dt if dt > 0 else 0.0

    def eta_s(self, remaining_steps: int) -> float:
        sps = self.steps_per_sec
        return remaining_steps / sps if sps > 0 else float("inf")
