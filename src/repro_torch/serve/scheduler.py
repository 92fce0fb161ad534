# Copy of src/repro/serve/scheduler.py, kept verbatim so the port imports nothing of the
# JAX package.
"""Continuous-batching admission: requests, FIFO queue, slot recycling.

The scheduler owns WHAT runs; the engine owns HOW.  Requests arrive on
an open-loop clock (``arrive_s``, generated by ``traffic.py`` — arrivals
do not wait for completions), queue FIFO, and are admitted one per free
KV slot.  A slot is recycled the step after its request finishes: the
engine re-prefills the same batch row while the other rows keep
decoding, so admission never restarts the batch.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

__all__ = ["Request", "Scheduler"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (Sp,) int32 token ids, Sp >= 1
    gen: int                      # decode tokens to produce (>= 1)
    arrive_s: float               # open-loop arrival time
    # -- filled by the engine --
    admit_step: int = -1
    done_step: int = -1
    admit_s: float = -1.0
    done_s: float = -1.0
    slot: int = -1
    weights_step: int = -1        # checkpoint step that served the request
    weights_age_s: float = 0.0    # answer time - checkpoint publish time
    tokens: list = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return self.done_step >= 0

    @property
    def latency_s(self) -> float:
        return self.done_s - self.arrive_s if self.done else float("nan")


class Scheduler:
    """FIFO over arrival order; ``pop_ready(now)`` hands the engine the
    next request whose arrival time has passed."""

    def __init__(self, requests: list[Request]):
        self._pending = deque(sorted(requests, key=lambda r: (r.arrive_s,
                                                              r.rid)))
        self.admitted = 0

    def __len__(self) -> int:
        return len(self._pending)

    def pop_ready(self, now_s: float) -> Request | None:
        if self._pending and self._pending[0].arrive_s <= now_s:
            self.admitted += 1
            return self._pending.popleft()
        return None

    def next_arrival(self) -> float | None:
        """Arrival time of the head request (None when drained) — lets a
        drained engine jump the virtual clock instead of spinning."""
        return self._pending[0].arrive_s if self._pending else None
