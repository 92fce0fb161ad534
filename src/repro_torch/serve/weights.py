"""Double-buffered parameter store with hot swap between decode steps.

Counterpart of ``src/repro/serve/weights.py``.  The trainer
(``launch/train.py --publish-dir``) publishes checkpoints at chunk
boundaries through ``checkpoint/ckpt.py``'s atomic npz + manifest
protocol.  The server side is this store:

* :meth:`poll` reads ``LATEST.json``; when it names a step newer than
  the active one and than the one already staged, the checkpoint is
  loaded into the **spare** buffer:
  ``load_checkpoint`` restores each leaf onto the active leaf's device
  and dtype, so the loaded tree is a second buffer beside the active one
  on the card.  The active buffer is never written in place.
* :meth:`flip` swaps the buffer references.  It is a plain Python
  assignment the engine performs strictly *between* decode steps: every
  step enqueued before it reads the old tensors (and keeps them alive
  until they are done), every later step reads the new ones.  Nothing
  is rebuilt: parameters are arguments of the engine's cached callables,
  so the cache keys are identical before and after the swap.

The store records every swap (``swaps``) and exposes the provenance of
the active weights (``step``, ``published_at``) so the engine can stamp
each finished request with the checkpoint age at answer time.
"""
from __future__ import annotations

from typing import Any

from ..checkpoint import ckpt

__all__ = ["WeightStore"]


class WeightStore:
    def __init__(self, params: Any, *, step: int = -1,
                 published_at: float | None = None):
        self._active = params
        self._spare: Any = None
        self._spare_meta: tuple[int, float] | None = None
        self.step = int(step)
        self.published_at = published_at
        self.polls = 0
        self.loads = 0
        self.swaps: list[dict] = []

    @property
    def params(self) -> Any:
        """The active buffer.  Engines must re-read this property each
        step rather than caching the reference — that re-read IS the
        acquire side of the swap."""
        return self._active

    @property
    def staged(self) -> bool:
        return self._spare_meta is not None

    def offer(self, params: Any, step: int, published_at: float) -> None:
        """Stage an in-memory parameter set into the spare buffer
        (tests and in-process publishers; newer steps only)."""
        if step <= self.step:
            return
        self._spare = params
        self._spare_meta = (int(step), float(published_at))

    def poll(self, ckpt_dir: str) -> bool:
        """Check the manifest; load a newer checkpoint into the spare
        buffer.  Returns True when something was staged.  The load is
        synchronous (manifest read is ~free; the npz read happens only
        on the step that discovers a new checkpoint).  A step already
        staged is not loaded again while it waits for its flip (the
        reference reloads it at every poll until then: a drain swap
        re-read the whole checkpoint each ``poll_every`` steps)."""
        self.polls += 1
        man = ckpt.read_manifest(ckpt_dir)
        newest = max(self.step, self._spare_meta[0] if self.staged else -1)
        if man is None or int(man["step"]) <= newest:
            return False
        self._spare = None                  # an older staged set goes first
        self._spare = ckpt.load_checkpoint(ckpt_dir, self._active,
                                           step=int(man["step"]))
        self._spare_meta = (int(man["step"]), float(man["time"]))
        self.loads += 1
        return True

    def flip(self, *, at_step: int = -1) -> bool:
        """Make the staged buffer active (reference swap, between decode
        steps).  Returns True when a swap happened."""
        if self._spare_meta is None:
            return False
        step, published_at = self._spare_meta
        self._active, self._spare = self._spare, None
        self._spare_meta = None
        self.swaps.append({"engine_step": int(at_step),
                           "from": self.step, "to": step})
        self.step = step
        self.published_at = published_at
        return True
