"""Continuous-batching decode engine over a cache of step callables.

Counterpart of ``src/repro/serve/engine.py``.  One engine owns a
fixed-shape ``(B, C)`` KV ring (``B`` slots × ring capacity ``C =
cache_capacity(cfg, max_len)``) and exactly TWO kinds of step callables,
resolved through ``serve.cache``:

* ``("decode", arch, B, C, dtype)`` — one
  :func:`~repro_torch.models.transformer.decode_step_slots` step
  advancing every slot at its own position, plus greedy sampling.  ONE
  entry for the engine's whole lifetime.
* ``("prefill", arch, B, C, Sb, dtype)`` — bucketized
  :func:`~repro_torch.models.transformer.prefill_rows` for one slot, with
  the true prompt length AND the target slot as arguments: one entry per
  prompt-length bucket ``Sb``, shared by every slot and every prompt
  length ≤ ``Sb``.

Parameters enter both as arguments on every call, never captured, so a
:class:`~repro_torch.serve.weights.WeightStore` flip changes WHICH
tensors the next step reads without rebuilding any entry: steady-state
serving — including serving straight through a live checkpoint swap —
adds ZERO cache entries.  The KV cache is updated in place (the
reference donates it to its executables): an admission writes one
slot's row while the other rows keep their state.  Each step reads its
sampled tokens back to the host once, the counterpart of the
reference's ``block_until_ready``.

Slot lifecycle: a request finishing at step ``k`` frees its slot; the
admission phase of step ``k+1`` re-prefills the same batch row while the
other rows keep decoding — no batch-wide restart, no shape change.

Swap modes (checked between decode steps, never inside one):

* ``"drain"`` (default, the paper-loop semantics): once a newer
  checkpoint is staged, admissions pause; in-flight requests finish on
  the old weights; the flip lands on the first step with no in-flight
  work and admissions resume on the new weights.
* ``"immediate"``: flip as soon as staged; in-flight requests keep
  their old-weight KV prefix and finish on the new weights (DESIGN.md
  §14).
"""
from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from ..models import transformer
from ..models.config import ModelConfig
from . import cache as serve_cache
from .scheduler import Request, Scheduler
from .weights import WeightStore

__all__ = ["ServeEngine", "DEFAULT_BUCKETS"]

DEFAULT_BUCKETS = (4, 8, 16, 32, 64)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, store: WeightStore | Any, *,
                 batch: int = 4, max_len: int = 64,
                 buckets: tuple[int, ...] | None = DEFAULT_BUCKETS,
                 dtype=torch.float32, swap_mode: str = "drain",
                 poll_every: int = 0, ckpt_dir: str | None = None):
        if cfg.mixer != "attn" or cfg.enc_dec or cfg.frontend:
            raise ValueError(
                f"ServeEngine serves decoder-only attention archs; "
                f"{cfg.name} (mixer={cfg.mixer!r}, enc_dec={cfg.enc_dec}, "
                f"frontend={cfg.frontend!r}) has no bucketized prefill "
                "path — see models.transformer.prefill_rows")
        if swap_mode not in ("drain", "immediate"):
            raise ValueError(f"swap_mode {swap_mode!r} not in "
                             "('drain', 'immediate')")
        self.cfg = cfg
        self.store = store if isinstance(store, WeightStore) \
            else WeightStore(store)
        self.B = int(batch)
        self.max_len = int(max_len)
        self.C = transformer.cache_capacity(cfg, max_len)
        self.buckets = tuple(sorted(buckets)) if buckets else None
        self.dtype = dtype
        self.swap_mode = swap_mode
        self.poll_every = int(poll_every)
        self.ckpt_dir = ckpt_dir

        cache0 = transformer.init_cache(cfg, self.store.params, self.B,
                                        max_len, dtype=dtype)
        self.device = cache0["idx"].device
        self._cache = {
            "idx": torch.zeros((self.B,), dtype=torch.int32,
                               device=self.device),
            "slot_pos": torch.full((self.B, self.C), -1, dtype=torch.int32,
                                   device=self.device),
            "layers": cache0["layers"],
        }
        self._slot_req: list[Request | None] = [None] * self.B
        self._remaining = np.zeros(self.B, np.int64)
        self._last_tok = np.zeros(self.B, np.int32)
        self._step = 0
        self.step_records: list[dict] = []
        self._t0: float | None = None

    # -- step callables -------------------------------------------------
    def bucket_for(self, sp: int) -> int:
        """Smallest configured bucket >= the prompt length (identity when
        bucketing is disabled — every distinct length then costs a fresh
        cache entry)."""
        if self.buckets is None:
            return int(sp)
        for b in self.buckets:
            if sp <= b:
                return b
        raise ValueError(f"prompt length {sp} exceeds largest bucket "
                         f"{self.buckets[-1]}")

    def _dtype_name(self) -> str:
        return str(self.dtype).removeprefix("torch.")

    def _decode_exec(self):
        cfg, B, C = self.cfg, self.B, self.C
        key = ("decode", cfg.name, B, C, self._dtype_name())

        def build():
            def f(params, cache, tokens):
                logits, cache = transformer.decode_step_slots(
                    cfg, params, cache, tokens)
                return torch.argmax(logits[:, 0, :], dim=-1), cache
            return f
        return serve_cache.lookup(key, build)

    def _prefill_exec(self, sb: int):
        cfg, C, dtype = self.cfg, self.C, self.dtype
        key = ("prefill", cfg.name, self.B, C, int(sb), self._dtype_name())

        def build():
            def f(params, cache, slot, tokens, true_len):
                ring, slot_pos, logits = transformer.prefill_rows(
                    cfg, params, tokens[None], true_len, C, dtype=dtype)
                for name, rows in ring["attn"].items():
                    cache["layers"]["attn"][name][:, slot] = rows[:, 0]
                cache["idx"][slot] = true_len
                cache["slot_pos"][slot] = slot_pos
                return torch.argmax(logits[0]), cache
            return f
        return serve_cache.lookup(key, build)

    # -- lifecycle ------------------------------------------------------
    @property
    def in_flight(self) -> int:
        return sum(r is not None for r in self._slot_req)

    def _now(self) -> float:
        return 0.0 if self._t0 is None else time.perf_counter() - self._t0

    def _finish(self, slot: int, now: float) -> None:
        req = self._slot_req[slot]
        req.done_step = self._step
        req.done_s = now
        req.weights_step = self.store.step
        req.weights_age_s = (0.0 if self.store.published_at is None
                             else max(0.0, time.time()
                                      - self.store.published_at))
        self._slot_req[slot] = None
        self._remaining[slot] = 0

    def _admit(self, slot: int, req: Request, params, now: float) -> None:
        sp = len(req.prompt)
        sb = self.bucket_for(sp)
        padded = np.zeros(sb, np.int32)
        padded[:sp] = req.prompt
        fn = self._prefill_exec(sb)
        nxt, self._cache = fn(params, self._cache, slot,
                              torch.from_numpy(padded).to(self.device), sp)
        req.slot = slot
        req.admit_step = self._step
        req.admit_s = now
        req.tokens = [int(nxt)]
        self._slot_req[slot] = req
        self._last_tok[slot] = req.tokens[-1]
        self._remaining[slot] = req.gen - 1
        if self._remaining[slot] <= 0:
            self._finish(slot, now)

    def step(self, sched: Scheduler) -> dict:
        """One engine step: maybe poll/flip, admit into free slots,
        decode every slot once, retire finished requests."""
        t_start = time.perf_counter()
        swap_affected = False

        if (self.poll_every and self.ckpt_dir is not None
                and self._step % self.poll_every == 0):
            if self.store.poll(self.ckpt_dir):
                swap_affected = True
        if self.store.staged and (self.swap_mode == "immediate"
                                  or self.in_flight == 0):
            self.store.flip(at_step=self._step)
            swap_affected = True
        params = self.store.params

        now = self._now()
        admitted = 0
        if not (self.swap_mode == "drain" and self.store.staged):
            for slot in range(self.B):
                if self._slot_req[slot] is not None:
                    continue
                req = sched.pop_ready(now)
                if req is None:
                    break
                self._admit(slot, req, params, now)
                admitted += 1

        active = self.in_flight
        if active:
            fn = self._decode_exec()
            tokens = torch.from_numpy(self._last_tok[:, None]).to(self.device)
            nxt, self._cache = fn(params, self._cache, tokens)
            nxt = nxt.cpu().numpy()
            now = self._now()
            for slot in range(self.B):
                req = self._slot_req[slot]
                if req is None:
                    continue
                req.tokens.append(int(nxt[slot]))
                self._last_tok[slot] = nxt[slot]
                self._remaining[slot] -= 1
                if self._remaining[slot] <= 0:
                    self._finish(slot, now)

        rec = {"step": self._step,
               "us": (time.perf_counter() - t_start) * 1e6,
               "swap": swap_affected, "active": active,
               "admitted": admitted}
        self.step_records.append(rec)
        self._step += 1
        return rec

    def run(self, requests: list[Request], *,
            max_steps: int = 200_000) -> dict:
        """Drive the engine until every request is served (open-loop:
        the clock starts at the first step and arrivals are honoured
        against wall time).  Returns the serving report."""
        sched = Scheduler(list(requests))
        self._t0 = time.perf_counter()
        served0 = self._step
        while len(sched) or self.in_flight or self.store.staged:
            if self._step - served0 >= max_steps:
                raise RuntimeError(f"serve loop exceeded {max_steps} steps "
                                   f"with {len(sched)} pending")
            if (not self.in_flight and len(sched)
                    and not self.store.staged):
                nxt = sched.next_arrival()
                gap = nxt - self._now()
                if gap > 0:
                    time.sleep(min(gap, 0.05))
            self.step(sched)
        wall = self._now()
        done = [r for r in requests if r.done]
        return {
            "requests": requests,
            "steps": self.step_records[:],
            "wall_s": wall,
            "reqs_per_s": len(done) / wall if wall > 0 else float("inf"),
            "tokens": sum(len(r.tokens) for r in done),
            "swaps": list(self.store.swaps),
            "cache": serve_cache.stats(),
        }
