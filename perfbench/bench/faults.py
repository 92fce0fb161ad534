"""Faults planted in the program under test, to show that the comparison
catches them (the benchmark's own runs plant none).

* ``unchanged`` — every step returns its state as it got it: the sync
  round does nothing, the async wave does nothing;
* ``half_batch`` — the loss leaves out half of each batch's rows and
  takes the mean over the rest.

A cell on one card has no exchange between cards to leave out, and a
training cell no served token to alter.
"""
from __future__ import annotations

import contextlib

__all__ = ["FAULTS", "planted"]

FAULTS = ("unchanged", "half_batch")


@contextlib.contextmanager
def planted(fault: str | None):
    """Plant ``fault`` in the program for the ``with`` block (None: no
    fault)."""
    if fault is None:
        yield
        return
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; have {FAULTS}")
    from repro_torch.core import runtime, simulator
    from repro_torch.models import transformer
    saved = [(runtime, "make_rfast_round", runtime.make_rfast_round),
             (simulator, "_wave_step", simulator._wave_step),
             (transformer, "loss_fn", transformer.loss_fn)]
    if fault == "unchanged":
        runtime.make_rfast_round = lambda *a, **k: (
            lambda state, *args: (state, {}))
        simulator._wave_step = lambda *a, **k: None
    else:
        loss_fn = transformer.loss_fn

        def half(cfg, params, tokens, labels, *a, **k):
            keep = max(1, tokens.shape[0] // 2)
            return loss_fn(cfg, params, tokens[:keep], labels[:keep], *a,
                           **k)

        transformer.loss_fn = half
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
