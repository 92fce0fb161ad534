"""Shape-keyed cache of the serving engine's step callables.

Counterpart of ``src/repro/serve/cache.py``: the same contract
(``lookup(key, build)`` + instrumented ``stats``/``clear``) and the same
keys,

    ("decode",  arch, B, C, dtype)
    ("prefill", arch, B, C, Sb, dtype)

where ``B`` is the fixed batch width, ``C`` the KV ring capacity, ``Sb``
a *bucketized* prompt length (``engine.bucket_for``) and ``dtype`` the
cache's dtype spelled as the reference spells it (``"float32"``).  The
reference caches jitted executables; PyTorch runs eagerly, so here an
entry is a plain Python callable built once per key.  The true prompt
length and the parameters are arguments of the callable, never part of
the key, so every prompt inside a bucket — and every hot-swapped
parameter set — resolves to the SAME entry: ``misses`` counts distinct
entries built since :func:`clear`, and a steady-state serving loop, a
live checkpoint swap included, must not grow it.
"""
from __future__ import annotations

from typing import Callable

__all__ = ["lookup", "stats", "clear"]

_cache: dict[tuple, Callable] = {}
_hits = 0
_misses = 0


def lookup(key: tuple, build: Callable[[], Callable]) -> Callable:
    """Return the cached callable for ``key``, constructing it with
    ``build()`` on the first request.  Counts a hit or a miss."""
    global _hits, _misses
    fn = _cache.get(key)
    if fn is None:
        _misses += 1
        fn = build()
        _cache[key] = fn
    else:
        _hits += 1
    return fn


def stats() -> dict:
    """Current counters: ``{"hits", "misses", "entries"}``.  Misses count
    distinct (arch, shape, bucket) entries built since the last
    :func:`clear`; a steady-state serving loop must not grow them."""
    return {"hits": _hits, "misses": _misses, "entries": len(_cache)}


def clear() -> None:
    """Drop every cached callable and zero the counters (test isolation)."""
    global _hits, _misses
    _cache.clear()
    _hits = 0
    _misses = 0
