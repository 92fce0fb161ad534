"""What a kernel launch would do, on meta tensors: the dry-run's record.

The launch tooling (``launch/dryrun.py``) runs a production step once on
``torch.device("meta")``: every tensor has a shape and a dtype and no
data.  There, each kernel wrapper of the port returns empty meta outputs
of its kernel's shapes and dtypes, runs neither its kernel nor its plain
version, and calls :func:`note` once with the operations and bytes of
the launch it stands for (the counts its bound on the card uses).  The
two collectives of ``core/runtime_sharded.py`` record themselves there,
in their own record.

This record is the dry-run's own.  ``dispatch.py``'s launch counters
count only kernels that really ran, so a meta run leaves them as they
were.  Outside :func:`recording` a note is dropped.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["is_meta", "note", "recording"]

_recorders: list[list[dict]] = []


def is_meta(t: torch.Tensor) -> bool:
    """Whether ``t`` lies on the meta device."""
    return t.device.type == "meta"


def note(name: str, *, flops: int, nbytes: int) -> None:
    """Record one launch of kernel ``name`` that a meta call stands for:
    its operations and the bytes it must move."""
    for calls in _recorders:
        calls.append({"name": name, "flops": int(flops),
                      "bytes": int(nbytes)})


@contextlib.contextmanager
def recording():
    """Record every meta launch noted inside the block, one dict each
    (``name``, ``flops``, ``bytes``); yields the list they go to."""
    calls: list[dict] = []
    _recorders.append(calls)
    try:
        yield calls
    finally:
        _recorders.remove(calls)
