"""Device resolution and kernel launch counters for the port.

The JAX package's dispatch (``src/repro/kernels/rfast_update/dispatch.py``)
memoizes one Pallas launch per shape signature and picks an execution
mode (compiled, interpret, emulate).  The port needs neither: a CUDA
kernel is compiled once per source (``kernels/_build.py``) and takes any
shape, and which version runs follows from where the tensors lie — a
wrapper runs its CUDA kernel on a CUDA tensor and its plain PyTorch
version on a CPU tensor.  There is no interpret mode.

What stays is the bookkeeping a run needs to show that its main path
went through the kernels: every wrapper calls :func:`record_launch` once
per kernel launch, and nowhere else.  :func:`stats` reads the counters
and :func:`clear` zeroes them.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "record_launch", "launches", "stats", "clear"]

_launches: dict[str, int] = {}


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is asked for (or defaulted to) and no
    GPU is present — the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU")
    return dev


def record_launch(name: str) -> None:
    """Count one launch of kernel ``name`` (called by its wrapper only)."""
    _launches[name] = _launches.get(name, 0) + 1


def launches(name: str) -> int:
    """Launches of kernel ``name`` since the last :func:`clear`."""
    return _launches.get(name, 0)


def stats() -> dict:
    """``{"launches": total, "by_kernel": {name: count}}``."""
    return {"launches": sum(_launches.values()),
            "by_kernel": dict(_launches)}


def clear() -> None:
    """Zero every launch counter."""
    _launches.clear()
