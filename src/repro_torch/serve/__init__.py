"""Serving side of the async fleet: continuous-batching decode over
hot-swappable checkpoints (DESIGN.md §14).

Counterpart of ``src/repro/serve/``, module for module."""
from . import cache
from .engine import DEFAULT_BUCKETS, ServeEngine
from .scheduler import Request, Scheduler
from .traffic import make_workload
from .weights import WeightStore

__all__ = ["cache", "ServeEngine", "DEFAULT_BUCKETS", "Request",
           "Scheduler", "make_workload", "WeightStore"]
