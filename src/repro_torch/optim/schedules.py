"""Learning-rate schedules.

Counterpart of ``src/repro/optim/schedules.py``: each schedule maps a
step (an int or a tensor) to a 0-d float32 CPU tensor, evaluated in
float32 as the reference evaluates it, so a run draws the same step
sizes in both packages.
"""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "step_decay", "cosine", "warmup_cosine"]

_F32 = torch.float32


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(_F32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=_F32)


def step_decay(lr: float, decay: float = 0.1, every: int = 30):
    """Paper §VI-B: initial 0.1, ×0.1 every 30 epochs."""
    def fn(step):
        k = torch.floor(_f32(step) / every)
        return torch.tensor(lr, dtype=_F32) * decay ** k
    return fn


def cosine(lr: float, total: int, final: float = 0.0):
    def fn(step):
        t = torch.clamp(_f32(step) / total, 0.0, 1.0)
        return final + 0.5 * (lr - final) * (1 + torch.cos(math.pi * t))
    return fn


def warmup_cosine(lr: float, warmup: int, total: int, final: float = 0.0):
    cos = cosine(lr, max(1, total - warmup), final)
    def fn(step):
        s = _f32(step)
        wu = lr * s / max(1, warmup)
        return torch.where(s < warmup, wu, cos(s - warmup))
    return fn
