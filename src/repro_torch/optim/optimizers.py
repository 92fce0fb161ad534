"""Minimal optimizers as ``init`` / ``update`` pairs over parameter dicts.

Counterpart of ``src/repro/optim/optimizers.py``.  R-FAST composes as
the *distribution* layer: the tracked direction ``z`` replaces the raw
gradient fed to the local optimizer.  The paper's ResNet experiments use
SGD + momentum 0.9 + weight decay 1e-4; AdamW serves the transformers.

Parameters, gradients and optimizer state are nested dicts of tensors
(the trees :func:`repro_torch.core.paramvec.unravel` returns); ``update``
returns new tensors and leaves its arguments untouched.  The arithmetic
is the reference's, not ``torch.optim``'s: ``momentum`` folds weight
decay into its buffer (``m = β·m + g + wd·p``), and ``adamw`` corrects
bias with ``t = step + 1`` and adds ``wd·p`` inside the step.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..core.paramvec import tree_map

__all__ = ["Optimizer", "sgd", "momentum", "adamw"]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], tuple[Any, Any]]
    # update(grads, opt_state, params, step) -> (new_params, new_opt_state)


def _lr_at(lr, step):
    """The step size as a float32 scalar (a schedule's value, or the
    constant), as the reference evaluates it."""
    return torch.as_tensor(lr(step) if callable(lr) else lr,
                           dtype=torch.float32)


def sgd(lr, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, step):
        g = _lr_at(lr, step)
        new = tree_map(lambda p, gr: p - g * (gr + weight_decay * p),
                   params, grads)
        return new, state

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9, weight_decay: float = 0.0) -> Optimizer:
    """Polyak heavy-ball, the paper's ResNet-50 setup (β=0.9, wd=1e-4)."""

    def init(params):
        return tree_map(torch.zeros_like, params)

    def update(grads, m, params, step):
        g = _lr_at(lr, step)
        m = tree_map(lambda mm, gr, p: beta * mm + gr + weight_decay * p,
                 m, grads, params)
        new = tree_map(lambda p, mm: p - g * mm, params, m)
        return new, m

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return (tree_map(torch.zeros_like, params),
                tree_map(torch.zeros_like, params))

    def update(grads, state, params, step):
        m, v = state
        g = _lr_at(lr, step)
        t = torch.as_tensor(step, dtype=torch.float32) + 1.0
        m = tree_map(lambda mm, gr: b1 * mm + (1 - b1) * gr, m, grads)
        v = tree_map(lambda vv, gr: b2 * vv + (1 - b2) * gr * gr, v, grads)
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        new = tree_map(lambda p, mm, vv: p - g * (
            (mm / bc1) / (torch.sqrt(vv / bc2) + eps) + weight_decay * p),
            params, m, v)
        return new, (m, v)

    return Optimizer(init, update)
