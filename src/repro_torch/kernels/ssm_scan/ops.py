"""The selective scan with an ``impl`` switch, and its autograd function.

Counterpart of ``src/repro/kernels/ssm_scan/ops.py``: ``impl="ref"`` is
the plain oracle :func:`.ref.selective_scan_ref`; ``impl="kernel"`` (the
reference's ``"pallas"``) is :class:`SelectiveScanFn`, whose forward is
:func:`.kernel.ssm_scan` and whose backward is
:func:`.backward.ssm_scan_bwd` — the CUDA kernels on CUDA tensors, their
plain twins on CPU tensors, and an error on any other device.

The JAX package has no backward scan kernel and differentiates
``selective_scan_ref`` through ``lax.scan``; :class:`SelectiveScanFn`
computes the same gradient of all six inputs (``A = −exp(A_log)`` and
``D`` are trained parameters) from the checkpoints its forward writes
every ``CKPT_EVERY`` steps.  ``selective_scan_ref`` under autograd is the
tests' oracle for it, not part of this path.
"""
from __future__ import annotations

import torch

from .backward import ssm_scan_bwd
from .kernel import CKPT_EVERY, ssm_scan
from .ref import selective_scan_ref

__all__ = ["selective_scan", "SelectiveScanFn"]


class SelectiveScanFn(torch.autograd.Function):
    """``(u, dt, A, B, C, D) -> (y, h_last)`` through :func:`ssm_scan`,
    differentiable in all six inputs through :func:`ssm_scan_bwd`; the
    gradient of ``y`` or of ``h_last`` may be absent."""

    @staticmethod
    def forward(ctx, u, dt, A, B, C, D):
        ctx.set_materialize_grads(False)
        if not any(ctx.needs_input_grad):
            return ssm_scan(u, dt, A, B, C, D)
        y, h, ckpt = ssm_scan(u, dt, A, B, C, D, ckpt_every=CKPT_EVERY)
        ctx.save_for_backward(u, dt, A, B, C, D, ckpt)
        return y, h

    @staticmethod
    def backward(ctx, gy, gh):
        if gy is None and gh is None:
            return (None,) * 6
        u, dt, A, B, C, D, ckpt = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
        grads = ssm_scan_bwd(u, dt, A, B, C, D, gy, gh, ckpt,
                             ckpt_every=CKPT_EVERY)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def selective_scan(u, dt, A, B, C, D, *, impl: str = "ref"):
    """u/dt (B,S,di); A (di,N); B/C (B,S,N); D (di,) -> (y, h_last)."""
    if impl == "ref":
        return selective_scan_ref(u, dt, A, B, C, D)
    if impl != "kernel":
        raise ValueError(f"impl must be 'ref' or 'kernel', got {impl!r}")
    return SelectiveScanFn.apply(u, dt, A, B, C, D)
