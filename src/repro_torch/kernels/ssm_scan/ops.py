"""The selective scan with an ``impl`` switch, and its autograd function.

Counterpart of ``src/repro/kernels/ssm_scan/ops.py``: ``impl="ref"`` is
the plain oracle :func:`.ref.selective_scan_ref`; ``impl="kernel"`` (the
reference's ``"pallas"``) is :class:`SelectiveScanFn`, whose forward is
:func:`.kernel.ssm_scan` — the CUDA kernel on CUDA tensors, its plain twin
on CPU tensors, and an error on any other device.

:class:`SelectiveScanFn` differentiates the scan as the JAX package does:
JAX has no backward scan kernel and differentiates ``selective_scan_ref``
through ``lax.scan``.  Its backward therefore runs ``selective_scan_ref``
again on the saved inputs under autograd and returns the gradients of all
six inputs (``A = −exp(A_log)`` and ``D`` are trained parameters).  The
forward always runs the kernel on the card; a backward scan kernel is
later work (ROADMAP), not part of this port.
"""
from __future__ import annotations

import torch

from .kernel import ssm_scan
from .ref import selective_scan_ref

__all__ = ["selective_scan", "SelectiveScanFn"]


class SelectiveScanFn(torch.autograd.Function):
    """``(u, dt, A, B, C, D) -> (y, h_last)`` through :func:`ssm_scan`,
    differentiable in all six inputs; the gradient of ``h_last`` may be
    absent."""

    @staticmethod
    def forward(ctx, u, dt, A, B, C, D):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(u, dt, A, B, C, D)
        return ssm_scan(u, dt, A, B, C, D)

    @staticmethod
    def backward(ctx, gy, gh):
        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = selective_scan_ref(*ins)
        pairs = [(o, g) for o, g in zip(outs, (gy, gh)) if g is not None]
        if not pairs:
            return (None,) * 6
        outs, cots = zip(*pairs)
        grads = torch.autograd.grad(outs, ins, cots, allow_unused=True)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def selective_scan(u, dt, A, B, C, D, *, impl: str = "ref"):
    """u/dt (B,S,di); A (di,N); B/C (B,S,N); D (di,) -> (y, h_last)."""
    if impl == "ref":
        return selective_scan_ref(u, dt, A, B, C, D)
    if impl != "kernel":
        raise ValueError(f"impl must be 'ref' or 'kernel', got {impl!r}")
    return SelectiveScanFn.apply(u, dt, A, B, C, D)
