"""The reference's matrix multiply, in fp32 or, for the control, in TF32.

The configurations state fp32 with TF32 off.  The control of the
benchmark's comparison is the reference one precision lower: TF32, whose
inputs keep 10 of fp32's 23 mantissa bits.  On the card that is the
hardware's own TF32 (``allow_tf32``); on the CPU, which has none, the
operands are rounded to TF32 (to nearest, ties away) before an fp32
product, which is what a TF32 tensor core computes.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["matmul", "fp32", "tf32", "set_mode", "mode"]

_mode = ["fp32"]


def mode() -> str:
    return _mode[0]


def set_mode(m: str) -> None:
    """``fp32`` (TF32 off everywhere) or ``tf32``."""
    if m not in ("fp32", "tf32"):
        raise ValueError(f"precision mode {m!r}")
    _mode[0] = m
    on = m == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


@contextlib.contextmanager
def tf32():
    prev = mode()
    set_mode("tf32")
    try:
        yield
    finally:
        set_mode(prev)


def fp32() -> None:
    set_mode("fp32")


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to 10 mantissa bits (fp32 storage), differentiably:
    the gradient passes straight through, as a TF32 unit's does."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + (1 << 12)) & ~((1 << 13) - 1)).view(torch.float32)
    return x + (r - x.detach())


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if mode() == "tf32" and a.device.type == "cpu":
        return _RoundedMatmul.apply(a, b)
    return a @ b


class _RoundedMatmul(torch.autograd.Function):
    """``a @ b`` with TF32 operands, forward and backward (each product
    of the backward rounds its operands too)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _round_tf32(a) @ _round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _round_tf32(g)
        ga = g @ _round_tf32(b).transpose(-1, -2)
        gb = _round_tf32(a).transpose(-1, -2) @ g
        while gb.dim() > b.dim():
            gb = gb.sum(0)
        return ga, gb
