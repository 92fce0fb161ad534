"""Model-layout (B,S,H,D) flash attention with an ``impl`` switch.

Counterpart of ``src/repro/kernels/flash_attention/ops.py``:
``impl="ref"`` is the plain oracle :func:`.ref.attention_ref`;
``impl="kernel"`` (the reference's ``"pallas"``) is the flash forward,
which follows its tensors — the CUDA kernel on CUDA tensors, its plain
twin on CPU tensors.
"""
from __future__ import annotations

from .kernel import flash_fwd
from .ref import attention_ref

__all__ = ["flash_attention"]


def flash_attention(q, k, v, *, causal=True, window=None, impl="ref",
                    bq=128, bk=128):
    """q (B,Sq,H,D); k/v (B,Sk,KV,D) — the model's natural layout."""
    if impl == "ref":
        return attention_ref(q, k, v, causal=causal, window=window)
    if impl != "kernel":
        raise ValueError(f"impl must be 'ref' or 'kernel', got {impl!r}")
    o, _ = flash_fwd(q.transpose(1, 2), k.transpose(1, 2),
                     v.transpose(1, 2), causal=causal, window=window, bq=bq,
                     bk=bk)
    return o.transpose(1, 2)
