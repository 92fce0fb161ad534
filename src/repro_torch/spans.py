"""Named spans of the training engines, for ``torch.profiler``.

:func:`span` marks where a phase of a round, a wave or a gradient runs.
While no profiler session is active it costs one flag check and returns a
shared no-op context; inside a session it is a
``torch.profiler.record_function`` range, so the span lands in the same
trace as the device records, on the same clock.  The spans the engines
open (names ``rfast.*``):

=================  ====================================================
``rfast.round``    a dense round (``core/protocol``, both backends)
``rfast.wave``     a wavefront wave (``core/simulator._wave_step``)
``rfast.mix``      S.1 descent and S.2a mailboxes, gathers and pull
``rfast.grad``     one node's gradient, as the engine calls its objective
``rfast.grad.fwd`` the loss (``core/paramvec.value_and_grad``)
``rfast.grad.bwd`` ``torch.autograd.grad`` of it, recompute included
``rfast.commit``   S.2b/c and S.4: the commit launch or its math
``rfast.scatter``  the row copies after the commit
=================  ====================================================
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["span"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that marks ``name`` in an active profiler session, and
    does nothing otherwise."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)
