"""The R-FAST protocol formulas (Algorithm 2, S.1–S.4), written once.

Counterpart of the scalar building blocks of
``src/repro/core/protocol.py``; every engine of the port composes its
update from these:

  S.1   v_i = x_i − γ z_i
  S.2a  x_i⁺ = w_ii v_i + Σ_j w_ij v_j            (stale consensus pull)
  S.2b  z½  = z_i + recv + ∇f_i(x⁺;ζ) − ∇f_i(x;ζ⁻)
  S.4   ρ̃ ← m·ρ + (1−m)·ρ̃                        (buffer commit)

They are plain tensor functions: broadcasting follows the arguments.
"""
from __future__ import annotations

import torch

__all__ = ["descent_step", "consensus_mix", "tracking_step",
           "mailbox_merge"]


def descent_step(x, z, lr):
    """S.1: local descent direction v = x − γ z."""
    return x - lr * z


def consensus_mix(w_self, v_self, w_in, v_in):
    """S.2a: x⁺ = w_ii v_i + Σ_k w_in[k] · v_in[k] (sum over leading axis)."""
    return w_self * v_self + torch.sum(w_in * v_in, dim=0)


def tracking_step(z, recv, g_new, g_old):
    """S.2b: robust gradient tracking z½ = z + recv + g_new − g_old."""
    return z + recv + g_new - g_old


def mailbox_merge(new, old, mask):
    """Masked commit (S.4 buffers): m·new + (1−m)·old."""
    return mask * new + (1 - mask) * old
