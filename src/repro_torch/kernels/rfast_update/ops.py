"""Public per-node wrappers: the flat-vector R-FAST update and commit.

Counterpart of ``src/repro/kernels/rfast_update/ops.py`` (``rfast_update``,
``rfast_commit``), with the same signatures except for the backend
switch: ``impl`` is ``"ref"`` (the PyTorch oracle of :mod:`.ref`) or
``"kernel"``, and the reference's ``interpret`` gives way to ``oracle``.
The port has no interpreter; ``oracle=True`` names the route the JAX
package runs under ``interpret=True``, the per-node commit kernel.

* ``rfast_commit(impl="kernel")`` goes through :func:`.grid.commit_grid`
  at lane count B = 1 with identity tables (one launch), as the
  reference does; with ``oracle=True`` through
  :func:`.kernel.rfast_commit_node`.
* ``rfast_update(impl="kernel", outputs="full")`` goes through
  :func:`.kernel.rfast_update_node`; ``outputs="commit"`` delegates to
  :func:`rfast_commit`.

The reference's ``pad_to_blocks``/``unpad`` (its ``(R, 128)`` blocking
and ``Pf % 32768`` rule) are TPU layout and have no counterpart: the
CUDA kernels mask their ragged tail.  On CPU tensors every kernel route
runs its plain twin; on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from .grid import commit_grid
from .kernel import one_dtype, rfast_commit_node, rfast_update_node
from .ref import rfast_commit_ref, rfast_update_ref

__all__ = ["rfast_update", "rfast_commit", "IMPLS"]

IMPLS = ("ref", "kernel")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def rfast_update(x, z, g_new, g_old, v_in, w_in, rho_in, rho_buf, mask,
                 rho_out, a_out, *, gamma, w_self, a_self,
                 impl: str = "ref", oracle: bool = False,
                 outputs: str = "full"):
    """Flat-vector protocol update; see :mod:`.ref` for the math.

    ``outputs="full"`` returns ``(x', v, z', ρ_out', ρ̃')``;
    ``outputs="commit"`` skips the x'/v streams (and the x/v_in/w_in
    inputs that feed only them) and returns ``(z', ρ_out', ρ̃')``.
    """
    if outputs not in ("full", "commit"):
        raise ValueError(f"outputs must be 'full' or 'commit', "
                         f"got {outputs!r}")
    _check_impl(impl)
    if outputs == "commit":
        return rfast_commit(z, g_new, g_old, rho_in, rho_buf, mask, rho_out,
                            a_out, a_self=a_self, impl=impl, oracle=oracle)
    fn = rfast_update_ref if impl == "ref" else rfast_update_node
    return fn(x, z, g_new, g_old, v_in, w_in, rho_in, rho_buf, mask,
              rho_out, a_out, gamma=gamma, w_self=w_self, a_self=a_self)


def rfast_commit(z, g_new, g_old, rho_in, rho_buf, mask, rho_out, a_out, *,
                 a_self, impl: str = "ref", oracle: bool = False):
    """Commit-only protocol update: the S.2b–S.4 tail of
    :func:`rfast_update`.  Returns ``(z', ρ_out', ρ̃')``."""
    _check_impl(impl)
    if impl == "ref":
        return rfast_commit_ref(z, g_new, g_old, rho_in, rho_buf, mask,
                                rho_out, a_out, a_self=a_self)
    if oracle:
        return rfast_commit_node(z, g_new, g_old, rho_in, rho_buf, mask,
                                 rho_out, a_out, a_self=a_self)
    # grid path at lane count B = 1: identity gather tables, one launch
    one_dtype("rfast_commit", (z, g_new, g_old, rho_in, rho_buf, rho_out))
    ka, ko = rho_in.shape[0], rho_out.shape[0]
    dev = z.device
    zero = np.zeros(1, np.int32)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                    device=dev).reshape(1, -1)
    z_n, ro_n, rb_n = commit_grid(
        zero, zero, np.arange(ka, dtype=np.int32)[None],
        np.arange(ka, dtype=np.int32)[None],
        np.arange(ko, dtype=np.int32)[None], f32(a_self).reshape(1),
        f32(mask), f32(a_out), z[None], g_new[None], g_old[None],
        rho_in, rho_buf, rho_out)
    return z_n[0], ro_n[0], rb_n[0]
