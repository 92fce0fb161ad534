"""R-FAST runtime: the protocol round around a per-node gradient.

Counterpart of ``src/repro/core/runtime.py`` on one device.  Node
granularity: node i holds its own model replica x_i (row i of the
stacked ``(N, p)`` state) plus the protocol state:

  z       (N, p)      gradient-tracking variable
  g_prev  (N, p)      last sampled local gradient
  rho     (E_pad, p)  running sums ρ_ji per A-edge
  rho_buf (E_pad, p)  receiver buffers ρ̃_ij
  mail_v  (E_pad, p)  consensus mailboxes (robust mode only)

Execution is synchronous rounds: every round runs S1–S5 for all nodes;
per-edge ``masks`` gate delivery (0 = packet lost — the receiver reuses
its mailbox copy and the ρ running sums recover the mass on the next
success).  ``masks=None`` is the synchronous special case of Remark 2.

This module is an engine shell: it turns a per-node gradient
``grad_fn(x_flat, batch, key) -> (loss, g_flat)`` into the node-stacked
``vgrads`` (a loop over nodes, the reference's ``vmap``) and delegates
all protocol math to :mod:`repro_torch.core.protocol`.

``node_axes``: in the reference it names the mesh axes the node vmap
runs over (``spmd_axis_name``), so the model's sharding annotations
compose with the node axis of a dense round that GSPMD partitions.  The
port's dense round runs every node in this one process, so here it only
records that intent and changes nothing; a round with one node a rank
over mesh axes is :func:`repro_torch.core.runtime_sharded.
make_sharded_round`, whose ``node_axes`` place the nodes.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from ..spans import span
from .plan import CommPlan, build_comm_plan
from .protocol import (ProtocolState, init_protocol_state,
                       make_protocol_round, protocol_tracked_mass)
from .topology import Topology

__all__ = ["RFASTNodeState", "RuntimeSpec", "make_rfast_round",
           "init_node_state", "edge_arrays", "runtime_tracked_mass"]

GradFn = Callable[[torch.Tensor, Any, Any], tuple[torch.Tensor, torch.Tensor]]
# per-node: (x_flat (p,), batch, key) -> (loss, g_flat (p,))

# The runtime's state and static-spec types ARE the protocol's.
RFASTNodeState = ProtocolState
RuntimeSpec = CommPlan


def edge_arrays(topo: Topology, e_pad: int | None = None) -> CommPlan:
    """Topology -> CommPlan (kept name: the runtime's static spec)."""
    return build_comm_plan(topo, e_pad)


def _node_slice(batch: Any, i: int) -> Any:
    """Node ``i``'s part of a batch (a tensor or a tuple of tensors, each
    leading with N)."""
    if isinstance(batch, tuple):
        return tuple(t[i] for t in batch)
    return batch[i]


def _make_vgrads(grad_fn: GradFn):
    """Node-stacked gradient: (x (N, p), batches, keys) -> (losses (N,),
    grads (N, p)).  ``keys`` is None or a sequence of per-node keys."""

    def vgrads(x, batches, keys):
        grads = torch.empty_like(x)
        losses = []
        for i in range(x.shape[0]):
            with span("rfast.grad"):
                loss, g = grad_fn(x[i], _node_slice(batches, i),
                                  None if keys is None else keys[i])
            grads[i] = g
            losses.append(torch.as_tensor(loss, device=x.device))
        return torch.stack(losses), grads

    return vgrads


def init_node_state(
    spec: CommPlan,
    params: torch.Tensor,
    grad_fn: GradFn,
    batches: Any,              # (N, ...) pytree: each node's first batch
    keys: Sequence | None = None,
    *,
    node_axes: Sequence[str] = (),
    robust: bool = False,
    momentum: float = 0.0,
    stacked: bool = False,
) -> RFASTNodeState:
    """Paper init: x_i = x0 (broadcast), z_i = g_prev_i = ∇f_i(x0; ζ0).

    ``keys`` (the reference splits one ``jax.random`` key) is None or one
    key per node, passed to ``grad_fn`` as is.  ``stacked=True``: params
    is every node's ``(N, p)`` start.  ``node_axes``: see the module
    docstring (no effect in one process)."""
    return init_protocol_state(spec, params, _make_vgrads(grad_fn), batches,
                               keys, robust=robust, momentum=momentum,
                               stacked=stacked)


def make_rfast_round(
    spec: CommPlan,
    grad_fn: GradFn,
    *,
    gamma,
    node_axes: Sequence[str] = (),
    robust: bool = False,
    momentum: float = 0.0,
    impl: str = "plain",
    oracle: bool = False,
    donate: bool = False,
):
    """Build ``round_fn(state, batches, keys, masks) -> (state, metrics)``.

    ``batches``: (N, ...) pytree of per-node minibatches.  ``masks``:
    (E_pad,) float deliveries for BOTH graphs (1 = delivered) or None for
    the synchronous special case.  ``gamma`` may be a schedule.
    ``impl``: "plain" (edge-major scatter/gather) or "kernel" (one fused
    ``commit_grid`` launch per round; ``oracle=True`` one per-node commit
    kernel launch per node).  ``donate=True`` commits x/z/ρ/ρ̃ in place
    (callers must rebind and not reuse the old state).  ``node_axes``:
    see the module docstring (no effect in one process).
    """
    return make_protocol_round(spec, _make_vgrads(grad_fn), gamma=gamma,
                               robust=robust, momentum=momentum, impl=impl,
                               oracle=oracle, donate=donate)


# Lemma-3 invariant on runtime state (tested under loss masks)
runtime_tracked_mass = protocol_tracked_mass
