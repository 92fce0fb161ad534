# Copy of src/repro/core/plan.py, kept verbatim so the port imports nothing of the
# JAX package; tests/test_torch_planners.py pins identical tables.
"""CommPlan: the single Topology -> edge-plan extraction.

Every execution engine (global-view simulator, dense GSPMD runtime,
shard_map ppermute runtime, fused-kernel protocol backend) needs the same
static data derived from a :class:`~repro.core.topology.Topology`:

* **dense padded edge arrays** — ``(src, dst, weight)`` triples per edge of
  G(W) and G(A), zero-padded to a common length ``e_pad`` (a multiple of
  ``n`` so the edge dim shards evenly), plus the diagonals.  Padded entries
  have ``src = dst = 0`` and weight ``0`` so masked scatter/gather sums
  ignore them.
* **matching decomposition** — the edge sets split into slots with unique
  sources AND destinations, each realizable as one ``lax.ppermute``; plus
  per-slot weight tables indexed by node id.
* **per-node neighbour tables** — in-/out-edges of each node padded to the
  max degree, as (edge-position, neighbour-id, weight, validity) arrays.
  These feed the fused per-node Pallas update kernel
  (`kernels/rfast_update`), which wants dense ``(K, P)`` neighbour stacks.

Historically this extraction was triplicated (``runtime.edge_arrays``,
``simulator._EdgeData.build``, ``runtime_sharded._slot_tables``); it now
lives here, built ONCE per topology, and the engines consume slices of it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .topology import Topology

__all__ = ["CommPlan", "build_comm_plan", "as_comm_plan", "pad_comm_plan",
           "matchings"]


def matchings(edges: list[tuple[int, int]]) -> list[list[tuple[int, int]]]:
    """Greedy decomposition into unique-source/unique-dest matchings.

    Each matching can be realized as a single ``lax.ppermute`` along the
    node mesh axes (exactly one inter-node hop per edge).
    """
    remaining = list(edges)
    slots = []
    while remaining:
        used_s: set[int] = set()
        used_d: set[int] = set()
        slot, rest = [], []
        for (j, i) in remaining:
            if j not in used_s and i not in used_d:
                slot.append((j, i))
                used_s.add(j)
                used_d.add(i)
            else:
                rest.append((j, i))
        slots.append(slot)
        remaining = rest
    return slots


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """Static protocol data extracted once from a Topology.

    Edge convention: position ``e`` in the W arrays is the ``e``-th edge of
    ``topo.edges_W()`` (and likewise for A); per-edge delivery masks are
    indexed the same way.  Positions ``>= n_edges_*`` are zero-weight
    padding.
    """

    n: int
    e_pad: int
    n_edges_w: int
    n_edges_a: int

    # -- dense padded edge arrays (all length e_pad / n) ----------------- #
    w_diag: np.ndarray   # (n,) f32
    a_diag: np.ndarray   # (n,) f32
    src_w: np.ndarray; dst_w: np.ndarray; w_edge: np.ndarray  # (e_pad,)
    src_a: np.ndarray; dst_a: np.ndarray; a_edge: np.ndarray  # (e_pad,)

    # -- matching decomposition (ppermute engine) ------------------------ #
    slots_w: tuple[tuple[tuple[int, int], ...], ...]
    slots_a: tuple[tuple[tuple[int, int], ...], ...]
    w_in_table: np.ndarray   # (S_w, n) f32: W[i, j] for slot edge (j, i)
    a_out_table: np.ndarray  # (S_a, n) f32: A[i, j] for slot edge (j, i)
    has_in_a: np.ndarray     # (S_a, n) f32: node i receives in slot s

    # -- per-node neighbour tables (fused-kernel backend) ---------------- #
    kw: int                  # max W in-degree  (>= 1)
    ka: int                  # max A in-degree  (>= 1)
    ko: int                  # max A out-degree (>= 1)
    in_w_epos: np.ndarray    # (n, kw) i32 W-edge position  (pad -> 0)
    in_w_src: np.ndarray     # (n, kw) i32 sender node id   (pad -> 0)
    in_w_wt: np.ndarray      # (n, kw) f32 W[i, j]          (pad -> 0)
    in_a_epos: np.ndarray    # (n, ka) i32 A-edge position  (pad -> 0)
    in_a_val: np.ndarray     # (n, ka) f32 1 = real edge
    out_a_epos: np.ndarray   # (n, ko) i32 A-edge position  (pad -> 0)
    out_a_wt: np.ndarray     # (n, ko) f32 A[dst, i]        (pad -> 0)
    out_a_val: np.ndarray    # (n, ko) f32 1 = real edge

    @property
    def s_w(self) -> int:
        return max(1, len(self.slots_w))

    @property
    def s_a(self) -> int:
        return max(1, len(self.slots_a))


def as_comm_plan(topo) -> "CommPlan":
    """Coerce a Topology-or-CommPlan argument to a CommPlan (engines
    accept either so a prebuilt plan is never re-derived)."""
    return topo if isinstance(topo, CommPlan) else build_comm_plan(topo)


def pad_comm_plan(plan: CommPlan, *, kw: int | None = None,
                  ka: int | None = None, ko: int | None = None) -> CommPlan:
    """Degree-pad the per-node neighbour tables to common maxima.

    CommPlans from different topologies (over the same ``n``) carry
    different max in-/out-degrees ``(kw, ka, ko)``; padding them to a
    shared maximum makes the WavefrontPlans built on top stackable into
    dense ``(S, ...)`` fleet arrays.  Padded columns are inert by the
    same argument as build_comm_plan's own degree padding: zero weight
    and zero validity (so gathers contribute nothing) with edge
    position / sender id 0 (so reads clamp harmlessly).  The dense edge
    arrays, matching decomposition, and diagonals are untouched.
    """
    kw = plan.kw if kw is None else int(kw)
    ka = plan.ka if ka is None else int(ka)
    ko = plan.ko if ko is None else int(ko)
    if kw < plan.kw or ka < plan.ka or ko < plan.ko:
        raise ValueError(
            f"cannot shrink degrees: have (kw={plan.kw}, ka={plan.ka}, "
            f"ko={plan.ko}), asked for ({kw}, {ka}, {ko})")
    if (kw, ka, ko) == (plan.kw, plan.ka, plan.ko):
        return plan

    def cols(a: np.ndarray, k: int) -> np.ndarray:
        if a.shape[1] == k:
            return a
        return np.concatenate(
            [a, np.zeros((a.shape[0], k - a.shape[1]), a.dtype)], axis=1)

    return dataclasses.replace(
        plan, kw=kw, ka=ka, ko=ko,
        in_w_epos=cols(plan.in_w_epos, kw), in_w_src=cols(plan.in_w_src, kw),
        in_w_wt=cols(plan.in_w_wt, kw),
        in_a_epos=cols(plan.in_a_epos, ka), in_a_val=cols(plan.in_a_val, ka),
        out_a_epos=cols(plan.out_a_epos, ko),
        out_a_wt=cols(plan.out_a_wt, ko), out_a_val=cols(plan.out_a_val, ko),
    )


def _pack_dense(edges, M, e_pad):
    src = np.zeros(e_pad, np.int32)
    dst = np.zeros(e_pad, np.int32)
    wt = np.zeros(e_pad, np.float32)
    for e, (j, i) in enumerate(edges):
        src[e], dst[e], wt[e] = j, i, M[i, j]
    return src, dst, wt


def _slot_tables(topo: Topology, slots_w, slots_a):
    n = topo.n
    w_in = np.zeros((max(1, len(slots_w)), n), np.float32)
    for s, es in enumerate(slots_w):
        for (j, i) in es:
            w_in[s, i] = topo.W[i, j]
    a_out = np.zeros((max(1, len(slots_a)), n), np.float32)
    has_in = np.zeros((max(1, len(slots_a)), n), np.float32)
    for s, es in enumerate(slots_a):
        for (j, i) in es:
            a_out[s, j] = topo.A[i, j]
            has_in[s, i] = 1.0
    return w_in, a_out, has_in


def _node_tables(n, edges, M, *, by: str):
    """Pad each node's edge list (by='dst': in-edges, by='src': out-edges)
    to the max degree.  Returns (epos, peer, weight, valid)."""
    per: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    for e, (j, i) in enumerate(edges):
        if by == "dst":
            per[i].append((e, j))
        else:
            per[j].append((e, i))
    k = max(1, max((len(p) for p in per), default=0))
    epos = np.zeros((n, k), np.int32)
    peer = np.zeros((n, k), np.int32)
    wt = np.zeros((n, k), np.float32)
    val = np.zeros((n, k), np.float32)
    for node, lst in enumerate(per):
        for s, (e, other) in enumerate(lst):
            epos[node, s] = e
            peer[node, s] = other
            if by == "dst":       # in-edge (other -> node): weight M[node, other]
                wt[node, s] = M[node, other]
            else:                 # out-edge (node -> other): weight M[other, node]
                wt[node, s] = M[other, node]
            val[node, s] = 1.0
    return epos, peer, wt, val


def build_comm_plan(topo: Topology, e_pad: int | None = None) -> CommPlan:
    """Build the complete communication plan for ``topo``.

    ``e_pad`` defaults to the smallest multiple of ``n`` that fits every
    edge of either graph (so the padded edge dim shards evenly over the
    node mesh axes).
    """
    ew, ea = topo.edges_W(), topo.edges_A()
    E = max(len(ew), len(ea), 1)
    e_pad = e_pad or max(topo.n, -(-E // topo.n) * topo.n)
    if e_pad < max(len(ew), len(ea)):
        raise ValueError(f"e_pad={e_pad} < edge count {max(len(ew), len(ea))}")

    src_w, dst_w, w_edge = _pack_dense(ew, topo.W, e_pad)
    src_a, dst_a, a_edge = _pack_dense(ea, topo.A, e_pad)

    slots_w = matchings(ew)
    slots_a = matchings(ea)
    w_in_table, a_out_table, has_in_a = _slot_tables(topo, slots_w, slots_a)

    in_w_epos, in_w_src, in_w_wt, _ = _node_tables(topo.n, ew, topo.W,
                                                   by="dst")
    in_a_epos, _, _, in_a_val = _node_tables(topo.n, ea, topo.A, by="dst")
    out_a_epos, _, out_a_wt, out_a_val = _node_tables(topo.n, ea, topo.A,
                                                      by="src")

    return CommPlan(
        n=topo.n, e_pad=e_pad, n_edges_w=len(ew), n_edges_a=len(ea),
        w_diag=np.diag(topo.W).astype(np.float32),
        a_diag=np.diag(topo.A).astype(np.float32),
        src_w=src_w, dst_w=dst_w, w_edge=w_edge,
        src_a=src_a, dst_a=dst_a, a_edge=a_edge,
        slots_w=tuple(tuple(s) for s in slots_w),
        slots_a=tuple(tuple(s) for s in slots_a),
        w_in_table=w_in_table, a_out_table=a_out_table, has_in_a=has_in_a,
        kw=in_w_epos.shape[1], ka=in_a_epos.shape[1], ko=out_a_epos.shape[1],
        in_w_epos=in_w_epos, in_w_src=in_w_src, in_w_wt=in_w_wt,
        in_a_epos=in_a_epos, in_a_val=in_a_val,
        out_a_epos=out_a_epos, out_a_wt=out_a_wt, out_a_val=out_a_val,
    )
