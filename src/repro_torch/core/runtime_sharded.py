"""R-FAST across ranks: the port's collectives and the ppermute round.

Counterpart of ``src/repro/core/runtime_sharded.py`` on
``torch.distributed``.  Every collective of the port goes through the
functions of this module, always in the same order on every rank of a
group (the reference chains its ppermutes through an
``optimization_barrier`` token for the same reason: independent
collectives issued in different orders deadlock):

* :func:`all_gather_flat` — a tiled gather along the last axis (the
  reference's ``lax.all_gather(..., tiled=True)``): the mesh engine's one
  collective a wave, and the full-width lane states it returns;
* :func:`ppermute` — one ``batch_isend_irecv`` per matching of G(W) or
  G(A); a rank that receives nothing gets zeros;
* the model group's collectives, which the reference's GSPMD inserts
  into its ``model``-axis program and the port's tensor parallelism
  (``models/sharding.py``) calls itself: :func:`all_reduce_sum`,
  :func:`all_reduce_max`, :func:`all_gather_seq` /
  :func:`reduce_scatter_seq` along one tensor dimension, and
  :func:`all_to_all_rows`; and over them the autograd pairs of
  Megatron's column- and row-parallel layers (:func:`copy_to_model`:
  identity forward, all-reduce backward; :func:`reduce_from_model`: the
  reverse; :func:`gather_from_model`: gather forward, this rank's block
  of the gradient backward; :func:`gather_from_seq` /
  :func:`reduce_scatter_to_seq`: the sequence-parallel gather and
  reduce-scatter, each the other's backward; :func:`all_to_all_model`:
  an exchange of rows forward, the reverse exchange backward).

Each call adds its output bytes to running totals by name
(:func:`collective_stats`, :func:`clear_collectives`), the way
``kernels/rfast_update/dispatch.py`` counts kernel launches; inside
:func:`record_collectives` it is also recorded one by one with its
shape, which is what RF206 (``analysis/torchlint.py``) audits.  Where a backend does not
carry point-to-point ops on a device's tensors (``STAGED``),
:func:`ppermute` always goes through pinned host buffers for that pair,
and the staged bytes are counted apart.  The rule is the pair's,
decided before the call: a collective never retries staged after an
error.  Gloo carries the gathers, all-reduces and reduce-scatters of
CUDA tensors itself, each rank of an all-reduce getting the same bits
(``tools/dist_probe.py`` on torch 2.11 and an H100), so only
point-to-point is staged.

On meta tensors (the launch tooling's dry-run) no collective calls
``torch.distributed``: each returns a meta output of the shape it would
return and records itself, with its group's size and whether the group
stays within one host (``CARDS_PER_HOST`` ranks, row-major).  That is
also the only thing a collective may do over a mesh that is only
described (``launch.mesh.describe_mesh``), whose groups hold a
:class:`DescribedGroup` in place of a process group.

The round (:func:`make_sharded_round`): the edge sets of G(W)/G(A) are
decomposed into matchings (unique sources and destinations;
:func:`repro_torch.core.plan.matchings`), and each matching becomes one
:func:`ppermute` among the ranks of the node axes — one node a rank,
O(deg · p) traffic, exactly one hop per edge.  The protocol math is
:mod:`repro_torch.core.protocol`'s scalar steps over the CommPlan's slot
tables; only the data movement differs from ``runtime.py``'s dense
round.

State layout (each rank holds its node's rows, the reference's ``(N,
...)`` arrays sharded over the node axes; slots padded to the max
degree):

  x, z, g_prev, m : (1, p)
  rho_out         : (1, S_a, p)   sender's running sums, slot-indexed
  rho_buf         : (1, S_a, p)   receiver's buffers, slot-indexed
  mail_v          : (1, S_w, p)   consensus mailboxes (robust mode)

The reference's PartitionSpec functions become layout functions that say
what a rank holds: :func:`sharded_state_specs` (its node's rows, and
:func:`shard_state` applies it) and :func:`packed_sweep_specs` (its lane
group and its slice of the flat parameter axis in the mesh sweep).  Its
``partial_auto_shard_map_supported`` / ``_shard_map`` pick a generation
of ``jax.shard_map`` that keeps the ``model`` axis AUTO, so that GSPMD
runs the per-node gradient tensor-parallel.  Here the round's
ppermutes run over the node axes' group (the ranks that share this
rank's ``model`` coordinate), and the ``model`` axis is what the
gradient makes of it: with a tensor-parallel gradient
(``models.sharding.tensor_parallel_grad``) a rank's rows are the flat
ravel of its blocks of the parameter tree, and the round's math, all
elementwise, runs on them as it runs on whole rows; with a plain
gradient the ranks of a model group run their node's round again on
whole rows (a replicated axis).
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, NamedTuple

import torch

from .plan import CommPlan, as_comm_plan, matchings  # noqa: F401 (re-export)
from .protocol import descent_step, mailbox_merge, momentum_mix, tracking_step
from .topology import Topology

__all__ = ["AxisGroup", "DescribedGroup", "ShardedState", "SweepLayout",
           "matchings", "CARDS_PER_HOST",
           "all_gather_flat", "ppermute", "all_reduce_sum", "all_reduce_max",
           "all_gather_seq", "reduce_scatter_seq", "all_to_all_rows",
           "copy_to_model", "reduce_from_model", "gather_from_model",
           "gather_from_seq", "all_to_all_model",
           "reduce_scatter_to_seq", "rank_block", "collective_stats",
           "clear_collectives", "record_collectives", "STAGED",
           "make_sharded_round", "init_sharded_state", "node_index",
           "sharded_state_specs", "shard_state", "packed_sweep_specs"]

GradFn = Callable[[torch.Tensor, Any, Any], tuple[torch.Tensor, torch.Tensor]]
# per-node: (x_flat (p,), batch, key) -> (loss, g_flat (p,))

# (backend, device type) pairs whose point-to-point ops ppermute stages
# through pinned host buffers, always.  Gloo gathers CUDA tensors
# (all_gather_into_tensor) but its send / recv fail on them ("writev ...
# Bad address", torch 2.11 on an H100; tools/dist_probe.py)
STAGED = frozenset({("gloo", "cuda")})
# ranks of one host in a described mesh (a DGX H100's 8 cards on NVLink;
# launch.mesh.CARDS_PER_HOST, which takes it from here)
CARDS_PER_HOST = 8


class DescribedGroup(NamedTuple):
    """The process group of a mesh that is only described: none.  It
    names the rank the caller analyses, so that rank knows its place in
    the group; a collective over it runs only on meta tensors."""

    rank: int


class AxisGroup(NamedTuple):
    """The ranks of one mesh group, in axis order, and their process
    group (None when the group is this rank alone)."""

    ranks: tuple[int, ...]
    pg: Any

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def index(self) -> int:
        """This rank's place in the group."""
        if isinstance(self.pg, DescribedGroup):
            return self.ranks.index(self.pg.rank)
        import torch.distributed as dist
        rank = dist.get_rank() if self.pg is not None else self.ranks[0]
        return self.ranks.index(rank)

    @property
    def intra_host(self) -> bool:
        """Whether the group's ranks share one host of
        :data:`CARDS_PER_HOST` (row-major world ranks)."""
        return len({r // CARDS_PER_HOST for r in self.ranks}) == 1


# --------------------------------------------------------------------- #
# the collective record
# --------------------------------------------------------------------- #
_totals: dict[str, dict] = {}
_recorders: list[list[dict]] = []


def _note(name: str, out: torch.Tensor, group_size: int, staged: int,
          t0: float | None = None, intra_host: bool = True) -> None:
    nb = out.numel() * out.element_size()
    dt = 0.0 if t0 is None else time.perf_counter() - t0
    tot = _totals.setdefault(name, {"calls": 0, "bytes": 0,
                                    "staged_bytes": 0, "seconds": 0.0,
                                    "max_bytes": 0})
    tot["calls"] += 1
    tot["bytes"] += nb
    tot["staged_bytes"] += staged
    tot["seconds"] += dt
    tot["max_bytes"] = max(tot["max_bytes"], nb)
    for calls in _recorders:
        calls.append({"name": name, "shape": tuple(out.shape), "bytes": nb,
                      "staged_bytes": staged, "group_size": group_size,
                      "intra_host": intra_host, "seconds": dt})


@contextlib.contextmanager
def record_collectives():
    """Record every collective issued inside the block, one dict each:
    its name, output shape and bytes, staged bytes, group size and the
    host seconds the call took (the whole exchange for gloo, whose calls
    return when it is done; only the enqueue for NCCL).  Yields the list
    the calls are appended to.  Outside such a block only the running
    totals of :func:`collective_stats` are kept."""
    calls: list[dict] = []
    _recorders.append(calls)
    try:
        yield calls
    finally:
        _recorders.remove(calls)


def collective_stats() -> dict:
    """Running totals since the last :func:`clear_collectives`:
    ``{"calls", "bytes", "staged_bytes", "seconds", "by_name": {name:
    {"calls", "bytes", "staged_bytes", "seconds", "max_bytes"}}}``."""
    by = {k: dict(v) for k, v in _totals.items()}
    return {"calls": sum(v["calls"] for v in by.values()),
            "bytes": sum(v["bytes"] for v in by.values()),
            "staged_bytes": sum(v["staged_bytes"] for v in by.values()),
            "seconds": sum(v["seconds"] for v in by.values()),
            "by_name": by}


def clear_collectives() -> None:
    """Zero the running totals."""
    _totals.clear()


def _meta_or_live(group: AxisGroup | None, t: torch.Tensor) -> bool:
    """True for a meta ``t`` (the collective only records itself);
    raises for a live tensor over a described mesh's group."""
    if t.device.type == "meta":
        return True
    if group is not None and isinstance(group.pg, DescribedGroup):
        raise ValueError("a described mesh (launch.mesh.describe_mesh) "
                         "makes no collective: run its step on meta tensors")
    return False


def _staged(group: AxisGroup, t: torch.Tensor) -> bool:
    import torch.distributed as dist
    return (str(dist.get_backend(group.pg)).lower(), t.device.type) in STAGED


# --------------------------------------------------------------------- #
# the two collectives
# --------------------------------------------------------------------- #
def all_gather_flat(t: torch.Tensor, group: AxisGroup | None) -> torch.Tensor:
    """Tiled gather of ``t`` along its last axis over ``group``: ``(...,
    q)`` on each of M ranks -> ``(..., M·q)``, rank i's block at
    ``[i·q, (i+1)·q)`` (the reference's ``all_gather(..., tiled=True)``
    on the flat parameter axis).  A group of one returns ``t``."""
    import torch.distributed as dist
    M = 1 if group is None else group.size
    if M == 1:
        _note("all_gather_flat", t, 1, 0)
        return t
    if _meta_or_live(group, t):
        out = t.new_empty((*t.shape[:-1], M * t.shape[-1]))
        _note("all_gather_flat", out, M, 0, intra_host=group.intra_host)
        return out
    t0 = time.perf_counter()
    src = t.contiguous()
    buf = torch.empty((M,) + src.shape, dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(buf.view(-1), src.view(-1), group=group.pg)
    out = buf.movedim(0, -2).reshape(*src.shape[:-1], M * src.shape[-1])
    _note("all_gather_flat", out, M, 0, t0)
    return out


def ppermute(t: torch.Tensor, perm, group: AxisGroup | None) -> torch.Tensor:
    """Send ``t`` along ``perm``, a list of ``(src, dst)`` indices into
    ``group`` with unique sources and destinations; returns what this
    rank receives, zeros where no pair ends at it (the reference's
    ``tperm``).  An empty ``perm`` moves nothing."""
    import torch.distributed as dist
    perm = [(int(s), int(d)) for s, d in perm]
    if not perm:
        out = torch.zeros_like(t)
        if t.device.type != "meta":     # on meta: nothing moves, no record
            _note("ppermute", out, 1 if group is None else group.size, 0)
        return out
    if group is None or group.size == 1:
        out = t.clone() if (0, 0) in perm else torch.zeros_like(t)
        _note("ppermute", out, 1, 0)
        return out
    if _meta_or_live(group, t):
        out = torch.empty_like(t)
        _note("ppermute", out, group.size, 0, intra_host=group.intra_host)
        return out
    t0 = time.perf_counter()
    me = group.index
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    out = torch.zeros_like(t)
    staged = _staged(group, t)
    send = t.contiguous()
    recv = out
    if staged:
        send = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        send.copy_(t)
        recv = torch.zeros(t.shape, dtype=t.dtype, pin_memory=True)
    ops = [dist.P2POp(dist.isend, send, group.ranks[d], group=group.pg)
           for d in dst]
    ops += [dist.P2POp(dist.irecv, recv, group.ranks[s], group=group.pg)
            for s in src]
    for w in dist.batch_isend_irecv(ops) if ops else ():
        w.wait()
    if staged:
        out.copy_(recv)
    nb = out.numel() * out.element_size()
    _note("ppermute", out, group.size, nb * (len(dst) + len(src))
          if staged else 0, t0)
    return out


# --------------------------------------------------------------------- #
# the model group's collectives
# --------------------------------------------------------------------- #
def _all_reduce(name: str, t: torch.Tensor, group: AxisGroup | None,
                op: str) -> torch.Tensor:
    import torch.distributed as dist
    M = 1 if group is None else group.size
    if M == 1:
        _note(name, t, 1, 0)
        return t
    if _meta_or_live(group, t):
        out = torch.empty_like(t)
        _note(name, out, M, 0, intra_host=group.intra_host)
        return out
    t0 = time.perf_counter()
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=group.pg)
    _note(name, out, M, 0, t0)
    return out


def all_reduce_sum(t: torch.Tensor, group: AxisGroup | None) -> torch.Tensor:
    """The elementwise sum of ``t`` over the ranks of ``group`` (the
    reference's ``psum``), a new tensor on every rank; a group of one
    returns ``t``."""
    return _all_reduce("all_reduce_sum", t, group, "sum")


def all_reduce_max(t: torch.Tensor, group: AxisGroup | None) -> torch.Tensor:
    """The elementwise max of ``t`` over the ranks of ``group`` (``pmax``)."""
    return _all_reduce("all_reduce_max", t, group, "max")


def all_gather_seq(t: torch.Tensor, group: AxisGroup | None,
                   dim: int = 1) -> torch.Tensor:
    """Tiled gather of ``t`` along ``dim`` over ``group``: rank i's ``t``
    at ``[i·n, (i+1)·n)`` of that dim (the sequence-parallel gather, and
    a sharded leaf's gather into the whole leaf)."""
    import torch.distributed as dist
    M = 1 if group is None else group.size
    dim = dim % t.dim()
    shape = tuple(t.shape)
    full = shape[:dim] + (M * shape[dim],) + shape[dim + 1:]
    if M == 1:
        _note("all_gather_seq", t, 1, 0)
        return t
    if _meta_or_live(group, t):
        out = t.new_empty(full)
        _note("all_gather_seq", out, M, 0, intra_host=group.intra_host)
        return out
    t0 = time.perf_counter()
    src = t.contiguous()
    buf = torch.empty((M,) + shape, dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(buf.view(-1), src.view(-1), group=group.pg)
    out = buf.movedim(0, dim).reshape(full)
    _note("all_gather_seq", out, M, 0, t0)
    return out


def reduce_scatter_seq(t: torch.Tensor, group: AxisGroup | None,
                       dim: int = 1) -> torch.Tensor:
    """The sum of ``t`` over ``group``, of which rank i keeps block i of
    ``dim`` (``[i·n/M, (i+1)·n/M)``; the sequence-parallel reduce-scatter).
    ``dim`` must divide over the group."""
    import torch.distributed as dist
    M = 1 if group is None else group.size
    dim = dim % t.dim()
    shape = tuple(t.shape)
    if shape[dim] % M:
        raise ValueError(f"dim {dim} of {shape} does not divide over the "
                         f"{M} ranks of the group")
    part = shape[:dim] + (shape[dim] // M,) + shape[dim + 1:]
    if M == 1:
        _note("reduce_scatter_seq", t, 1, 0)
        return t
    if _meta_or_live(group, t):
        out = t.new_empty(part)
        _note("reduce_scatter_seq", out, M, 0, intra_host=group.intra_host)
        return out
    t0 = time.perf_counter()
    src = t.unflatten(dim, (M, shape[dim] // M)).movedim(dim, 0).contiguous()
    out = torch.empty(part, dtype=t.dtype, device=t.device)
    # torch 2.13 renames reduce_scatter_tensor; 2.11 has only the old name
    rs = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    rs(out.view(-1), src.view(-1), group=group.pg)
    _note("reduce_scatter_seq", out, M, 0, t0)
    return out


def all_to_all_rows(t: torch.Tensor, group: AxisGroup | None,
                    send, recv) -> torch.Tensor:
    """The rows of ``t`` (its leading dim) exchanged over ``group``: the
    first ``send[0]`` to the group's rank 0, the next ``send[1]`` to its
    rank 1, and so on; returns the rows received, ``recv[i]`` from rank
    i, in rank order (``all_to_all_single`` with those splits)."""
    import torch.distributed as dist
    M = 1 if group is None else group.size
    if sum(send) != t.shape[0] or len(send) != M or len(recv) != M:
        raise ValueError(f"splits {list(send)} -> {list(recv)} do not fit "
                         f"{t.shape[0]} rows over {M} ranks")
    full = (sum(recv),) + tuple(t.shape[1:])
    if M == 1:
        _note("all_to_all", t, 1, 0)
        return t
    if _meta_or_live(group, t):
        out = t.new_empty(full)
        _note("all_to_all", out, M, 0, intra_host=group.intra_host)
        return out
    t0 = time.perf_counter()
    out = torch.empty(full, dtype=t.dtype, device=t.device)
    dist.all_to_all_single(out, t.contiguous(), output_split_sizes=list(recv),
                           input_split_sizes=list(send), group=group.pg)
    _note("all_to_all", out, M, 0, t0)
    return out


def rank_block(t: torch.Tensor, group: AxisGroup, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` (``group.size`` blocks)."""
    n = t.shape[dim] // group.size
    return t.narrow(dim, group.index * n, n)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_seq(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return rank_block(g, ctx.group, ctx.dim), None, None


class _GatherFromSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_seq(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_seq(g, ctx.group, ctx.dim), None, None


class _ReduceScatterToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter_seq(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_seq(g, ctx.group, ctx.dim), None, None


class _AllToAllModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, send, recv):
        ctx.group, ctx.send, ctx.recv = group, send, recv
        return all_to_all_rows(x, group, send, recv)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_rows(g, ctx.group, ctx.recv, ctx.send), None, \
            None, None


def copy_to_model(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """Megatron's f: ``x`` forward, the all-reduce of its gradient over
    ``group`` backward (the input of a column-parallel layer, which each
    rank's block differentiates only in part)."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """Megatron's g: the all-reduce of ``x`` forward (a row-parallel
    layer's partial sums), its gradient as it is backward."""
    return _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, group: AxisGroup,
                      dim: int) -> torch.Tensor:
    """The gather of ``x`` along ``dim`` forward; backward, this rank's
    block of the gradient, which every rank computed whole."""
    return _GatherFromModel.apply(x, group, dim)


def gather_from_seq(x: torch.Tensor, group: AxisGroup,
                    dim: int = 1) -> torch.Tensor:
    """The gather of ``x`` along ``dim`` forward, the reduce-scatter of
    its gradient backward (each rank's gradient of the whole is a part)."""
    return _GatherFromSeq.apply(x, group, dim)


def all_to_all_model(x: torch.Tensor, group: AxisGroup, send,
                     recv) -> torch.Tensor:
    """:func:`all_to_all_rows` of ``x`` forward; backward, its gradient's
    rows sent back where they came from."""
    return _AllToAllModel.apply(x, group, tuple(send), tuple(recv))


def reduce_scatter_to_seq(x: torch.Tensor, group: AxisGroup,
                          dim: int = 1) -> torch.Tensor:
    """The reduce-scatter of ``x`` along ``dim`` forward, the gather of
    its gradient backward."""
    return _ReduceScatterToSeq.apply(x, group, dim)


# --------------------------------------------------------------------- #
# layouts: what a rank holds
# --------------------------------------------------------------------- #
class ShardedState(NamedTuple):
    step: int
    x: torch.Tensor
    z: torch.Tensor
    g_prev: torch.Tensor
    rho_out: torch.Tensor
    rho_buf: torch.Tensor
    mail_v: torch.Tensor | None
    m: torch.Tensor | None


def node_index(mesh, node_axes) -> int:
    """This rank's node: its index along the node axes (the reference's
    ``_node_index``: row-major over ``node_axes``)."""
    return mesh.group(tuple(node_axes)).index


def sharded_state_specs(mesh, node_axes) -> slice:
    """The rows of an ``(N, ...)`` :class:`ShardedState` field this rank
    holds: its own node (the reference's ``P(node_axes, None, ...)``)."""
    i = node_index(mesh, node_axes)
    return slice(i, i + 1)


def shard_state(state, mesh, node_axes):
    """This rank's block of ``state``: a :class:`ShardedState` or any
    tuple of tensors (a batch) leading with the node axis, its rows
    :func:`sharded_state_specs` copied out (so the round updates no
    other node's rows)."""
    rows = sharded_state_specs(mesh, node_axes)
    pick = lambda t: (t[rows].clone() if isinstance(t, torch.Tensor)
                      else t)
    if isinstance(state, ShardedState):
        return state._replace(**{f: pick(getattr(state, f))
                                 for f in state._fields[1:]})
    if isinstance(state, tuple):
        return tuple(pick(t) for t in state)
    return pick(state)


class SweepLayout(NamedTuple):
    """What one rank of a mesh sweep holds (:func:`packed_sweep_specs`):
    lane group ``g`` of ``D`` (lanes ``[g·S_loc, (g+1)·S_loc)`` of the
    ``S_pad`` padded lanes) and param shard ``m`` of ``M`` (columns
    ``[m·p_loc, (m+1)·p_loc)`` of the ``p_pad`` padded width, of which
    ``[lo, hi)`` are real).  ``param`` is the param axis' group."""

    D: int
    M: int
    g: int
    m: int
    S_pad: int
    S_loc: int
    p: int
    p_pad: int
    p_loc: int
    param: AxisGroup | None

    @property
    def lanes(self) -> range:
        return range(self.g * self.S_loc, (self.g + 1) * self.S_loc)

    @property
    def lo(self) -> int:
        return min(self.p, self.m * self.p_loc)

    @property
    def hi(self) -> int:
        return min(self.p, (self.m + 1) * self.p_loc)


def packed_sweep_specs(mesh, n_lanes: int, p: int, *,
                       lane_axis: str = "data",
                       param_axis: str | None = "model") -> SweepLayout:
    """The reference's per-leaf PartitionSpecs of the mesh sweep
    (``P(lane_axis, ..., param_axis)`` on the state, ``P(lane_axis,
    ...)`` on the wave tables) as this rank's share: the lanes pad to a
    multiple of the lane axis' size D (the last lane repeated) and split
    into D contiguous groups; the flat axis pads with zeros to ``p_pad =
    M·ceil(p / M)`` and splits into M slices when the param axis has
    size M > 1 (else every rank of a group holds the full width).
    ``mesh=None`` is the one-process layout: every lane, full width.
    Raises for a rank outside the mesh."""
    if mesh is None:
        return SweepLayout(D=1, M=1, g=0, m=0, S_pad=n_lanes, S_loc=n_lanes,
                           p=p, p_pad=p, p_loc=p, param=None)
    coords = mesh.coords
    if coords is None:
        raise ValueError(f"rank {mesh.rank} is not in the mesh "
                         f"(ranks {list(mesh.ranks)})")
    D = mesh.axis_size(lane_axis)
    M = mesh.axis_size(param_axis)
    S_pad = -(-n_lanes // D) * D
    p_pad = -(-p // M) * M
    return SweepLayout(D=D, M=M, g=coords[lane_axis],
                       m=coords[param_axis] if M > 1 else 0, S_pad=S_pad,
                       S_loc=S_pad // D, p=p, p_pad=p_pad, p_loc=p_pad // M,
                       param=mesh.group(param_axis) if M > 1 else None)


# --------------------------------------------------------------------- #
# the ppermute round
# --------------------------------------------------------------------- #
def _node_slice(batch: Any, i: int) -> Any:
    if isinstance(batch, tuple):
        return tuple(t[i] for t in batch)
    return batch[i]


def init_sharded_state(topo: Topology | CommPlan, params: torch.Tensor,
                       grad_fn: GradFn, batches: Any, keys=None, *,
                       momentum: float = 0.0,
                       robust: bool = False) -> ShardedState:
    """Init with the reference's unsharded semantics: every node's rows,
    x_i = params, z_i = g_prev_i = ∇f_i(params; batches[i]); rank r
    keeps its block with :func:`shard_state`."""
    plan = as_comm_plan(topo)
    n = plan.n
    if params.dim() != 1:
        raise ValueError(f"params must be flat (p,), got "
                         f"{tuple(params.shape)}")
    x = params.reshape(1, -1).expand(n, -1).clone()
    g0 = torch.stack([grad_fn(x[i], _node_slice(batches, i),
                              None if keys is None else keys[i])[1]
                      for i in range(n)])
    zer = lambda S: x.new_zeros((n, S, x.shape[1]))
    return ShardedState(
        step=0, x=x, z=g0, g_prev=g0.clone(), rho_out=zer(plan.s_a),
        rho_buf=zer(plan.s_a), mail_v=zer(plan.s_w) if robust else None,
        m=torch.zeros_like(x) if momentum else None)


def make_sharded_round(
    topo: Topology | CommPlan,
    grad_fn: GradFn,
    mesh,
    *,
    gamma,
    node_axes,
    momentum: float = 0.0,
    robust: bool = False,
):
    """Build ``round_fn(state, batches, keys=None, masks=None) -> (state,
    metrics)`` over this rank's node (:func:`shard_state` of an
    :func:`init_sharded_state`).

    ``batches`` is the node's block (a tensor or tuple leading with 1),
    ``keys`` None or its one key, ``masks`` None or its ``(1, S_w + S_a)``
    0/1 deliveries in robust mode.  ``gamma`` may be a schedule.  The
    node axes' ranks must number the topology's nodes.  Every rank of
    the mesh calls the round in step; the metrics hold every node's
    loss (one gather of n floats)."""
    plan = as_comm_plan(topo)
    group = mesh.group(tuple(node_axes))
    if group.size != plan.n:
        raise ValueError(f"node axes {tuple(node_axes)} hold {group.size} "
                         f"ranks, the topology {plan.n} nodes")
    idx = group.index
    slots_w, slots_a = plan.slots_w, plan.slots_a
    S_w, S_a = plan.s_w, plan.s_a
    tables = {}

    def col(name, table, dev):
        if (name, dev) not in tables:
            tables[(name, dev)] = torch.as_tensor(table[..., idx],
                                                  device=dev)
        return tables[(name, dev)]

    def round_fn(state: ShardedState, batches, keys=None, masks=None):
        dev = state.x.device
        w_diag = col("w_diag", plan.w_diag, dev)
        a_diag = col("a_diag", plan.a_diag, dev)
        w_in, a_out = col("w_in", plan.w_in_table, dev), col(
            "a_out", plan.a_out_table, dev)
        has_in = col("has_in", plan.has_in_a, dev)
        lr = gamma(state.step) if callable(gamma) else gamma

        # (S1) local descent direction
        if momentum:
            m = momentum_mix(state.m, state.z, momentum)
            v = descent_step(state.x, m, lr)
        else:
            m = None
            v = descent_step(state.x, state.z, lr)

        # (S2a) consensus pull: one ppermute per W-matching
        x_new = w_diag * v
        mail_new = []
        for s in range(S_w):
            rv = ppermute(v, slots_w[s] if s < len(slots_w) else [], group)
            if robust:
                mk = masks[0, s] if masks is not None else 1.0
                rv = mailbox_merge(rv, state.mail_v[:, s], mk)
                mail_new.append(rv)
            x_new = x_new + w_in[s] * rv

        # (S2b) fresh gradient at the mixed point
        loss, g = grad_fn(x_new[0], _node_slice(batches, 0),
                          None if keys is None else keys[0])
        g_new = g[None]

        # robust tracking: one ppermute per A-matching
        recv = torch.zeros_like(state.z)
        buf_new = []
        for s in range(S_a):
            rr = ppermute(state.rho_out[:, s],
                          slots_a[s] if s < len(slots_a) else [], group)
            mk = (masks[0, S_w + s] if (robust and masks is not None)
                  else 1.0)
            old = state.rho_buf[:, s]
            gate = mk * has_in[s]
            recv = recv + gate * (rr - old)
            buf_new.append(mailbox_merge(rr, old, gate))

        z_half = tracking_step(state.z, recv, g_new, state.g_prev)
        z_new = a_diag * z_half
        rho_out_new = state.rho_out + torch.stack(
            [a_out[s] * z_half[0] for s in range(S_a)])[None]
        new_state = ShardedState(
            step=state.step + 1, x=x_new, z=z_new, g_prev=g_new,
            rho_out=rho_out_new, rho_buf=torch.stack(buf_new, dim=1),
            mail_v=torch.stack(mail_new, dim=1) if robust else None, m=m)
        losses = all_gather_flat(
            torch.as_tensor(loss, dtype=torch.float32,
                            device=dev).reshape(1), group)
        return new_state, {"loss": losses.mean(), "losses": losses}

    return round_fn
