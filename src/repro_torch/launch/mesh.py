"""The sweep mesh: ranks laid out as (lane groups × param shards).

Counterpart of ``src/repro/launch/mesh.py``'s ``make_sweep_mesh`` and
``node_axes_for`` on ``torch.distributed``.  A :class:`SweepMesh` places
the world's ranks row-major on two named axes: rank ``r`` of the mesh
sits at lane group ``r // M`` and param shard ``r % M``.  It carries the
``dist.new_group`` subgroups along each axis (the ranks that share the
other axis' coordinate) and along both, which the engines' collectives
(:mod:`repro_torch.core.runtime_sharded`) run over.

With no process group initialized the world is this one process, so
:func:`make_sweep_mesh` with no arguments is the trivial 1 × 1 mesh and
needs no collective, as the reference's is on a 1-device CI.

The reference's ``make_production_mesh`` and ``HW`` (a TPU pod's mesh
and its roofline constants) wait for the launch tooling, where they get
the H100's.
"""
from __future__ import annotations

import dataclasses

from ..core.runtime_sharded import AxisGroup

__all__ = ["SweepMesh", "make_sweep_mesh", "node_axes_for"]


@dataclasses.dataclass(frozen=True)
class SweepMesh:
    """Ranks on named axes (see the module docstring).

    ``shape`` maps each axis name to its size, in ``axis_names`` order;
    ``ranks`` are the world ranks of the mesh, row-major; ``rank`` is
    this process's.  ``groups`` maps a tuple of axis names to this
    rank's :class:`~repro_torch.core.runtime_sharded.AxisGroup` along
    them (empty when this rank is outside the mesh)."""

    axis_names: tuple[str, ...]
    shape: dict
    ranks: tuple[int, ...]
    rank: int
    groups: dict

    @property
    def coords(self) -> dict | None:
        """This rank's index on every axis; None outside the mesh."""
        if self.rank not in self.ranks:
            return None
        i, out = self.ranks.index(self.rank), {}
        for a in reversed(self.axis_names):
            i, out[a] = divmod(i, self.shape[a])
        return {a: out[a] for a in self.axis_names}

    def axis_size(self, axis: str | None) -> int:
        """Size of ``axis``; 1 for None or a name the mesh lacks."""
        return int(self.shape.get(axis, 1)) if axis is not None else 1

    def group(self, axes) -> AxisGroup:
        """This rank's group along ``axes`` (an axis name or a tuple of
        them): the mesh ranks that share its coordinates on every other
        axis, ordered by their index along ``axes``."""
        key = (axes,) if isinstance(axes, str) else tuple(axes)
        key = tuple(a for a in self.axis_names if a in key)
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is not in the mesh "
                             f"(ranks {list(self.ranks)})")
        return self.groups[key]


def _world() -> tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _build_groups(lane_axis, param_axis, D, M, ranks, rank) -> dict:
    """This rank's groups: along the param axis (its lane group's M
    ranks), along the lane axis (the D ranks of its param shard) and
    along both.  Every rank enters ``dist.new_group`` for every group
    of more than one rank, in the same order, as torch requires even of
    non-members."""
    import torch.distributed as dist

    from .multihost import group_timeout
    world = (tuple(range(dist.get_world_size()))
             if dist.is_available() and dist.is_initialized() else None)
    made: dict[tuple, object] = {}
    mine: dict[tuple, AxisGroup] = {}
    for axes, sets in (((param_axis,), [ranks[g * M:(g + 1) * M]
                                         for g in range(D)]),
                       ((lane_axis,), [ranks[m::M] for m in range(M)]),
                       ((lane_axis, param_axis), [ranks])):
        for members in sets:
            pg = None
            if len(members) > 1:
                if members not in made:
                    made[members] = (
                        dist.group.WORLD if members == world
                        else dist.new_group(list(members),
                                            timeout=group_timeout()))
                pg = made[members]
            if rank in members:
                mine[axes] = AxisGroup(ranks=members, pg=pg)
    return mine


def make_sweep_mesh(*, lanes: int | None = None, param_shards: int = 1,
                    ranks=None, lane_axis: str = "data",
                    param_axis: str = "model") -> SweepMesh:
    """(lane groups × param shards) mesh for the mesh-mapped fleet sweep
    (``repro_torch.core.simulator.run_sweep(mesh=...)``).

    Uses the world's ranks (or ``ranks``, a list of them): any
    ``lanes * param_shards`` prefix works, so the same call runs on one
    process and on a fleet.  Defaults: every rank on the lane axis, no
    parameter sharding.  Every rank of the world must call it with the
    same arguments (the subgroups are made collectively)."""
    rank, world = _world()
    ranks = tuple(range(world)) if ranks is None else tuple(
        int(r) for r in ranks)
    m = int(param_shards)
    if m < 1:
        raise ValueError(f"param_shards must be >= 1, got {m}")
    d = int(lanes) if lanes is not None else max(1, len(ranks) // m)
    if d < 1:
        raise ValueError(f"lanes must be >= 1, got {d}")
    if d * m > len(ranks):
        raise ValueError(f"mesh {d}x{m} needs {d * m} devices, have "
                         f"{len(ranks)} (start more ranks: torchrun, or "
                         "repro_torch.launch.train --host-devices)")
    if lane_axis == param_axis:
        raise ValueError(f"the two axes need two names, got {lane_axis!r}")
    used = ranks[:d * m]
    return SweepMesh(axis_names=(lane_axis, param_axis),
                     shape={lane_axis: d, param_axis: m}, ranks=used,
                     rank=rank, groups=_build_groups(lane_axis, param_axis,
                                                     d, m, used, rank))


def node_axes_for(mesh, *, n_nodes: int | None = None) -> tuple[str, ...]:
    """Which mesh axes carry the R-FAST node dimension.

    Default: all non-'model' axes.  ``n_nodes`` may select the
    'pod'-only variant (nodes span pods, the 'data' axis is then free)."""
    names = mesh.axis_names
    if n_nodes is None:
        return tuple(a for a in names if a != "model")
    if "pod" in names and n_nodes == mesh.shape["pod"]:
        return ("pod",)
    non_model = tuple(a for a in names if a != "model")
    prod = 1
    for a in non_model:
        prod *= mesh.shape[a]
    if n_nodes == prod:
        return non_model
    raise ValueError(f"unsupported n_nodes={n_nodes} for mesh {names}")
