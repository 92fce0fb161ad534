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

:func:`describe_mesh` makes a mesh that is only described: axis names
and sizes and the rank the caller analyses, with groups that hold no
process group and so can make no collective.  The launch tooling
(``launch/specs.py``, ``launch/dryrun.py``) runs one rank of such a mesh
on ``torch.device("meta")``, where the collectives only record what
they would move.  :func:`make_production_mesh` is the reference's
production mesh laid out on DGX H100 hosts, and :data:`HW` holds the
H100 SXM 80GB rates the roofline divides by.
"""
from __future__ import annotations

import dataclasses

from ..core.runtime_sharded import CARDS_PER_HOST, AxisGroup, DescribedGroup

__all__ = ["SweepMesh", "make_sweep_mesh", "node_axes_for",
           "describe_mesh", "make_production_mesh", "HW",
           "HBM_BYTES_PER_S", "FP32_FLOP_PER_S", "TF32_FLOP_PER_S",
           "BF16_FLOP_PER_S", "MUFU_PER_CLOCK_SM", "H100_SMS",
           "NVLINK_BYTES_PER_S", "IB_BYTES_PER_S", "CARDS_PER_HOST",
           "HBM_BYTES"]

# H100 SXM5 80GB, NVIDIA H100 Tensor Core GPU data sheet (dense rates,
# no sparsity, at the 700 W limit); data-sheet figures, not measurements
HBM_BYTES_PER_S = 3.35e12    # HBM3
HBM_BYTES = 80e9             # 80 GB of HBM3
FP32_FLOP_PER_S = 67e12      # fp32 outside the tensor cores
TF32_FLOP_PER_S = 495e12     # TF32 tensor cores
BF16_FLOP_PER_S = 989e12     # bf16 tensor cores, fp32 accumulate
H100_SMS = 132               # SMs of the SXM5 part
# sm_90 special-function (MUFU: ex2, rcp, ...) results per clock per SM,
# the CUDA C++ Programming Guide's arithmetic-instruction throughput table
MUFU_PER_CLOCK_SM = 16
# DGX H100 (NVIDIA DGX H100 data sheet): CARDS_PER_HOST = 8 cards a host
# on NVLink 4, 900 GB/s a card in both directions together, so 450 GB/s
# each way; one ConnectX-7 400 Gb/s NDR InfiniBand port a card between
# hosts, 50 GB/s
NVLINK_BYTES_PER_S = 450e9
IB_BYTES_PER_S = 50e9


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


def _described_groups(axis_names, sizes, rank) -> dict:
    """``rank``'s group along every non-empty subset of the axes: the
    ranks sharing its coordinates off the subset, in row-major order
    over the subset, each holding a :class:`DescribedGroup`."""
    import itertools

    import numpy as np
    grid = np.arange(int(np.prod(sizes))).reshape(sizes)
    coords = np.unravel_index(rank, sizes)
    out = {}
    for k in range(1, len(axis_names) + 1):
        for sub in itertools.combinations(range(len(axis_names)), k):
            idx = tuple(slice(None) if i in sub else coords[i]
                        for i in range(len(axis_names)))
            members = tuple(int(r) for r in grid[idx].reshape(-1))
            out[tuple(axis_names[i] for i in sub)] = AxisGroup(
                ranks=members, pg=DescribedGroup(rank=rank))
    return out


def describe_mesh(shape, axis_names, *, rank: int = 0) -> SweepMesh:
    """A mesh of ``shape`` (sizes in ``axis_names`` order) that is only
    described: ranks ``0 .. size − 1`` row-major (rank ``r`` of a host of
    :data:`CARDS_PER_HOST` cards is ``r // CARDS_PER_HOST``'s), the
    analysed rank ``rank``, and a group along every subset of the axes
    that holds a :class:`~repro_torch.core.runtime_sharded.
    DescribedGroup` in place of a process group.  It needs no process
    group and starts none; a collective over it runs only on meta
    tensors (it records what it would move and moves nothing) and raises
    on any other."""
    sizes = tuple(int(s) for s in shape)
    names = tuple(axis_names)
    if len(sizes) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"a mesh needs one distinct name per axis; got "
                         f"shape {sizes} and names {names}")
    if min(sizes, default=0) < 1:
        raise ValueError(f"mesh axes must have size >= 1, got {sizes}")
    total = 1
    for s in sizes:
        total *= s
    if not 0 <= rank < total:
        raise ValueError(f"rank {rank} is outside the {total} ranks of "
                         f"mesh {sizes}")
    return SweepMesh(axis_names=names, shape=dict(zip(names, sizes)),
                     ranks=tuple(range(total)), rank=int(rank),
                     groups=_described_groups(names, sizes, rank))


def make_production_mesh(*, multi_pod: bool = False,
                         rank: int = 0) -> SweepMesh:
    """The production mesh, described (:func:`describe_mesh`):
    ``("data", "model")`` = (32, 8), 256 cards, or with ``multi_pod``
    ``("pod", "data", "model")`` = (2, 32, 8), 512.

    The reference's chip counts and axis names on another layout: its
    (16, 16) and (2, 16, 16) fit a TPU v5e pod's 16 × 16 torus, where
    every axis runs over the same inter-chip links.  An H100 cluster is
    hosts of 8 cards joined by NVLink, the hosts by InfiniBand at about a
    ninth of that rate (:data:`HW`), so ``model`` spans the 8 cards of
    one host (32 DGX H100 hosts a pod) and ``data`` / ``pod`` cross
    hosts."""
    if multi_pod:
        return describe_mesh((2, 32, CARDS_PER_HOST),
                             ("pod", "data", "model"), rank=rank)
    return describe_mesh((32, CARDS_PER_HOST), ("data", "model"), rank=rank)


# the roofline's rates (per card), under the reference's key names:
# ``ici_bw`` is the link within a host (NVLink), ``ib_bw`` the one
# between hosts
HW = {
    "peak_flops_bf16": BF16_FLOP_PER_S,   # FLOP/s
    "hbm_bw": HBM_BYTES_PER_S,            # B/s
    "ici_bw": NVLINK_BYTES_PER_S,         # B/s, one direction
    "ib_bw": IB_BYTES_PER_S,              # B/s, one direction
}
