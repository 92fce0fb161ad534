"""Logical-axis sharding rules for model tensors (MaxText-style).

Counterpart of ``src/repro/models/sharding.py``: the rule tables
(:data:`DEFAULT_RULES`, :data:`FSDP_RULES`), the thread-local
``(mesh, rules)`` context (:func:`mesh_rules`, :func:`current_rules`),
and the mapping of logical axes to mesh axes (:func:`logical_to_spec`),
copied.  A mesh is anything with the reference's ``mesh.shape[axis]``:
a :class:`~repro_torch.launch.mesh.SweepMesh`, a described mesh
(``launch.mesh.describe_mesh``) or JAX's ``AbstractMesh``.

:class:`PartitionSpec` is the port's own: a tuple of mesh axes per
dimension (None, an axis name or a tuple of names) whose ``repr`` is
JAX's.

In the reference, :func:`shard` is a ``with_sharding_constraint`` that
GSPMD takes as a layout for the compiler.  PyTorch compiles no program
here, and the port's mesh shards the R-FAST state's flat vector, not
the model's tensors (``core/runtime_sharded.py``), so the port's
:func:`shard` checks what the reference checks and returns ``x`` as it
is; its consumer is the launch tooling's report of what each rank would
hold (``launch/shardings.py``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

__all__ = ["PartitionSpec", "NamedSharding", "shard", "logical_to_spec",
           "mesh_rules", "named_sharding", "DEFAULT_RULES", "FSDP_RULES",
           "current_rules"]


class PartitionSpec(tuple):
    """Mesh axes per dimension of a tensor: each entry None (replicated),
    an axis name, or a tuple of axis names (sharded over their product).
    Entries are canonical as JAX keeps them: a one-name tuple is the
    name, an empty one None, a list a tuple."""

    def __new__(cls, *parts):
        def canon(p):
            if isinstance(p, (tuple, list)):
                return None if not p else p[0] if len(p) == 1 else tuple(p)
            return p
        return super().__new__(cls, tuple(canon(p) for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class NamedSharding(tuple):
    """A ``(mesh, spec)`` pair: the reference's ``NamedSharding``, which
    the port only reports."""

    def __new__(cls, mesh, spec: PartitionSpec):
        return super().__new__(cls, (mesh, spec))

    @property
    def mesh(self):
        return self[0]

    @property
    def spec(self) -> PartitionSpec:
        return self[1]


# logical axis -> mesh axis (None = replicated)
DEFAULT_RULES: dict[str, Optional[str]] = {
    "batch": "data",          # per-node batch (node axis handled outside)
    "node": "data",
    "seq": None,
    "embed": None,
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "vocab": "model",
    "expert": "model",
    "cap": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "kv_seq": None,
    "frontend": None,
}

# beyond-baseline: fully-sharded params (FSDP over the data axis on the
# embed dim) — used by the memory-term hillclimb.
FSDP_RULES = dict(DEFAULT_RULES, embed="data")

_local = threading.local()


def current_rules():
    return getattr(_local, "ctx", None)


@contextlib.contextmanager
def mesh_rules(mesh, rules: dict[str, Optional[str]] | None = None):
    """Activate (mesh, rules) for `shard` annotations in this thread."""
    prev = current_rules()
    _local.ctx = (mesh, rules or DEFAULT_RULES) if mesh is not None else None
    try:
        yield
    finally:
        _local.ctx = prev


def _axis_size(mesh, m) -> int:
    if isinstance(m, (tuple, list)):
        s = 1
        for a in m:
            s *= mesh.shape[a]
        return s
    return mesh.shape[m]


def logical_to_spec(axes: Sequence[Optional[str]],
                    rules: dict[str, Optional[str]],
                    shape: Sequence[int] | None = None,
                    mesh=None) -> PartitionSpec:
    used: set[str] = set()
    spec = []
    for i, ax in enumerate(axes):
        m = rules.get(ax) if ax else None
        if m is not None:
            flat = tuple(m) if isinstance(m, (tuple, list)) else (m,)
            if any(a in used for a in flat):
                m = None
            elif shape is not None and mesh is not None \
                    and shape[i] % _axis_size(mesh, flat):
                m = None    # axis does not divide this dim: best-effort drop
            else:
                used.update(flat)
        spec.append(m)
    return PartitionSpec(*spec)


def shard(x, *axes: Optional[str]):
    """The reference's logical sharding annotation: a no-op without an
    active mesh; inside one, a rank mismatch raises ``ValueError`` as
    the reference's does.  Then ``x`` comes back unchanged: there is no
    compiler to take the layout (see the module docstring)."""
    ctx = current_rules()
    if ctx is None:
        return x
    if x.ndim != len(axes):
        raise ValueError(f"rank {x.ndim} vs axes {axes}")
    return x


def named_sharding(mesh, rules, *axes: Optional[str]) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(axes, rules))
