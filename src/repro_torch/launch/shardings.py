"""Leaf-path → PartitionSpec resolution for params, protocol state,
batches and KV caches.

Counterpart of ``src/repro/launch/shardings.py``; the rule tables, the
name table and the resolution are copied.  Every param leaf gets
*logical* axes from a name table; logical axes map to mesh axes through
a rule dict; a divisibility check drops any mapping that does not divide
the dim (e.g. whisper's vocab 51866 % 16 != 0 → vocab falls back to
replicated and the embed dim picks up 'model').

These are pure functions of leaf paths, shapes and a mesh's axis sizes
(``mesh.shape[axis]``): a :class:`~repro_torch.launch.mesh.SweepMesh`, a
described mesh (:func:`~repro_torch.launch.mesh.make_production_mesh`)
or JAX's ``AbstractMesh``.  A leaf is anything with a ``shape`` (a
tensor, meta or not).  The specs say how the reference's GSPMD program
lays each leaf out, and for every arch the port runs the same layout in
a train case: ``models.sharding.tensor_parallel`` reads each parameter
leaf's spec here (:func:`param_pspec`, the node axes leading), and a
rank holds the block :func:`shard_shape` names (the counterpart of
``NamedSharding.shard_shape``).  Prefill and decode of the decoder-only
text archs run it too, the parameters without lead axes and the decode
cache by :func:`cache_pspecs` (``models.sharding.with_cache``).  The
mesh sweep shards the R-FAST state's flat vector instead
(:func:`repro_torch.core.runtime_sharded.packed_sweep_specs`).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

from ..models.sharding import PartitionSpec as P

__all__ = ["RULES_BASE", "RULES_FSDP", "param_pspec", "tree_pspecs",
           "tree_shardings", "batch_pspec", "cache_pspecs", "mesh_axis_size",
           "shard_shape", "tree_map_with_path"]

# logical axis -> mesh axis
RULES_BASE: dict[str, Optional[str]] = {
    "vocab": "model",
    "embed": None,
    "model_out": "model",
    "model_in": "model",
    "expert": "model",
    "batch": "data",
    "kv_heads": "model",
    "head_dim": None,
}
# beyond-baseline: FSDP the embed dim over 'data' (memory hillclimb)
RULES_FSDP = dict(RULES_BASE, embed="data")

# trailing-dims logical axes by parameter leaf name
_TABLE: dict[str, tuple] = {
    "wq": ("embed", "model_out"), "wk": ("embed", "model_out"),
    "wv": ("embed", "model_out"), "wi": ("embed", "model_out"),
    "wg": ("embed", "model_out"), "k_up": (None, "model_out"),
    "v_up": (None, "model_out"), "q_b": (None, "model_out"),
    "in_proj": ("embed", "model_out"), "dt_proj": (None, "model_out"),
    "bq": ("model_out",), "bk": ("model_out",), "bv": ("model_out",),
    "bi": ("model_out",), "bo": ("embed",),
    "wo": ("model_in", "embed"), "out_proj": ("model_in", "embed"),
    "x_proj": ("model_in", None),
    "w_dkv": ("embed", None), "q_a": ("embed", None), "w_kr": ("embed", None),
    "c_scale": (None,), "q_scale": (None,),
    "conv_w": (None, "model_out"), "conv_b": ("model_out",),
    "dt_bias": ("model_out",), "D": ("model_out",),
    "A_log": ("model_in", None),
    "router": ("embed", None),
    "scale": (None,), "bias": (None,),
    "embed": ("vocab", "embed"),
    "lm_head": ("embed", "vocab"),
    "frontend_proj": (None, "embed"),
}


def tree_map_with_path(fn, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts, lists, tuples and named
    tuples (whose keys, indices and field names make the path), None
    kept as None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def mesh_axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        s = 1
        for a in axis:
            s *= mesh.shape[a]
        return s
    return mesh.shape[axis]


def _resolve(axes: Sequence, shape: tuple, mesh, rules: dict) -> P:
    """Map logical axes to mesh axes, dropping non-dividing / duplicate."""
    used: set[str] = set()
    out = []
    for ax, dim in zip(axes, shape):
        m = rules.get(ax) if isinstance(ax, str) else ax
        if isinstance(m, str):
            m = (m,)
        if m:
            flat = tuple(a for a in m if a not in used)
            sz = mesh_axis_size(mesh, flat) if flat else 1
            if flat and dim % sz == 0 and sz > 1:
                used.update(flat)
                out.append(flat if len(flat) > 1 else flat[0])
                continue
        out.append(None)
    return P(*out)


def _ndim(leaf) -> int:
    return len(leaf.shape)


def param_pspec(path, leaf, mesh, rules: dict,
                lead_axes: tuple = ()) -> P:
    names = [str(p) for p in path]
    base = _TABLE.get(names[-1], ())
    lead = _ndim(leaf) - len(base) - len(lead_axes)
    axes = list(lead_axes) + [None] * lead + list(base)
    if "experts" in names and len(axes) >= 2:
        axes[len(lead_axes) + 1] = "expert"   # (L, E, ...) expert dim
    return _resolve(axes, tuple(leaf.shape), mesh, rules)


def tree_pspecs(tree: Any, mesh, rules: dict, lead_axes: tuple = ()) -> Any:
    return tree_map_with_path(
        lambda p, l: param_pspec(p, l, mesh, rules, lead_axes), tree)


def shard_shape(spec: P, shape: Sequence[int], mesh) -> tuple[int, ...]:
    """The block of a ``shape`` leaf laid out by ``spec`` that one rank
    holds (``NamedSharding.shard_shape``): each dim divided by the size
    of the mesh axes it is sharded over."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, ax in zip(shape, spec):
        sz = mesh_axis_size(mesh, ax)
        if dim % sz:
            raise ValueError(f"dim {dim} does not divide over mesh axes "
                             f"{ax!r} of size {sz}")
        out.append(int(dim) // sz)
    return tuple(out)


def tree_shardings(tree: Any, mesh, rules: dict,
                   lead_axes: tuple = ()) -> Any:
    """``(spec, shard shape)`` a leaf: :func:`tree_pspecs` and the block
    of the leaf one rank would hold under it."""
    return tree_map_with_path(
        lambda p, l: (lambda s: (s, shard_shape(s, l.shape, mesh)))(
            param_pspec(p, l, mesh, rules, lead_axes)), tree)


def batch_pspec(ndim: int, mesh, batch_axes, shape=None) -> P:
    """Leading-dim batch sharding, remaining dims replicated."""
    if batch_axes and shape is not None:
        sz = mesh_axis_size(mesh, tuple(batch_axes))
        if shape[0] % sz:
            batch_axes = ()
    spec = [tuple(batch_axes) if batch_axes else None] + [None] * (ndim - 1)
    return P(*spec)


# ---------------- KV-cache specs ------------------------------------- #
def cache_pspecs(cache_struct: Any, mesh, batch_axes,
                 seq_shard: bool = False) -> Any:
    """seq_shard=True: shard the cache LENGTH dim over 'model'
    (flash-decode style): attention reduces over the sharded length with
    an O(B·H·hd) psum instead of all-gathering / all-reducing
    O(B·H·C) score rows — the fix for GQA archs whose kv_heads don't
    divide the model axis (the reference's §Perf 3)."""
    msz = mesh.shape["model"]
    baxes = tuple(batch_axes)

    def spec(path, leaf):
        nm = str(path[-1])
        nd = _ndim(leaf)
        shape = tuple(leaf.shape)
        bsz = mesh_axis_size(mesh, baxes) if baxes else 1

        def b(dim_size):
            return baxes if (baxes and dim_size % bsz == 0) else None

        if nm in ("k", "v") and nd == 5:          # (L,B,C,KV,hd)
            L, B, C, KV, hd = shape
            # kv-head sharding is contraction-free and preferred when it
            # divides; otherwise sequence-shard (flash-decode)
            if KV % msz == 0:
                return P(None, b(B), None, "model", None)
            if seq_shard and C % msz == 0:
                return P(None, b(B), "model", None, None)
            if hd % msz == 0:
                return P(None, b(B), None, None, "model")
            return P(None, b(B), None, None, None)
        if nm == "c" and nd == 4:                  # (L,B,C,r)
            if seq_shard and shape[2] % msz == 0:
                return P(None, b(shape[1]), "model", None)
            return P(None, b(shape[1]), None,
                     "model" if shape[3] % msz == 0 else None)
        if nm == "kr" and nd == 4:
            return P(None, b(shape[1]), None, None)
        if nm == "conv" and nd == 4:               # (L,B,K-1,di)
            return P(None, b(shape[1]), None,
                     "model" if shape[3] % msz == 0 else None)
        if nm == "h" and nd == 4:                  # (L,B,di,N)
            return P(None, b(shape[1]),
                     "model" if shape[2] % msz == 0 else None, None)
        if nm in ("cross_k", "cross_v") and nd == 5:
            L, B, F, KV, hd = shape
            if KV % msz == 0:
                return P(None, b(B), None, "model", None)
            if hd % msz == 0:
                return P(None, b(B), None, None, "model")
            return P(None, b(B), None, None, None)
        return P(*([None] * nd))                   # idx, slot_pos, ...

    return tree_map_with_path(spec, cache_struct)
