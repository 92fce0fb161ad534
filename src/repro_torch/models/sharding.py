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
GSPMD takes as a layout for the compiler, which then runs the ``model``
axis tensor-parallel.  PyTorch compiles no program, so the port's
:func:`shard` checks what the reference checks and returns ``x`` as it
is, and the port runs the same layout explicitly:

* :class:`TensorParallel` (made by :func:`tensor_parallel`) holds the
  mesh, the rules, the ``model`` group and, for every parameter leaf,
  the dimension its PartitionSpec (``launch/shardings.param_pspec``,
  with the node axes leading as the reference lays out the R-FAST
  state) shards over ``model``, or None for a replicated leaf;
  :func:`local_tree` cuts this rank's blocks of a whole tree (the
  shapes are ``launch.shardings.shard_shape`` of those specs) and
  :func:`gather_tree` gathers a local tree whole again;
* inside :func:`use_tensor_parallel` the model code runs Megatron's
  layers on the local blocks (``core/runtime_sharded``'s collectives):
  the vocab-parallel embedding (:func:`embed_lookup`), column-parallel
  q/k/v and wi/wg and row-parallel wo (:func:`parallel_block`), the
  vocab-parallel head (:func:`to_head`) and cross entropy
  (:func:`vocab_parallel_ce`).  With sequence parallelism (the
  reference's ``seq`` → ``model``) the residual stream holds this
  rank's block of the sequence: it is gathered before each attention or
  MLP and reduce-scattered after it.  A block whose spec cuts inside a
  head (or leaves a projection replicated) gathers its leaves over
  ``model`` and runs replicated, each rank keeping its own block of the
  gradient: chosen from the spec, the same on every rank;
* :func:`tensor_parallel_grad` is the flat gradient of the local tree;
  with sequence parallelism each rank saw only its part of the
  sequence through the replicated leaves (the norms' scales), so their
  gradients are all-reduced over ``model`` and every copy stays the
  same.

The five dense decoders run so (:func:`tensor_parallel_supported`: an
attention mixer with GQA, a dense MLP without biases, no frontend, no
encoder); the other archs keep the replicated ``model`` axis.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Optional, Sequence

__all__ = ["PartitionSpec", "NamedSharding", "shard", "logical_to_spec",
           "mesh_rules", "named_sharding", "DEFAULT_RULES", "FSDP_RULES",
           "current_rules", "TensorParallel", "tensor_parallel",
           "tensor_parallel_supported", "use_tensor_parallel",
           "current_tensor_parallel", "local_tree", "gather_tree",
           "gather_flat",
           "embed_lookup", "parallel_block", "to_head", "vocab_parallel_ce",
           "tensor_parallel_grad"]


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


# --------------------------------------------------------------------- #
# tensor parallelism over the model axis
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """One rank's tensor-parallel layout (see the module docstring).

    ``group`` is its ``model`` group; ``dims`` maps each parameter
    leaf's key path to the dimension (from the end, so a layer-stacked
    leaf and one layer of it agree) that its spec shards over ``model``,
    or None; ``gathered`` names the blocks
    (``("layers", "attn")``, ``("layers", "mlp")``) that gather their
    leaves and run replicated; ``seq_parallel`` whether the residual
    stream is sharded over the sequence."""

    mesh: Any
    rules: dict
    group: Any
    dims: dict
    gathered: frozenset
    seq_parallel: bool

    @property
    def size(self) -> int:
        return self.group.size

    @property
    def index(self) -> int:
        return self.group.index


def tensor_parallel_supported(cfg) -> bool:
    """Whether the port runs ``cfg``'s ``model`` axis tensor-parallel:
    the dense decoders with GQA attention (rfast-100m, llama3-8b,
    olmo-1b, qwen2.5-3b, deepseek-7b)."""
    return (cfg.mixer == "attn" and cfg.attention != "mla"
            and not cfg.moe_experts and not cfg.enc_dec
            and not cfg.frontend and not cfg.mlp_bias and bool(cfg.d_ff)
            and cfg.use_rope)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _leaf_map(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _leaf_map(fn, v, prefix + (k,)) for k, v in tree.items()}
    return fn(prefix, tree)


def tensor_parallel(cfg, tree, mesh, *, rules=None, node_axes=None,
                    seq_parallel: bool = False) -> TensorParallel:
    """This rank's :class:`TensorParallel` for ``cfg``'s whole parameter
    tree ``tree`` (leaves with a ``shape``: meta tensors will do) on
    ``mesh``: each leaf's spec is ``launch.shardings.param_pspec`` under
    ``rules`` (the reference's ``RULES_BASE`` by default) with the node
    axes (every axis but ``model`` by default) leading, as the reference
    lays out the R-FAST state.  Raises where the port cannot run the
    layout: an arch :func:`tensor_parallel_supported` refuses, a spec
    over another axis, or an embedding or head the spec leaves
    replicated (``vocab`` must divide over ``model``)."""
    import torch

    from ..launch import shardings as sh
    if not tensor_parallel_supported(cfg):
        raise ValueError(f"{cfg.name}: the port runs the 'model' axis "
                         "tensor-parallel for the dense GQA decoders only")
    rules = rules or sh.RULES_BASE
    if node_axes is None:
        node_axes = tuple(a for a in mesh.axis_names if a != "model")
    node_axes = tuple(node_axes)
    lead = (node_axes,) if node_axes else ()
    rows = (sh.mesh_axis_size(mesh, node_axes),) if lead else ()
    M = sh.mesh_axis_size(mesh, "model")
    dims = {}
    for path, leaf in _paths(tree):
        shape = tuple(leaf.shape)
        stacked = torch.empty(rows + shape, device="meta")
        spec = tuple(sh.param_pspec(path, stacked, mesh, rules,
                                    lead_axes=lead))[len(lead):]
        dim = None
        for i, ax in enumerate(spec):
            if ax is None:
                continue
            if ax != "model":
                raise ValueError(f"{'/'.join(path)}: spec {spec} shards over "
                                 f"{ax!r}; the port's tensor parallelism "
                                 "runs the 'model' axis only")
            dim = i - len(shape)
        dims[path] = dim
    if dims.get(("embed",)) != -2 or dims.get(("lm_head",), -1) != -1:
        raise ValueError(f"{cfg.name}: vocab {cfg.vocab} does not divide "
                         f"over the {M} ranks of 'model': the embedding "
                         "and head must be vocab-parallel")
    attn = ("layers", "attn")
    col = [k for k in ("wq", "wk", "wv", "bq", "bk", "bv")
           if attn + (k,) in dims]
    attn_ok = (all(dims[attn + (k,)] == -1 for k in col)
               and dims[attn + ("wo",)] == -2
               and cfg.n_heads % M == 0 and cfg.n_kv_heads % M == 0)
    mlp = ("layers", "mlp")
    mlp_ok = (all(dims[mlp + (k,)] == -1 for k in ("wi", "wg")
                  if mlp + (k,) in dims) and dims[mlp + ("wo",)] == -2)
    gathered = frozenset(b for b, ok in ((attn, attn_ok), (mlp, mlp_ok))
                         if not ok)
    return TensorParallel(mesh=mesh, rules=rules, group=mesh.group("model"),
                          dims=dims, gathered=gathered,
                          seq_parallel=bool(seq_parallel))


def local_tree(tree, tp: TensorParallel):
    """This rank's blocks of the whole tree ``tree``: each sharded leaf
    cut along its dim (a copy, so the whole leaf can be freed), each
    replicated leaf as it is."""
    def cut(path, leaf):
        dim = tp.dims[path]
        if dim is None:
            return leaf
        n = leaf.shape[dim] // tp.size
        return leaf.narrow(dim, tp.index * n, n).clone()
    return _leaf_map(cut, tree)


def gather_tree(tree, tp: TensorParallel):
    """The whole tree from every rank's local ``tree`` (one gather over
    the model group a sharded leaf, in the tree's order, which is every
    rank's): for checkpoints, evaluation and tests."""
    from ..core.runtime_sharded import all_gather_seq
    return _leaf_map(lambda path, leaf: leaf if tp.dims[path] is None
                     else all_gather_seq(leaf, tp.group, tp.dims[path]),
                     tree)


def gather_flat(flat, spec, tp: TensorParallel):
    """The whole tree's flat vector (the ravel order of the whole tree)
    from this rank's local ``flat``, ravelled by ``spec``."""
    from ..core.paramvec import make_ravel_spec, ravel, unravel
    whole = gather_tree(unravel(spec, flat), tp)
    return ravel(make_ravel_spec(whole, dtype=spec.dtype), whole)


def current_tensor_parallel() -> TensorParallel | None:
    return getattr(_local, "tp", None)


@contextlib.contextmanager
def use_tensor_parallel(tp: TensorParallel | None):
    """Run the model code inside the block on ``tp``'s local blocks (None:
    the whole model, as outside any block)."""
    prev = current_tensor_parallel()
    _local.tp = tp
    try:
        yield
    finally:
        _local.tp = prev


def _check_seq(tp: TensorParallel, S: int) -> None:
    if tp.seq_parallel and S % tp.size:
        raise ValueError(f"sequence parallelism over {tp.size} ranks needs "
                         f"a sequence that divides, got {S}")


def embed_lookup(embed, tokens):
    """``embed[tokens]``; under tensor parallelism the vocab-parallel
    lookup: ids outside this rank's rows give zeros, and the ranks' rows
    are summed (reduce-scattered over the sequence with sequence
    parallelism)."""
    import torch

    from ..core.runtime_sharded import reduce_from_model, reduce_scatter_to_seq
    tp = current_tensor_parallel()
    if tp is None:
        return embed[tokens]
    _check_seq(tp, tokens.shape[1])
    rows = embed.shape[0]
    local = tokens.long() - tp.index * rows
    inside = (local >= 0) & (local < rows)
    x = embed[local.clamp(0, rows - 1)]
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    if tp.seq_parallel:
        return reduce_scatter_to_seq(x, tp.group, 1)
    return reduce_from_model(x, tp.group)


def parallel_block(key: tuple, params: dict, x, fn):
    """``fn(params, x)`` of a residual block (attention, MLP) whose input
    ``x`` is the residual stream; under tensor parallelism on the local
    blocks: column-parallel in, row-parallel out (the input's gradient
    and the output all-reduced, or with sequence parallelism the input
    gathered over the sequence and the output reduce-scattered), or for
    a block in ``tp.gathered`` its sharded leaves gathered (each rank
    keeps its block of their gradient) and ``fn`` run replicated."""
    from ..core import runtime_sharded as rs
    tp = current_tensor_parallel()
    if tp is None:
        return fn(params, x)
    g = tp.group
    if key in tp.gathered:
        gather = rs.gather_from_seq if tp.seq_parallel else \
            rs.gather_from_model
        full = {k: (v if tp.dims[key + (k,)] is None
                    else gather(v, g, tp.dims[key + (k,)]))
                for k, v in params.items()}
        if not tp.seq_parallel:
            return fn(full, x)
        y = fn(full, rs.gather_from_seq(x, g, 1))
        return rs.rank_block(y, g, 1)
    if tp.seq_parallel:
        return rs.reduce_scatter_to_seq(fn(params, rs.gather_from_seq(
            x, g, 1)), g, 1)
    return rs.reduce_from_model(fn(params, rs.copy_to_model(x, g)), g)


def to_head(x):
    """The residual stream ready for the vocab-parallel head: gathered
    over the sequence with sequence parallelism, else its gradient
    all-reduced (each rank's head block differentiates it in part)."""
    from ..core import runtime_sharded as rs
    tp = current_tensor_parallel()
    if tp is None:
        return x
    if tp.seq_parallel:
        return rs.gather_from_seq(x, tp.group, 1)
    return rs.copy_to_model(x, tp.group)


def vocab_parallel_ce(logits, labels, ce: str, tp: TensorParallel):
    """Mean next-token cross entropy from this rank's vocab block of the
    logits ``(B, S, V / M)``: the max, the sum of exponentials and the
    target's logit each all-reduced over the model group, so no rank
    builds a ``(B, S, V)`` tensor.  The target's log-probability is its
    logit less lse: ``ce="full"`` takes that logit in fp32 (the fp32
    log-softmax's), ``"lse"`` in the logits' own dtype, as
    ``models.transformer.loss_fn`` does."""
    import torch

    from ..core.runtime_sharded import all_reduce_max, reduce_from_model
    g = tp.group
    V = logits.shape[-1]
    lf = logits.to(torch.float32)
    m = all_reduce_max(lf.detach().amax(-1, keepdim=True), g)
    se = reduce_from_model(torch.exp(lf - m).sum(-1, keepdim=True), g)
    lse = m + torch.log(se)
    local = labels.long() - tp.index * V
    inside = (local >= 0) & (local < V)
    idx = local.clamp(0, V - 1)[..., None]
    # the target's log-probability is its logit less lse; lse stays out
    # of the masked gather so that every rank's block gets its gradient
    src = lf if ce == "full" else logits
    tgt = torch.gather(src, -1, idx)[..., 0].to(torch.float32)
    tgt = reduce_from_model(torch.where(inside, tgt, torch.zeros(
        (), dtype=tgt.dtype, device=tgt.device)), g)
    return (lse[..., 0] - tgt).mean()


def tensor_parallel_grad(spec, loss_fn, tp: TensorParallel):
    """``(params, batch, key) -> loss`` on the local tree that ``spec``
    ravels -> ``(x_loc, batch, key) -> (loss, g_loc)``: the flat
    gradient of the local blocks (``core.paramvec.value_and_grad``) with
    the loss run under :func:`use_tensor_parallel`, and with sequence
    parallelism the replicated leaves' gradients all-reduced over the
    model group (one call: their segments side by side).  The loss is
    the same on every rank of the group."""
    import torch

    from ..core.paramvec import value_and_grad
    from ..core.runtime_sharded import all_reduce_sum

    vg = value_and_grad(spec, loss_fn)
    segs = [(off, int(torch.Size(shape).numel()))
            for path, shape, off in zip(spec.paths, spec.shapes,
                                        spec.offsets)
            if tp.dims[path] is None]

    def grad(x, batch, key):
        with use_tensor_parallel(tp):
            loss, g = vg(x, batch, key)
        if tp.seq_parallel and segs:
            red = all_reduce_sum(torch.cat([g[o:o + n] for o, n in segs]),
                                 tp.group)
            i = 0
            for o, n in segs:
                g[o:o + n] = red[i:i + n]
                i += n
        return loss, g

    return grad
