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
  rank's block of the sequence: it is gathered before each attention,
  SSM or MLP block and reduce-scattered after it.  A block whose spec
  cuts inside a head (or leaves a projection replicated) gathers its
  leaves over ``model`` and runs replicated, each rank keeping its own
  block of the gradient: chosen from the spec, the same on every rank;
* the Mamba block (``models/ssm.py``, the reference's ``ssm_inner`` →
  ``model``) runs on this rank's ``d_inner / M`` channels: in_proj's
  block holds whole columns of ``[x | z]``, not a channel block, so the
  ranks exchange column chunks of its output until each holds x and z
  at its channels (:func:`ssm_channels`); the conv, the gate and the scan
  kernels run on them; ``x_proj`` is row-parallel and its partial sums
  feed every channel's dt, B and C, so they are all-reduced forward and
  their gradient all-reduced backward (:func:`ssm_proj`);
* where ``vocab`` does not divide over ``model`` (hymba-1.5b's 32001)
  the spec leaves the embedding and the head replicated
  (``TensorParallel.vocab_parallel`` False): the lookup and the head
  run on the replicated stream, or with sequence parallelism on this
  rank's block of the sequence, whose loss sum is all-reduced
  (:func:`seq_parallel_mean`);
* the MoE block (``models/moe.py``, the reference's ``expert`` →
  ``model``) runs expert-parallel: every rank routes all the tokens
  with the replicated router (the same top-k, slots and drops as the
  whole block), dispatches to its own ``E / M`` experts only and adds
  their outputs to the shared experts' column / row-parallel partial
  sum, which the block all-reduces; the router loss is a sum over
  experts, so each rank sums its own experts' terms and the layers'
  sum is all-reduced once (:func:`router_loss`);
* MLA (``models/attention.py``) runs column-parallel on whole heads:
  ``q_b`` (or ``wq``), ``k_up`` and ``v_up`` hold ``H / M`` heads'
  columns and ``wo`` their rows, while the latent ``c``, the roped key
  part and the q-LoRA path come whole from the replicated
  down-projections;
* the enc-dec arch (whisper-large-v3) runs its encoder the same way:
  attention and the MLP column / row-parallel (``("enc_layers",
  "attn")``, ``("enc_layers", "mlp")``), on a stream of its own that is
  sequence-parallel over the frames where the decoder's is and ``model``
  divides the frame count, else replicated
  (``TensorParallel.enc_seq_parallel``; the reference's ``shard`` of
  the encoder's stream drops the same way).  The encoder's output enters
  the decoder once a forward (:func:`enter_decoder`): gathered over the
  frames, or as it is, with each rank's gradient of it (from its own
  cross-attention heads, ``("layers", "cross")``) summed over the model
  group in the backward, once for every layer.  A row-parallel MLP's
  output bias ``bo`` is added once, after the reduction;
* a decoder-only frontend's projected rows (pixtral-12b's patches) come
  before the text: the vocab-parallel lookup's partial sums carry them
  on the group's rank 0 only, so that the reduction counts them once
  (:func:`embed_lookup`), and the sequence the decoder's stream cuts is
  the whole ``F + S_text``;
* :func:`tensor_parallel_grad` is the flat gradient of the local tree.
  With sequence parallelism each rank saw only its part of the
  sequence through the replicated leaves (the norms' scales, and a
  replicated embedding and head), so their gradients are all-reduced
  over ``model`` and every copy stays the same; the encoder's leaves
  (``enc_layers``, ``enc_norm``, whisper's ``frontend_proj``) so under
  the encoder's sequence parallelism, the others under the decoder's.
  The replicated leaves that feed only this rank's experts or heads
  (the router, MLA's down-projections: ``TensorParallel.partial``) have
  a gradient that is a part of the whole with or without sequence
  parallelism, and are all-reduced either way, once.

Every arch of the repo trains so (:func:`tensor_parallel_supported`).

Prefill and decode run the same blocks on parameters laid out without
lead axes (``node_axes=()``), and a rank holds its block of the decode
cache as the reference's ``launch/shardings.cache_pspecs`` lays it out
(:func:`with_cache`; ``TensorParallel.cache``), for every arch that
trains so; the MoE block runs on a rank's experts in decode as in the
forward, every rank routing the step's tokens with the whole router:

* the k/v ring by KV heads (``"heads"``): the attention block is
  column-parallel on whole heads and its rank's ring holds those heads;
* by ring slots (``"slots"``, the reference's flash-decode layout): the
  block is gathered, the rank that owns a position's slot writes it
  (:func:`ring_write`), and each rank attends over its ``C / M`` slots,
  whose row max, sum of exponentials and unnormalized ``p·v`` the ranks
  merge with one ``all_reduce_max`` and one ``all_reduce_sum``
  (:func:`ring_attend`);
* by head dim (``"head_dim"``): the block is gathered, a rank writes and
  keeps its ``hd / M`` slice of every row, the scores are its partial
  sums all-reduced, and its ``p·v`` slice of the output is gathered;
* ``"replicated"``: the block is gathered and the ring whole;
* the SSM state by channels (``"channels"``): the conv window and h of
  the Mamba block's ``d_inner / M`` channels, which the block runs on;
* the enc-dec arch's cross caches ``cross_k`` / ``cross_v`` (top-level
  leaves beside ``layers``) by KV heads beside a column-parallel cross
  attention block, whose rank runs its heads on them; or, beside a
  gathered one, by head dim (its ``hd / M`` slice of every head, the
  scores' partial sums all-reduced and the ``p·v`` slice gathered, as
  the ring's) or whole.  A decode step's cross attention gathers only
  the query and output leaves (its k and v are cached);
* MLA's latent ``c`` (B, C, r) by ring slots (``"slots"``) or by latent
  dim (``"latent_dim"``), beside the roped key part ``kr`` (B, C, rd),
  whole on every rank: decode attends in the absorbed form
  (:func:`latent_attend`), ``q̃ = qn · k_upᵀ`` per head, so that the
  scores ``q̃ · c + qr · kr`` and the values ``(p · c) · v_up`` need no
  whole ``c``; a column-parallel block gathers every head's q̃ and qr, the
  ranks merge their slots' softmax as the ring's slots do, or sum their
  latent slices' partial scores and gather their slices of ``p · c``, and
  each rank keeps its heads.  ``c`` whole (``"replicated"``) runs the
  forward's attention on it.

``idx`` and ``slot_pos`` are whole on every rank.  A gathered block's
prefill k/v (the ring's and the cross caches') are whole, and so are
MLA's ``c`` and ``kr`` (its down-projections are whole), of which
:func:`ring_block` keeps the rank's block by the leaf's own layout;
:func:`last_position` gives the head the sequence's last row on every
rank.  A decoder-only frontend's prefix enters the ring as any other
rows.

Where a served batch's rows are split over the ``data`` axes
(``launch/specs.build_prefill`` / ``build_decode``), the model code runs
inside :func:`use_batch_group`: the group of the ranks that hold the
batch's rows, in the order ``batch_pspec`` lays them out
(:func:`current_batch_group`).  The MoE block routes by the whole batch
there (``models/moe.py``: one gather of each expert's choice count over
the group), as the reference's GSPMD program does.  So the port keeps
three thread-local contexts: ``(mesh, rules)``, the tensor-parallel
layout and the batch group.
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
           "current_tensor_parallel", "use_batch_group",
           "current_batch_group", "local_tree", "gather_tree",
           "gather_flat",
           "embed_lookup", "local_rows", "enter_decoder", "parallel_block",
           "ssm_channels", "ssm_proj",
           "expert_offset", "router_loss", "to_head", "vocab_parallel_ce",
           "seq_parallel_mean", "tensor_parallel_grad",
           "with_cache", "gather_cache", "zeros_cache", "block_params",
           "ring_block", "ring_write", "ring_attend", "latent_attend",
           "last_position"]


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
    (``("layers", "attn")``, ``("layers", "ssm")``, ``("layers",
    "mlp")``, ``("layers", "cross")``, ``("enc_layers", "attn")``,
    ``("enc_layers", "mlp")``) that gather their leaves and run
    replicated; ``seq_parallel`` whether the (decoder's) residual stream
    is sharded over the sequence; ``vocab_parallel`` whether the
    embedding and the head are (else both are replicated); ``partial``
    the replicated leaves whose gradient on a rank is its experts' or
    heads' part (the router of an expert-parallel MoE block, the
    down-projections of a column-parallel MLA block);
    ``enc_seq_parallel`` whether the encoder's stream is sharded over
    the frames (None: the arch has no encoder); ``cache`` maps each
    decode cache leaf's name (``k``, ``v``, ``c``, ``kr``, ``conv``,
    ``h``, ``cross_k``, ``cross_v``, ``idx``, ``slot_pos``) to the dim,
    from the end, that its spec shards over ``model``, or None (None: no
    cache layout, :func:`with_cache`)."""

    mesh: Any
    rules: dict
    group: Any
    dims: dict
    gathered: frozenset
    seq_parallel: bool
    vocab_parallel: bool
    partial: frozenset = frozenset()
    enc_seq_parallel: Optional[bool] = None
    cache: Optional[dict] = None

    @property
    def size(self) -> int:
        return self.group.size

    @property
    def index(self) -> int:
        return self.group.index

    def leaf_layout(self, leaf: str) -> Optional[str]:
        """The layout of the cache leaf ``leaf`` by its own dims
        (:data:`LEAF_LAYOUTS`; ``"k"``: the k/v ring's, ``"cross_k"``: the
        cross caches', ``"h"``: the SSM state's, ``"c"``: MLA's latent's),
        None without one."""
        if self.cache is None or leaf not in self.cache:
            return None
        return LEAF_LAYOUTS.get(leaf, KV_LAYOUTS)[self.cache[leaf]]

    @property
    def kv_layout(self) -> Optional[str]:
        """The k/v ring's layout (:data:`KV_LAYOUTS`), None without one."""
        return self.leaf_layout("k")

    @property
    def cache_layout(self) -> dict:
        """``{"kv": ..., "ssm": ...}``: the k/v ring's and the SSM
        state's layouts, None where the arch has no such cache; an enc-dec
        arch's also ``"cross"``, the cross caches', and an MLA arch's
        ``"latent"``, its latent ``c``'s."""
        out = {"kv": self.kv_layout, "ssm": self.leaf_layout("h")}
        for leaf, key in (("cross_k", "cross"), ("c", "latent")):
            if self.cache is not None and leaf in self.cache:
                out[key] = self.leaf_layout(leaf)
        return out

    @property
    def expert_parallel(self) -> bool:
        """Whether the MoE block runs on this rank's experts."""
        return (MOE + ("router",) in self.dims
                and MOE not in self.gathered)

    def stream_seq_parallel(self, path: tuple) -> bool:
        """Whether the stream that the leaf or block at ``path`` runs on
        is sequence-parallel: the encoder's (:data:`ENCODER`) or the
        decoder's."""
        if self.enc_seq_parallel is not None and path[0] in ENCODER:
            return self.enc_seq_parallel
        return self.seq_parallel


# the dim of each SSM leaf that runs on a rank's channels (the channel
# dim of ``d_inner``; in_proj's columns are [x | z]): the layout
# ``models/ssm.py`` runs the block in, else the block runs gathered
SSM_DIMS = {"in_proj": -1, "conv_w": -1, "conv_b": -1, "x_proj": -2,
            "dt_proj": -1, "dt_bias": -1, "A_log": -2, "D": -1,
            "out_proj": -2}


# the enc-dec arch's leaves that run on the encoder's stream
ENCODER = ("enc_layers", "enc_norm", "frontend_proj")
CROSS = ("layers", "cross")
MOE = ("layers", "mlp")
# the MoE block runs expert-parallel when the stacked experts sit on
# their E dim and the shared experts are a column / row-parallel MLP
MOE_DIMS = {("experts", "wi"): -3, ("experts", "wg"): -3,
            ("experts", "wo"): -3, ("shared", "wi"): -1,
            ("shared", "wg"): -1, ("shared", "wo"): -2, ("router",): None}
# MLA runs on a rank's heads when the up-projections are column blocks
# and the down-projections whole
MLA_COLUMNS = ("q_b", "wq", "k_up", "v_up")
MLA_WHOLE = ("w_dkv", "c_scale", "w_kr", "q_a", "q_scale")
# a cache leaf's dim over model (from the end of (B, C, KV, hd), of the
# cross caches' (B, F, KV, hd), of (B, di, N) and of MLA's (B, C, r))
# -> its layout
KV_LAYOUTS = {-2: "heads", -3: "slots", -1: "head_dim", None: "replicated"}
SSM_LAYOUTS = {-2: "channels", None: "replicated"}
LATENT_LAYOUTS = {-2: "slots", -1: "latent_dim", None: "replicated"}
# the leaves laid out by a map of their own (the others: KV_LAYOUTS)
LEAF_LAYOUTS = {"h": SSM_LAYOUTS, "c": LATENT_LAYOUTS, "kr": LATENT_LAYOUTS}
ATTN = ("layers", "attn")
NEG = -1e30                 # a masked score (the models' own)


def tensor_parallel_supported(cfg) -> bool:
    """Whether the port runs ``cfg``'s ``model`` axis tensor-parallel:
    every arch of the repo, i.e. the dense and MoE decoders with GQA
    attention (rfast-100m, llama3-8b, olmo-1b, qwen2.5-3b, deepseek-7b,
    phi3.5-moe-42b-a6.6b), MLA with MoE (deepseek-v2-236b), the SSM arch
    (falcon-mamba-7b), the hybrid of GQA attention and SSM (hymba-1.5b),
    the decoder with a patch prefix (pixtral-12b) and the enc-dec arch
    with cross attention, absolute positions and biased MLPs
    (whisper-large-v3)."""
    return cfg.mixer in ("attn", "ssm", "hybrid")


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
    over another axis, an embedding and a head of which the spec
    shards one and leaves the other replicated, or a frontend's prefix
    before a replicated head under sequence parallelism (the rank's
    block of the sequence would not be one of the text's).  The
    encoder's stream is sequence-parallel where the decoder's is and
    ``model`` divides ``cfg.frontend_seq``."""
    import torch

    from ..launch import shardings as sh
    if not tensor_parallel_supported(cfg):
        raise ValueError(f"{cfg.name}: the port does not run its 'model' "
                         "axis tensor-parallel")
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
    embed, head = dims.get(("embed",)), dims.get(("lm_head",), "tied")
    if embed == -2 and head in (-1, "tied"):
        vocab_parallel = True
    elif embed is None and head in (None, "tied"):
        vocab_parallel = False
    else:
        raise ValueError(f"{cfg.name}: the spec shards the embedding "
                         f"(dim {embed}) and the head (dim {head}) unlike: "
                         "both must be vocab-parallel or both replicated")
    if (cfg.frontend and not cfg.enc_dec and seq_parallel
            and not vocab_parallel):
        raise ValueError(f"{cfg.name}: a frontend's prefix before a "
                         "replicated head runs without sequence "
                         "parallelism only")

    def heads(key):     # GQA column-parallel on whole heads, else gathered
        col = [k for k in ("wq", "wk", "wv", "bq", "bk", "bv")
               if key + (k,) in dims]
        return (key, all(dims[key + (k,)] == -1 for k in col)
                and dims[key + ("wo",)] == -2
                and cfg.n_heads % M == 0 and cfg.n_kv_heads % M == 0)

    def mlp(key):       # a dense MLP column / row-parallel, else gathered
        return (key, all(dims[key + (k,)] == -1 for k in ("wi", "wg", "bi")
                         if key + (k,) in dims)
                and dims[key + ("wo",)] == -2)
    blocks, partial = [], []
    attn = ATTN
    if cfg.mixer in ("attn", "hybrid") and cfg.attention == "mla":
        whole = [attn + (k,) for k in MLA_WHOLE if attn + (k,) in dims]
        ok = (all(dims[attn + (k,)] == -1 for k in MLA_COLUMNS
                  if attn + (k,) in dims)
              and dims[attn + ("wo",)] == -2
              and all(dims[k] is None for k in whole)
              and cfg.n_heads % M == 0)
        blocks.append((attn, ok))
        partial += whole if ok else []
    elif cfg.mixer in ("attn", "hybrid"):
        blocks.append(heads(attn))
    ssm = ("layers", "ssm")
    if cfg.mixer in ("ssm", "hybrid"):
        blocks.append((ssm, cfg.d_inner % M == 0 and all(
            dims[ssm + (k,)] == d for k, d in SSM_DIMS.items())))
    if cfg.moe_experts:
        ok = all(dims[MOE + k] == d for k, d in MOE_DIMS.items()
                 if MOE + k in dims)
        blocks.append((MOE, ok))
        partial += [MOE + ("router",)] if ok else []
    elif MOE + ("wo",) in dims:
        blocks.append(mlp(MOE))
    enc_sp = None
    if cfg.enc_dec:
        blocks += [heads(CROSS), heads(("enc_layers", "attn")),
                   mlp(("enc_layers", "mlp"))]
        enc_sp = bool(seq_parallel) and cfg.frontend_seq % M == 0
    gathered = frozenset(b for b, ok in blocks if not ok)
    return TensorParallel(mesh=mesh, rules=rules, group=mesh.group("model"),
                          dims=dims, gathered=gathered,
                          seq_parallel=bool(seq_parallel),
                          vocab_parallel=vocab_parallel,
                          partial=frozenset(partial),
                          enc_seq_parallel=enc_sp)


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


def with_cache(tp: TensorParallel, cache, *,
               seq_shard: bool = True) -> TensorParallel:
    """``tp`` with the layout of the decode cache ``cache`` (a whole cache
    of ``models.transformer.init_cache``, an enc-dec arch's cross caches
    included; meta tensors will do): each leaf's dim over ``model`` from
    ``launch.shardings.cache_pspecs(cache, mesh, (), seq_shard=seq_shard)``
    (the batch rows are the caller's, outside the model group).  Raises
    where the port does not run the layout: a sharded leaf other than the
    k/v ring, MLA's latent ``c``, the SSM state and the cross caches (so
    MLA's ``kr``, which every rank's heads score against at every slot),
    a ring or cross caches by heads beside a gathered attention block or
    any other layout beside a column-parallel one, an SSM state by
    channels beside a gathered Mamba block or a whole one beside a block
    on channels.  ``c`` by slots or latent dim runs beside a
    column-parallel MLA block and a gathered one
    (:func:`latent_attend`)."""
    from ..launch import shardings as sh
    specs = sh.cache_pspecs(cache, tp.mesh, (), seq_shard=seq_shard)
    dims = {}
    for path, spec in _paths(specs):
        spec = tuple(spec)
        axes = [i - len(spec) for i, ax in enumerate(spec) if ax == "model"]
        dims[path[-1]] = axes[0] if axes else None
    bad = [k for k, d in dims.items() if k not in CACHE_LEAVES
           or (k in WHOLE_LEAVES and d is not None)]
    if bad or len({dims.get("k"), dims.get("v")} - {None}) > 1:
        raise ValueError(f"the port lays out no {bad or 'k / v'} cache "
                         "leaf over 'model'")
    out = dataclasses.replace(tp, cache=dims)
    for leaf, block in (("k", ATTN), ("cross_k", CROSS)):
        lay = out.leaf_layout(leaf)
        if lay is not None and (lay == "heads") == (block in tp.gathered):
            kind = "gathered" if block in tp.gathered else "column-parallel"
            what = "a k/v ring" if leaf == "k" else "cross caches"
            raise ValueError(f"{what} by {lay} beside a {kind} "
                             f"{'/'.join(block)} block")
    ssm, st = ("layers", "ssm"), out.leaf_layout("h")
    if st is not None and (st == "channels") == (ssm in tp.gathered):
        block = "gathered" if ssm in tp.gathered else "channel"
        raise ValueError(f"an SSM state {st} beside a {block} Mamba block")
    return out


# the decode cache's leaves whose layout the port runs, and those of them
# it runs whole only
CACHE_LEAVES = ("k", "v", "c", "kr", "conv", "h", "cross_k", "cross_v",
                "idx", "slot_pos")
WHOLE_LEAVES = ("kr", "idx", "slot_pos")


def _cache_dim(tp: TensorParallel, path: tuple):
    """The dim over ``model`` of the cache leaf at ``path`` (from the
    cache's root): a ``layers`` leaf's or a top-level cross cache's."""
    if path[0] == "layers" or path[0] in ("cross_k", "cross_v"):
        return tp.cache.get(path[-1])
    return None


def gather_cache(cache, tp: TensorParallel):
    """The whole decode cache from every rank's block (one gather over
    the model group a sharded leaf, the cross caches included): for
    checks and tests."""
    from ..core.runtime_sharded import all_gather_seq
    return _leaf_map(lambda path, leaf: leaf if _cache_dim(tp, path) is None
                     else all_gather_seq(leaf, tp.group,
                                         _cache_dim(tp, path)), cache)


def zeros_cache(cache, tp: TensorParallel, device):
    """Zero blocks on ``device`` of the whole cache leaves ``cache`` (a
    tree from the cache's root, such as ``{"layers": ...}``; meta tensors
    will do), in their dtypes: nothing whole is allocated."""
    import torch

    def block(path, leaf):
        shape = list(leaf.shape)
        dim = _cache_dim(tp, path)
        if dim is not None:
            shape[dim] //= tp.size
        return torch.zeros(shape, dtype=leaf.dtype, device=device)
    return _leaf_map(block, cache)


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


def current_batch_group():
    return getattr(_local, "batch", None)


@contextlib.contextmanager
def use_batch_group(group):
    """Run the model code inside the block on this rank's rows of a batch
    whose rows ``group`` (an ``AxisGroup`` of the batch axes, this rank
    at its place in the rows' order) splits; None: the rows are the whole
    batch, as outside any block."""
    prev = current_batch_group()
    _local.batch = group
    try:
        yield
    finally:
        _local.batch = prev


def _check_seq(tp: TensorParallel, S: int,
               path: tuple = ("layers",)) -> None:
    if tp.stream_seq_parallel(path) and S % tp.size:
        raise ValueError(f"sequence parallelism over {tp.size} ranks needs "
                         f"a sequence that divides, got {S}")


def embed_lookup(embed, tokens, frontend=None, proj=None):
    """``embed[tokens]``, after a decoder-only frontend's projected rows
    ``frontend @ proj`` (B, F, d) when ``frontend`` is given; under
    tensor parallelism the vocab-parallel lookup: ids outside this
    rank's rows give zeros, and the ranks' rows are summed
    (reduce-scattered over the whole sequence of F + S_text rows with
    sequence parallelism, where rank 0's partial sum carries the
    frontend's rows and the others' zeros, so that they count once).  A
    replicated embedding is looked up whole, or with sequence
    parallelism at this rank's block of the sequence only (no frontend:
    :func:`tensor_parallel` refuses it)."""
    import torch

    from ..core.runtime_sharded import (rank_block, reduce_from_model,
                                        reduce_scatter_to_seq)
    prefixed = lambda x: x if frontend is None else torch.cat(
        [(frontend @ proj).to(x.dtype), x], dim=1)
    tp = current_tensor_parallel()
    if tp is None:
        return prefixed(embed[tokens])
    F = 0 if frontend is None else frontend.shape[1]
    _check_seq(tp, F + tokens.shape[1])
    if not tp.vocab_parallel:
        if tp.seq_parallel:
            return embed[rank_block(tokens, tp.group, 1)]
        return prefixed(embed[tokens])
    rows = embed.shape[0]
    local = tokens.long() - tp.index * rows
    inside = (local >= 0) & (local < rows)
    x = embed[local.clamp(0, rows - 1)]
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    if not tp.seq_parallel:
        return prefixed(reduce_from_model(x, tp.group))
    if frontend is not None:
        x = torch.cat([_prefix_part(tp, frontend, proj, x), x], dim=1)
    return reduce_scatter_to_seq(x, tp.group, 1)


def _prefix_part(tp: TensorParallel, frontend, proj, x):
    """This rank's part of the frontend's rows in the vocab-parallel
    lookup's partial sums ``x``: the projected rows on the group's rank
    0, zeros on the others, so that the reduction counts them once."""
    if tp.index == 0:
        return (frontend @ proj).to(x.dtype)
    return x.new_zeros(x.shape[0], frontend.shape[1], x.shape[2])


def local_rows(t, dim: int, path: tuple = ("layers",)):
    """``t``'s rows of the sequence (dim ``dim``) that this rank's stream
    holds: the block of the rank when the stream of ``path`` (the
    decoder's, or with ``("enc_layers",)`` the encoder's) is
    sequence-parallel, else ``t`` (as outside tensor parallelism)."""
    from ..core.runtime_sharded import rank_block
    tp = current_tensor_parallel()
    if tp is None or not tp.stream_seq_parallel(path):
        return t
    _check_seq(tp, t.shape[dim], path)
    return rank_block(t, tp.group, dim)


def enter_decoder(enc):
    """The encoder's output ``enc`` (B, F, d), or this rank's block of its
    frames, ready for every decoder layer's cross attention: gathered
    over the frames when the encoder's stream is sequence-parallel.
    Where each rank's gradient of it is a part of the whole (its own
    heads of a column-parallel cross attention, or its block of the
    decoder's sequence), the backward sums the parts over the model
    group once, for the layers together (a reduce-scatter, or an
    all-reduce for a replicated stream).  A gathered cross attention on
    a replicated decoder stream (so a replicated encoder stream too)
    gives every rank the whole gradient, which it keeps as it is."""
    from ..core import runtime_sharded as rs
    tp = current_tensor_parallel()
    if tp is None:
        return enc
    if tp.enc_seq_parallel:
        return rs.gather_from_seq(enc, tp.group, 1)
    if CROSS not in tp.gathered or tp.seq_parallel:
        return rs.copy_to_model(enc, tp.group)
    return enc


def _first(out, f):
    """``f`` of a block's output, or of its first part when the block
    returns more (the MoE block's ``(y, router loss)``)."""
    return (f(out[0]), *out[1:]) if isinstance(out, tuple) else f(out)


def _gather_leaves(tp: TensorParallel, key: tuple, params: dict, gather):
    """Block ``key``'s leaves ``params`` with each sharded one gathered
    whole by ``gather`` (its rule for the gradient)."""
    return _leaf_map(lambda path, v: v if tp.dims[key + path] is None
                     else gather(v, tp.group, tp.dims[key + path]), params)


def block_params(key: tuple, params: dict) -> dict:
    """The leaves ``params`` of block ``key`` as the block runs them, for
    a computation outside :func:`parallel_block`'s frame (no gradient):
    a gathered block's sharded leaves gathered whole, else as they are
    (whole outside tensor parallelism, the rank's blocks otherwise)."""
    from ..core.runtime_sharded import gather_from_model
    tp = current_tensor_parallel()
    if tp is None or key not in tp.gathered:
        return params
    return _gather_leaves(tp, key, params, gather_from_model)


def parallel_block(key: tuple, params: dict, x, fn):
    """``fn(params, x)`` of a residual block (attention, cross attention,
    MLP, MoE) whose input ``x`` is the residual stream (the decoder's,
    or the encoder's for a ``key`` under ``enc_layers``); under tensor
    parallelism on the local blocks: column-parallel in, row-parallel
    out (the input's gradient and the output all-reduced, or with the
    stream's sequence parallelism the input gathered over the sequence
    and the output reduce-scattered), or for a block in ``tp.gathered``
    its sharded leaves (nested ones too) gathered (each rank keeps its
    block of their gradient) and ``fn`` run replicated.  A row-parallel
    block's output bias ``bo`` (replicated) is added once, to the
    reduced output; ``fn`` runs without it.  Where ``fn`` returns a
    tuple, only its first part is the block's output; the rest comes
    back as it is."""
    from ..core import runtime_sharded as rs
    tp = current_tensor_parallel()
    if tp is None:
        return fn(params, x)
    g = tp.group
    sp = tp.stream_seq_parallel(key)
    if key in tp.gathered:
        full = _gather_leaves(tp, key, params, rs.gather_from_seq if sp
                              else rs.gather_from_model)
        if not sp:
            return fn(full, x)
        out = fn(full, rs.gather_from_seq(x, g, 1))
        return _first(out, lambda y: rs.rank_block(y, g, 1))
    bias = params.get("bo")
    if bias is not None:
        params = {k: v for k, v in params.items() if k != "bo"}
    if sp:
        out = fn(params, rs.gather_from_seq(x, g, 1))
        reduce = lambda y: rs.reduce_scatter_to_seq(y, g, 1)
    else:
        out = fn(params, rs.copy_to_model(x, g))
        reduce = lambda y: rs.reduce_from_model(y, g)
    return _first(out, reduce if bias is None else lambda y: reduce(y) + bias)


def ssm_channels(xz, d_inner: int):
    """``(x, z)`` of the Mamba block's ``xz = h @ in_proj``.  Whole
    (outside tensor parallelism, or in a gathered block) they are the
    two halves; on a rank's in_proj block ``(..., 2·d_inner / M)``,
    which holds whole columns of ``[x | z]`` and not a channel block,
    the ranks exchange column chunks so that each gets x and z at its
    ``d_inner / M`` channels (``all_to_all_model``; the gradient goes
    back the same way), the layout GSPMD gives the reference's
    ``shard(x, ..., "ssm_inner")``."""
    from ..core.runtime_sharded import all_to_all_model
    c = xz.shape[-1] // 2
    if c == d_inner:
        return xz[..., :d_inner], xz[..., d_inner:]
    tp = current_tensor_parallel()
    M, r = tp.size, tp.index
    # this block's two chunks of c columns are chunks 2r and 2r + 1 of
    # [x | z]; chunk k holds channels of rank k mod M
    dest = [(2 * r + j) % M for j in (0, 1)]
    chunks = xz.unflatten(-1, (2, c)).movedim(-2, 0)
    if dest[0] > dest[1]:
        chunks, dest = chunks.flip(0), dest[::-1]
    send = [dest.count(q) for q in range(M)]
    recv = [sum((2 * s + j) % M == r for j in (0, 1)) for s in range(M)]
    # rank r's x chunk (r) comes from rank r // 2, its z chunk (M + r)
    # from rank (M + r) // 2, a later one: rows arrive in rank order
    x, z = all_to_all_model(chunks, tp.group, send, recv)
    return x, z


def ssm_proj(partial, d_inner: int, channels: int):
    """The Mamba block's ``x @ x_proj`` from this rank's ``partial``:
    as it is when the block holds all ``d_inner`` channels; on a rank's
    ``channels`` a row-parallel partial sum, all-reduced forward, and,
    since every rank's dt, B and C differentiate the whole sum in part,
    its gradient all-reduced backward."""
    from ..core.runtime_sharded import copy_to_model, reduce_from_model
    if channels == d_inner:
        return partial
    g = current_tensor_parallel().group
    return copy_to_model(reduce_from_model(partial, g), g)


def expert_offset(n_local: int, n_experts: int) -> int:
    """The first of the experts that a block holding ``n_local`` of
    ``n_experts`` stacked experts runs: 0 for all of them (outside
    tensor parallelism, or in a gathered block), else this rank's block
    of the E dim."""
    if n_local == n_experts:
        return 0
    return current_tensor_parallel().index * n_local


def router_loss(aux):
    """The router loss summed over the layers, ``aux``: as it is, or
    under expert parallelism, where each rank summed its own experts'
    terms, all-reduced over the model group (forward only: each rank's
    router then gets its experts' part of the gradient, which
    :func:`tensor_parallel_grad` sums once)."""
    from ..core.runtime_sharded import reduce_from_model
    tp = current_tensor_parallel()
    if tp is None or not tp.expert_parallel:
        return aux
    return reduce_from_model(aux, tp.group)


def to_head(x):
    """The residual stream ready for the vocab-parallel head: gathered
    over the sequence with sequence parallelism, else its gradient
    all-reduced (each rank's head block differentiates it in part).  A
    replicated head takes the stream as it is (the replicated stream, or
    this rank's block of the sequence): an all-reduce of its gradient
    would count the head's M times."""
    from ..core import runtime_sharded as rs
    tp = current_tensor_parallel()
    if tp is None or not tp.vocab_parallel:
        return x
    if tp.seq_parallel:
        return rs.gather_from_seq(x, tp.group, 1)
    return rs.copy_to_model(x, tp.group)


def last_position(x):
    """The residual stream's last position ``(B, 1, d)``, ready for the
    head: the sequence's last row on every rank.  With sequence
    parallelism it is the last rank's, so each rank's last row is
    gathered and the last kept (the gradient back as ``to_head``'s
    rule: summed over the ranks of a vocab-parallel head, which
    differentiate it in part, this rank's own of a replicated one); the
    whole stream's last row otherwise, its gradient all-reduced before a
    vocab-parallel head."""
    from ..core import runtime_sharded as rs
    tp = current_tensor_parallel()
    last = x[:, -1:]
    if tp is None or not (tp.seq_parallel or tp.vocab_parallel):
        return last
    g = tp.group
    if not tp.seq_parallel:
        return rs.copy_to_model(last, g)
    gather = rs.gather_from_seq if tp.vocab_parallel else rs.gather_from_model
    return gather(last, g, 1)[:, -1:]


def ring_block(kv, leaf: str = "k"):
    """This rank's block of the rows ``kv`` that a prefill places in the
    cache leaf ``leaf``: the ring's k or v (B, C, KV, hd) (``"k"``,
    ``"v"``), a layer's cross k or v (B, F, KV, hd) (``"cross_k"``), or
    MLA's ``c`` (B, C, r) or ``kr`` (B, C, rd).  A gathered attention
    block's k and v are whole, and so are MLA's ``c`` and ``kr``, of
    which a layout by slots keeps the rank's ``C / M`` slots and one by
    head dim or latent dim its slice of the last dim; a column-parallel
    block's k and v are already the rank's heads, and a replicated leaf
    keeps them whole."""
    from ..core.runtime_sharded import rank_block
    tp = current_tensor_parallel()
    layout = None if tp is None else tp.leaf_layout(leaf)
    if layout not in ("slots", "head_dim", "latent_dim"):
        return kv
    return rank_block(kv, tp.group, tp.cache[leaf])


def ring_write(ring, new, slot, leaf: str = "k") -> None:
    """Write each row's new entry ``new`` (B, ...) of the cache leaf
    ``leaf`` (the ring's ``"k"`` or ``"v"``, MLA's ``"c"`` or ``"kr"``)
    at its ring slot ``slot`` (B,) of ``ring`` (B, C, ...), in place.
    Under a layout by slots ``ring`` is this rank's ``C / M`` slots and
    only the owner of a row's slot writes it (the others write back what
    they hold); under one by head dim or latent dim the rank writes its
    slice of the last dim; a whole leaf is written whole."""
    import torch

    from ..core.runtime_sharded import rank_block
    tp = current_tensor_parallel()
    layout = None if tp is None else tp.leaf_layout(leaf)
    rows = torch.arange(ring.shape[0], device=ring.device)
    new = new.to(ring.dtype)
    if layout == "slots":
        n = ring.shape[1]
        local = slot - tp.index * n
        mine = ((local >= 0) & (local < n)).reshape(
            (-1,) + (1,) * (new.dim() - 1))
        local = local.clamp(0, n - 1)
        new = torch.where(mine, new, ring[rows, local])
        slot = local
    elif layout in ("head_dim", "latent_dim"):
        new = rank_block(new, tp.group, -1)
    ring[rows, slot] = new


def ring_attend(q, k, v, valid, scale, sdpa, leaf: str = "k"):
    """Attention of ``q`` (B, Sq, KV, R, hd) over the cache leaves ``k``,
    ``v`` (B, C, KV, hd) laid out as ``leaf`` (``"k"``: the ring,
    ``"cross_k"``: the cross caches) where ``valid`` (B, C) (the whole
    leaf's mask): ``sdpa(q, k, v, mask, scale)`` on a whole leaf or a
    rank's heads.  On this rank's slots, the masked scores' row max is
    all-reduced (max), and each rank's sum of exponentials and
    unnormalized ``p·v`` are all-reduced together (one sum), O(B·H·hd);
    a rank whose slots are all masked adds zeros.  On this rank's
    head-dim slice, the scores' partial sums are all-reduced (O(B·H·C)),
    the softmax is whole, and the rank's slice of ``p·v`` is gathered.
    What crosses the ranks is fp32 whatever the cache's dtype: the
    partial scores of a head-dim slice, and a rank's ``p·v`` before the
    merge."""
    import torch

    from ..core import runtime_sharded as rs
    tp = current_tensor_parallel()
    layout = None if tp is None else tp.leaf_layout(leaf)
    if layout not in ("slots", "head_dim"):
        return sdpa(q, k, v, valid[:, None, None, None, :], scale)
    g = tp.group
    f32 = torch.float32
    if layout == "head_dim":
        s = torch.einsum("bqgrd,bkgd->bgrqk",
                         rs.rank_block(q, g, -1).to(f32), k.to(f32))
        s = (rs.all_reduce_sum(s, g) * scale).masked_fill(
            ~valid[:, None, None, None, :], NEG)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        return rs.all_gather_seq(torch.einsum("bgrqk,bkgd->bqgrd", p, v),
                                 g, -1)
    n = k.shape[1]
    mask = valid[:, tp.index * n:(tp.index + 1) * n]
    s = torch.einsum("bqgrd,bkgd->bgrqk", q, k) * scale
    s = s.to(f32).masked_fill(~mask[:, None, None, None, :], NEG)
    return _merge_slots(s, v.to(f32), "bgrqk,bkgd->bqgrd", g).to(v.dtype)


def _merge_slots(s, v, spec: str, g):
    """The softmax over every rank's slots, applied to the values: ``s``
    this rank's masked fp32 scores (its slots the last dim), contracted
    with its fp32 values ``v`` by the einsum ``spec``.  The scores' row
    max is all-reduced (max), and each rank's unnormalized output and
    its sum of exponentials (the same contraction with a column of ones
    beside ``v``) are all-reduced together (one sum); a rank whose slots
    are all masked adds zeros."""
    import torch

    from ..core import runtime_sharded as rs
    e = torch.exp(s - rs.all_reduce_max(s.amax(-1, keepdim=True), g))
    red = rs.all_reduce_sum(torch.einsum(spec, e, torch.cat(
        [v, v.new_ones(v.shape[:-1] + (1,))], -1)), g)
    return red[..., :-1] / red[..., -1:]


def latent_attend(qn, qr, c, kr, p, valid, scale, attend):
    """MLA's decode attention of ``qn`` (B, 1, H, hd) and ``qr`` (B, 1, H,
    rd) over the latent ``c`` (B, C, r) and the roped key part ``kr`` (B,
    C, rd) where ``valid`` (B, C) (the whole ring's mask), through the
    block's leaves ``p`` (H of the heads: ``k_up``'s columns), projected
    by ``wo``: ``attend(qn, qr, c, kr, mask)`` on a whole ``c``.

    On this rank's block of ``c`` it attends in the absorbed form: with
    ``q̃ = qn · k_upᵀ`` (B, 1, H, r) a head's scores are ``q̃ · c + qr ·
    kr`` and its output ``(p · c) · v_up``.  Beside a column-parallel
    block the ranks gather every head's ``[q̃ | qr]`` (one gather), and
    every rank attends every head.  By slots, the masked scores of this
    rank's ``C / M`` slots (against the same slots of ``kr``) have their
    row max all-reduced (max), and the sums of exponentials and
    ``u = Σ p · c`` (B, 1, H, r) are all-reduced together (one sum),
    the ring's slots merge (:func:`_merge_slots`); by latent dim, the
    partial scores
    of this rank's ``r / M`` slice are all-reduced (one sum), ``qr · kr``
    is added once, the softmax is whole and the slices of ``u`` are
    gathered.  Each rank then keeps its heads' ``u`` for its ``v_up``
    columns and ``wo`` rows.  What crosses the ranks is fp32 whatever
    the cache's dtype."""
    import torch

    from ..core import runtime_sharded as rs
    tp = current_tensor_parallel()
    layout = None if tp is None else tp.leaf_layout("c")
    if layout not in ("slots", "latent_dim"):
        return attend(qn, qr, c, kr, valid[:, None, None, :])
    g, f32 = tp.group, torch.float32
    B, _, H, hd = qn.shape
    r = p["k_up"].shape[0]
    qt = torch.einsum("bqhd,rhd->bqhr", qn.to(f32),
                      p["k_up"].reshape(r, H, hd).to(f32))
    q = torch.cat([qt, qr.to(f32)], -1)
    column = ATTN not in tp.gathered
    if column:
        q = rs.all_gather_seq(q, g, 2)
    qt, qr = q[..., :r], q[..., r:]
    cf = c.to(f32)
    if layout == "latent_dim":
        s = torch.einsum("bqhr,bkr->bhqk", rs.rank_block(qt, g, -1), cf)
        s = rs.all_reduce_sum(s, g) + torch.einsum(
            "bqhd,bkd->bhqk", qr, kr.to(f32))
        s = (s * scale).masked_fill(~valid[:, None, None, :], NEG)
        u = rs.all_gather_seq(torch.einsum(
            "bhqk,bkr->bqhr", torch.softmax(s, dim=-1), cf), g, -1)
    else:
        n = c.shape[1]
        mine = slice(tp.index * n, (tp.index + 1) * n)
        s = torch.einsum("bqhr,bkr->bhqk", qt, cf) + torch.einsum(
            "bqhd,bkd->bhqk", qr, kr[:, mine].to(f32))
        s = (s * scale).masked_fill(~valid[:, None, None, mine], NEG)
        u = _merge_slots(s, cf, "bhqk,bkr->bqhr", g)
    if column:
        u = rs.rank_block(u, g, 2)
    vd = p["v_up"].shape[-1] // H
    o = torch.einsum("bqhr,rhd->bqhd", u, p["v_up"].reshape(r, H, vd)
                     .to(f32))
    return o.reshape(B, 1, H * vd).to(qn.dtype) @ p["wo"]


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


def seq_parallel_mean(per_token, tp: TensorParallel):
    """The mean over the whole sequence of a per-token loss of which this
    rank holds its block of the sequence: the local sum all-reduced over
    the model group, over the tokens of every block.  Each rank's
    gradient of a replicated leaf is then its block's part, which
    :func:`tensor_parallel_grad` all-reduces."""
    from ..core.runtime_sharded import reduce_from_model
    return reduce_from_model(per_token.sum(), tp.group) / (
        per_token.numel() * tp.size)


def tensor_parallel_grad(spec, loss_fn, tp: TensorParallel):
    """``(params, batch, key) -> loss`` on the local tree that ``spec``
    ravels -> ``(x_loc, batch, key) -> (loss, g_loc)``: the flat
    gradient of the local blocks (``core.paramvec.value_and_grad``) with
    the loss run under :func:`use_tensor_parallel`, and the gradients of
    the replicated leaves that are a rank's part all-reduced over the
    model group (one call: their segments side by side): every
    replicated leaf's whose stream (the encoder's or the decoder's,
    ``TensorParallel.stream_seq_parallel``) is sequence-parallel, and
    those of ``tp.partial``.  The loss is the same on every rank of the
    group."""
    import torch

    from ..core.paramvec import value_and_grad
    from ..core.runtime_sharded import all_reduce_sum

    vg = value_and_grad(spec, loss_fn)
    segs = [(off, int(torch.Size(shape).numel()))
            for path, shape, off in zip(spec.paths, spec.shapes,
                                        spec.offsets)
            if tp.dims[path] is None
            and (tp.stream_seq_parallel(path) or path in tp.partial)]

    def grad(x, batch, key):
        with use_tensor_parallel(tp):
            loss, g = vg(x, batch, key)
        if segs:
            red = all_reduce_sum(torch.cat([g[o:o + n] for o, n in segs]),
                                 tp.group)
            i = 0
            for o, n in segs:
                g[o:o + n] = red[i:i + n]
                i += n
        return loss, g

    return grad
