"""Input specs and step functions for every (architecture × input shape)
combination: the dry-run's subject matter.

Counterpart of ``src/repro/launch/specs.py``.  Shapes (the reference's):

  train_4k     seq 4096    global_batch 256   train_step (R-FAST round)
  prefill_32k  seq 32768   global_batch 32    prefill (forward logits)
  decode_32k   seq 32768   global_batch 128   serve_step (1 token + cache)
  long_500k    seq 524288  global_batch 1     serve_step, sub-quadratic only

Each build function returns ``(step_fn, args)``.  Where the reference returns
``ShapeDtypeStruct`` stand-ins of the *global* arrays with their
shardings, the port returns tensors of the shapes *one rank* of its mesh
holds, on ``device`` (``"meta"`` by default: shapes and dtypes, no data,
nothing allocated; another device materializes the same case from
``seed``).  What a rank of the port holds:

* **train** — ``comm="ppermute"`` (and ``"auto"``) is
  :func:`~repro_torch.core.runtime_sharded.make_sharded_round` over the
  node axes: this rank's node, its flat state rows ``(1, p)`` and ``(1,
  S_a, p)`` and its node's whole batch.  For every arch
  (``models.sharding.tensor_parallel_supported``: the dense, MoE, MLA,
  SSM and hybrid decoders, pixtral-12b's patch prefix and
  whisper-large-v3's encoder and cross attention) on a ``model`` axis
  of M > 1 ranks, the axis runs tensor-parallel as the reference's
  GSPMD runs it: a rank's tree is its blocks of the leaves the
  reference's PartitionSpecs shard (``models.sharding.tensor_parallel``,
  the node axes leading) and whole copies of the rest, ``p`` is the
  width of their flat ravel, and the gradient is
  ``models.sharding.tensor_parallel_grad``; ``step_fn.info`` says
  ``"model_axis": "tensor"`` and records the sequence parallelism (where
  M divides the decoder's whole sequence, a frontend's prefix
  included), the blocks that run gathered, whether the embedding and
  head are vocab-parallel or replicated and, for an enc-dec arch,
  whether the encoder's stream is sequence-parallel
  (``"encoder_seq_parallel"``).  ``comm="dense"`` is
  :func:`~repro_torch.core.runtime.make_rfast_round`, which the port
  runs in one process for every node, so its figures are the whole
  round's.  The gradient is the flat-vector gradient of ``loss_fn(...,
  remat=True, ce=ce)``.
* **prefill / decode** — ``forward(..., last_only=True)`` and
  ``decode_step`` on this rank's batch rows (:func:`~.shardings.
  batch_pspec`'s divisibility rule).  For every arch on a ``model`` axis
  of M > 1 ranks, the axis runs tensor-parallel (:func:`serving_layout`):
  a rank holds its blocks of the parameter tree laid out without lead
  axes, as the reference's ``tree_shardings(params, mesh, rules)``
  lays them out (an MoE block's ``E / M`` experts, MLA's ``H / M``
  heads), and its block of every decode cache leaf, as
  ``cache_pspecs(cache, mesh, batch_axes, seq_shard=cache_seq_shard)``
  lays it out (the cross caches ``cross_k`` / ``cross_v`` and MLA's
  latent ``c`` included; MLA's ``kr``, ``idx`` and ``slot_pos`` whole);
  ``seq_parallel`` shards the prefill's residual stream over the
  sequence (a frontend's prefix included) where M divides it, and
  whisper's encoder stream over the frames where M divides them too.
  ``step_fn.info`` says ``"model_axis": "tensor"``, the blocks that run
  gathered, ``vocab_parallel`` and ``cache_layout`` (the k/v ring by
  ``heads``, ``slots``, ``head_dim`` or ``replicated``, the SSM state by
  ``channels`` or ``replicated``, for the enc-dec arch the cross caches,
  ``"cross"``, by ``heads``, ``head_dim`` or ``replicated``, and for the
  MLA arch its latent, ``"latent"``, by ``slots``, ``latent_dim`` or
  ``replicated``).  At M = 1 every rank holds the whole model and cache
  (``"model_axis": "replicated"``, ``cache_layout`` None).  Where the
  batch axes split the rows (fewer rows a rank than ``global_batch``),
  the step runs inside ``models.sharding.use_batch_group`` of those
  axes' group, at M = 1 too: an MoE layer then routes the whole batch's
  tokens as the reference's one program does (one gather of the
  experts' choice counts over the group a layer, ``models/moe.py``);
  ``step_fn.info["batch_ranks"]`` is the group's size, or None where
  every rank holds every row (nothing is gathered).

``dtype`` defaults to the reference's bf16.  Parameter trees follow the
reference's dtypes (:func:`~repro_torch.models.transformer.param_shapes`:
the MoE router and the SSM's A_log and D stay fp32).  The train state is
one flat vector of one dtype, so there every leaf is in ``dtype``, A_log
and D included; ``step_fn.info["state_dtype"]`` records it.  The
reference's per-node PRNG keys are not an argument: the port's gradient
takes no key (RNG cannot be matched; ROADMAP).

``rules`` is the reference's (``RULES_BASE`` by default): the
tensor-parallel train case cuts its blocks by them, prefill and decode
by their ``model`` axis (an FSDP rule's ``embed`` -> ``data`` is only
reported), and the dry-run reports the layout they name.
``step_fn.info`` holds what the dry-run records beside its counts.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.paramvec import make_ravel_spec, ravel, value_and_grad
from ..core.plan import build_comm_plan
from ..core.protocol import ProtocolState
from ..core.runtime import init_node_state, make_rfast_round
from ..core.runtime_sharded import (DescribedGroup, ShardedState,
                                    init_sharded_state, make_sharded_round,
                                    shard_state)
from ..core.topology import binary_tree
from ..models import sharding as msh
from ..models.config import ModelConfig
from ..models.transformer import (cast_params, decode_step, forward,
                                  init_cache, init_params, loss_fn,
                                  param_shapes)
from . import shardings as sh

__all__ = ["SHAPES", "LONG_WINDOW", "SEQ_PARALLEL_OPT_OUT",
           "shape_supported", "act_rules", "build_train", "whole_cache",
           "serving_layout", "build_prefill", "build_decode", "build_case",
           "input_specs", "tensors_of"]

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode", long=True),
}
LONG_WINDOW = 8192          # sliding window used by dense archs at 500k

# the reference's per-arch tuning: sequence-parallel residual sharding
# regresses MHA-32 (deepseek-7b) and deepseek-v2's MoE dispatch
SEQ_PARALLEL_OPT_OUT = {"deepseek-7b", "deepseek-v2-236b"}


def shape_supported(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and cfg.enc_dec:
        return False, ("enc-dec audio model: quadratic encoder context, no "
                       "sliding-window decoder analogue (DESIGN.md §4)")
    return True, ""


def _long_variant(cfg: ModelConfig) -> ModelConfig:
    """Sub-quadratic serving variant for the 500k shape."""
    if cfg.mixer == "ssm":
        return cfg
    if cfg.attn_window and cfg.attn_window <= LONG_WINDOW:
        return cfg
    return dataclasses.replace(cfg, attn_window=LONG_WINDOW)


# activation rules (models/sharding.py logical axes -> mesh axes)
def act_rules(batch_axes, seq_parallel: bool = False) -> dict:
    """seq_parallel: shard the residual stream's sequence dim over
    'model' (sequence parallelism), as the reference's GSPMD program
    would; the port records the rules and runs the same eager step."""
    return dict(
        batch=tuple(batch_axes) if batch_axes else None,
        seq="model" if seq_parallel else None,
        embed=None, mlp="model", heads="model",
        kv_heads="model", head_dim=None, vocab="model", expert="model",
        cap=None, ssm_inner="model", ssm_state=None, kv_seq=None,
        frontend=None, node=None,
    )


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _params(cfg: ModelConfig, dtype, device, seed: int) -> dict:
    """The parameter tree on ``device``: :func:`param_shapes` on meta,
    else ``init_params`` drawn there from ``seed``, in the same dtypes."""
    if torch.device(device).type == "meta":
        return param_shapes(cfg, dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    return cast_params(init_params(cfg, gen), dtype)


def _tokens(shape, vocab: int, device, gen) -> torch.Tensor:
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.int32, device="meta")
    return torch.randint(0, vocab, shape, generator=gen, device=device,
                         dtype=torch.int32)


def _frontend(cfg: ModelConfig, lead: tuple, dtype, device, gen):
    if not cfg.frontend:
        return None
    shape = lead + (cfg.frontend_seq, cfg.frontend_dim or cfg.d_model)
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def _rows(mesh, batch_axes, global_batch: int, shape_tail: tuple) -> int:
    """The batch rows one rank holds under ``batch_pspec``."""
    spec = sh.batch_pspec(1 + len(shape_tail), mesh, batch_axes,
                          (global_batch,) + shape_tail)
    return sh.shard_shape(spec, (global_batch,) + shape_tail, mesh)[0]


def _s_text(cfg: ModelConfig, seq: int) -> int:
    return seq - (cfg.frontend_seq if (cfg.frontend and not cfg.enc_dec)
                  else 0)


# ------------------------------------------------------------------ #
# train_4k: one R-FAST production round
# ------------------------------------------------------------------ #
def build_train(cfg: ModelConfig, mesh, *, seq: int, global_batch: int,
                rules=None, node_axes=None, gamma=1e-2, topo=None,
                dtype=torch.bfloat16, comm: str = "auto", ce: str = "lse",
                seq_parallel: bool | None = None, impl: str = "kernel",
                device="meta", seed: int = 0):
    """One R-FAST round for this rank (see the module docstring).

    ``comm``: ``"ppermute"`` / ``"auto"`` (one node a rank of the node
    axes) or ``"dense"`` (every node in this process).  ``impl`` is the
    dense round's commit backend (``"kernel"``: one ``commit_grid``
    launch a round).  ``device`` other than meta materializes the case:
    weights (every rank draws the whole tree and keeps its blocks) and
    every node's tokens from ``seed``, the state by the paper's init (a
    gradient of every node; a ppermute rank keeps its node's rows and
    batch, ``runtime_sharded.shard_state``).  A ppermute case
    materializes only on a mesh of real ranks (``launch.mesh.
    make_sweep_mesh`` in a process group; every rank of the mesh calls
    this together), a described mesh's only on meta."""
    if seq_parallel is None:
        seq_parallel = cfg.name not in SEQ_PARALLEL_OPT_OUT
    if node_axes is None:
        node_axes = tuple(a for a in mesh.axis_names if a != "model")
    node_axes = tuple(node_axes)
    n_nodes = sh.mesh_axis_size(mesh, node_axes)
    b_node = global_batch // n_nodes
    if b_node < 1:
        raise ValueError(f"global batch {global_batch} is smaller than the "
                         f"{n_nodes} nodes")
    topo = topo or binary_tree(n_nodes)
    plan = build_comm_plan(topo)
    if comm == "auto":
        comm = "ppermute"
    if comm not in ("ppermute", "dense"):
        raise ValueError(f"comm must be 'auto', 'ppermute' or 'dense', got "
                         f"{comm!r}")
    live = torch.device(device).type != "meta"
    if live and comm != "dense" and isinstance(
            mesh.group(node_axes).pg, DescribedGroup):
        raise ValueError("a described mesh materializes only a dense case: "
                         "a ppermute case runs live on a mesh of real ranks "
                         "(launch.mesh.make_sweep_mesh), on meta on a "
                         "described one")
    s_text = _s_text(cfg, seq)
    inner_batch = tuple(a for a in mesh.axis_names
                        if a != "model" and a not in node_axes)
    arules = act_rules(inner_batch, seq_parallel=seq_parallel)

    tree = _params(cfg, dtype, device, seed)
    p_whole = make_ravel_spec(tree).p
    M = sh.mesh_axis_size(mesh, "model") if "model" in mesh.axis_names \
        else 1
    tp = None
    if (comm == "ppermute" and M > 1 and "model" not in node_axes
            and msh.tensor_parallel_supported(cfg)):
        # the decoder's whole sequence: the text and a frontend's prefix
        s_dec = s_text + (cfg.frontend_seq if cfg.frontend
                          and not cfg.enc_dec else 0)
        tp = msh.tensor_parallel(
            cfg, tree, mesh, rules=rules, node_axes=node_axes,
            seq_parallel=seq_parallel and s_dec % M == 0)
        tree = msh.local_tree(tree, tp)
    rspec = make_ravel_spec(tree, dtype=dtype)
    p = rspec.p

    def loss(params, batch, _key):
        return loss_fn(cfg, params, batch[0], batch[1],
                       batch[2] if len(batch) > 2 else None, remat=True,
                       ce=ce)
    grad_fn = (value_and_grad(rspec, loss) if tp is None
               else msh.tensor_parallel_grad(rspec, loss, tp))

    rows = n_nodes if (comm == "dense" or live) else 1
    gen = (torch.Generator(device=device).manual_seed(seed + 1)
           if live else None)
    batch = [_tokens((rows, b_node, s_text), cfg.vocab, device, gen),
             _tokens((rows, b_node, s_text), cfg.vocab, device, gen)]
    fr = _frontend(cfg, (rows, b_node), dtype, device, gen)
    if fr is not None:
        batch.append(fr)
    batch = tuple(batch)

    if comm == "ppermute":
        round_fn = make_sharded_round(topo, grad_fn, mesh, gamma=gamma,
                                      node_axes=node_axes)
        if live:
            state = shard_state(init_sharded_state(
                topo, ravel(rspec, tree), grad_fn, batch), mesh, node_axes)
            batch = shard_state(batch, mesh, node_axes)
        else:
            row = lambda *s: torch.empty(s, dtype=dtype, device="meta")
            state = ShardedState(step=0, x=row(1, p), z=row(1, p),
                                 g_prev=row(1, p),
                                 rho_out=row(1, plan.s_a, p),
                                 rho_buf=row(1, plan.s_a, p), mail_v=None,
                                 m=None)
    else:
        round_fn = make_rfast_round(plan, grad_fn, gamma=gamma,
                                    node_axes=node_axes, impl=impl)
        if live:
            state = init_node_state(plan, ravel(rspec, tree), grad_fn, batch)
        else:
            row = lambda *s: torch.empty(s, dtype=dtype, device="meta")
            state = ProtocolState(step=0, x=row(n_nodes, p),
                                  z=row(n_nodes, p), g_prev=row(n_nodes, p),
                                  rho=row(plan.e_pad, p),
                                  rho_buf=row(plan.e_pad, p), mail_v=None,
                                  m=None)
    del tree

    def train_step(state, batches, keys=None):
        with msh.mesh_rules(mesh, arules):
            return round_fn(state, batches, keys, None)

    train_step.info = dict(
        kind="train", comm=comm, n_nodes=n_nodes, b_node=b_node, seq=seq,
        s_text=s_text, p=p, p_model=rspec.p_model, p_whole=p_whole,
        impl=impl, dtype=_dtype_name(dtype), state_dtype=_dtype_name(dtype),
        node_axes=list(node_axes), inner_batch_axes=list(inner_batch),
        model_axis="replicated" if tp is None else "tensor",
        seq_parallel=seq_parallel if tp is None else tp.seq_parallel,
        tensor_parallel=None if tp is None else dict(
            ranks=tp.size, gathered=sorted("/".join(b)
                                           for b in tp.gathered),
            vocab_parallel=tp.vocab_parallel,
            **({} if tp.enc_seq_parallel is None
               else {"encoder_seq_parallel": tp.enc_seq_parallel})),
        ce=ce, matchings=len(plan.slots_w) + len(plan.slots_a))
    # what a caller needs to gather a state row whole
    # (models.sharding.gather_flat)
    train_step.tensor_parallel, train_step.ravel_spec = tp, rspec
    return train_step, (state, batch, None)


# ------------------------------------------------------------------ #
# prefill / decode: the model axis tensor-parallel
# ------------------------------------------------------------------ #
def whole_cache(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16) -> dict:
    """The whole decode cache of ``batch`` rows and ``max_len`` positions
    as meta tensors, an enc-dec arch's cross caches from a meta frontend
    (nothing run but shapes), the same on every rank."""
    with msh.use_tensor_parallel(None):
        return init_cache(cfg, param_shapes(cfg, dtype), batch, max_len,
                          dtype, _frontend(cfg, (batch,), dtype, "meta",
                                           None))


def serving_layout(cfg: ModelConfig, tree, mesh, *, max_len: int,
                   cache_seq_shard: bool = True, seq_parallel: bool = False,
                   rules=None, dtype=torch.bfloat16):
    """This rank's :class:`~repro_torch.models.sharding.TensorParallel`
    for prefill and decode of ``cfg`` on ``mesh`` (``tree`` the whole
    parameter tree; meta tensors will do), or None where the ``model``
    axis stays replicated (M = 1): the parameters laid out without lead
    axes by the ``model`` axis of ``rules``, the
    decode cache of ``max_len`` positions by ``cache_pspecs(...,
    seq_shard=cache_seq_shard)`` (``models.sharding.with_cache``), the
    prefill's stream sequence-parallel with ``seq_parallel``.  Every rank
    of the mesh calls it with the same arguments."""
    M = sh.mesh_axis_size(mesh, "model") if "model" in mesh.axis_names \
        else 1
    if M <= 1:
        return None
    rules = {k: (v if v == "model" else None)
             for k, v in (rules or sh.RULES_BASE).items()}
    tp = msh.tensor_parallel(cfg, tree, mesh, rules=rules, node_axes=(),
                             seq_parallel=seq_parallel)
    return msh.with_cache(tp, whole_cache(cfg, 1, max_len, dtype),
                          seq_shard=cache_seq_shard)


def _batch_group(mesh, batch_axes, rows: int, global_batch: int):
    """The group of the batch axes where they split the rows (this rank
    holds ``rows`` of ``global_batch``), else None."""
    return mesh.group(batch_axes) if rows < global_batch else None


def _serving_info(tp, group) -> dict:
    out = dict(batch_ranks=None if group is None else group.size)
    if tp is None:
        return dict(out, model_axis="replicated", tensor_parallel=None,
                    cache_layout=None)
    return dict(out, model_axis="tensor", tensor_parallel=dict(
        ranks=tp.size, gathered=sorted("/".join(b) for b in tp.gathered),
        vocab_parallel=tp.vocab_parallel), cache_layout=tp.cache_layout)


# ------------------------------------------------------------------ #
# prefill_32k: full forward producing logits
# ------------------------------------------------------------------ #
def build_prefill(cfg: ModelConfig, mesh, *, seq: int, global_batch: int,
                  rules=None, dtype=torch.bfloat16,
                  seq_parallel: bool | None = None, device="meta",
                  seed: int = 0):
    """The reference's ``prefill_step`` for this rank (see the module
    docstring): ``forward(..., last_only=True)`` of its batch rows, the
    last position's logits (this rank's vocab block where the head is
    vocab-parallel).  ``device`` other than meta draws the weights (every
    rank the whole tree, keeping its blocks) and the tokens from
    ``seed``; a tensor-parallel case materializes only on a mesh of real
    ranks.  The info's ``cache_layout`` is the one a ``prefill_cache`` of
    this case would fill (``cache_pspecs``' default ``seq_shard``, as
    :func:`build_decode`'s)."""
    if seq_parallel is None:
        seq_parallel = cfg.name not in SEQ_PARALLEL_OPT_OUT
    batch_axes = tuple(a for a in mesh.axis_names if a != "model")
    arules = act_rules(batch_axes, seq_parallel=seq_parallel)
    s_text = _s_text(cfg, seq)
    b = _rows(mesh, batch_axes, global_batch, (s_text,))
    live = torch.device(device).type != "meta"
    gen = (torch.Generator(device=device).manual_seed(seed + 1)
           if live else None)
    params = _params(cfg, dtype, device, seed)
    M = sh.mesh_axis_size(mesh, "model") if "model" in mesh.axis_names \
        else 1
    tp = serving_layout(cfg, params, mesh, max_len=seq, rules=rules,
                        dtype=dtype,
                        seq_parallel=seq_parallel and seq % M == 0)
    if tp is not None:
        params = msh.local_tree(params, tp)
    group = _batch_group(mesh, batch_axes, b, global_batch)

    @torch.no_grad()
    def prefill_step(params, tokens, frontend=None):
        with msh.mesh_rules(mesh, arules), msh.use_tensor_parallel(tp), \
                msh.use_batch_group(group):
            logits, _ = forward(cfg, params, tokens, frontend, remat=True,
                                last_only=True)
        return logits

    args = [params, _tokens((b, s_text), cfg.vocab, device, gen)]
    fr = _frontend(cfg, (b,), dtype, device, gen)
    if fr is not None:
        args.append(fr)
    prefill_step.info = dict(kind="prefill", seq=seq, s_text=s_text,
                             rows=b, dtype=_dtype_name(dtype),
                             seq_parallel=seq_parallel if tp is None
                             else tp.seq_parallel,
                             **_serving_info(tp, group))
    prefill_step.tensor_parallel = tp
    return prefill_step, tuple(args)


# ------------------------------------------------------------------ #
# decode_32k / long_500k: serve_step (one token, filled cache)
# ------------------------------------------------------------------ #
def build_decode(cfg: ModelConfig, mesh, *, seq: int, global_batch: int,
                 long: bool = False, rules=None, dtype=torch.bfloat16,
                 cache_seq_shard: bool = True, device="meta",
                 seed: int = 0):
    """The reference's ``serve_step`` for this rank (see the module
    docstring): one ``decode_step`` of its batch rows over an empty
    cache of ``seq`` positions (this rank's blocks of the layout).
    ``device`` other than meta draws the weights and tokens from
    ``seed`` as :func:`build_prefill` does."""
    if long:
        cfg = _long_variant(cfg)
    batch_axes = tuple(a for a in mesh.axis_names if a != "model")
    arules = act_rules(batch_axes)
    b = _rows(mesh, batch_axes, global_batch, (1,))
    live = torch.device(device).type != "meta"
    gen = (torch.Generator(device=device).manual_seed(seed + 1)
           if live else None)
    params = _params(cfg, dtype, device, seed)
    tp = serving_layout(cfg, params, mesh, max_len=seq, rules=rules,
                        cache_seq_shard=cache_seq_shard, dtype=dtype)
    if tp is not None:
        params = msh.local_tree(params, tp)
    group = _batch_group(mesh, batch_axes, b, global_batch)

    def serve_step(params, cache, token):
        with msh.mesh_rules(mesh, arules), msh.use_tensor_parallel(tp), \
                msh.use_batch_group(group):
            return decode_step(cfg, params, cache, token)

    with msh.use_tensor_parallel(tp):
        cache = init_cache(cfg, params, b, seq, dtype,
                           _frontend(cfg, (b,), dtype, device, gen))
    serve_step.info = dict(kind="decode", seq=seq, rows=b, long=long,
                           attn_window=cfg.attn_window,
                           dtype=_dtype_name(dtype),
                           cache_seq_shard=cache_seq_shard,
                           **_serving_info(tp, group))
    return serve_step, (params, cache,
                        _tokens((b, 1), cfg.vocab, device, gen))


# ------------------------------------------------------------------ #
def build_case(cfg: ModelConfig, mesh, shape_name: str, **kw):
    info = SHAPES[shape_name]
    if info["kind"] == "train":
        return build_train(cfg, mesh, seq=info["seq"],
                           global_batch=info["batch"], **kw)
    if info["kind"] == "prefill":
        return build_prefill(cfg, mesh, seq=info["seq"],
                             global_batch=info["batch"], **kw)
    return build_decode(cfg, mesh, seq=info["seq"],
                        global_batch=info["batch"],
                        long=info.get("long", False), **kw)


def input_specs(arch: str, shape_name: str, mesh=None, **kw):
    """Public API: meta tensors (shapes and dtypes of one rank, nothing
    allocated) for every model input of (arch × shape), plus the step
    function they feed.  Returns (step_fn, args)."""
    from ..configs import get_config
    from .mesh import make_production_mesh

    if mesh is None:
        mesh = make_production_mesh()
    return build_case(get_config(arch), mesh, shape_name, **kw)


def tensors_of(tree) -> list:
    """Every tensor of a tree of dicts, lists and (named) tuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors_of(v)]
    return []

