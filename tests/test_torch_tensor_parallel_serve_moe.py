"""Prefill and decode with the ``model`` axis tensor-parallel for the MoE
and MLA archs against JAX: experts over ``model`` in decode, MLA's latent
cache by slots or by latent dim.

One spawn of 4 gloo ranks (``spawn_local``) runs every case; the JAX
side runs here, where JAX sees one device.  Weights have the layout of
JAX's ``init_params`` of reduced configs (d 64, vocab 256, 2 layers, 4
experts top-2): phi3.5-moe with 4 heads and 2 KV heads of 16,
deepseek-v2 with 4 MLA heads of 16, ``kv_lora_rank`` 32, ``qk_rope_dim``
16 and 1 shared expert; ``dsv2_w8`` the same with an ``attn_window`` of
8 (a ring of 8 slots, 2 a rank on 4 ranks, which the decode steps wrap
across the ranks twice) and ``dsv2_drop`` with ``capacity_factor`` 0.25
(the prefill drops some of its tokens' choices).  They are drawn with
numpy from a seed, like the tokens.  Each case is ``prefill_cache`` of a
prompt of 8 tokens and 16 teacher-forced ``decode_step``s (B 2,
``max_len`` 48) on this rank's blocks, the layout from
``launch.specs.serving_layout``; the prefill is sequence-parallel for
phi3.5-moe and not for deepseek-v2 (the reference's
``SEQ_PARALLEL_OPT_OUT``):

* phi on (1, 2): the ring by KV heads, 2 experts a rank; on (1, 4),
  where 2 KV heads do not divide, the ring by slots (12 a rank) beside
  the gathered attention block, 1 expert a rank;
* dsv2 on (1, 4): ``c`` by slots (12 a rank) beside 1 MLA head a rank,
  or with ``cache_seq_shard=False`` by latent dim (8 of 32); on (2, 2)
  by slots with the batch rows over ``data``; on (1, 3), where 4 heads
  and 4 experts do not divide, by slots (16 a rank) beside the gathered
  MLA and MoE blocks; ``dsv2_w8`` and ``dsv2_drop`` on (1, 4) by slots;
* the batch rows over ``data``, where every MoE layer routes the whole
  batch (``sharding.use_batch_group``: one gather of the experts' choice
  counts over the data group a layer): ``dsv2_drop`` on (2, 2), ``c`` by
  slots, and on (2, 1) with no tensor parallelism; ``phi_drop``
  (``capacity_factor`` 0.25) on (2, 2), the ring by heads, its prefill
  sequence-parallel; ``dsv2_drop_b16``, ``dsv2_drop`` at B 16 and 4
  decode steps on (2, 2), where a decode step's 16 tokens overflow an
  expert.  The whole batch drops choices at the prefill (``dsv2_drop``,
  ``phi_drop``) or at a decode step (``dsv2_drop_b16``) that no rank's
  own rows would drop.

Every step's logits (gathered over the vocab) are held within 1e-5 of
the largest |logit| to JAX's unsharded ``prefill_cache`` +
``decode_step`` of the whole batch, on the rank's rows; the gathered
cache (``k`` / ``v``, or ``c`` and ``kr``), ``idx`` and ``slot_pos`` to
JAX's final cache; each local cache leaf has the shape of
``NamedSharding(mesh, spec).shard_shape`` of JAX's own ``cache_pspecs``;
every rank's routes (each token's experts and whether it was kept) at
the prefill and at each step equal the unsharded model's on the whole
batch, cut to the rank's rows, and the whole batch drops where
``DROPS`` says.
deepseek-v2 by slots and by latent dim runs once more in bf16, held to
JAX's bf16 run within ``BF16_TOL``.  ``decode_step_slots`` (rows at
positions 5 and 0, each row routed alone) of phi and dsv2 on (1, 4) is
held to the port's unsharded one.  ``build_prefill(device="cpu")`` is
held to JAX's ``forward(..., last_only=True)``, and
``build_decode(device="cpu")``'s argument bytes a rank to the meta
case's.

The fault of the batch rows over ``data``, beside the repaired code:
each data rank routing its own rows alone (``dsv2_drop`` on (2, 2) with
no batch group) misses 1e-5 on node 1.  The four faults of the model
axis, on ranks 0-3 (dsv2 on (1, 4), ``c`` by slots), each beside the
repaired code:

1. ``mla_decode`` writing every rank's block at the position's slot
   within the block (``pos % (C / M)``): from position 12 on, ranks 1-3
   overwrite valid slots of their blocks;
2. ``_mla_attend`` on a rank's block of slots as if it were the whole
   ring: each rank's heads softmax over its own slots only;
3. ``prefill_cache``'s ``ring_block`` without the leaf's name: every
   rank keeps the whole ``c``, which the decode's merge cannot cut;
4. ``c``'s layout read through ``KV_LAYOUTS``: by slots it reads
   ``"heads"``, every rank keeps the whole ``c`` and its gathered blocks
   are not the cache.

On meta, the production meshes: phi3.5-moe and deepseek-v2
``decode_32k``, ``prefill_32k`` and ``long_500k`` on (32, 8) and
``decode_32k`` on (64, 4) say ``"model_axis": "tensor"`` and the
layouts of ``cache_pspecs``, a rank's cache and parameter leaves have
JAX's ``shard_shape``, and one decode step issues exactly these
collectives over the model group (L layers), and over the data group
(across hosts) one gather of the experts' counts a layer at
``decode_32k``, none at ``long_500k``'s batch of 1:

* phi3.5-moe (32 layers, the ring by KV heads, the attention and MoE
  blocks column / row-parallel, vocab-parallel): the embedding's sum and
  one a block, 1 + 2·32 = 65 sums;
* deepseek-v2 (60 layers) with ``c`` by slots: a layer's gather of every
  head's ``[q̃ | qr]``, the merge's max and sum, the MLA block's and the
  MoE block's sums: 60 gathers, 60 maxes, 1 + 3·60 = 181 sums; by latent
  dim: the gather, the partial scores' sum, the gather of ``u``'s slices
  and the two blocks' sums: 120 gathers, 181 sums.

The ranks import this module by name, so JAX is imported inside the
tests only.
"""
import dataclasses as dc

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.runtime_sharded import all_gather_seq
from repro_torch.launch import shardings as sh
from repro_torch.launch import specs
from repro_torch.launch.dryrun import _distinct_bytes
from repro_torch.launch.mesh import describe_mesh, make_sweep_mesh
from repro_torch.launch.multihost import spawn_local
from repro_torch.models import moe as moe_mod
from repro_torch.models import sharding as msh
from repro_torch.models.transformer import (FP32_LEAVES, cast_params,
                                            decode_step, decode_step_slots,
                                            init_cache, param_shapes,
                                            params_from_jax, prefill_cache)

TOL = 1e-5
B, S, STEPS, MAX_LEN = 2, 8, 16, 48
CFGS = {"phi": ("phi3.5-moe-42b-a6.6b", dict(n_kv_heads=2)),
        "dsv2": ("deepseek-v2-236b", {}),
        "dsv2_w8": ("deepseek-v2-236b", dict(attn_window=8)),
        "dsv2_drop": ("deepseek-v2-236b", dict(capacity_factor=0.25)),
        "phi_drop": ("phi3.5-moe-42b-a6.6b", dict(n_kv_heads=2,
                                                  capacity_factor=0.25)),
        "dsv2_drop_b16": ("deepseek-v2-236b", dict(capacity_factor=0.25))}
# the configs whose batch (B unless listed) and decode steps (STEPS unless
# listed) differ: at B 16 a decode step's 16 tokens overflow an expert
BATCH = {"dsv2_drop_b16": 16}
STEPS_OF = {"dsv2_drop_b16": 4}
# where the whole batch drops choices: at its prefill or a decode step
DROPS = {"dsv2_drop": "prefill", "phi_drop": "prefill",
         "dsv2_drop_b16": "decode"}
PHI = lambda kv: {"kv": kv, "ssm": None}
MLA = lambda c: {"kv": None, "ssm": None, "latent": c}
# (config, mesh (nodes, model ranks), cache_seq_shard, cache_layout,
# gathered blocks)
CASES = [("phi", (1, 2), True, PHI("heads"), []),
         ("phi", (1, 4), True, PHI("slots"), ["layers/attn"]),
         ("dsv2", (1, 4), True, MLA("slots"), []),
         ("dsv2", (1, 4), False, MLA("latent_dim"), []),
         ("dsv2", (2, 2), True, MLA("slots"), []),
         ("dsv2", (1, 3), True, MLA("slots"), ["layers/attn",
                                               "layers/mlp"]),
         ("dsv2_w8", (1, 4), True, MLA("slots"), []),
         ("dsv2_drop", (1, 4), True, MLA("slots"), []),
         # the batch rows over data: every MoE layer routes the whole
         # batch (one gather of the experts' counts over the data group)
         ("dsv2_drop", (2, 2), True, MLA("slots"), []),
         ("dsv2_drop", (2, 1), True, None, []),
         ("phi_drop", (2, 2), True, PHI("heads"), []),
         ("dsv2_drop_b16", (2, 2), True, MLA("slots"), [])]
# the production dtype: deepseek-v2's weights and cache in bf16 on (1, 4),
# c by slots and by latent dim, held to JAX's bf16 run within BF16_TOL of
# the largest |logit| / cache entry (8 ulps of bf16's 2^-8)
BF16_CASES = [("dsv2", (1, 4), True, MLA("slots"), []),
              ("dsv2", (1, 4), False, MLA("latent_dim"), [])]
BF16_TOL = 3e-2
# decode_step_slots against the port's unsharded one: (config, layout)
SLOTS = [("phi", PHI("slots")), ("dsv2", MLA("slots"))]
# build_prefill / build_decode materialized: (config, mesh)
LIVE = [("dsv2", (2, 2)), ("phi", (1, 4))]


def _cfg(key, get=get_config):
    name, kw = CFGS[key]
    return dc.replace(get(name).reduced(max_d_model=64, vocab=256), **kw)


def _batch(key) -> int:
    return BATCH.get(key, B)


def _steps(key) -> int:
    return STEPS_OF.get(key, STEPS)


def _seq_parallel(key) -> bool:
    """The prefill's sequence parallelism: the reference's opt-out."""
    return CFGS[key][0] not in specs.SEQ_PARALLEL_OPT_OUT


def _tokens(key):
    """(batch, S + steps) int32: the prompt, then the decode steps'
    tokens."""
    rng = np.random.default_rng(200 + list(CFGS).index(key))
    return rng.integers(0, _cfg(key).vocab,
                        (_batch(key), S + _steps(key))).astype(np.int32)


def _whole_logits(lg, tp):
    if tp is None or not tp.vocab_parallel:
        return lg
    return all_gather_seq(lg, tp.group, -1)


def _routes(fn):
    """``(fn(), routes)``: every ``moe._slots`` call's (experts, kept) as
    numpy arrays, in order (kept: the whole batch's decision, under a
    batch group too)."""
    seen, slots = [], moe_mod._slots

    def rec(cfg, expert_idx, C, *offset):
        pos, keep = slots(cfg, expert_idx, C, *offset)
        seen.append((expert_idx.numpy().copy(), keep.numpy().copy()))
        return pos, keep
    moe_mod._slots = rec
    try:
        return fn(), seen
    finally:
        moe_mod._slots = slots


def _shapes(tree):
    return {"/".join(p): tuple(t.shape) for p, t in msh._paths(tree)}


def _run(cfg, tp, params, toks, dtype=torch.float32, group=None):
    """prefill_cache + the decode steps of ``toks`` under ``tp`` and the
    batch ``group``, the cache in ``dtype``: the logits of each (whole
    vocab, as fp32), this rank's own, and the final cache."""
    got, own = [], []
    with msh.use_tensor_parallel(tp), msh.use_batch_group(group):
        cache, lg = prefill_cache(cfg, params, toks[:, :S], MAX_LEN, dtype)
        for i in range(toks.shape[1] - S + 1):
            if i:
                lg, cache = decode_step(cfg, params, cache,
                                        toks[:, S + i - 1:S + i])
            own.append(lg.float().numpy().copy())
            got.append(_whole_logits(lg, tp).float().numpy().copy())
    return got, own, cache


def _layout(key, mesh, full, seq_shard=True, dtype=torch.float32):
    return specs.serving_layout(_cfg(key), full, mesh, max_len=MAX_LEN,
                                cache_seq_shard=seq_shard,
                                seq_parallel=_seq_parallel(key), dtype=dtype)


def _rank_rows(routes, rows: slice, batch: int, K: int):
    """The whole batch's routes (experts (1, batch·s, K), kept (1,
    batch·s·K)) cut to the tokens of its rows ``rows``."""
    out = []
    for experts, kept in routes:
        s = experts.shape[1] // batch
        out.append((experts[:, rows.start * s:rows.stop * s],
                    kept[:, rows.start * s * K:rows.stop * s * K]))
    return out


def _case_rank(key, mesh, tree, seq_shard, dtype=torch.float32,
               group=True):
    """One case on this rank of ``mesh``, the weights and cache in
    ``dtype``, the batch rows over ``data`` inside its batch group (none
    with ``group`` False: each rank routes its rows alone); in fp32 also
    the unsharded model's routes on the whole batch, cut to this rank's
    rows, and the whole batch's drops at the prefill and the steps."""
    if mesh.coords is None:
        return None
    cfg = _cfg(key)
    full = cast_params(params_from_jax(tree, device="cpu")[0], dtype)
    tp = _layout(key, mesh, full, seq_shard, dtype)
    D, node, Bk = mesh.shape["data"], mesh.coords["data"], _batch(key)
    rows = slice(node * Bk // D, (node + 1) * Bk // D)
    every = torch.from_numpy(_tokens(key))
    bgroup = mesh.group("data") if D > 1 and group else None
    (got, own, cache), routes = _routes(lambda: _run(
        cfg, tp, full if tp is None else msh.local_tree(full, tp),
        every[rows], dtype, bgroup))
    out = {"node": node, "model": 0 if tp is None else tp.index,
           "logits": np.stack(got)}
    if not group:
        return out
    whole_routes = drops = None
    if dtype == torch.float32:
        whole_routes = _routes(lambda: _run(cfg, None, full, every))[1]
        L = cfg.n_layers
        drops = {"prefill": sum(int((~k).sum())
                                for _, k in whole_routes[:L]),
                 "decode": sum(int((~k).sum())
                               for _, k in whole_routes[L:])}
        whole_routes = _rank_rows(whole_routes, rows, Bk, cfg.moe_top_k)
    whole = cache if tp is None else msh.gather_cache(cache, tp)
    return dict(out, layout=None if tp is None else tp.cache_layout,
                gathered=[] if tp is None else sorted(
                    "/".join(b) for b in tp.gathered),
                vocab_parallel=None if tp is None else tp.vocab_parallel,
                seq_parallel=None if tp is None else tp.seq_parallel,
                shapes=_shapes(cache["layers"]),
                routes=routes, whole_routes=whole_routes,
                whole_drops=drops, idx=int(whole["idx"]),
                slot_pos=whole["slot_pos"].numpy(),
                cache={"/".join(p): t.float().numpy() for p, t in
                       msh._paths(whole["layers"])})


def _slots_rank(key, tree):
    """``decode_step_slots`` on (1, 4): rows at positions 5 and 0 of an
    empty cache, 12 steps (from slot 11 of rank 0 into rank 1's slots),
    the logits, the gathered cache and the routes against the unsharded
    step's."""
    mesh = make_sweep_mesh(lanes=1, param_shards=4)
    cfg = _cfg(key)
    full, _ = params_from_jax(tree, device="cpu")
    tp = _layout(key, mesh, full)
    local = msh.local_tree(full, tp)
    whole = init_cache(cfg, full, B, MAX_LEN)
    with msh.use_tensor_parallel(tp):
        cache = init_cache(cfg, local, B, MAX_LEN)
    for c in (whole, cache):
        c["slot_pos"] = c["slot_pos"].expand(B, -1).clone()
        c["idx"] = torch.tensor([5, 0], dtype=torch.int32)
    toks = torch.from_numpy(_tokens(key))
    err, same_routes = 0.0, True
    for i in range(12):
        (want, whole), r_want = _routes(lambda: decode_step_slots(
            cfg, full, whole, toks[:, i:i + 1]))
        with msh.use_tensor_parallel(tp):
            (lg, cache), r_got = _routes(lambda: decode_step_slots(
                cfg, local, cache, toks[:, i:i + 1]))
            lg = _whole_logits(lg, tp)
        err = max(err, float((lg - want).abs().max() / want.abs().max()))
        same_routes &= len(r_got) == len(r_want) == cfg.n_layers and all(
            np.array_equal(a, b) for g, w in zip(r_got, r_want)
            for a, b in zip(g, w))
    gathered = msh.gather_cache(cache, tp)
    return {"err": err, "layout": tp.cache_layout, "routes": same_routes,
            "row_routes": [e.shape for e, _ in r_got],
            "idx": gathered["idx"].tolist(),
            "slot_pos": bool(torch.equal(gathered["slot_pos"],
                                         whole["slot_pos"])),
            "cache_err": max(float((gathered["layers"]["attn"][k]
                                    - whole["layers"]["attn"][k]).abs().max())
                             for k in whole["layers"]["attn"])}


def _live_rank(key, D, M):
    """``build_prefill`` / ``build_decode`` materialized on a (D, M) mesh
    from seed 0: the prefill's logits (whole vocab) and tokens, and each
    build function's argument bytes a rank beside its meta case's."""
    mesh = make_sweep_mesh(lanes=D, param_shards=M)
    if mesh.coords is None:
        return None
    cfg = _cfg(key)
    kw = dict(seq=S, global_batch=B, dtype=torch.float32)
    desc = describe_mesh((D, M), ("data", "model"), rank=mesh.rank)
    out = {"node": mesh.coords["data"]}
    for name, build in (("prefill", specs.build_prefill),
                        ("decode", specs.build_decode)):
        fn, args = build(cfg, mesh, device="cpu", **kw)
        _, meta = build(cfg, desc, **kw)
        out[name] = {"info": fn.info,
                     "live_bytes": _distinct_bytes(specs.tensors_of(args)),
                     "meta_bytes": _distinct_bytes(specs.tensors_of(meta))}
        if name == "prefill":
            out["tokens"] = args[1].numpy()
            out["logits"] = _whole_logits(fn(*args),
                                          fn.tensor_parallel).numpy()
        else:
            logits, _ = fn(*args)
            out["decode_shape"] = tuple(logits.shape)
    return out


def _faults_rank(tree):
    """The four faults on (1, 4), dsv2 with ``c`` by slots: the repaired
    code and each old one, as the largest error of the logits and the
    gathered cache against the unsharded run (relative to its largest
    entry), or ``"BlockShape"`` where the prefill's cache leaves are not
    ``init_cache``'s blocks (the decode is then not run: a rank's merge
    would raise while the others wait in its collectives)."""
    mesh = make_sweep_mesh(lanes=1, param_shards=4)
    cfg = _cfg("dsv2")
    full, _ = params_from_jax(tree, device="cpu")
    toks = torch.from_numpy(_tokens("dsv2"))
    want, _, want_cache = _run(cfg, None, full, toks)
    tp = _layout("dsv2", mesh, full)
    local = msh.local_tree(full, tp)
    with msh.use_tensor_parallel(tp):
        blocks = _shapes(init_cache(cfg, local, B, MAX_LEN)["layers"])

    def err():
        with msh.use_tensor_parallel(tp):
            cache, _ = prefill_cache(cfg, local, toks[:, :S], MAX_LEN)
        if _shapes(cache["layers"]) != blocks:
            return "BlockShape"
        got, _, cache = _run(cfg, tp, local, toks)
        whole = msh.gather_cache(cache, tp)["layers"]["attn"]
        return max([_rel(g, w) for g, w in zip(got, want)]
                   + [_rel(whole[k].numpy(), want_cache["layers"]["attn"][k]
                           .numpy()) for k in ("c", "kr")])

    def patched(obj, name, value):
        old = getattr(obj, name)
        setattr(obj, name, value)
        try:
            return err()
        finally:
            setattr(obj, name, old)
    ring_write, ring_block = msh.ring_write, msh.ring_block

    def old_write(ring, new, slot, leaf="k"):   # MUTATION: pos % (C / M)
        if leaf != "c":
            return ring_write(ring, new, slot, leaf)
        ring[torch.arange(ring.shape[0]), slot % ring.shape[1]] = new

    def old_attend(qn, qr, c, kr, p, valid, scale, attend):
        n = c.shape[1]               # MUTATION: the block as the ring
        mine = slice(tp.index * n, (tp.index + 1) * n)
        return attend(qn, qr, c, kr[:, mine], valid[:, None, None, mine])
    leaf_layouts = {k: v for k, v in msh.LEAF_LAYOUTS.items() if k != "c"}
    with msh.use_tensor_parallel(tp):
        layout4 = dict(msh.LEAF_LAYOUTS)
        msh.LEAF_LAYOUTS = leaf_layouts      # MUTATION: c by KV_LAYOUTS
        try:
            old_name = tp.cache_layout["latent"]
        finally:
            msh.LEAF_LAYOUTS = layout4
    return {"layout": tp.cache_layout, "right": err(),
            "write": patched(msh, "ring_write", old_write),
            "attend": patched(msh, "latent_attend", old_attend),
            "block": patched(msh, "ring_block",
                             lambda kv, leaf="k": ring_block(kv)),
            "kv_layouts": patched(msh, "LEAF_LAYOUTS", leaf_layouts),
            "kv_layouts_name": old_name}


def _serve_rank(trees):
    meshes = {(D, M): make_sweep_mesh(lanes=D, param_shards=M,
                                      ranks=range(D * M))
              for _, (D, M), *_ in CASES}
    cases = [_case_rank(key, meshes[m], trees[key], seq_shard)
             for key, m, seq_shard, *_ in CASES]
    bf16 = [_case_rank(key, meshes[m], trees[key], seq_shard,
                       torch.bfloat16)
            for key, m, seq_shard, *_ in BF16_CASES]
    return {"cases": cases, "bf16": bf16,
            "slots": [_slots_rank(key, trees[key]) for key, _ in SLOTS],
            "live": [_live_rank(key, D, M) for key, (D, M) in LIVE],
            "faults": _faults_rank(trees["dsv2"]),
            # MUTATION: each data rank routes its own rows alone
            "per_rank": _case_rank("dsv2_drop", meshes[(2, 2)],
                                   trees["dsv2_drop"], True, group=False)}


def _tree(key):
    """Weights in the layout of JAX's ``init_params`` (its shapes, from
    ``jax.eval_shape``), drawn with numpy: matrices N(0, 1)·d_in^-½ (the
    router's too, so that the routes spread), the embedding N(0, 1)·0.02,
    norm scales 1 + N(0, 0.1), the rest N(0, 0.1)."""
    import jax

    from repro.configs import get_config as jget
    from repro.models.transformer import init_params as jinit
    shapes = jax.eval_shape(lambda k: jinit(_cfg(key, jget), k),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(300 + list(CFGS).index(key))

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        z = rng.normal(0, 1, leaf.shape).astype(np.float32)
        if name == "embed":
            return 0.02 * z
        if name.endswith("scale"):
            return 1 + 0.1 * z
        if len(leaf.shape) >= 2:
            return z / np.sqrt(leaf.shape[-2])
        return 0.1 * z
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _np_tree(t):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in t.items()}


def _name(path):
    return "/".join(str(getattr(p, "key", p)) for p in path)


def _jax_side(key, tree, dtype="float32"):
    """JAX's unsharded prefill_cache + the decode steps of one config on
    its whole batch, the weights and cache in ``dtype`` (the router in
    fp32, as JAX's ``init_params`` keeps it): the logits of each (as
    fp32) and the final cache."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models import transformer as jt
    jcfg = _cfg(key, jget)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(a, "float32" if _name(path[-1:])
                                    in FP32_LEAVES else dtype), tree)
    toks = jnp.asarray(_tokens(key))
    cache, lg = jt.prefill_cache(jcfg, params, toks[:, :S], MAX_LEN,
                                 dtype=jnp.dtype(dtype))
    step = jax.jit(lambda c, t: jt.decode_step(jcfg, params, c, t))
    f32 = lambda a: np.asarray(a, np.float32)
    logits = [f32(lg)]
    for i in range(_steps(key)):
        lg, cache = step(cache, toks[:, S + i:S + i + 1])
        logits.append(f32(lg))
    return {"logits": np.stack(logits), "idx": int(cache["idx"]),
            "slot_pos": np.asarray(cache["slot_pos"]),
            "cache": {_name(path): f32(leaf) for path, leaf in
                      jax.tree_util.tree_flatten_with_path(
                          cache["layers"])[0]}}


def _jax_live(key):
    """JAX's ``forward(..., last_only=True)`` on the weights
    ``build_prefill(device="cpu")`` draws from seed 0 and its tokens."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models import transformer as jt
    cfg = _cfg(key)
    tree = _np_tree(specs._params(cfg, torch.float32, "cpu", 0))
    gen = torch.Generator(device="cpu").manual_seed(1)
    b = B // dict(LIVE)[key][0]
    toks = specs._tokens((b, S), cfg.vocab, "cpu", gen).numpy()
    return jt.forward(_cfg(key, jget), jax.tree.map(jnp.asarray, tree),
                      jnp.asarray(toks), last_only=True)[0], toks


@pytest.fixture(scope="module")
def spawned():
    """The ranks' results and JAX's, computed side by side."""
    from concurrent.futures import ThreadPoolExecutor
    trees = {key: _tree(key) for key in CFGS}
    with ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(spawn_local, _serve_rank, 4, trees,
                            timeout_s=60.0, join_s=240.0)
        want = {key: _jax_side(key, trees[key]) for key in CFGS}
        want_bf16 = {key: _jax_side(key, trees[key], "bfloat16")
                     for key in {c[0] for c in BF16_CASES}}
        live = {key: _jax_live(key) for key, _ in LIVE}
        outs = ranks.result()
    return outs, want, live, want_bf16


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _same_routes(got, want) -> bool:
    return len(got) == len(want) and all(
        np.array_equal(a, b) for g, w in zip(got, want)
        for a, b in zip(g, w))


def _rows_of(key, node, D) -> slice:
    return slice(node * _batch(key) // D, (node + 1) * _batch(key) // D)


def _logits_held(r, ref, key, D, tol):
    assert r["logits"].shape[0] == _steps(key) + 1
    for step, (got, w) in enumerate(zip(
            r["logits"], ref["logits"][:, _rows_of(key, r["node"], D)])):
        assert _rel(got, w) <= tol, (step, _rel(got, w))


def _held(ranks, ref, key, D, M, layout, gathered, tol):
    """Every rank's logits of every step, gathered cache, ``idx`` and
    ``slot_pos`` against JAX's unsharded run ``ref`` of the whole batch
    within ``tol``, and its layout (None at M = 1: no tensor
    parallelism)."""
    assert len(ranks) == D * M
    for r in ranks:
        rows = _rows_of(key, r["node"], D)
        assert r["layout"] == layout
        assert r["gathered"] == gathered
        if M > 1:
            assert r["vocab_parallel"] == (_cfg(key).vocab % M == 0)
            assert r["seq_parallel"] == _seq_parallel(key)
        _logits_held(r, ref, key, D, tol)
        assert r["idx"] == ref["idx"] == S + _steps(key)
        assert np.array_equal(r["slot_pos"], ref["slot_pos"])
        assert set(r["cache"]) == set(ref["cache"])
        for name, w in ref["cache"].items():
            assert _rel(r["cache"][name], w[:, rows]) <= tol, name


IDS = [f"{k}-{d}x{m}-" + ("replicated" if lay is None
                          else lay.get("latent") or lay["kv"])
       for k, (d, m), _, lay, _ in CASES]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_prefill_and_decode_match_jax_unsharded(spawned, i):
    outs, want, _, _ = spawned
    key, (D, M), _, layout, gathered = CASES[i]
    ranks = [o["cases"][i] for o in outs if o["cases"][i] is not None]
    _held(ranks, want[key], key, D, M, layout, gathered, TOL)
    cfg = _cfg(key)
    for r in ranks:
        # the prefill and every step, each MoE layer's routes: the same
        # top-k and drops as the unsharded model's on the whole batch, on
        # this rank's rows
        assert len(r["routes"]) == (_steps(key) + 1) * cfg.n_layers
        assert _same_routes(r["routes"], r["whole_routes"])
        prefill_kept = [keep for _, keep in r["routes"][:cfg.n_layers]]
        assert all(k.shape == (1, S * _batch(key) // D * cfg.moe_top_k)
                   for k in prefill_kept)
        if key in DROPS:
            assert r["whole_drops"][DROPS[key]] > 0, r["whole_drops"]


@pytest.mark.parametrize("i", range(len(BF16_CASES)), ids=[
    f"{k}-{d}x{m}-{lay['latent']}" for k, (d, m), _, lay, _ in BF16_CASES])
def test_bf16_prefill_and_decode_match_jax_bf16(spawned, i):
    outs, _, _, want = spawned
    key, (D, M), _, layout, gathered = BF16_CASES[i]
    ranks = [o["bf16"][i] for o in outs if o["bf16"][i] is not None]
    _held(ranks, want[key], key, D, M, layout, gathered, BF16_TOL)


def test_local_cache_leaves_have_the_reference_shard_shapes(spawned):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh, NamedSharding

    from repro.configs import get_config as jget
    from repro.launch import shardings as jsh
    from repro.models import transformer as jt
    outs, _, _, _ = spawned
    for i, (key, (D, M), seq_shard, _, _) in enumerate(CASES):
        jcfg = _cfg(key, jget)
        cache = jax.eval_shape(lambda: jt.init_cache(
            jcfg, None, _batch(key), MAX_LEN, jnp.float32))
        mesh = AbstractMesh((D, M), ("data", "model"))
        specs_ = jsh.cache_pspecs(cache["layers"], mesh, ("data",),
                                  seq_shard=seq_shard)
        want = {_name(path): NamedSharding(mesh, spec).shard_shape(
            leaf.shape) for (path, leaf), spec in zip(
                jax.tree_util.tree_flatten_with_path(cache["layers"])[0],
                jax.tree.leaves(specs_, is_leaf=lambda s: isinstance(
                    s, jax.sharding.PartitionSpec)))}
        for o in outs:
            if o["cases"][i] is not None:
                assert o["cases"][i]["shapes"] == want, (key, D, M)


@pytest.mark.parametrize("j", range(len(SLOTS)), ids=[k for k, _ in SLOTS])
def test_decode_step_slots_matches_the_unsharded_step(spawned, j):
    outs, _, _, _ = spawned
    key, layout = SLOTS[j]
    for o in outs:
        s = o["slots"][j]
        assert s["layout"] == layout
        assert s["err"] <= TOL and s["cache_err"] <= TOL, s
        assert s["slot_pos"] and s["idx"] == [17, 12]
        # each row routed alone, as the unsharded step routes it
        assert s["routes"] and s["row_routes"] == [
            (B, 1, _cfg(key).moe_top_k)] * _cfg(key).n_layers


def test_build_prefill_and_decode_live(spawned):
    outs, _, live, _ = spawned
    for j, (key, (D, M)) in enumerate(LIVE):
        ranks = [o["live"][j] for o in outs if o["live"][j] is not None]
        assert len(ranks) == D * M
        want, toks = live[key]
        for r in ranks:
            for name in ("prefill", "decode"):
                info = r[name]["info"]
                assert info["model_axis"] == "tensor"
                assert info["tensor_parallel"]["ranks"] == M
                assert info["batch_ranks"] == (D if D > 1 else None)
                assert r[name]["live_bytes"] == r[name]["meta_bytes"] > 0
            assert np.array_equal(r["tokens"], toks)
            assert _rel(r["logits"], np.asarray(want)) <= TOL
            assert r["decode_shape"] == (B // D, 1, _cfg(key).vocab // M)


def test_four_faults_repaired_and_the_old_code_misses(spawned):
    outs, _, _, _ = spawned
    faults = [o["faults"] for o in outs]
    assert len(faults) == 4
    for f in faults:
        assert f["layout"] == MLA("slots")
        assert isinstance(f["right"], float) and f["right"] <= TOL, f
        # 3 and 4 (c by slots read as "heads"): the whole c kept on
        # every rank, not its block of C / M slots
        assert f["block"] == f["kv_layouts"] == "BlockShape", f
        assert f["kv_layouts_name"] == "heads"
    # 1: position 12 is written into slot 0 of every rank's block, the
    # valid slot 0 of the ring on rank 0
    assert all(isinstance(f["write"], float) and f["write"] > TOL
               for f in faults), faults
    # 2: each rank's heads softmax over its own 12 slots only
    assert all(isinstance(f["attend"], float) and f["attend"] > TOL
               for f in faults), faults


def test_per_rank_routing_misses_the_whole_batch(spawned):
    """The fault of the batch rows over ``data``: each data rank routing
    its rows alone (the capacity and slots of its rows, no batch group),
    ``dsv2_drop`` on (2, 2).  Node 1's logits miss ``TOL`` of JAX's run
    of the whole batch, where the whole batch's routing holds."""
    outs, want, _, _ = spawned
    key, D = "dsv2_drop", 2
    i = CASES.index((key, (D, 2), True, MLA("slots"), []))
    right = [o["cases"][i] for o in outs if o["cases"][i] is not None]
    old = [o["per_rank"] for o in outs if o["per_rank"] is not None]
    assert len(right) == len(old) == 4
    ref = want[key]["logits"]

    def err(r):
        return max(_rel(g, w) for g, w in zip(
            r["logits"], ref[:, _rows_of(key, r["node"], D)]))
    assert all(err(r) <= TOL for r in right)
    missed = [err(r) for r in old if r["node"] == 1]
    assert len(missed) == 2 and min(missed) > TOL, missed


# (arch, shape, mesh, cache_seq_shard, cache_layout, the local cache
# leaves' shapes, collectives a decode step by name over the model group
# and over the data group: the module docstring's counts; a MoE layer's
# gather of the experts' counts where the batch rows are split, none at
# long_500k's batch of 1)
META = [("phi3.5-moe-42b-a6.6b", "decode_32k", (32, 8), True,
         PHI("heads"), {"all_reduce_sum": 65}, {"all_gather_flat": 32}),
        ("phi3.5-moe-42b-a6.6b", "decode_32k", (64, 4), True,
         PHI("heads"), {"all_reduce_sum": 65}, {"all_gather_flat": 32}),
        ("phi3.5-moe-42b-a6.6b", "long_500k", (32, 8), True,
         PHI("heads"), {"all_reduce_sum": 65}, {}),
        ("phi3.5-moe-42b-a6.6b", "prefill_32k", (32, 8), True,
         PHI("heads"), None, None),
        ("deepseek-v2-236b", "decode_32k", (32, 8), True, MLA("slots"),
         {"all_gather_seq": 60, "all_reduce_max": 60,
          "all_reduce_sum": 181}, {"all_gather_flat": 60}),
        ("deepseek-v2-236b", "decode_32k", (32, 8), False,
         MLA("latent_dim"), {"all_gather_seq": 120, "all_reduce_sum": 181},
         {"all_gather_flat": 60}),
        ("deepseek-v2-236b", "decode_32k", (64, 4), True, MLA("slots"),
         {"all_gather_seq": 60, "all_reduce_max": 60,
          "all_reduce_sum": 181}, {"all_gather_flat": 60}),
        ("deepseek-v2-236b", "long_500k", (32, 8), True, MLA("slots"),
         {"all_gather_seq": 60, "all_reduce_max": 60,
          "all_reduce_sum": 181}, {}),
        ("deepseek-v2-236b", "prefill_32k", (32, 8), True, MLA("slots"),
         None, None)]


def _jax_shard_shapes(arch, shape, mesh, seq_shard):
    """JAX's ``NamedSharding.shard_shape`` of every parameter leaf
    (``tree_shardings``) and, for a decode shape, every cache leaf
    (``cache_pspecs``), at full size on an AbstractMesh."""
    import jax
    from jax.sharding import AbstractMesh, NamedSharding

    from repro.configs import get_config as jget
    from repro.launch import shardings as jsh
    from repro.launch import specs as jspecs
    from repro.models import transformer as jt
    cfg = jget(arch)
    info = jspecs.SHAPES[shape]
    if info.get("long"):
        cfg = jspecs._long_variant(cfg)
    amesh = AbstractMesh(mesh, ("data", "model"))
    params = jax.eval_shape(lambda k: jt.init_params(
        cfg, k, jax.numpy.bfloat16), jax.random.PRNGKey(0))
    out = {"params": {_name(p): ns.shard_shape(leaf.shape) for (p, leaf), (
        _, ns) in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                      jax.tree_util.tree_flatten_with_path(jsh.tree_shardings(
                          params, amesh, jsh.RULES_BASE))[0])}}
    if info["kind"] == "decode":
        cache = jax.eval_shape(lambda p: jt.init_cache(
            cfg, p, info["batch"], info["seq"], jax.numpy.bfloat16), params)
        sp = jsh.cache_pspecs(cache, amesh, ("data",), seq_shard=seq_shard)
        out["cache"] = {_name(p): NamedSharding(amesh, s).shard_shape(
            leaf.shape) for (p, leaf), s in zip(
                jax.tree_util.tree_flatten_with_path(cache)[0],
                jax.tree.leaves(sp, is_leaf=lambda s: isinstance(
                    s, jax.sharding.PartitionSpec)))}
    return out


@pytest.mark.parametrize("arch,shape,mesh,seq_shard,layout,coll,data_coll",
                         META, ids=[
                             f"{a}-{s}-{m[0]}x{m[1]}-{lay.get('latent') or lay['kv']}"
                             for a, s, m, _, lay, _, _ in META])
def test_production_mesh_meta_layouts_and_collectives(arch, shape, mesh,
                                                      seq_shard, layout,
                                                      coll, data_coll):
    from repro_torch.core import runtime_sharded as rs
    kw = {} if coll is None else {"cache_seq_shard": seq_shard}
    fn, args = specs.build_case(get_config(arch),
                                describe_mesh(mesh, ("data", "model")),
                                shape, **kw)
    info = fn.info
    assert info["model_axis"] == "tensor"
    assert info["cache_layout"] == layout
    assert info["tensor_parallel"] == {"ranks": mesh[1], "gathered": [],
                                       "vocab_parallel": True}
    want = _jax_shard_shapes(arch, shape, mesh, seq_shard)
    assert _shapes(args[0]) == want["params"]
    if coll is None:
        assert info["seq_parallel"] == _seq_parallel(
            "phi" if arch.startswith("phi") else "dsv2")
        return
    assert _shapes(args[1]) == want["cache"]
    assert info["batch_ranks"] == (mesh[0] if data_coll else None)
    with rs.record_collectives() as calls:
        fn(*args)
    counts: dict = {mesh[0]: {}, mesh[1]: {}}
    for c in calls:
        if c["group_size"] > 1:
            by = counts[c["group_size"]]
            by[c["name"]] = by.get(c["name"], 0) + 1
            # the model group within a host, the data group across hosts
            assert c["intra_host"] == (c["group_size"] == mesh[1])
    assert counts == {mesh[1]: coll, mesh[0]: data_coll}


def test_deepseek_v2_decode_32k_rank_holds_its_blocks():
    """At (32, 8) a rank holds 4096 of ``c``'s 32768 slots, the whole
    ``kr`` (0.94 GiB each) and its blocks of the weights (20 of 160
    experts, 16 of 128 heads): ≈ 58.8 GiB of arguments, where the whole
    bf16 tree and cache came to ≈ 466 GiB."""
    fn, args = specs.input_specs("deepseek-v2-236b", "decode_32k")
    params, cache, _ = args
    attn = cache["layers"]["attn"]
    assert tuple(attn["c"].shape) == (60, 4, 4096, 512)
    assert tuple(attn["kr"].shape) == (60, 4, 32768, 64)
    assert _distinct_bytes([attn["c"]]) == _distinct_bytes([attn["kr"]]) \
        == 60 * 4 * 32768 * 64 * 2
    total = _distinct_bytes(specs.tensors_of(args))
    assert 55 * 2 ** 30 < total < 62 * 2 ** 30
    assert tuple(params["layers"]["mlp"]["experts"]["wi"].shape) == (
        60, 20, 5120, 1536)


def test_phi_decode_32k_rank_holds_its_blocks():
    """At (32, 8) a rank holds one KV head of the ring (2 GiB of its 16)
    and its blocks of the weights (2 of 16 experts, 4 of 32 heads): ≈
    11.8 GiB of arguments, where the whole bf16 tree and ring came to
    ≈ 94 GiB."""
    fn, args = specs.input_specs("phi3.5-moe-42b-a6.6b", "decode_32k")
    params, cache, _ = args
    ring = specs.tensors_of(cache["layers"])
    assert _distinct_bytes(ring) == 2 * 32 * 4 * 32768 * 1 * 128 * 2
    total = _distinct_bytes(specs.tensors_of(args))
    assert 11 * 2 ** 30 < total < 12.5 * 2 ** 30
    assert tuple(params["layers"]["mlp"]["experts"]["wi"].shape) == (
        32, 2, 4096, 6400)


def test_a_sharded_kr_is_refused(monkeypatch):
    """``kr`` is scored by every head at every slot: a layout that cuts
    it over ``model`` is refused, as one the MLA block cannot run."""
    cfg = _cfg("dsv2")
    mesh = describe_mesh((1, 4), ("data", "model"))
    tp = specs.serving_layout(cfg, param_shapes(cfg), mesh, max_len=MAX_LEN,
                              dtype=torch.float32)
    assert tp.cache_layout == MLA("slots")
    pspecs = sh.cache_pspecs

    def kr_by_slots(cache, mesh, batch_axes, seq_shard=False):
        out = pspecs(cache, mesh, batch_axes, seq_shard=seq_shard)
        out["layers"]["attn"]["kr"] = out["layers"]["attn"]["c"]
        return out
    monkeypatch.setattr(sh, "cache_pspecs", kr_by_slots)
    with pytest.raises(ValueError, match=r"no \['kr'\] cache leaf"):
        msh.with_cache(dc.replace(tp, cache=None),
                       specs.whole_cache(cfg, 1, MAX_LEN, torch.float32))
