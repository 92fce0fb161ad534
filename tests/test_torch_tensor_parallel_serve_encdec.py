"""Prefill and decode of the enc-dec and frontend archs with the ``model``
axis tensor-parallel against JAX: whisper-large-v3's encoder and cross
caches, and pixtral-12b's patch prefix in the ring.

One spawn of 4 gloo ranks (``spawn_local``) runs every case; the JAX
side runs here, where JAX sees one device.  Weights have the layout of
JAX's ``init_params`` of the reduced configs of
``tests/test_torch_tensor_parallel_encdec.py`` (d 64, 2 + 2 layers, head
dim 16): whisper at vocab 258 over F = 6 frames with 4 heads, or 2
(``whisper_g``: at M = 4 its three attention blocks are gathered and its
cross caches go by head dim, as whisper-large-v3's do at M = 8), and
pixtral with 2 KV heads and 16 patch rows; drawn with numpy from a seed,
like the tokens and the frames or patches.  Each case is
``prefill_cache(..., frontend=)`` of a prompt of 8 tokens
(sequence-parallel: whisper's decoder stream of 8 rows, pixtral's of 16
+ 8) and 16 teacher-forced ``decode_step``s (B 2, ``max_len`` 48) on
this rank's blocks, the layout from ``launch.specs.serving_layout``:

* whisper on (1, 2): the self ring and the cross caches by KV heads, the
  encoder's stream sequence-parallel (6 frames, 3 a rank), the head
  vocab-parallel; on (1, 4): by heads, the encoder's stream and the head
  (258 rows) replicated; on (2, 2): the batch rows over ``data``;
* whisper_g on (1, 2): by heads; on (1, 4): the self ring by slots (12 a
  rank) and the cross caches by head dim (4 of 16 a rank), or with
  ``cache_seq_shard=False`` both by head dim; the encoder's stream and
  the head replicated;
* pixtral on (1, 2): the ring by KV heads; on (1, 4): by slots (the 16
  patch rows and 8 tokens fill ranks 0-1's slots), the attention
  gathered; vocab-parallel on both.

Every step's logits (gathered over the vocab) are held within 1e-5 of
the largest |logit| to JAX's unsharded ``prefill_cache(..., frontend=)``
+ ``decode_step``; the gathered cache (the ring, ``cross_k`` and
``cross_v``), ``idx`` and ``slot_pos`` to JAX's final cache; each local
cache leaf has the shape of ``NamedSharding(mesh, spec).shard_shape`` of
JAX's own ``cache_pspecs`` on JAX's whole cache; a replicated head's
logits are bitwise equal across the model group.  whisper's
``init_cache(..., frontend=)`` gives each rank the same cross blocks as
its prefill, held to JAX's ``init_cache``.  ``build_prefill(device=
"cpu")`` is held to JAX's ``forward(..., last_only=True)`` with the
frontend, and ``build_decode(device="cpu")``'s argument bytes a rank to
the meta case's.

The three faults of this path, on ranks 0-1 ((1, 2), the encoder's
stream sequence-parallel), each against the port's unsharded run of
``init_cache(..., frontend=)`` and 4 decode steps:

1. ``init_cache`` passing the encoder's output to the cross caches
   without ``models.sharding.enter_decoder``: a rank's 3 of the 6
   frames, which the decode steps attend to alone;
2. the cross attention of a decode step outside its ``parallel_block``
   frame on a column-parallel block: a rank's partial sum of ``wo``'s
   rows, never reduced;
3. the cross caches made from a gathered block's local leaves (whisper
   with 3 heads of 16 at M = 2: a rank's 24 columns of ``wk`` are a
   head and a half): the old code cannot shape them into heads and
   raises.

On meta, the production (32, 8) mesh: whisper-large-v3 and pixtral-12b
``decode_32k`` and ``prefill_32k`` say ``"model_axis": "tensor"`` and the
layout of ``cache_pspecs``, every cache leaf and parameter leaf of a rank
has JAX's ``shard_shape``, and one decode step issues exactly these
collectives over the model group (L layers):

* whisper-large-v3 at (32, 8) (32 layers, the self ring by slots, the
  cross caches by head dim, all three attention blocks gathered, the
  MLP column-parallel, the embedding and head replicated): the self
  attention's 7 leaves (wq, wk, wv, wo, bq, bk, bv) gathered, the cross
  attention's 3 (wq, bq, wo: its k and v are cached) and its ``p·v``
  slice, 11·32 = 352 gathers; the ring's merge (one max, one sum), the
  cross scores' sum and the MLP's sum, 32 maxes and 3·32 = 96 sums;
* whisper-large-v3 at (32, 4) (everything column-parallel, the head
  replicated): one sum a block (self, cross, MLP), 3·32 = 96 sums;
* pixtral-12b at (32, 8) (40 layers, one KV head a rank,
  vocab-parallel): the embedding's sum and one a block (attention, MLP),
  1 + 2·40 = 81 sums.

The ranks import this module by name, so JAX is imported inside the
tests only.
"""
import dataclasses as dc

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.runtime_sharded import all_gather_seq
from repro_torch.launch import specs
from repro_torch.launch.dryrun import _distinct_bytes
from repro_torch.launch.mesh import describe_mesh, make_sweep_mesh
from repro_torch.launch.multihost import spawn_local
from repro_torch.models import attention as attn
from repro_torch.models import sharding as msh
from repro_torch.models import transformer as tr
from repro_torch.models.layers import norm_apply
from repro_torch.models.transformer import (decode_step, init_cache,
                                            params_from_jax, prefill_cache)

TOL = 1e-5
B, S, STEPS, MAX_LEN = 2, 8, 16, 48
TRAP_STEPS = 4
CFGS = {"whisper": ("whisper-large-v3", dict(frontend_seq=6)),
        "whisper_g": ("whisper-large-v3", dict(frontend_seq=6, n_heads=2,
                                               n_kv_heads=2)),
        "pixtral": ("pixtral-12b", dict(n_kv_heads=2)),
        # the third fault's: 3 heads of 16 gathered at M = 2
        "whisper_3": ("whisper-large-v3", dict(frontend_seq=6, n_heads=3,
                                               n_kv_heads=3))}
VOCAB = {"whisper": 258, "whisper_g": 258, "pixtral": 256, "whisper_3": 258}
GATHERED3 = ["enc_layers/attn", "layers/attn", "layers/cross"]
# (config, mesh (nodes, model ranks), cache_seq_shard, cache_layout, the
# encoder's stream sequence-parallel, the blocks gathered)
CASES = [("whisper", (1, 2), True, {"kv": "heads", "cross": "heads"},
          True, []),
         ("whisper", (1, 4), True, {"kv": "heads", "cross": "heads"},
          False, []),
         ("whisper", (2, 2), True, {"kv": "heads", "cross": "heads"},
          True, []),
         ("whisper_g", (1, 2), True, {"kv": "heads", "cross": "heads"},
          True, []),
         ("whisper_g", (1, 4), True, {"kv": "slots", "cross": "head_dim"},
          False, GATHERED3),
         ("whisper_g", (1, 4), False, {"kv": "head_dim",
                                       "cross": "head_dim"},
          False, GATHERED3),
         ("pixtral", (1, 2), True, {"kv": "heads"}, None, []),
         ("pixtral", (1, 4), True, {"kv": "slots"}, None, ["layers/attn"])]
# build_prefill / build_decode materialized: (config, mesh)
LIVE = [("whisper", (2, 2)), ("pixtral", (1, 4))]


def _cfg(key, get=get_config):
    name, kw = CFGS[key]
    return dc.replace(get(name).reduced(max_d_model=64, vocab=VOCAB[key]),
                      **kw)


def _data(key):
    """Tokens (B, S + STEPS) int32 (the prompt, then the decode steps')
    and the frontend (B, F, frontend_dim) fp32."""
    cfg = _cfg(key)
    rng = np.random.default_rng(200 + list(CFGS).index(key))
    toks = rng.integers(0, cfg.vocab, (B, S + STEPS)).astype(np.int32)
    return toks, rng.standard_normal(
        (B, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32)


def _whole_logits(lg, tp):
    if tp is None or not tp.vocab_parallel:
        return lg
    return all_gather_seq(lg, tp.group, -1)


def _shapes(cache):
    return {"/".join(p): tuple(t.shape) for p, t in msh._paths(cache)}


def _run(cfg, tp, params, toks, fr):
    """prefill_cache of the prompt with the frontend + ``STEPS`` decode
    steps under ``tp``: the logits of each (whole vocab), this rank's
    own, and the final cache."""
    got, own = [], []
    with msh.use_tensor_parallel(tp):
        cache, lg = prefill_cache(cfg, params, toks[:, :S], MAX_LEN,
                                  frontend=fr)
        for i in range(STEPS + 1):
            if i:
                lg, cache = decode_step(cfg, params, cache,
                                        toks[:, S + i - 1:S + i])
            own.append(lg.numpy().copy())
            got.append(_whole_logits(lg, tp).numpy().copy())
    return got, own, cache


def _tokenwise(cfg, tp, params, toks, fr):
    """``init_cache(..., frontend=)`` + ``TRAP_STEPS`` decode steps under
    ``tp``: the logits of each (whole vocab)."""
    got = []
    with msh.use_tensor_parallel(tp):
        cache = init_cache(cfg, params, toks.shape[0], MAX_LEN,
                           frontend=fr)
        for i in range(TRAP_STEPS):
            lg, cache = decode_step(cfg, params, cache, toks[:, i:i + 1])
            got.append(_whole_logits(lg, tp).numpy().copy())
    return got


def _case_rank(key, mesh, tree, seq_shard):
    """One case on this rank of ``mesh``."""
    if mesh.coords is None:
        return None
    cfg = _cfg(key)
    full, _ = params_from_jax(tree, device="cpu")
    tp = specs.serving_layout(cfg, full, mesh, max_len=MAX_LEN,
                              cache_seq_shard=seq_shard, seq_parallel=True,
                              dtype=torch.float32)
    node = mesh.coords["data"]
    rows = slice(node * B // mesh.shape["data"],
                 (node + 1) * B // mesh.shape["data"])
    toks, fr = (torch.from_numpy(a)[rows] for a in _data(key))
    local = msh.local_tree(full, tp)
    got, own, cache = _run(cfg, tp, local, toks, fr)
    whole = msh.gather_cache(cache, tp)
    out = {"node": node, "model": tp.index, "logits": np.stack(got),
           "own": np.stack(own), "layout": tp.cache_layout,
           "gathered": sorted("/".join(b) for b in tp.gathered),
           "vocab_parallel": tp.vocab_parallel,
           "enc_seq_parallel": tp.enc_seq_parallel, "shapes": _shapes(cache),
           "idx": int(whole["idx"]), "slot_pos": whole["slot_pos"].numpy(),
           "cache": {"/".join(p): t.numpy() for p, t in msh._paths(whole)
                     if p[0] not in ("idx", "slot_pos")}}
    if cfg.enc_dec:
        with msh.use_tensor_parallel(tp):
            init = init_cache(cfg, local, toks.shape[0], MAX_LEN,
                              frontend=fr)
        out["init_shapes"] = _shapes(init)
        out["init_equal"] = all(torch.equal(init[k], cache[k])
                                for k in ("cross_k", "cross_v"))
        init = msh.gather_cache(init, tp)
        out["init_cross"] = {k: init[k].numpy()
                             for k in ("cross_k", "cross_v")}
    return out


def _live_rank(key, D, M):
    """``build_prefill`` / ``build_decode`` materialized on a (D, M) mesh
    from seed 0: the prefill's logits (whole vocab), tokens and frontend,
    and each build function's argument bytes a rank beside its meta
    case's."""
    mesh = make_sweep_mesh(lanes=D, param_shards=M)
    if mesh.coords is None:
        return None
    cfg = _cfg(key)
    prefix = 0 if cfg.enc_dec else cfg.frontend_seq
    kw = dict(seq=S + prefix, global_batch=B, dtype=torch.float32)
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
            out["tokens"], out["frontend"] = args[1].numpy(), args[2].numpy()
            out["logits"] = _whole_logits(fn(*args),
                                          fn.tensor_parallel).numpy()
        else:
            logits, cache = fn(*args)
            out["decode_shape"] = tuple(logits.shape)
            out["decode_cross"] = (tuple(cache["cross_k"].shape)
                                   if cfg.enc_dec else None)
    return out


def _old_cross(cfg, lp, x, k, v):
    """MUTATION: the cross attention on the local leaves, outside the
    block's frame (the code before the repair)."""
    hc = norm_apply(cfg, lp["ln_cross"], x)
    return x + attn.cross_apply(cfg, lp["cross"], hc, k, v)


def _mutated(module, name, value, fn):
    """``fn()`` with ``module.name`` patched to ``value``: its relative
    error, or the exception's name where it raises."""
    own = getattr(module, name)
    setattr(module, name, value)
    try:
        return fn()
    except (RuntimeError, ValueError) as e:
        return type(e).__name__
    finally:
        setattr(module, name, own)


def _traps_rank(trees):
    """Ranks 0-1, (1, 2), sequence-parallel: the three repaired faults
    beside the old code of each, as errors of 4 decode steps after
    ``init_cache(..., frontend=)`` against the unsharded run's (relative
    to its largest |logit|)."""
    mesh = make_sweep_mesh(lanes=1, param_shards=2, ranks=range(2))
    if mesh.coords is None:
        return None
    out = {}
    for key in ("whisper", "whisper_3"):
        cfg = _cfg(key)
        full, _ = params_from_jax(trees[key], device="cpu")
        toks, fr = (torch.from_numpy(a) for a in _data(key))
        want = _tokenwise(cfg, None, full, toks, fr)
        tp = specs.serving_layout(cfg, full, mesh, max_len=MAX_LEN,
                                  seq_parallel=True, dtype=torch.float32)
        local = msh.local_tree(full, tp)

        def err():
            got = _tokenwise(cfg, tp, local, toks, fr)
            return max(float(np.abs(g - w).max() / np.abs(w).max())
                       for g, w in zip(got, want))
        res = {"right": err(), "layout": tp.cache_layout,
               "gathered": sorted("/".join(b) for b in tp.gathered),
               "enc_seq_parallel": tp.enc_seq_parallel}
        if key == "whisper":
            # 1. the encoder's output as a rank's block of the frames
            res["no_enter"] = _mutated(msh, "enter_decoder",
                                       lambda enc: enc, err)
            # 2. the cross attention outside its frame
            res["no_frame"] = _mutated(tr, "_cross", _old_cross, err)
        else:
            # 3. the cross caches of a gathered block's local leaves
            res["local_leaves"] = _mutated(msh, "block_params",
                                           lambda key, p: p, err)
        out[key] = res
    return out


def _serve_rank(trees):
    cases = [_case_rank(key, make_sweep_mesh(lanes=D, param_shards=M),
                        trees[key], seq_shard)
             for key, (D, M), seq_shard, *_ in CASES]
    return {"cases": cases,
            "live": [_live_rank(key, D, M) for key, (D, M) in LIVE],
            "traps": _traps_rank(trees)}


def _tree(key):
    """Weights in the layout of JAX's ``init_params`` (its shapes, from
    ``jax.eval_shape``), drawn with numpy: matrices N(0, 1)·d_in^-½, the
    embedding N(0, 1)·0.02, norm scales 1 + N(0, 0.1), biases
    N(0, 0.1)."""
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
        if len(leaf.shape) >= 2 and not name.startswith("b"):
            return z / np.sqrt(leaf.shape[-2])
        return 0.1 * z
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _np_tree(t):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in t.items()}


def _name(path):
    return "/".join(str(getattr(p, "key", p)) for p in path)


def _jax_side(key, tree):
    """JAX's unsharded ``prefill_cache(..., frontend=)`` + 16 decode steps
    of one config: the logits of each, the final cache, and (enc-dec)
    ``init_cache(..., frontend=)``'s cross caches."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models import transformer as jt
    jcfg = _cfg(key, jget)
    params = jax.tree.map(jnp.asarray, tree)
    toks, fr = (jnp.asarray(a) for a in _data(key))
    cache, lg = jt.prefill_cache(jcfg, params, toks[:, :S], MAX_LEN,
                                 frontend=fr)
    step = jax.jit(lambda c, t: jt.decode_step(jcfg, params, c, t))
    logits = [np.asarray(lg)]
    for i in range(STEPS):
        lg, cache = step(cache, toks[:, S + i:S + i + 1])
        logits.append(np.asarray(lg))
    out = {"logits": np.stack(logits), "idx": int(cache["idx"]),
           "slot_pos": np.asarray(cache["slot_pos"]),
           "cache": {_name(path): np.asarray(leaf) for path, leaf in
                     jax.tree_util.tree_flatten_with_path(cache)[0]
                     if _name(path) not in ("idx", "slot_pos")}}
    if jcfg.enc_dec:
        init = jt.init_cache(jcfg, params, B, MAX_LEN, frontend=fr)
        out["init_cross"] = {k: np.asarray(init[k])
                             for k in ("cross_k", "cross_v")}
    return out


def _jax_live(key):
    """JAX's ``forward(..., last_only=True)`` on the weights
    ``build_prefill(device="cpu")`` draws from seed 0, its tokens and its
    frontend."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models import transformer as jt
    cfg = _cfg(key)
    tree = _np_tree(specs._params(cfg, torch.float32, "cpu", 0))
    gen = torch.Generator(device="cpu").manual_seed(1)
    b = B // dict(LIVE)[key][0]
    toks = specs._tokens((b, S), cfg.vocab, "cpu", gen).numpy()
    fr = specs._frontend(cfg, (b,), torch.float32, "cpu", gen).numpy()
    return jt.forward(_cfg(key, jget), jax.tree.map(jnp.asarray, tree),
                      jnp.asarray(toks), jnp.asarray(fr),
                      last_only=True)[0], toks, fr


@pytest.fixture(scope="module")
def spawned():
    """The ranks' results and JAX's, computed side by side."""
    from concurrent.futures import ThreadPoolExecutor
    trees = {key: _tree(key) for key in CFGS}
    with ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(spawn_local, _serve_rank, 4, trees,
                            timeout_s=60.0, join_s=240.0)
        want = {key: _jax_side(key, trees[key])
                for key in dict.fromkeys(c[0] for c in CASES)}
        live = {key: _jax_live(key) for key, _ in LIVE}
        outs = ranks.result()
    return outs, want, live


def _ranks(outs, i):
    return [o["cases"][i] for o in outs if o["cases"][i] is not None]


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


IDS = [f"{k}-{d}x{m}-{lay['kv']}-{lay.get('cross', 'nocross')}"
       for k, (d, m), _, lay, *_ in CASES]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_prefill_and_decode_match_jax_unsharded(spawned, i):
    outs, want, _ = spawned
    key, (D, M), _, layout, enc_sp, gathered = CASES[i]
    ref = want[key]
    ranks = _ranks(outs, i)
    assert len(ranks) == D * M
    cfg = _cfg(key)
    for r in ranks:
        rows = slice(r["node"] * B // D, (r["node"] + 1) * B // D)
        assert r["layout"] == dict(layout, ssm=None)
        assert r["gathered"] == gathered
        assert r["enc_seq_parallel"] == enc_sp
        assert r["vocab_parallel"] == (cfg.vocab % M == 0)
        assert r["logits"].shape[0] == STEPS + 1
        for step, (got, w) in enumerate(zip(r["logits"],
                                            ref["logits"][:, rows])):
            assert _rel(got, w) <= TOL, (step, _rel(got, w))
        assert r["idx"] == ref["idx"] == S + STEPS + (
            0 if cfg.enc_dec else cfg.frontend_seq)
        assert np.array_equal(r["slot_pos"], ref["slot_pos"])
        assert set(r["cache"]) == set(ref["cache"])
        for name, w in ref["cache"].items():
            assert _rel(r["cache"][name], w[:, rows]) <= TOL, name
        if cfg.enc_dec:
            # init_cache(frontend=) gives the prefill's cross blocks
            assert r["init_equal"] and r["init_shapes"]["cross_k"] == \
                r["shapes"]["cross_k"]
            for name, w in ref["init_cross"].items():
                assert _rel(r["init_cross"][name], w[:, rows]) <= TOL, name
    if not ranks[0]["vocab_parallel"]:     # a replicated head: bitwise
        for r in ranks[1:]:
            if r["node"] == ranks[0]["node"]:
                assert np.array_equal(r["own"], ranks[0]["own"])


def _jax_cache_shard_shapes(cfg_jax, mesh, batch, max_len, seq_shard,
                            dtype):
    """JAX's ``NamedSharding.shard_shape`` of every leaf of its whole
    cache (``init_cache`` with the frontend) under its ``cache_pspecs``
    with the batch over ``data``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro.launch import shardings as jsh
    from repro.models import transformer as jt
    params = jax.eval_shape(lambda k: jt.init_params(cfg_jax, k, dtype),
                            jax.random.PRNGKey(0))
    fr = jax.ShapeDtypeStruct((batch, cfg_jax.frontend_seq,
                               cfg_jax.frontend_dim or cfg_jax.d_model),
                              dtype)
    cache = jax.eval_shape(lambda p, f: jt.init_cache(
        cfg_jax, p, batch, max_len, dtype, frontend=f), params, fr)
    sp = jsh.cache_pspecs(cache, mesh, ("data",), seq_shard=seq_shard)
    return {_name(p): NamedSharding(mesh, s).shard_shape(leaf.shape)
            for (p, leaf), s in zip(
                jax.tree_util.tree_flatten_with_path(cache)[0],
                jax.tree.leaves(sp, is_leaf=lambda s: isinstance(
                    s, jax.sharding.PartitionSpec)))}, params


def test_local_cache_leaves_have_the_reference_shard_shapes(spawned):
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh

    from repro.configs import get_config as jget
    outs, _, _ = spawned
    for i, (key, (D, M), seq_shard, *_) in enumerate(CASES):
        want, _ = _jax_cache_shard_shapes(
            _cfg(key, jget), AbstractMesh((D, M), ("data", "model")), B,
            MAX_LEN, seq_shard, jnp.float32)
        for r in _ranks(outs, i):
            assert r["shapes"] == want, (key, D, M)


def test_build_prefill_and_decode_live(spawned):
    outs, _, live = spawned
    for j, (key, (D, M)) in enumerate(LIVE):
        ranks = [o["live"][j] for o in outs if o["live"][j] is not None]
        assert len(ranks) == D * M
        want, toks, fr = live[key]
        cfg = _cfg(key)
        for r in ranks:
            for name in ("prefill", "decode"):
                info = r[name]["info"]
                assert info["model_axis"] == "tensor"
                assert info["tensor_parallel"]["ranks"] == M
                assert r[name]["live_bytes"] == r[name]["meta_bytes"] > 0
                assert ("cross" in info["cache_layout"]) == cfg.enc_dec
            assert r["prefill"]["info"]["seq_parallel"]
            assert np.array_equal(r["tokens"], toks)
            assert np.array_equal(r["frontend"], fr)
            assert _rel(r["logits"], np.asarray(want)) <= TOL
            V = cfg.vocab
            assert r["decode_shape"] == (B // D, 1, V // M if V % M == 0
                                         else V)
            if cfg.enc_dec:     # by heads: the rank's KV / M heads
                assert r["decode_cross"] == (
                    cfg.n_layers, B // D, cfg.frontend_seq,
                    cfg.n_kv_heads // M, cfg.hd)


def test_three_faults_repaired_and_the_old_code_misses(spawned):
    """Fault 1 (no ``enter_decoder``) and fault 2 (the cross attention
    outside its frame) miss the tolerance on whisper's column-parallel
    blocks with the encoder's stream sequence-parallel; fault 3 (a
    gathered block's local leaves) raises on whisper_3."""
    outs, _, _ = spawned
    traps = [o["traps"] for o in outs if o["traps"] is not None]
    assert len(traps) == 2
    for t in traps:
        w, g = t["whisper"], t["whisper_3"]
        assert w["layout"] == {"kv": "heads", "ssm": None, "cross": "heads"}
        assert w["enc_seq_parallel"] and w["gathered"] == []
        assert g["layout"] == {"kv": "slots", "ssm": None,
                               "cross": "head_dim"}
        assert g["enc_seq_parallel"] and g["gathered"] == GATHERED3
        assert w["right"] <= TOL and g["right"] <= TOL, t
        for old in (w["no_enter"], w["no_frame"]):
            assert isinstance(old, float) and old > TOL, t
        assert g["local_leaves"] == "RuntimeError", t


# (arch, shape, mesh, cache_seq_shard, cache_layout, collectives a decode
# step by name: the module docstring's counts)
META = [("whisper-large-v3", "decode_32k", (32, 8), True,
         {"kv": "slots", "cross": "head_dim"},
         {"all_gather_seq": 352, "all_reduce_max": 32,
          "all_reduce_sum": 96}),
        ("whisper-large-v3", "decode_32k", (32, 4), True,
         {"kv": "heads", "cross": "heads"}, {"all_reduce_sum": 96}),
        ("pixtral-12b", "decode_32k", (32, 8), True, {"kv": "heads"},
         {"all_reduce_sum": 81}),
        ("whisper-large-v3", "prefill_32k", (32, 8), True,
         {"kv": "slots", "cross": "head_dim"}, None),
        ("whisper-large-v3", "prefill_32k", (32, 4), True,
         {"kv": "heads", "cross": "heads"}, None),
        ("pixtral-12b", "prefill_32k", (32, 8), True, {"kv": "heads"},
         None)]


@pytest.mark.parametrize("arch,shape,mesh,seq_shard,layout,coll", META,
                         ids=[f"{a}-{s}-{m[0]}x{m[1]}"
                              for a, s, m, *_ in META])
def test_production_mesh_meta_layouts_and_collectives(arch, shape, mesh,
                                                      seq_shard, layout,
                                                      coll):
    import jax
    from jax.sharding import AbstractMesh

    from repro.configs import get_config as jget
    from repro.launch import shardings as jsh
    from repro.launch import specs as jspecs
    from repro_torch.core import runtime_sharded as rs
    kw = {} if coll is None else {"cache_seq_shard": seq_shard}
    fn, args = specs.build_case(get_config(arch),
                                describe_mesh(mesh, ("data", "model")),
                                shape, **kw)
    info = fn.info
    assert info["model_axis"] == "tensor"
    assert info["cache_layout"] == dict(layout, ssm=None)
    assert info["tensor_parallel"]["ranks"] == mesh[1]
    amesh = AbstractMesh(mesh, ("data", "model"))
    want, params = _jax_cache_shard_shapes(
        jget(arch), amesh, jspecs.SHAPES[shape]["batch"],
        jspecs.SHAPES[shape]["seq"], seq_shard, jax.numpy.bfloat16)
    got = {_name(p): ns.shard_shape(leaf.shape) for (p, leaf), (_, ns) in zip(
        jax.tree_util.tree_flatten_with_path(params)[0],
        jax.tree_util.tree_flatten_with_path(jsh.tree_shardings(
            params, amesh, jsh.RULES_BASE))[0])}
    assert _shapes(args[0]) == got
    if coll is None:
        assert info["seq_parallel"]
        return
    assert _shapes(args[1]) == want
    with rs.record_collectives() as calls:
        fn(*args)
    counts: dict = {}
    for c in calls:
        if c["group_size"] > 1:
            assert c["group_size"] == mesh[1]
            counts[c["name"]] = counts.get(c["name"], 0) + 1
    assert counts == coll


def test_whisper_decode_32k_rank_holds_its_cross_blocks():
    """At (32, 8) a rank's cross caches are its head-dim slice (8 of 64)
    of every head: 2 × 32 × 4 × 1500 × 20 × 8 × 2 B = 0.12 GB; with its
    slots of the ring (2.5 GiB) and its blocks of the weights (0.6 GiB)
    its arguments come to ≈ 3.2 GiB, where the whole bf16 tree, ring and
    cross caches came to ≈ 24 GiB."""
    fn, args = specs.input_specs("whisper-large-v3", "decode_32k")
    params, cache, _ = args
    assert tuple(cache["cross_k"].shape) == (32, 4, 1500, 20, 8)
    cross = _distinct_bytes([cache["cross_k"], cache["cross_v"]])
    assert cross == 2 * 32 * 4 * 1500 * 20 * 8 * 2
    total = _distinct_bytes(specs.tensors_of(args))
    assert 2.5 * 2 ** 30 < total < 3.3 * 2 ** 30


def test_a_prefix_before_a_replicated_head_is_refused_in_serving():
    """pixtral's prefix under sequence parallelism: served with its
    vocab-parallel head, refused before a replicated one (vocab 257 at
    M = 2) unless the stream stays replicated."""
    from repro_torch.models.transformer import param_shapes
    mesh = describe_mesh((1, 2), ("data", "model"))
    cfg = _cfg("pixtral")
    tp = specs.serving_layout(cfg, param_shapes(cfg), mesh, max_len=MAX_LEN,
                              seq_parallel=True, dtype=torch.float32)
    assert tp.vocab_parallel and tp.seq_parallel
    assert tp.cache_layout == {"kv": "heads", "ssm": None}
    odd = dc.replace(cfg, vocab=257)
    with pytest.raises(ValueError, match="prefix before a replicated head"):
        specs.serving_layout(odd, param_shapes(odd), mesh, max_len=MAX_LEN,
                             seq_parallel=True, dtype=torch.float32)
    tp = specs.serving_layout(odd, param_shapes(odd), mesh, max_len=MAX_LEN,
                              seq_parallel=False, dtype=torch.float32)
    assert not tp.vocab_parallel and not tp.seq_parallel


def test_a_cross_layout_the_block_does_not_run_is_refused():
    """Cross caches by heads beside a gathered cross block (whisper_g's 2
    heads over 4 ranks with the heads' layout forced) raise, as do ones
    by head dim beside a column-parallel block (whisper at M = 2)."""
    from repro_torch.models.transformer import param_shapes
    cfg = _cfg("whisper_g")
    tp = specs.serving_layout(cfg, param_shapes(cfg),
                              describe_mesh((1, 4), ("data", "model")),
                              max_len=MAX_LEN, dtype=torch.float32)
    assert tp.cache_layout["cross"] == "head_dim"
    whole = specs.whole_cache(cfg, 1, MAX_LEN, torch.float32)
    forced = dict(whole, **{k: torch.empty(2, 1, 6, 4, 16, device="meta")
                            for k in ("cross_k", "cross_v")})
    with pytest.raises(ValueError, match="cross caches by heads beside a "
                                         "gathered"):
        msh.with_cache(dc.replace(tp, cache=None), forced)
    cfg = _cfg("whisper")
    tp = specs.serving_layout(cfg, param_shapes(cfg),
                              describe_mesh((1, 2), ("data", "model")),
                              max_len=MAX_LEN, dtype=torch.float32)
    assert tp.cache_layout["cross"] == "heads"
    whole = specs.whole_cache(cfg, 1, MAX_LEN, torch.float32)
    forced = dict(whole, **{k: torch.empty(2, 1, 6, 3, 16, device="meta")
                            for k in ("cross_k", "cross_v")})
    with pytest.raises(ValueError, match="cross caches by head_dim beside "
                                         "a column-parallel"):
        msh.with_cache(dc.replace(tp, cache=None), forced)


def _tensor_result():
    return torch.arange(6.0)


def test_a_rank_stays_until_its_tensor_result_is_read():
    """A rank's CPU tensor result goes to the parent by file descriptor,
    fetched from the rank's own process (the phase's ranks return
    captured scan arguments so): ``spawn_local``'s rank waits until the
    parent has read every result.  Read 2 s after the rank put it, the
    tensor still arrives; a rank that returned at once left a
    descriptor no one could fetch."""
    import multiprocessing as mp
    import time

    from repro_torch.launch import multihost
    ctx = mp.get_context("spawn")
    results, done = ctx.Queue(), ctx.Event()
    p = ctx.Process(target=multihost._rank_main, args=(
        _tensor_result, (), 0, 1, multihost._free_port(), "gloo", 30.0,
        results, done), daemon=True)
    p.start()
    try:
        deadline = time.monotonic() + 120
        while results.empty() and time.monotonic() < deadline:
            time.sleep(0.1)
        time.sleep(2.0)
        rank, ok, out = results.get(timeout=60)
        assert (rank, ok) == (0, True) and torch.equal(out, torch.arange(6.0))
    finally:
        done.set()
        p.join(60)
    assert p.exitcode == 0

