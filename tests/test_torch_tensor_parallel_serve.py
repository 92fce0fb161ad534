"""Prefill and decode with the ``model`` axis tensor-parallel against JAX.

One spawn of 4 gloo ranks (``spawn_local``) runs every case; the JAX
side runs here, where JAX sees one device.  Weights have the layout of
JAX's ``init_params`` of reduced configs (d 64, 2 layers): rfast-100m
(4 heads, 2 KV heads, head dim 24), qwen2.5-3b (4 / 2 / 16, tied, qkv
biases), falcon-mamba-7b (d_inner 128) and hymba-1.5b at vocab 257 (5
heads, 1 KV head of 8; the embedding and head replicated), drawn with
numpy from a seed, like the tokens.  Each case is ``prefill_cache`` of
a prompt of 8 tokens (sequence-parallel) and 16 teacher-forced
``decode_step``s (B 2, ``max_len`` 32) on this rank's blocks, the
layout from ``launch.specs.serving_layout``:

* rfast-100m and qwen2.5-3b on (1, 2): the ring by KV heads
  (``heads``); on (1, 4), where 2 KV heads do not divide, by ring slots
  (``slots``, 8 a rank: ranks 1-3 start with every slot empty) or, with
  ``cache_seq_shard=False``, by head dim (``head_dim``); rfast-100m on
  (2, 2), the batch rows over ``data``; rfast-100m with an
  ``attn_window`` of 8 on (1, 4): 2 slots a rank, the ring wrapping over
  the ranks within the decode steps;
* hymba-1.5b's single KV head by slots on (1, 2) and by head dim on (1,
  4), its SSM state by channels; falcon-mamba-7b's by channels on both.

Every step's logits (gathered over the vocab) are held within 1e-5 of
the largest |logit| to JAX's unsharded ``prefill_cache`` +
``decode_step``; the gathered cache, ``idx`` and ``slot_pos`` to JAX's
final cache; each local cache leaf has the shape of
``NamedSharding(mesh, spec).shard_shape`` of JAX's own ``cache_pspecs``;
a replicated head's logits are bitwise equal across the model group.
qwen2.5-3b by slots and by head dim on (1, 4) runs once more in the
production dtype, its weights and cache in bf16 (the merges cross the
ranks in fp32, gloo's bf16 all-reduce carries the row-parallel sums),
held to JAX's bf16 run within ``BF16_TOL``.
``build_prefill(device="cpu")`` (sequence-parallel) is held to JAX's
``forward(..., last_only=True)`` on the same weights and tokens, and
``build_decode(device="cpu")``'s argument bytes a rank to the meta
case's.  ``decode_step_slots`` (a position a row) on the wrapping ring
is held to the port's unsharded one.

The two traps of this path, on ranks 0-1: the conv window of the
decode state taken from the first columns of a rank's in_proj block
(``xz[..., :di]``, which holds chunks of ``[x | z]``, not the rank's
channels) misses after K − 1 decode steps; ``last_only`` taking the
last row of a replicated head's sequence-parallel stream gives rank 0
the logits of position S / M − 1.

On meta, the production (32, 8) mesh: llama3-8b, qwen2.5-3b and
hymba-1.5b ``decode_32k`` and ``prefill_32k`` say ``"model_axis":
"tensor"`` and the layout of ``cache_pspecs``, a rank's cache leaves
and parameter leaves have JAX's ``shard_shape``, and one decode step
issues exactly these collectives over the model group of 8 (L layers):

* ``heads`` (llama3-8b, 32 layers, vocab-parallel): one all-reduce for
  the embedding and one a block (attention, MLP): 1 + 2·32 = 65 sums;
* ``slots`` (qwen2.5-3b, 36 layers, attention gathered: its 7 leaves
  wq, wk, wv, wo, bq, bk, bv gathered a layer): 7·36 = 252 gathers, one
  max and one sum (the merge) a layer and one sum for the MLP, with the
  embedding's: 36 maxes, 1 + 2·36 = 73 sums;
* ``head_dim`` (qwen2.5-3b, ``cache_seq_shard=False``): the 7 gathers
  and the output's gather a layer, 8·36 = 288, the scores' sum and the
  MLP's a layer, 73 sums, no max;
* ``slots`` + ``channels`` (hymba-1.5b, 32 layers, the embedding and
  head replicated): 4 gathers (wq, wk, wv, wo), one max and one merge
  sum a layer, the Mamba block's all-to-all and two sums (x_proj's
  partial sums, out_proj's), the MLP's sum: 128 gathers, 32 maxes, 128
  sums, 32 all-to-alls;
* ``channels`` (falcon-mamba-7b, 64 layers, no MLP): 1 + 2·64 = 129
  sums, 64 all-to-alls.

The ranks import this module by name, so JAX is imported inside the
tests only.
"""
import dataclasses as dc

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.paramvec import tree_map
from repro_torch.core.runtime_sharded import all_gather_seq
from repro_torch.launch import specs
from repro_torch.launch.dryrun import _distinct_bytes
from repro_torch.launch.mesh import describe_mesh, make_sweep_mesh
from repro_torch.launch.multihost import spawn_local
from repro_torch.models import sharding as msh
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.transformer import (decode_step, decode_step_slots,
                                            forward, init_cache,
                                            params_from_jax, prefill_cache)

TOL = 1e-5
B, S, STEPS, MAX_LEN = 2, 8, 16, 32
CFGS = {"rfast": ("rfast-100m", dict(n_heads=4, n_kv_heads=2, head_dim=24)),
        "rfast_w8": ("rfast-100m", dict(n_heads=4, n_kv_heads=2,
                                        head_dim=24, attn_window=8)),
        "qwen": ("qwen2.5-3b", dict(n_heads=4, n_kv_heads=2, head_dim=16)),
        "falcon": ("falcon-mamba-7b", {}),
        "hymba": ("hymba-1.5b", dict(vocab=257))}
# (config, mesh (nodes, model ranks), cache_seq_shard, k/v layout); the
# window-8 case's 24 positions pass from slot 7 (rank 3's last) to slot 0
# (rank 0's) twice, and the 8-token prompt leaves every slot of ranks 1-3
# empty in the 32-slot rings of the other slots cases
CASES = [("rfast", (1, 2), True, "heads"), ("rfast", (1, 4), True, "slots"),
         ("rfast", (1, 4), False, "head_dim"),
         ("rfast", (2, 2), True, "heads"),
         ("rfast_w8", (1, 4), True, "slots"),
         ("qwen", (1, 2), True, "heads"), ("qwen", (1, 4), True, "slots"),
         ("qwen", (1, 4), False, "head_dim"),
         ("hymba", (1, 2), True, "slots"), ("hymba", (1, 4), False,
                                            "head_dim"),
         ("falcon", (1, 2), True, None), ("falcon", (1, 4), True, None)]
# the production dtype: qwen2.5-3b's weights and cache in bf16 on (1, 4),
# the ring by slots and by head dim, held to JAX's bf16 run within
# BF16_TOL of the largest |logit| / cache entry (8 ulps of bf16's 2^-8:
# the bf16 weights and cache round differently in the two frameworks)
BF16_CASES = [("qwen", (1, 4), True, "slots"),
              ("qwen", (1, 4), False, "head_dim")]
BF16_TOL = 3e-2
# build_prefill / build_decode materialized: (config, mesh)
LIVE = [("rfast", (2, 2)), ("hymba", (1, 4))]


def _cfg(key, get=get_config):
    name, kw = CFGS[key]
    return dc.replace(get(name).reduced(max_d_model=64, vocab=256), **kw)


def _tokens(key):
    """(B, S + STEPS) int32: the prompt, then the decode steps' tokens."""
    rng = np.random.default_rng(100 + list(CFGS).index(key))
    return rng.integers(0, _cfg(key).vocab, (B, S + STEPS)).astype(np.int32)


def _whole_logits(lg, tp):
    if tp is None or not tp.vocab_parallel:
        return lg
    return all_gather_seq(lg, tp.group, -1)


def _run(cfg, tp, params, toks, steps=STEPS, dtype=torch.float32):
    """prefill_cache + ``steps`` decode steps under ``tp``, the cache in
    ``dtype``: the logits of each (whole vocab, as fp32), this rank's
    own, and the final cache."""
    got, own = [], []
    with msh.use_tensor_parallel(tp):
        cache, lg = prefill_cache(cfg, params, toks[:, :S], MAX_LEN, dtype)
        shapes = {"/".join(p): tuple(t.shape) for p, t in
                  msh._paths(cache["layers"])}
        for i in range(steps + 1):
            if i:
                lg, cache = decode_step(cfg, params, cache,
                                        toks[:, S + i - 1:S + i])
            own.append(lg.float().numpy().copy())
            got.append(_whole_logits(lg, tp).float().numpy().copy())
    return got, own, cache, shapes


def _case_rank(key, mesh, tree, seq_shard, dtype=torch.float32):
    """One case on this rank of ``mesh``, the weights and cache in
    ``dtype``."""
    if mesh.coords is None:
        return None
    cfg = _cfg(key)
    full, _ = params_from_jax(tree, device="cpu")
    full = tree_map(lambda t: t.to(dtype), full)
    tp = specs.serving_layout(cfg, full, mesh, max_len=MAX_LEN,
                              cache_seq_shard=seq_shard, seq_parallel=True,
                              dtype=dtype)
    node = mesh.coords["data"]
    rows = slice(node * B // mesh.shape["data"],
                 (node + 1) * B // mesh.shape["data"])
    toks = torch.from_numpy(_tokens(key))[rows]
    got, own, cache, shapes = _run(cfg, tp, msh.local_tree(full, tp), toks,
                                   dtype=dtype)
    whole = msh.gather_cache(cache, tp)
    return {"node": node, "model": tp.index, "logits": np.stack(got),
            "own": np.stack(own), "layout": tp.cache_layout,
            "gathered": sorted("/".join(b) for b in tp.gathered),
            "vocab_parallel": tp.vocab_parallel, "shapes": shapes,
            "idx": int(whole["idx"]), "slot_pos": whole["slot_pos"].numpy(),
            "cache": {"/".join(p): t.float().numpy() for p, t in
                      msh._paths(whole["layers"])}}


def _slots_rank(tree):
    """``decode_step_slots`` on the wrapping ring (rfast-100m, window 8,
    (1, 4), slots): rows at positions 5 and 0 of an empty cache, 12
    steps, the logits and the gathered cache against the unsharded
    step's."""
    mesh = make_sweep_mesh(lanes=1, param_shards=4)
    cfg = _cfg("rfast_w8")
    full, _ = params_from_jax(tree, device="cpu")
    tp = specs.serving_layout(cfg, full, mesh, max_len=MAX_LEN,
                              dtype=torch.float32)
    local = msh.local_tree(full, tp)
    whole = init_cache(cfg, full, B, MAX_LEN)
    with msh.use_tensor_parallel(tp):
        cache = init_cache(cfg, local, B, MAX_LEN)
    for c in (whole, cache):
        c["slot_pos"] = c["slot_pos"].expand(B, -1).clone()
        c["idx"] = torch.tensor([5, 0], dtype=torch.int32)
    toks = torch.from_numpy(_tokens("rfast_w8"))
    err = 0.0
    for i in range(12):
        want, whole = decode_step_slots(cfg, full, whole, toks[:, i:i + 1])
        with msh.use_tensor_parallel(tp):
            lg, cache = decode_step_slots(cfg, local, cache,
                                          toks[:, i:i + 1])
            lg = _whole_logits(lg, tp)
        err = max(err, float((lg - want).abs().max() / want.abs().max()))
    gathered = msh.gather_cache(cache, tp)
    return {"err": err, "layout": tp.kv_layout,
            "idx": gathered["idx"].tolist(),
            "slot_pos": bool(torch.equal(gathered["slot_pos"],
                                         whole["slot_pos"])),
            "cache_err": max(float((gathered["layers"]["attn"][k]
                                    - whole["layers"]["attn"][k]).abs().max())
                             for k in ("k", "v"))}


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


def _traps_rank(trees):
    """Ranks 0-1, (1, 2): the repaired conv window and ``last_only``
    beside the old code of each, as errors against the unsharded run
    (relative to its largest |logit|)."""
    mesh = make_sweep_mesh(lanes=1, param_shards=2, ranks=range(2))
    if mesh.coords is None:
        return None
    out = {}
    # 1. the conv window: falcon-mamba-7b, K - 1 = 3 decode steps
    cfg = _cfg("falcon")
    full, _ = params_from_jax(trees["falcon"], device="cpu")
    toks = torch.from_numpy(_tokens("falcon"))
    steps = cfg.ssm_conv - 1
    want, _, _, _ = _run(cfg, None, full, toks, steps)
    tp = specs.serving_layout(cfg, full, mesh, max_len=MAX_LEN,
                              seq_parallel=True, dtype=torch.float32)
    local = msh.local_tree(full, tp)
    err = lambda got: max(float(np.abs(g - w).max() / np.abs(w).max())
                          for g, w in zip(got, want))
    out["window"] = err(_run(cfg, tp, local, toks, steps)[0])
    inner = ssm_mod._ssm_inner

    def old_window(cfg, p, xz, conv_fn, h0=None):  # MUTATION: xz[..., :di]
        y, h, raw = inner(cfg, p, xz, conv_fn, h0)
        return y, h, xz[..., :raw.shape[-1]]
    try:
        ssm_mod._ssm_inner = old_window
        out["window_old"] = err(_run(cfg, tp, local, toks, steps)[0])
    finally:
        ssm_mod._ssm_inner = inner
    # 2. last_only: hymba-1.5b's replicated head, sequence-parallel
    cfg = _cfg("hymba")
    full, _ = params_from_jax(trees["hymba"], device="cpu")
    prompt = torch.from_numpy(_tokens("hymba"))[:, :S]
    with torch.no_grad():
        want = forward(cfg, full, prompt, last_only=True)[0]
        tp = specs.serving_layout(cfg, full, mesh, max_len=MAX_LEN,
                                  seq_parallel=True, dtype=torch.float32)
        local = msh.local_tree(full, tp)
        rel = lambda: float((forward(cfg, local, prompt, last_only=True)[0]
                             - want).abs().max() / want.abs().max())
        with msh.use_tensor_parallel(tp):
            out["last"] = rel()
            last = msh.last_position
            try:        # MUTATION: the last row of the rank's block
                msh.last_position = lambda x: msh.to_head(x)[:, -1:]
                out["last_old"] = rel()
            finally:
                msh.last_position = last
    out["vocab_parallel"] = tp.vocab_parallel
    return out


def _serve_rank(trees):
    cases = [_case_rank(key, make_sweep_mesh(lanes=D, param_shards=M),
                        trees[key], seq_shard)
             for key, (D, M), seq_shard, _ in CASES]
    bf16 = [_case_rank(key, make_sweep_mesh(lanes=D, param_shards=M),
                       trees[key], seq_shard, torch.bfloat16)
            for key, (D, M), seq_shard, _ in BF16_CASES]
    return {"cases": cases, "bf16": bf16,
            "slots": _slots_rank(trees["rfast_w8"]),
            "live": [_live_rank(key, D, M) for key, (D, M) in LIVE],
            "traps": _traps_rank(trees)}


def _tree(key):
    """Weights in the layout of JAX's ``init_params`` (its shapes, from
    ``jax.eval_shape``), drawn with numpy: dense weights N(0, 1)·d_in^-½,
    the embedding N(0, 1)·0.02, norm scales 1 + N(0, 0.1), the rest
    (biases, the SSM's own leaves) N(0, 0.1)."""
    import jax

    from repro.configs import get_config as jget
    from repro.models.transformer import init_params as jinit
    shapes = jax.eval_shape(lambda k: jinit(_cfg(key, jget), k),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(list(CFGS).index(key))

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        z = rng.normal(0, 1, leaf.shape).astype(np.float32)
        if name == "embed":
            return 0.02 * z
        if name == "scale":
            return 1 + 0.1 * z
        if len(leaf.shape) >= 2 and (name.startswith(("w", "lm_"))
                                     or name.endswith("_proj")):
            return z / np.sqrt(leaf.shape[-2])
        return 0.1 * z
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _np_tree(t):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in t.items()}


def _jax_side(key, tree, dtype="float32"):
    """JAX's unsharded prefill_cache + 16 decode steps of one config, the
    weights and cache in ``dtype``: the logits of each (as fp32), the
    final cache, and ``forward(..., last_only=True)`` of the prompt."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models import transformer as jt
    jcfg = _cfg(key, jget)
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
    toks = jnp.asarray(_tokens(key))
    cache, lg = jt.prefill_cache(jcfg, params, toks[:, :S], MAX_LEN,
                                 dtype=jnp.dtype(dtype))
    step = jax.jit(lambda c, t: jt.decode_step(jcfg, params, c, t))
    f32 = lambda a: np.asarray(a, np.float32)
    logits = [f32(lg)]
    for i in range(STEPS):
        lg, cache = step(cache, toks[:, S + i:S + i + 1])
        logits.append(f32(lg))
    last = jt.forward(jcfg, params, toks[:, :S], last_only=True)[0]
    return {"logits": np.stack(logits), "last": f32(last),
            "idx": int(cache["idx"]),
            "slot_pos": np.asarray(cache["slot_pos"]),
            "cache": {"/".join(str(getattr(p, "key", p)) for p in path):
                      f32(leaf) for path, leaf in
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


def _ranks(outs, i):
    return [o["cases"][i] for o in outs if o["cases"][i] is not None]


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _held(ranks, ref, key, D, M, layout, tol):
    """Every rank's logits of every step, gathered cache, ``idx`` and
    ``slot_pos`` against JAX's unsharded run ``ref``, within ``tol``;
    a replicated head's logits bitwise across the model group."""
    assert len(ranks) == D * M
    cfg = _cfg(key)
    for r in ranks:
        rows = slice(r["node"] * B // D, (r["node"] + 1) * B // D)
        assert r["layout"] == {
            "kv": layout,
            "ssm": "channels" if cfg.mixer in ("ssm", "hybrid") else None}
        assert r["logits"].shape[0] == STEPS + 1
        for step, (got, w) in enumerate(zip(r["logits"],
                                            ref["logits"][:, rows])):
            assert _rel(got, w) <= tol, (step, _rel(got, w))
        assert r["idx"] == ref["idx"] == S + STEPS
        assert np.array_equal(r["slot_pos"], ref["slot_pos"])
        assert set(r["cache"]) == set(ref["cache"])
        for name, w in ref["cache"].items():
            assert _rel(r["cache"][name], w[:, rows]) <= tol, name
        assert r["gathered"] == ([] if layout in ("heads", None)
                                 else ["layers/attn"])
        assert r["vocab_parallel"] == (cfg.vocab % M == 0)
    if not ranks[0]["vocab_parallel"]:     # a replicated head: bitwise
        for r in ranks[1:]:
            assert np.array_equal(r["own"], ranks[0]["own"])


@pytest.mark.parametrize("i", range(len(CASES)), ids=[
    f"{k}-{d}x{m}-{lay or 'channels'}" for k, (d, m), _, lay in CASES])
def test_prefill_and_decode_match_jax_unsharded(spawned, i):
    outs, want, _, _ = spawned
    key, (D, M), _, layout = CASES[i]
    _held(_ranks(outs, i), want[key], key, D, M, layout, TOL)


@pytest.mark.parametrize("i", range(len(BF16_CASES)), ids=[
    f"{k}-{d}x{m}-{lay}" for k, (d, m), _, lay in BF16_CASES])
def test_bf16_prefill_and_decode_match_jax_bf16(spawned, i):
    outs, _, _, want = spawned
    key, (D, M), _, layout = BF16_CASES[i]
    ranks = [o["bf16"][i] for o in outs if o["bf16"][i] is not None]
    _held(ranks, want[key], key, D, M, layout, BF16_TOL)


def test_local_cache_leaves_have_the_reference_shard_shapes(spawned):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh, NamedSharding

    from repro.configs import get_config as jget
    from repro.launch import shardings as jsh
    from repro.models import transformer as jt
    outs, _, _, _ = spawned
    for i, (key, (D, M), seq_shard, _) in enumerate(CASES):
        jcfg = _cfg(key, jget)
        cache = jax.eval_shape(lambda: jt.init_cache(
            jcfg, None, B, MAX_LEN, jnp.float32))
        mesh = AbstractMesh((D, M), ("data", "model"))
        specs_ = jsh.cache_pspecs(cache["layers"], mesh, ("data",),
                                  seq_shard=seq_shard)
        want = {"/".join(str(getattr(p, "key", p)) for p in path):
                NamedSharding(mesh, spec).shard_shape(leaf.shape)
                for (path, leaf), spec in zip(
                    jax.tree_util.tree_flatten_with_path(cache["layers"])[0],
                    jax.tree.leaves(specs_, is_leaf=lambda s: isinstance(
                        s, jax.sharding.PartitionSpec)))}
        for r in _ranks(outs, i):
            assert r["shapes"] == want, (key, D, M)


def test_decode_step_slots_matches_the_unsharded_step(spawned):
    outs, _, _, _ = spawned
    for o in outs:
        s = o["slots"]
        assert s["layout"] == "slots"
        assert s["err"] <= TOL and s["cache_err"] <= TOL
        assert s["slot_pos"] and s["idx"] == [17, 12]


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
                assert r[name]["live_bytes"] == r[name]["meta_bytes"] > 0
            assert r["prefill"]["info"]["seq_parallel"]
            assert np.array_equal(r["tokens"], toks)
            assert _rel(r["logits"], np.asarray(want)) <= TOL
            V = _cfg(key).vocab
            assert r["decode_shape"] == (B // D, 1, V // M if V % M == 0
                                         else V)


def test_traps_of_the_conv_window_and_the_last_position(spawned):
    outs, _, _, _ = spawned
    traps = [o["traps"] for o in outs if o["traps"] is not None]
    assert len(traps) == 2
    for t in traps:
        assert t["window"] <= TOL and t["last"] <= TOL, t
        # the old window: rank 1's in_proj block is z's columns
        assert t["window_old"] > TOL, t
        assert t["vocab_parallel"] is False
    # the old last row: rank 0 returns position S / 2 − 1's logits
    assert traps[0]["last_old"] > TOL
    assert traps[1]["last_old"] <= TOL


def _meta_case(arch, shape, seq_shard):
    from repro_torch.core import runtime_sharded as rs
    kw = {} if shape == "prefill_32k" else {"cache_seq_shard": seq_shard}
    fn, args = specs.input_specs(arch, shape, **kw)
    calls = None
    if fn.info["kind"] == "decode":
        with rs.record_collectives() as calls:
            fn(*args)
    return fn, args, calls


def _jax_shard_shapes(arch, shape, seq_shard=True):
    """JAX's ``NamedSharding.shard_shape`` of every parameter leaf
    (``tree_shardings``) and, for a decode shape, every cache leaf
    (``cache_pspecs``), at full size on AbstractMesh (32, 8)."""
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
    mesh = AbstractMesh((32, 8), ("data", "model"))
    params = jax.eval_shape(lambda k: jt.init_params(cfg, k, jax.numpy.
                                                     bfloat16),
                            jax.random.PRNGKey(0))
    name = lambda path: "/".join(str(getattr(p, "key", p)) for p in path)
    out = {"params": {name(p): ns.shard_shape(leaf.shape) for (p, leaf), (
        _, ns) in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                      jax.tree_util.tree_flatten_with_path(jsh.tree_shardings(
                          params, mesh, jsh.RULES_BASE))[0])}}
    if info["kind"] == "decode":
        cache = jax.eval_shape(lambda p: jt.init_cache(
            cfg, p, info["batch"], info["seq"], jax.numpy.bfloat16), params)
        sp = jsh.cache_pspecs(cache, mesh, ("data",), seq_shard=seq_shard)
        out["cache"] = {name(p): NamedSharding(mesh, s).shard_shape(
            leaf.shape) for (p, leaf), s in zip(
                jax.tree_util.tree_flatten_with_path(cache)[0],
                jax.tree.leaves(sp, is_leaf=lambda s: isinstance(
                    s, jax.sharding.PartitionSpec)))}
    return out


def _port_shapes(tree):
    return {"/".join(p): tuple(t.shape) for p, t in msh._paths(tree)}


# (arch, shape, cache_seq_shard, k/v layout, SSM layout, collectives a
# decode step by name: the module docstring's counts)
META = [("llama3-8b", "decode_32k", True, "heads", None,
         {"all_reduce_sum": 65}),
        ("qwen2.5-3b", "decode_32k", True, "slots", None,
         {"all_gather_seq": 252, "all_reduce_max": 36,
          "all_reduce_sum": 73}),
        ("qwen2.5-3b", "decode_32k", False, "head_dim", None,
         {"all_gather_seq": 288, "all_reduce_sum": 73}),
        ("hymba-1.5b", "decode_32k", True, "slots", "channels",
         {"all_gather_seq": 128, "all_reduce_max": 32,
          "all_reduce_sum": 128, "all_to_all": 32}),
        ("falcon-mamba-7b", "decode_32k", True, None, "channels",
         {"all_reduce_sum": 129, "all_to_all": 64}),
        ("qwen2.5-3b", "prefill_32k", True, "slots", None, None),
        ("hymba-1.5b", "prefill_32k", True, "slots", "channels", None)]


@pytest.mark.parametrize("arch,shape,seq_shard,kv,ssm,coll", META, ids=[
    f"{a}-{s}-{kv or ssm}" for a, s, _, kv, ssm, _ in META])
def test_production_mesh_meta_layouts_and_collectives(arch, shape, seq_shard,
                                                      kv, ssm, coll):
    fn, args, calls = _meta_case(arch, shape, seq_shard)
    info = fn.info
    assert info["model_axis"] == "tensor"
    assert info["cache_layout"] == {"kv": kv, "ssm": ssm}
    assert info["tensor_parallel"]["ranks"] == 8
    want = _jax_shard_shapes(arch, shape, seq_shard)
    assert _port_shapes(args[0]) == want["params"]
    if coll is None:
        assert info["seq_parallel"]
        return
    cache = args[1]
    got = _port_shapes(cache["layers"])
    assert got == {k[len("layers/"):]: v for k, v in want["cache"].items()
                   if k.startswith("layers/")}
    assert tuple(cache["idx"].shape) == want["cache"]["idx"]
    assert tuple(cache["slot_pos"].shape) == want["cache"]["slot_pos"]
    counts: dict = {}
    for c in calls:
        if c["group_size"] > 1:
            assert c["group_size"] == 8
            counts[c["name"]] = counts.get(c["name"], 0) + 1
    assert counts == coll


# the rest of the layout table at full width, on meta: (arch, mesh,
# cache_seq_shard, k/v layout, SSM layout)
TABLE = [("rfast-100m", (32, 8), True, "slots", None),
         ("rfast-100m", (32, 8), False, "head_dim", None),
         ("rfast-100m", (64, 4), True, "heads", None),
         ("olmo-1b", (32, 8), True, "heads", None),
         ("deepseek-7b", (32, 8), True, "heads", None),
         ("hymba-1.5b", (32, 8), False, "head_dim", "channels"),
         ("whisper-large-v3", (32, 8), True, "slots", None),
         ("whisper-large-v3", (32, 8), False, "head_dim", None),
         ("whisper-large-v3", (64, 4), True, "heads", None),
         ("pixtral-12b", (32, 8), True, "heads", None),
         ("pixtral-12b", (64, 4), True, "heads", None),
         ("phi3.5-moe-42b-a6.6b", (32, 8), True, "heads", None),
         ("phi3.5-moe-42b-a6.6b", (64, 4), True, "heads", None),
         ("deepseek-v2-236b", (32, 8), True, None, None),
         ("deepseek-v2-236b", (32, 8), False, None, None),
         ("deepseek-v2-236b", (64, 4), True, None, None)]
# the enc-dec arch's cross caches by mesh: by head dim where its 20 KV
# heads do not divide over model (64 does), by heads where they do
CROSS_LAYOUT = {"whisper-large-v3": {(32, 8): "head_dim", (64, 4): "heads"}}
# the MLA arch's latent c by cache_seq_shard: by slots where it is on (M
# divides the 32768 slots), else by latent dim (M divides 512)
LATENT_LAYOUT = {"deepseek-v2-236b": {True: "slots", False: "latent_dim"}}


@pytest.mark.parametrize("arch,mesh,seq_shard,kv,ssm", TABLE)
def test_layout_table_at_full_width(arch, mesh, seq_shard, kv, ssm):
    fn, args = specs.build_decode(get_config(arch),
                                  describe_mesh(mesh, ("data", "model")),
                                  seq=32768, global_batch=128,
                                  cache_seq_shard=seq_shard)
    assert fn.info["model_axis"] == "tensor"
    want = {"kv": kv, "ssm": ssm}
    if arch in CROSS_LAYOUT:
        want["cross"] = CROSS_LAYOUT[arch][mesh]
    if arch in LATENT_LAYOUT:
        want["latent"] = LATENT_LAYOUT[arch][seq_shard]
    assert fn.info["cache_layout"] == want


def test_a_ring_that_nothing_divides_stays_whole():
    """rfast-100m's 2 KV heads, 32 slots and head dim 16 over 3 ranks: the
    ring is replicated, beside the gathered attention block."""
    cfg = dc.replace(_cfg("rfast"), head_dim=16)
    fn, (_, cache, _) = specs.build_decode(
        cfg, describe_mesh((1, 3), ("data", "model")), seq=MAX_LEN,
        global_batch=B, dtype=torch.float32)
    assert fn.info["cache_layout"] == {"kv": "replicated", "ssm": None}
    assert fn.info["tensor_parallel"]["gathered"] == ["layers/attn",
                                                      "layers/mlp"]
    assert tuple(cache["layers"]["attn"]["k"].shape) == (2, B, MAX_LEN, 2,
                                                         16)


def test_llama_decode_32k_rank_holds_its_blocks():
    """A rank at (32, 8) holds one KV head of the k/v ring and its blocks
    of the weights: ≈ 3.9 GiB of arguments, where the whole bf16 tree
    and ring came to 31 GiB."""
    fn, args = specs.input_specs("llama3-8b", "decode_32k")
    params, cache, _ = args
    assert tuple(cache["layers"]["attn"]["k"].shape) == (32, 4, 32768, 1, 128)
    total = _distinct_bytes(specs.tensors_of(args))
    ring = 2 * 32 * 4 * 32768 * 1 * 128 * 2
    assert ring == 2 ** 31 and 3.5 * 2 ** 30 < total < 4.2 * 2 ** 30


def test_other_archs_keep_prefill_and_decode_replicated():
    """Every one of the eleven archs (phi3.5-moe and deepseek-v2, the MoE
    and MLA ones, too) serves tensor-parallel on a ``model`` axis of M >
    1, with its cache laid out; at M = 1 every arch keeps the whole model
    and cache on its rank (``"replicated"``, no cache layout)."""
    assert len(ARCHS) == 11
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        for mesh, axis in (((2, 2), "tensor"), ((4, 1), "replicated")):
            for build in (specs.build_prefill, specs.build_decode):
                fn, _ = build(cfg, describe_mesh(mesh, ("data", "model")),
                              seq=32, global_batch=4)
                assert fn.info["model_axis"] == axis, (arch, mesh)
                assert (fn.info["cache_layout"] is None) == (
                    axis == "replicated"), (arch, mesh)
                assert ("latent" in (fn.info["cache_layout"] or {})) == (
                    axis == "tensor" and cfg.attention == "mla"
                    and cfg.mixer != "ssm")


def test_a_layout_the_blocks_do_not_run_is_refused():
    """A ring by heads beside a gathered attention block (rfast-100m's 2 KV
    heads over 4 ranks with the heads' layout forced) raises, as does a
    cache layout missing under tensor parallelism."""
    cfg = _cfg("rfast")
    from repro_torch.models.transformer import param_shapes
    mesh = describe_mesh((1, 4), ("data", "model"))
    tp = specs.serving_layout(cfg, param_shapes(cfg), mesh, max_len=MAX_LEN,
                              dtype=torch.float32)
    assert tp.kv_layout == "slots"
    with pytest.raises(ValueError, match="heads beside a gathered"):
        msh.with_cache(dc.replace(tp, cache=None), {"layers": {
            "attn": {k: torch.empty(2, 2, 32, 4, 24, device="meta")
                     for k in ("k", "v")}}})
    bare = dc.replace(tp, cache=None)
    with msh.use_tensor_parallel(bare), pytest.raises(ValueError,
                                                      match="no cache"):
        init_cache(cfg, param_shapes(cfg, torch.float32), B, MAX_LEN)
