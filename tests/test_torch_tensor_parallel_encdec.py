"""The port's ``model`` axis tensor-parallel for the enc-dec and frontend
archs against JAX: whisper-large-v3's encoder, cross attention and
biased MLPs, and pixtral-12b's patch prefix.

One spawn of 4 gloo ranks (``spawn_local``) runs every case; the JAX
side runs here, where JAX sees one device.  Weights have the layout of
JAX's ``init_params`` of reduced configs (``ModelConfig.reduced``, d 64,
2 + 2 layers) and, like the tokens and the frames or patches, are drawn
with numpy from a seed.  whisper at vocab 258 (vocab-parallel at M = 2,
replicated at M = 4) over F = 6 frames (the encoder's stream
sequence-parallel at M = 2, replicated at M = 4), with 4 heads, or 2
(``whisper_g``: at M = 4 its three attention blocks take the gathered
path, as whisper-large-v3's 20 heads do at M = 8); pixtral with 16 patch
rows before 16 tokens and 2 KV heads (column-parallel at M = 2,
gathered at M = 4):

* on a (2, 2) mesh with sequence parallelism and on (1, 4) without (and
  ``whisper_g`` on (1, 4) with it: the decoder's stream
  sequence-parallel, the encoder's replicated): the gradient at x0 and 3
  rounds of ``make_sharded_round``, each gathered whole
  (``models.sharding.gather_tree``), within 1e-4 of JAX's unsharded
  ``jax.value_and_grad(loss_fn)`` (with the frontend) and its dense
  ``make_rfast_round``; the loss the same on every rank of a model
  group; the replicated leaves bitwise equal across it after the 3
  rounds; RF206 clean on the (2, 2) rounds;
* each rank's local leaves have the shapes of ``NamedSharding(mesh,
  spec).shard_shape`` of the reference's PartitionSpecs;
* on meta: pixtral-12b ``train_4k`` on the production (32, 8) mesh holds
  7 rows of ``param_shard_elements_per_rank`` bf16 elements and says
  ``"model_axis": "tensor"``; whisper-large-v3's rank holds its shard
  rows too, with its three attention blocks gathered, its vocab and its
  encoder's stream replicated;
* on ranks 0-1 (a (1, 2) mesh with sequence parallelism) the traps of
  the layout: the gradient right, and wrong (beyond the tolerance) with
  the MLPs' ``bo`` added on every rank, with the encoder's replicated
  leaves all-reduced while its stream (F = 5) is replicated, with the
  encoder output's gradient not summed over the cross-attention head
  blocks, or with pixtral's patch rows counted on every rank.

The ranks import this module by name, so JAX is imported inside the
tests only.
"""
import dataclasses as dc

import numpy as np
import pytest
import torch

from repro_torch.analysis import torchlint
from repro_torch.configs import get_config
from repro_torch.core import binary_tree
from repro_torch.core.paramvec import make_ravel_spec, ravel, value_and_grad
from repro_torch.core.runtime_sharded import (clear_collectives,
                                              collective_stats,
                                              init_sharded_state,
                                              make_sharded_round,
                                              shard_state)
from repro_torch.launch import specs
from repro_torch.launch.dryrun import _distinct_bytes
from repro_torch.launch.mesh import make_sweep_mesh
from repro_torch.launch.multihost import spawn_local
from repro_torch.models import sharding as msh
from repro_torch.models.transformer import loss_fn, params_from_jax

TOL = 1e-4
GAMMA, ROUNDS, B, S = 0.05, 3, 2, 16
CFGS = {"whisper": ("whisper-large-v3", dict(frontend_seq=6)),
        "whisper_g": ("whisper-large-v3", dict(frontend_seq=6, n_heads=2,
                                               n_kv_heads=2)),
        "pixtral": ("pixtral-12b", dict(n_kv_heads=2))}
VOCAB = {"whisper": 258, "whisper_g": 258, "pixtral": 256}
# (config, mesh (nodes, model ranks), sequence parallel)
CASES = [("whisper", (2, 2), True), ("whisper", (1, 4), False),
         ("whisper_g", (1, 4), True), ("whisper_g", (1, 4), False),
         ("pixtral", (2, 2), True), ("pixtral", (1, 4), False)]
FIELDS = ("x", "z", "g_prev")
ATTN3 = ["enc_layers/attn", "layers/attn", "layers/cross"]


def _cfg(key, get=get_config):
    name, kw = CFGS[key]
    return dc.replace(get(name).reduced(max_d_model=64, vocab=VOCAB[key]),
                      **kw)


def _data(key, n):
    """(tokens, labels) (n, B, S) int32 and the frontend (n, B, F, fd)."""
    cfg = _cfg(key)
    rng = np.random.default_rng(10 * list(CFGS).index(key) + n)
    toks = tuple(rng.integers(0, cfg.vocab, (n, B, S)).astype(np.int32)
                 for _ in range(2))
    return toks + (rng.standard_normal(
        (n, B, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32),)


def _lf(cfg):
    return lambda p, b, k: loss_fn(cfg, p, b[0], b[1], b[2], remat=True)


def _case_rank(cfg, mesh, np_tree, data, sp, audit):
    """One case on this rank: the tensor-parallel gradient at x0 and 3
    rounds, each gathered whole."""
    full, _ = params_from_jax(np_tree, device="cpu")
    tp = msh.tensor_parallel(cfg, full, mesh, seq_parallel=sp)
    local = msh.local_tree(full, tp)
    spec = make_ravel_spec(local)
    grad = msh.tensor_parallel_grad(spec, _lf(cfg), tp)
    whole = lambda flat: msh.gather_flat(flat, spec, tp).numpy()
    na = ("data",)
    topo = binary_tree(mesh.shape["data"])
    batches = tuple(torch.from_numpy(a) for a in data)
    node = mesh.coords["data"]
    loss0, g0 = grad(ravel(spec, local), tuple(t[node] for t in batches),
                     None)
    st = shard_state(init_sharded_state(topo, ravel(spec, local), grad,
                                        batches), mesh, na)
    blk = shard_state(batches, mesh, na)
    rf = make_sharded_round(topo, grad, mesh, gamma=GAMMA, node_axes=na)
    clear_collectives()
    for _ in range(ROUNDS):
        st, metrics = rf(st, blk)
    rep = [(path, off, int(np.prod(shape))) for path, shape, off in zip(
        spec.paths, spec.shapes, spec.offsets) if tp.dims[path] is None]
    out = {"node": node, "model": tp.index, "loss0": float(loss0),
           "g0": whole(g0), "losses": metrics["losses"].numpy(),
           "gathered": sorted("/".join(b) for b in tp.gathered),
           "vocab_parallel": tp.vocab_parallel,
           "enc_seq_parallel": tp.enc_seq_parallel,
           "shapes": {"/".join(k): shape
                      for k, shape in zip(spec.paths, spec.shapes)},
           "replicated_paths": ["/".join(p) for p, _, _ in rep],
           "replicated": np.concatenate([st.x[0, o:o + n].numpy()
                                         for _, o, n in rep]),
           "coll": {k: v["calls"]
                    for k, v in collective_stats()["by_name"].items()}}
    out.update({f: whole(getattr(st, f)[0]) for f in FIELDS})
    if audit:
        out["audit"] = [d.code for d in torchlint.audit_tensor_parallel_round(
            lambda s: rf(s, blk), st, subject="tp_encdec_round")]
    return out


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


# the groups of leaves a trap reaches, by key path
GROUPS = {"bo": lambda path: path[-1] == "bo",
          # the encoder's replicated leaves
          "enc_replicated": lambda path: path[0] in ("enc_norm",
                                                     "frontend_proj")
          or (path[0] == "enc_layers"
              and (path[1] in ("ln1", "ln2") or path[-1] == "bo")),
          "encoder": lambda path: path[0] in msh.ENCODER,
          "frontend_proj": lambda path: path[0] == "frontend_proj"}


def _leaf_errors(cfg, full, tp, batch, grad_tp=None):
    """The tensor-parallel loss and gradient gathered whole against the
    unsharded ones: the loss's relative error, the whole vector's and
    (to each one's largest entry) the groups of leaves a trap reaches.
    ``grad_tp`` builds the gradient's reduction (default ``tp``)."""
    lf = _lf(cfg)
    local = msh.local_tree(full, tp)
    spec = make_ravel_spec(local)
    vg = msh.tensor_parallel_grad(spec, lf, tp)
    if grad_tp is not None:
        vg = grad_tp(spec, lf, tp)
    loss, g = vg(ravel(spec, local), batch, None)
    fspec = make_ravel_spec(full)
    dloss, gd = value_and_grad(fspec, lf)(ravel(fspec, full), batch, None)
    gw = msh.gather_flat(g, spec, tp)
    out = {"loss": float(abs(loss - dloss) / abs(dloss)),
           "whole": _rel(gw, gd)}
    for name, member in GROUPS.items():
        idx = [np.arange(off, off + int(np.prod(shape)))
               for path, shape, off in zip(fspec.paths, fspec.shapes,
                                           fspec.offsets) if member(path)]
        if idx:
            i = torch.from_numpy(np.concatenate(idx))
            out[name] = _rel(gw[i], gd[i])
    return out


def _old_reduction(spec, lf, tp):
    """MUTATION: every replicated leaf's gradient all-reduced under the
    decoder's sequence parallelism, whatever the stream (the rule before
    the encoder had a stream of its own)."""
    cls = msh.TensorParallel
    own = cls.stream_seq_parallel
    cls.stream_seq_parallel = lambda self, path: self.seq_parallel
    try:
        return msh.tensor_parallel_grad(spec, lf, tp)
    finally:
        cls.stream_seq_parallel = own


def _traps_rank(trees):
    """Ranks 0-1 on a (1, 2) mesh with sequence parallelism: whisper over
    F = 5 frames (its encoder's stream replicated, its decoder's
    sequence-parallel, 4 heads column-parallel, vocab-parallel) and
    pixtral; the gradient right, and with each trap sprung."""
    mesh = make_sweep_mesh(lanes=1, param_shards=2, ranks=range(2))
    if mesh.coords is None:
        return None
    from repro_torch.core import runtime_sharded as rs
    out = {}
    for key, F in (("whisper", 5), ("pixtral", None)):
        cfg = _cfg(key)
        cfg = cfg if F is None else dc.replace(cfg, frontend_seq=F)
        full, _ = params_from_jax(trees[key], device="cpu")
        rng = np.random.default_rng(7)
        batch = tuple(torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
                      .int() for _ in range(2)) + (torch.from_numpy(
                          rng.standard_normal((B, cfg.frontend_seq,
                                               cfg.frontend_dim))
                          .astype(np.float32)),)
        tp = msh.tensor_parallel(cfg, full, mesh, seq_parallel=True)
        res = {"right": _leaf_errors(cfg, full, tp, batch),
               "enc_seq_parallel": tp.enc_seq_parallel,
               "vocab_parallel": tp.vocab_parallel,
               "gathered": sorted("/".join(b) for b in tp.gathered)}
        if key == "whisper":
            block = msh.parallel_block

            def bo_everywhere(k, params, x, fn):
                # MUTATION: bo added inside the row-parallel frame
                if "bo" not in params:
                    return block(k, params, x, fn)
                bo = params["bo"]
                rest = {n: v for n, v in params.items() if n != "bo"}
                return block(k, rest, x, lambda p, y: fn(dict(p, bo=bo), y))
            msh.parallel_block = bo_everywhere
            try:
                res["bo_everywhere"] = _leaf_errors(cfg, full, tp, batch)
            finally:
                msh.parallel_block = block
            res["enc_reduced"] = _leaf_errors(cfg, full, tp, batch,
                                              grad_tp=_old_reduction)
            enter = msh.enter_decoder

            def unsummed(enc):
                # MUTATION: the encoder output enters, its gradient unsummed
                tp = msh.current_tensor_parallel()
                if tp is None or not tp.enc_seq_parallel:
                    return enc
                return rs.gather_from_model(enc, tp.group, 1)
            msh.enter_decoder = unsummed
            try:
                res["enc_unsummed"] = _leaf_errors(cfg, full, tp, batch)
            finally:
                msh.enter_decoder = enter
        else:
            part = msh._prefix_part
            # MUTATION: every rank's partial sums carry the patch rows
            msh._prefix_part = lambda tp, f, p, x: (f @ p).to(x.dtype)
            try:
                res["patches_everywhere"] = _leaf_errors(cfg, full, tp,
                                                         batch)
            finally:
                msh._prefix_part = part
        out[key] = res
    return out


def _tp_rank(trees, data):
    outs = []
    for i, (key, (D, M), sp) in enumerate(CASES):
        mesh = make_sweep_mesh(lanes=D, param_shards=M)
        outs.append(_case_rank(_cfg(key), mesh, trees[key], data[(key, D)],
                               sp, audit=(D, M) == (2, 2)))
    return {"cases": outs, "traps": _traps_rank(trees)}


def _tree(key):
    """Weights in the layout of JAX's ``init_params`` (its shapes, from
    ``jax.eval_shape``), drawn with numpy: matrices N(0, 1)·d_in^-½, the
    embedding N(0, 1)·0.02, norm scales 1 + N(0, 0.1), biases
    N(0, 0.1), so that every leaf's gradient is exercised."""
    import jax

    from repro.configs import get_config as jget
    from repro.models.transformer import init_params as jinit
    shapes = jax.eval_shape(lambda k: jinit(_cfg(key, jget), k),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(100 + list(CFGS).index(key))

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


def _jax_side(key, tree, data):
    """For one config, per node count: JAX's unsharded
    ``value_and_grad`` of every node at x0 (with its frontend), and the
    dense round's state after 3 rounds from the reference's init, as
    flat numpy rows in the ravel order."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.core import binary_tree as jbinary_tree
    from repro.core.protocol import init_protocol_state
    from repro.core.runtime import edge_arrays, make_rfast_round
    from repro.models.transformer import loss_fn as jloss
    jcfg = _cfg(key, jget)
    params = jax.tree.map(jnp.asarray, tree)
    vg = jax.jit(jax.value_and_grad(lambda p, b, k: jloss(
        jcfg, p, b[0], b[1], b[2])))

    def rows(t):
        leaves = [np.asarray(leaf) for leaf in jax.tree.leaves(t)]
        return np.stack([np.concatenate([leaf[i].reshape(-1)
                                         for leaf in leaves])
                         for i in range(leaves[0].shape[0])])

    want = {}
    for n in sorted({n for k, n in data if k == key}):
        batches = tuple(jnp.asarray(a) for a in data[(key, n)])
        g0 = [vg(params, tuple(b[i] for b in batches), None)
              for i in range(n)]
        stack = jax.tree.map(lambda *ls: jnp.stack(ls), *(g for _, g in g0))
        spec = edge_arrays(jbinary_tree(n))
        rf = make_rfast_round(spec, vg, gamma=GAMMA)
        keys = jax.random.split(jax.random.PRNGKey(1), n)

        @jax.jit
        def run(params, stack):
            st = init_protocol_state(spec, params, lambda x, b, k: (
                None, stack), batches, None)
            return jax.lax.fori_loop(0, ROUNDS, lambda _, st: rf(
                st, batches, keys, None)[0], st)

        st = run(params, stack)
        want[(key, n)] = {"loss0": [float(l) for l, _ in g0],
                          "g0": rows(stack),
                          **{f: rows(getattr(st, f)) for f in FIELDS}}
    return want


@pytest.fixture(scope="module")
def spawned():
    """The ranks' results and JAX's, computed side by side (the ranks,
    and one thread a config)."""
    from concurrent.futures import ThreadPoolExecutor
    trees = {key: _tree(key) for key in CFGS}
    data = {(key, m[0]): _data(key, m[0]) for key, m, _ in CASES}
    with ThreadPoolExecutor(1 + len(CFGS)) as pool:
        ranks = pool.submit(spawn_local, _tp_rank, 4, trees, data,
                            timeout_s=60.0, join_s=240.0)
        sides = [pool.submit(_jax_side, key, trees[key], data)
                 for key in CFGS]
        want = {k: v for f in sides for k, v in f.result().items()}
        outs = ranks.result()
    return outs, want


def _ranks(outs, i):
    return [o["cases"][i] for o in outs]


IDS = [f"{k}-{d}x{m}-sp{int(sp)}" for k, (d, m), sp in CASES]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_gradient_and_rounds_match_jax_unsharded(spawned, i):
    outs, want = spawned
    key, (D, M), sp = CASES[i]
    ref = want[(key, D)]
    for r in _ranks(outs, i):
        n = r["node"]
        assert abs(r["loss0"] - ref["loss0"][n]) <= TOL
        np.testing.assert_allclose(r["g0"], ref["g0"][n], rtol=TOL,
                                   atol=TOL)
        for f in FIELDS:
            np.testing.assert_allclose(r[f], ref[f][n], rtol=TOL, atol=TOL,
                                       err_msg=f)
        # every rank of the model group reports the same losses
        assert np.array_equal(r["losses"], _ranks(outs, i)[0]["losses"])
    cfg = _cfg(key)
    misaligned = cfg.n_heads % M or cfg.n_kv_heads % M
    for r in _ranks(outs, i):
        if cfg.enc_dec:
            assert r["gathered"] == (ATTN3 if misaligned else [])
            assert r["enc_seq_parallel"] == (sp and cfg.frontend_seq % M
                                             == 0)
        else:
            assert r["gathered"] == (["layers/attn"] if misaligned else [])
            assert r["enc_seq_parallel"] is None
        assert r["vocab_parallel"] == (cfg.vocab % M == 0)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_replicated_leaves_bitwise_across_the_model_group(spawned, i):
    outs, _ = spawned
    key, (D, M), _ = CASES[i]
    by_node: dict = {}
    for r in _ranks(outs, i):
        assert "frontend_proj" in r["replicated_paths"]
        if key.startswith("whisper"):
            assert {"layers/mlp/bo", "enc_layers/mlp/bo",
                    "enc_norm/scale"} <= set(r["replicated_paths"])
        by_node.setdefault(r["node"], []).append(r["replicated"])
    for reps in by_node.values():
        assert len(reps) == M and reps[0].size > 0
        for rep in reps[1:]:
            assert np.array_equal(rep, reps[0])


def test_local_leaves_have_the_reference_shard_shapes(spawned):
    import jax
    from jax.sharding import AbstractMesh

    from repro.configs import get_config as jget
    from repro.launch import shardings as jsh
    from repro.models.transformer import init_params as jinit
    outs, _ = spawned
    for i, (key, (D, M), _) in enumerate(CASES):
        jcfg = _cfg(key, jget)
        stacked = jax.eval_shape(lambda k: jax.tree.map(
            lambda l: jax.numpy.broadcast_to(l, (D,) + l.shape),
            jinit(jcfg, k)), jax.random.PRNGKey(0))
        mesh = AbstractMesh((D, M), ("data", "model"))
        shard = jsh.tree_shardings(stacked, mesh, jsh.RULES_BASE,
                                   lead_axes=(("data",),))
        want = {}
        for (path, leaf), (_, ns) in zip(
                jax.tree_util.tree_flatten_with_path(stacked)[0],
                jax.tree_util.tree_flatten_with_path(shard)[0]):
            name = "/".join(str(getattr(p, "key", p)) for p in path)
            want[name] = ns.shard_shape(leaf.shape)[1:]
        cfg = _cfg(key)
        for r in _ranks(outs, i):
            assert r["shapes"] == want
            # frontend_proj whole; the cross / encoder k projections a
            # rank's columns
            assert r["shapes"]["frontend_proj"] == (cfg.frontend_dim,
                                                    cfg.d_model)
            for blk in (("layers/cross", "enc_layers/attn")
                        if cfg.enc_dec else ()):
                assert r["shapes"][f"{blk}/wk"][-1] == \
                    cfg.n_kv_heads * cfg.hd // M


def test_collectives_and_rf206(spawned):
    outs, _ = spawned
    for i, (key, (D, M), sp) in enumerate(CASES):
        for r in _ranks(outs, i):
            if (D, M) == (2, 2):
                assert r["audit"] == []
            assert ("reduce_scatter_seq" in r["coll"]) == sp, (key, sp)
            # the cross entropy's max, one a gradient: vocab-parallel only
            assert r["coll"].get("all_reduce_max", 0) == (
                ROUNDS if r["vocab_parallel"] else 0)


def _meta_rows(arch, tensor_parallel):
    from repro_torch.launch.dryrun import _gspmd
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shardings import RULES_BASE
    fn, args = specs.input_specs(arch, "train_4k")
    state, batch, _ = args
    per_rank = _gspmd(get_config(arch), make_production_mesh(),
                      RULES_BASE)["param_shard_elements_per_rank"]
    batch_bytes = sum(t.numel() * t.element_size() for t in batch)
    assert fn.info["model_axis"] == "tensor" and fn.info["p"] == per_rank
    assert fn.info["seq_parallel"]
    assert fn.info["tensor_parallel"] == tensor_parallel
    assert _distinct_bytes(specs.tensors_of(args)) == \
        7 * per_rank * 2 + batch_bytes
    return per_rank, batch


def test_pixtral_train_4k_meta_arguments_are_the_shard_rows():
    per_rank, batch = _meta_rows("pixtral-12b", {
        "ranks": 8, "gathered": [], "vocab_parallel": True})
    assert per_rank == 1_602_114_560
    # 256 patch rows before 3840 tokens: 4096 rows a sequence
    assert [tuple(t.shape) for t in batch] == [
        (1, 8, 3840), (1, 8, 3840), (1, 8, 256, 1024)]


def test_whisper_train_4k_meta_arguments_are_the_shard_rows():
    per_rank, _ = _meta_rows("whisper-large-v3", {
        "ranks": 8, "gathered": ATTN3, "vocab_parallel": False,
        "encoder_seq_parallel": False})
    assert per_rank == 318_499_840


def test_whisper_build_train_at_m4_runs_its_encoder_sequence_parallel():
    """M = 4 divides whisper-large-v3's 1500 frames and its 20 heads and
    not its vocab of 51866: everything column-parallel, the encoder's
    stream sequence-parallel, the embedding and the head replicated."""
    from repro_torch.launch.mesh import describe_mesh
    fn, _ = specs.build_train(get_config("whisper-large-v3"),
                              describe_mesh((64, 4), ("data", "model")),
                              seq=4096, global_batch=256)
    assert fn.info["tensor_parallel"] == {
        "ranks": 4, "gathered": [], "vocab_parallel": False,
        "encoder_seq_parallel": True}
    assert fn.info["p"] == 502_087_680


def test_a_prefix_before_a_replicated_head_refuses_sequence_parallelism():
    from repro_torch.launch.mesh import describe_mesh
    from repro_torch.models.transformer import param_shapes
    cfg = get_config("pixtral-12b").reduced(vocab=257)
    mesh = describe_mesh((1, 2), ("data", "model"))
    with pytest.raises(ValueError, match="prefix before a replicated head"):
        msh.tensor_parallel(cfg, param_shapes(cfg), mesh, seq_parallel=True)
    tp = msh.tensor_parallel(cfg, param_shapes(cfg), mesh,
                             seq_parallel=False)
    assert not tp.vocab_parallel and tp.enc_seq_parallel is None


def test_traps_of_the_bias_the_encoder_and_the_prefix(spawned):
    """``bo`` added once, the encoder's replicated leaves reduced by its
    own stream's rule, the encoder output's gradient summed over the
    cross-attention heads, the patch rows counted once; each trap
    sprung wrong (the mutations miss the tolerance)."""
    outs, _ = spawned
    traps = [o["traps"] for o in outs if o["traps"] is not None]
    assert len(traps) == 2
    for t in traps:
        w, p = t["whisper"], t["pixtral"]
        assert w["enc_seq_parallel"] is False and w["gathered"] == []
        assert w["vocab_parallel"] and p["vocab_parallel"]
        for r in (w["right"], p["right"]):
            assert max(r.values()) <= TOL, r
        assert w["bo_everywhere"]["loss"] > TOL
        assert w["bo_everywhere"]["bo"] > TOL, w["bo_everywhere"]
        # the forward is right, the encoder's replicated leaves M times
        assert w["enc_reduced"]["loss"] <= TOL
        assert w["enc_reduced"]["enc_replicated"] > TOL, w["enc_reduced"]
        assert w["enc_unsummed"]["loss"] <= TOL
        assert w["enc_unsummed"]["encoder"] > TOL, w["enc_unsummed"]
        bad = p["patches_everywhere"]
        assert min(bad["loss"], bad["whole"], bad["frontend_proj"]) > TOL, \
            bad
