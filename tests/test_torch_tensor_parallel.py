"""The port's tensor parallelism over the ``model`` axis against JAX.

One spawn of 4 gloo ranks (``spawn_local``) runs every case; the JAX
side runs here, where JAX sees one device.  Weights have the layout of
JAX's ``init_params`` of reduced configs (``ModelConfig.reduced``, d 64,
vocab 256, 2 layers; heads set so that the cut is whole heads at M = 2
and inside a KV head at M = 4) and, like the tokens, are drawn with
numpy from a seed (norm scales and biases away from 1 and 0):

* rfast-100m and qwen2.5-3b (tied, qkv biases) on a (2, 2) mesh (two
  nodes, two model ranks each: column / row blocks of whole heads),
  rfast-100m with sequence parallelism on and off, qwen with
  ``ce="full"``; rfast-100m and qwen on a (1, 4) mesh, where the spec
  cuts inside a KV head and the attention takes the gather path.  The
  gradient at x0 and 3 rounds of ``make_sharded_round`` over the
  tensor-parallel gradient, each gathered whole
  (``models.sharding.gather_tree``), within 1e-4 (the ppermute round's
  ``TOL``) of JAX's unsharded ``jax.value_and_grad(loss_fn)`` and its
  dense ``make_rfast_round``; the loss the same on every rank of a
  model group, and the replicated leaves bitwise equal across it after
  the 3 rounds;
* each rank's local leaves have the shapes of ``NamedSharding(mesh,
  spec).shard_shape`` of the reference's PartitionSpecs of the R-FAST
  state (node axes leading);
* ``launch.specs.build_train(comm="ppermute")`` materialized on the
  ranks of a (2, 2) mesh from seed 0: its arguments' bytes a rank equal
  the meta case's, and one round gathered equals the dense case's round
  on the same seeds;
* RF206: the tensor-parallel round audits clean, and a round that
  all-reduces a state row over ``model`` is reported;
* on meta: llama3-8b and falcon-mamba-7b ``train_4k`` on the production
  (32, 8) mesh hold 7 rows of ``param_shard_elements_per_rank`` bf16
  elements and their batch, exactly, and say ``"model_axis": "tensor"``.

The SSM archs (reduced, d 64, d_inner 128): falcon-mamba-7b (no
attention, no MLP; vocab-parallel) and hymba-1.5b at vocab 257, so that
its embedding and head stay replicated as at 32001, with 5 heads and 1
KV head, which take the gathered attention; each on (2, 2) with
sequence parallelism and on (1, 4) without.  JAX's side scans with
``lax.scan`` as its model does; the port's scan runs its plain twins.
On ranks 0-1 (a (1, 2) mesh) the two traps of the layout at falcon's
reduced width: the SSM block's gradients (``x_proj``, ``in_proj``, the
block's input) and the replicated head's, with and without sequence
parallelism, against the unsharded ones, and the same with a
forward-only all-reduce of ``x_proj``'s partial sums or an all-reduced
gradient at the replicated head, which miss the tolerance.

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
from repro_torch.core.paramvec import make_ravel_spec, ravel
from repro_torch.core.runtime_sharded import (all_reduce_sum,
                                              clear_collectives,
                                              collective_stats,
                                              init_sharded_state,
                                              make_sharded_round, rank_block,
                                              shard_state)
from repro_torch.launch import specs
from repro_torch.launch.dryrun import _distinct_bytes
from repro_torch.launch.mesh import describe_mesh, make_sweep_mesh
from repro_torch.launch.multihost import spawn_local
from repro_torch.models import sharding as msh
from repro_torch.models.transformer import loss_fn, params_from_jax

TOL = 1e-4
GAMMA, ROUNDS, B, S = 0.05, 3, 2, 16
CFGS = {"rfast": ("rfast-100m", dict(n_heads=4, n_kv_heads=2, head_dim=24)),
        "qwen": ("qwen2.5-3b", dict(n_heads=4, n_kv_heads=2, head_dim=16)),
        "falcon": ("falcon-mamba-7b", {}),
        "hymba": ("hymba-1.5b", dict(vocab=257)),
        # the traps' config: falcon with a replicated head
        "falcon_rep": ("falcon-mamba-7b", dict(vocab=257))}
SSM_KEYS = ("falcon", "hymba")
# (config, mesh (nodes, model ranks), sequence parallel)
CASES = [("rfast", (2, 2), True), ("rfast", (2, 2), False),
         ("qwen", (2, 2), True), ("rfast", (1, 4), True),
         ("qwen", (1, 4), False), ("falcon", (2, 2), True),
         ("falcon", (1, 4), False), ("hymba", (2, 2), True),
         ("hymba", (1, 4), False)]
FIELDS = ("x", "z", "g_prev")
LIVE = dict(seq=S, global_batch=2 * B, dtype=torch.float32, impl="plain",
            seed=0)


def _cfg(key, get=get_config):
    name, kw = CFGS[key]
    return dc.replace(get(name).reduced(max_d_model=64, vocab=256), **kw)


def _data(key, n):
    """(tokens, labels), (n, B, S) int32 each."""
    rng = np.random.default_rng(10 * list(CFGS).index(key) + n)
    vocab = _cfg(key).vocab
    return tuple(rng.integers(0, vocab, (n, B, S)).astype(np.int32)
                 for _ in range(2))


def _case_rank(cfg, mesh, np_tree, data, sp, ce, audit):
    """One case on this rank: the tensor-parallel gradient at x0 and 3
    rounds, each gathered whole."""
    full, _ = params_from_jax(np_tree, device="cpu")
    tp = msh.tensor_parallel(cfg, full, mesh, seq_parallel=sp)
    local = msh.local_tree(full, tp)
    spec = make_ravel_spec(local)
    grad = msh.tensor_parallel_grad(spec, lambda p, b, k: loss_fn(
        cfg, p, b[0], b[1], remat=True, ce=ce), tp)
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
    coll = collective_stats()
    rep = [(off, int(np.prod(shape))) for path, shape, off in zip(
        spec.paths, spec.shapes, spec.offsets) if tp.dims[path] is None]
    out = {"node": node, "model": tp.index, "loss0": float(loss0),
           "g0": whole(g0), "losses": metrics["losses"].numpy(),
           "gathered": sorted("/".join(b) for b in tp.gathered),
           "vocab_parallel": tp.vocab_parallel,
           "shapes": {"/".join(k): shape
                      for k, shape in zip(spec.paths, spec.shapes)},
           "replicated": np.concatenate([st.x[0, o:o + n].numpy()
                                         for o, n in rep]),
           "coll": {k: v["calls"] for k, v in coll["by_name"].items()}}
    out.update({f: whole(getattr(st, f)[0]) for f in FIELDS})
    if audit:
        run = lambda s: rf(s, blk)
        group = tp.group
        out["audit"] = [d.code for d in torchlint.audit_tensor_parallel_round(
            run, st, subject="tp_round")]
        out["altered"] = [d.code for d in torchlint.audit_tensor_parallel_round(
            lambda s: (all_reduce_sum(s.x, group), run(s))[1], st,
            subject="tp_round_altered")]
    return out


def _live_rank():
    """``build_train(comm="ppermute")`` materialized on a (2, 2) mesh: its
    argument bytes beside the meta case's, one round gathered whole."""
    cfg = _cfg("rfast")
    mesh = make_sweep_mesh(lanes=2, param_shards=2)
    fn, (st, batch, _) = specs.build_train(cfg, mesh, comm="ppermute",
                                           device="cpu", **LIVE)
    meta_fn, meta_args = specs.build_train(
        cfg, describe_mesh((2, 2), ("data", "model"), rank=mesh.rank),
        comm="ppermute", **LIVE)
    live_bytes = _distinct_bytes(specs.tensors_of((st, batch)))
    st, _ = fn(st, batch)
    return {"node": mesh.coords["data"], "info": fn.info,
            "live_bytes": live_bytes,
            "meta_bytes": _distinct_bytes(specs.tensors_of(meta_args)),
            "x": msh.gather_flat(st.x[0], fn.ravel_spec,
                                 fn.tensor_parallel).numpy()}


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _block_errors(cfg, tp, lp, h, w):
    """The SSM block of layer params ``lp`` on this rank's channels
    (``parallel_block`` without sequence parallelism) against the whole
    block: the relative error of the output and of the gradients of
    x_proj, in_proj, conv_w (this rank's blocks) and the block's
    input."""
    from repro_torch.models.ssm import ssm_apply
    key = ("layers", "ssm")
    whole = {k: v.clone().requires_grad_() for k, v in lp.items()}
    h0 = h.clone().requires_grad_()
    y0 = ssm_apply(cfg, whole, h0)
    (y0 * w).sum().backward()
    cut = lambda k, v: v if tp.dims[key + (k,)] is None else rank_block(
        v, tp.group, tp.dims[key + (k,)])
    local = {k: cut(k, v).clone().requires_grad_() for k, v in lp.items()}
    h1 = h.clone().requires_grad_()
    with msh.use_tensor_parallel(tp):
        y1 = msh.parallel_block(key, local, h1,
                                lambda p, x: ssm_apply(cfg, p, x))
    (y1 * w).sum().backward()
    blk = lambda k: cut(k, whole[k].grad)
    return {"y": _rel(y1.detach(), y0.detach()),
            "x_proj": _rel(local["x_proj"].grad, blk("x_proj")),
            "in_proj": _rel(local["in_proj"].grad, blk("in_proj")),
            "conv_w": _rel(local["conv_w"].grad, blk("conv_w")),
            "input": _rel(h1.grad, h0.grad)}


def _model_error(cfg, full, tp, batch):
    """The tensor-parallel gradient of the whole model gathered, against
    the unsharded gradient (relative to its largest entry)."""
    from repro_torch.core.paramvec import value_and_grad
    lf = lambda p, b, k: loss_fn(cfg, p, b[0], b[1], remat=True)
    local = msh.local_tree(full, tp)
    spec = make_ravel_spec(local)
    _, g = msh.tensor_parallel_grad(spec, lf, tp)(ravel(spec, local), batch,
                                                   None)
    fspec = make_ravel_spec(full)
    _, gd = value_and_grad(fspec, lf)(ravel(fspec, full), batch, None)
    return _rel(msh.gather_flat(g, spec, tp), gd)


def _traps_rank(tree):
    """Ranks 0-1 on a (1, 2) mesh, falcon at its reduced width with a
    replicated head: the SSM block and the whole model's gradient right,
    and each with one trap sprung (a forward-only all-reduce of
    ``x_proj``'s partial sums; an all-reduced gradient at the replicated
    head), against the unsharded ones."""
    from repro_torch.core import runtime_sharded as rs
    mesh = make_sweep_mesh(lanes=1, param_shards=2, ranks=range(2))
    if mesh.coords is None:
        return None
    cfg = _cfg("falcon_rep")
    full, _ = params_from_jax(tree, device="cpu")
    rng = np.random.default_rng(7)
    h = torch.from_numpy(rng.normal(0, 1, (B, S, cfg.d_model)).astype(
        np.float32))
    w = torch.from_numpy(rng.normal(0, 1, (B, S, cfg.d_model)).astype(
        np.float32))
    lp = {k: v[0] for k, v in full["layers"]["ssm"].items()}
    toks, labels = (torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))
                                     ).int() for _ in range(2))
    tps = {sp: msh.tensor_parallel(cfg, full, mesh, seq_parallel=sp)
           for sp in (False, True)}
    out = {"vocab_parallel": tps[False].vocab_parallel,
           "block": _block_errors(cfg, tps[False], lp, h, w),
           "model": {sp: _model_error(cfg, full, tp, (toks, labels))
                     for sp, tp in tps.items()}}
    ssm_proj, to_head = msh.ssm_proj, msh.to_head
    g = tps[False].group
    try:        # MUTATION: x_proj's partial sums all-reduced forward only
        msh.ssm_proj = lambda t, di, c: (t if c == di else
                                         rs.reduce_from_model(t, g))
        out["block_forward_only"] = _block_errors(cfg, tps[False], lp, h, w)
    finally:
        msh.ssm_proj = ssm_proj
    try:        # MUTATION: the replicated head's input copied to the model
        msh.to_head = lambda x: (x if msh.current_tensor_parallel() is None
                                 else rs.copy_to_model(x, g))
        out["model_copied_head"] = _model_error(cfg, full, tps[False],
                                                (toks, labels))
    finally:
        msh.to_head = to_head
    return out


def _tp_rank(trees, data):
    outs = []
    for i, (key, (D, M), sp) in enumerate(CASES):
        mesh = make_sweep_mesh(lanes=D, param_shards=M)
        outs.append(_case_rank(_cfg(key), mesh, trees[key], data[(key, D)],
                               sp, CES[key], audit=i == 0))
    return {"cases": outs, "live": _live_rank(),
            "traps": _traps_rank(trees["falcon_rep"])}


# the cross entropy a config
CES = {"rfast": "lse", "qwen": "full", "falcon": "lse", "hymba": "full",
       "falcon_rep": "lse"}


def _tree(key):
    """Weights in the layout of JAX's ``init_params`` (its shapes, from
    ``jax.eval_shape``), drawn with numpy: dense weights N(0, 1)·d_in^-½,
    the embedding N(0, 1)·0.02, norm scales 1 + N(0, 0.1), biases
    N(0, 0.1), so that every leaf's gradient is exercised."""
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


def _jax_inputs():
    """The weights (numpy, JAX's layout) and the data, by (config,
    nodes)."""
    trees = {key: _tree(key) for key in CFGS}
    data = {(key, m[0]): _data(key, m[0]) for key, m, _ in CASES}
    return trees, data


def _jax_side(key, tree, data):
    """For one config, per node count: JAX's unsharded
    ``value_and_grad`` of every node at x0, and the dense round's state
    after 3 rounds from the reference's init (``init_protocol_state``
    over those gradients), as flat numpy rows in the ravel order."""
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
        jcfg, p, b[0], b[1], ce=CES[key])))

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
    trees, data = _jax_inputs()
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


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{k}-{d}x{m}-sp{int(sp)}"
                              for k, (d, m), sp in CASES])
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
    misaligned = cfg.n_heads and (cfg.n_heads % M or cfg.n_kv_heads % M)
    assert {tuple(r["gathered"]) for r in _ranks(outs, i)} == {
        ("layers/attn",) if misaligned else ()}
    # vocab 257 does not divide over the model group: a replicated head
    assert {r["vocab_parallel"] for r in _ranks(outs, i)} == {
        cfg.vocab % M == 0}


@pytest.mark.parametrize("i", range(len(CASES)))
def test_replicated_leaves_bitwise_across_the_model_group(spawned, i):
    outs, _ = spawned
    by_node: dict = {}
    for r in _ranks(outs, i):
        by_node.setdefault(r["node"], []).append(r["replicated"])
    for reps in by_node.values():
        assert len(reps) == CASES[i][1][1] and reps[0].size > 0
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
        for r in _ranks(outs, i):
            assert r["shapes"] == want


def test_collectives_and_rf206(spawned):
    outs, _ = spawned
    for r in _ranks(outs, 0):             # rfast (2, 2), sequence parallel
        c = r["coll"]
        assert c["all_gather_seq"] > 0 and c["reduce_scatter_seq"] > 0
        # a gradient: the max, the sum of exponentials, the target logit
        # and the replicated leaves' gradients
        assert c["all_reduce_max"] == ROUNDS
        assert c["all_reduce_sum"] == 3 * ROUNDS
        assert r["audit"] == [] and r["altered"] == ["RF206"]
    for r in _ranks(outs, 1):             # no sequence parallelism
        assert "reduce_scatter_seq" not in r["coll"]
    for i, (key, _, sp) in enumerate(CASES):
        for r in _ranks(outs, i):
            assert ("reduce_scatter_seq" in r["coll"]) == sp, (key, sp)
            # the SSM block's exchange of in_proj's column chunks
            assert ("all_to_all" in r["coll"]) == (key in SSM_KEYS)


def test_build_train_live_ppermute_matches_the_dense_case(spawned):
    outs, _ = spawned
    cfg = _cfg("rfast")
    fn, (st, batch, _) = specs.build_train(
        cfg, describe_mesh((2, 2), ("data", "model")), comm="dense",
        device="cpu", **LIVE)
    st, _ = fn(st, batch)
    for o in outs:
        live = o["live"]
        assert live["info"]["model_axis"] == "tensor"
        assert live["info"]["tensor_parallel"] == {
            "ranks": 2, "gathered": [], "vocab_parallel": True}
        assert live["live_bytes"] == live["meta_bytes"]
        assert live["live_bytes"] == 4 * (5 * live["info"]["p"]
                                          + 2 * B * S)
        np.testing.assert_allclose(live["x"], st.x[live["node"]].numpy(),
                                   rtol=TOL, atol=TOL)


def _train_4k_meta_rows(arch, tensor_parallel):
    from repro_torch.launch.dryrun import _gspmd
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shardings import RULES_BASE
    fn, args = specs.input_specs(arch, "train_4k")
    state, batch, _ = args
    per_rank = _gspmd(get_config(arch), make_production_mesh(),
                      RULES_BASE)["param_shard_elements_per_rank"]
    batch_bytes = sum(t.numel() * t.element_size() for t in batch)
    assert fn.info["model_axis"] == "tensor" and fn.info["p"] == per_rank
    assert fn.info["tensor_parallel"] == tensor_parallel
    assert _distinct_bytes(specs.tensors_of(args)) == \
        7 * per_rank * 2 + batch_bytes
    assert batch_bytes == 2 * 8 * 4096 * 4


def test_llama_train_4k_meta_arguments_are_the_shard_rows():
    _train_4k_meta_rows("llama3-8b", {"ranks": 8, "gathered": [],
                                      "vocab_parallel": True})


def test_falcon_mamba_train_4k_meta_arguments_are_the_shard_rows():
    _train_4k_meta_rows("falcon-mamba-7b", {"ranks": 8, "gathered": [],
                                            "vocab_parallel": True})


def test_hymba_build_train_is_tensor_parallel_with_a_replicated_vocab():
    fn, _ = specs.build_train(get_config("hymba-1.5b").reduced(vocab=257),
                              describe_mesh((2, 2), ("data", "model")),
                              seq=16, global_batch=4)
    assert fn.info["model_axis"] == "tensor"
    assert fn.info["tensor_parallel"] == {
        "ranks": 2, "gathered": ["layers/attn"], "vocab_parallel": False}


def test_other_archs_keep_the_replicated_model_axis():
    """Every arch of the repo runs its ``model`` axis tensor-parallel
    (since the enc-dec and frontend archs do, whisper-large-v3 and
    pixtral-12b among them); what keeps the axis replicated is a layout
    the port does not run: a spec over another axis (the FSDP rules'
    ``embed`` -> ``data``) is refused, and the dense round (one process
    for every node) holds whole rows."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.shardings import RULES_FSDP
    from repro_torch.models.transformer import param_shapes
    assert len(ARCHS) == 11
    assert all(msh.tensor_parallel_supported(get_config(a)) for a in ARCHS)
    mesh = describe_mesh((2, 2), ("data", "model"))
    for arch in ("pixtral-12b", "whisper-large-v3"):
        cfg = get_config(arch).reduced()
        fn, _ = specs.build_train(cfg, mesh, seq=32, global_batch=4)
        assert fn.info["model_axis"] == "tensor"
        assert fn.info["seq_parallel"]
        fn, _ = specs.build_train(cfg, mesh, seq=32, global_batch=4,
                                  comm="dense")
        assert fn.info["model_axis"] == "replicated"
    cfg = get_config("pixtral-12b").reduced()
    with pytest.raises(ValueError, match="shards over 'data'; the port's "
                       "tensor parallelism runs the 'model' axis only"):
        msh.tensor_parallel(cfg, param_shapes(cfg),
                            describe_mesh((2, 2), ("data", "model")),
                            rules=RULES_FSDP, node_axes=())


def test_traps_of_the_ssm_block_and_the_replicated_head(spawned):
    """x_proj's all-reduce pair and the replicated head right, each trap
    sprung wrong (the mutations miss the tolerance)."""
    outs, _ = spawned
    traps = [o["traps"] for o in outs if o["traps"] is not None]
    assert len(traps) == 2
    for t in traps:
        assert t["vocab_parallel"] is False
        assert max(t["block"].values()) <= TOL, t["block"]
        assert max(t["model"].values()) <= TOL, t["model"]
        bad = t["block_forward_only"]
        assert bad["y"] <= TOL      # the forward is right, the gradient not
        assert min(bad[k] for k in ("x_proj", "conv_w", "input")) > TOL, bad
        assert t["model_copied_head"] > TOL
    # at M = 2 rank 0's in_proj block is x's columns, rank 1's z's (the
    # gate's, which x_proj does not reach)
    assert traps[0]["block_forward_only"]["in_proj"] > TOL


def _refuse(name):
    def f(*a, **k):
        raise AssertionError(f"{name} ran on meta tensors")
    return f


def test_model_collectives_on_meta_record_and_send_nothing(monkeypatch):
    """The model group's collectives and their autograd pairs over a
    described mesh: meta outputs of the right shapes, forward and
    backward, each recorded with its bytes, group and link; no call
    into ``torch.distributed``."""
    import torch.distributed as dist

    from repro_torch.core import runtime_sharded as rs
    for n in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
              "reduce_scatter_single", "all_to_all_single", "get_rank",
              "get_backend"):
        if hasattr(dist, n):
            monkeypatch.setattr(dist, n, _refuse(f"dist.{n}"))
    mesh = describe_mesh((4, 8), ("data", "model"), rank=9)
    g = mesh.group("model")
    m = lambda *s: torch.empty(s, device="meta", requires_grad=True)
    with rs.record_collectives() as colls:
        assert rs.all_reduce_sum(m(2, 3), g).shape == (2, 3)
        assert rs.all_reduce_max(m(2, 3), g).shape == (2, 3)
        assert rs.all_gather_seq(m(2, 4, 3), g, 1).shape == (2, 32, 3)
        assert rs.reduce_scatter_seq(m(2, 16, 3), g, -2).shape == (2, 2, 3)
        assert rs.all_to_all_rows(m(2, 5), g, [0, 1, 1] + [0] * 5,
                                  [1, 0, 0, 0, 0, 1, 0, 0]).shape == (2, 5)
    assert [(c["name"], c["bytes"], c["group_size"], c["intra_host"])
            for c in colls] == [("all_reduce_sum", 24, 8, True),
                                ("all_reduce_max", 24, 8, True),
                                ("all_gather_seq", 768, 8, True),
                                ("reduce_scatter_seq", 48, 8, True),
                                ("all_to_all", 40, 8, True)]
    with pytest.raises(ValueError, match="does not divide"):
        rs.reduce_scatter_seq(m(2, 12, 3), g, 1)
    pairs = [(rs.copy_to_model, (2, 16, 3), (2, 16, 3), ["all_reduce_sum"]),
             (rs.reduce_from_model, (2, 16, 3), (2, 16, 3),
              ["all_reduce_sum"]),
             (lambda x, g: rs.gather_from_model(x, g, -1), (2, 16, 3),
              (2, 16, 24), ["all_gather_seq"]),
             (rs.gather_from_seq, (2, 4, 3), (2, 32, 3),
              ["all_gather_seq", "reduce_scatter_seq"]),
             (rs.reduce_scatter_to_seq, (2, 16, 3), (2, 2, 3),
              ["reduce_scatter_seq", "all_gather_seq"]),
             (lambda x, g: rs.all_to_all_model(x, g, [1, 1] + [0] * 6,
                                               [0] * 7 + [2]), (2, 4, 3),
              (2, 4, 3), ["all_to_all", "all_to_all"])]
    for fn, shape, out, names in pairs:
        x = m(*shape)
        with rs.record_collectives() as colls:
            y = fn(x, g)
            y.sum().backward()
        assert y.shape == out and x.grad.shape == shape
        assert [c["name"] for c in colls] == names
