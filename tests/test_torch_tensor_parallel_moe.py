"""The port's ``model`` axis tensor-parallel for the MoE and MLA archs
against JAX: experts over ``model``, MLA's heads column-parallel.

One spawn of 4 gloo ranks (``spawn_local``) runs every case; the JAX
side runs here, where JAX sees one device.  Weights have the layout of
JAX's ``init_params`` of reduced configs (``ModelConfig.reduced``, d 64,
vocab 256, 2 layers, 4 experts top-2; deepseek-v2 with 1 shared expert
and MLA's 4 heads, phi3.5-moe with 4 heads and 2 KV heads, so that M = 2
cuts whole heads and M = 4 cuts inside a KV head, where phi's attention
takes the gathered path) and, like the tokens, are drawn with numpy
from a seed:

* phi3.5-moe and deepseek-v2 on a (2, 2) mesh with sequence parallelism
  and on a (1, 4) mesh without, and deepseek-v2 at ``capacity_factor``
  0.25 (C = 8 for T = 32 tokens: tokens dropped) on (1, 4): the gradient
  at x0 and 3 rounds of ``make_sharded_round``, each gathered whole
  (``models.sharding.gather_tree``), within 1e-4 of JAX's unsharded
  ``jax.value_and_grad(loss_fn)`` and its dense ``make_rfast_round``;
  the loss the same on every rank of a model group; the replicated
  leaves (the router and MLA's down-projections among them) bitwise
  equal across it after the 3 rounds; every rank's routes (each
  token's experts and whether it was kept) at x0 equal, and equal to
  the unsharded model's;
* each rank's local leaves have the shapes of ``NamedSharding(mesh,
  spec).shard_shape`` of the reference's PartitionSpecs;
* on meta: phi3.5-moe ``train_4k`` on the production (32, 8) mesh holds
  7 rows of ``param_shard_elements_per_rank`` bf16 elements and says
  ``"model_axis": "tensor"``, and its dry-run counts the MoE block's
  all-reduces under ``all-reduce``;
* on ranks 0-1 (a (1, 2) mesh, deepseek-v2 without sequence
  parallelism) the traps of the layout: the gradient right, and wrong
  (beyond the tolerance) with the router's gradient not summed over the
  model group, with MLA's down-projections' not summed, or with the
  router loss computed whole on every rank.

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
from repro_torch.models import moe as moe_mod
from repro_torch.models import sharding as msh
from repro_torch.models.transformer import loss_fn, params_from_jax

TOL = 1e-4
GAMMA, ROUNDS, B, S = 0.05, 3, 2, 16
CFGS = {"phi": ("phi3.5-moe-42b-a6.6b", dict(n_kv_heads=2)),
        "dsv2": ("deepseek-v2-236b", {}),
        "dsv2_drop": ("deepseek-v2-236b", dict(capacity_factor=0.25))}
# (config, mesh (nodes, model ranks), sequence parallel)
CASES = [("phi", (2, 2), True), ("phi", (1, 4), False),
         ("dsv2", (2, 2), True), ("dsv2", (1, 4), False),
         ("dsv2_drop", (1, 4), False)]
FIELDS = ("x", "z", "g_prev")
MLA_DOWN = ("w_dkv", "c_scale", "w_kr", "q_a", "q_scale")


def _cfg(key, get=get_config):
    name, kw = CFGS[key]
    return dc.replace(get(name).reduced(max_d_model=64, vocab=256), **kw)


def _data(key, n):
    """(tokens, labels), (n, B, S) int32 each."""
    rng = np.random.default_rng(10 * list(CFGS).index(key) + n)
    vocab = _cfg(key).vocab
    return tuple(rng.integers(0, vocab, (n, B, S)).astype(np.int32)
                 for _ in range(2))


def _routes(fn):
    """``fn()`` with every ``moe._slots`` call's (experts, kept) recorded:
    ``(fn(), [(expert_idx, keep), ...])`` as numpy arrays."""
    seen, slots = [], moe_mod._slots

    def rec(cfg, expert_idx, C):
        pos, keep = slots(cfg, expert_idx, C)
        seen.append((expert_idx.numpy().copy(), keep.numpy().copy()))
        return pos, keep
    moe_mod._slots = rec
    try:
        return fn(), seen
    finally:
        moe_mod._slots = slots


def _case_rank(cfg, mesh, np_tree, data, sp, audit):
    """One case on this rank: the routes and the tensor-parallel gradient
    at x0, the unsharded model's routes, 3 rounds, each gathered
    whole."""
    full, _ = params_from_jax(np_tree, device="cpu")
    tp = msh.tensor_parallel(cfg, full, mesh, seq_parallel=sp)
    local = msh.local_tree(full, tp)
    spec = make_ravel_spec(local)
    lf = lambda p, b, k: loss_fn(cfg, p, b[0], b[1], remat=True)
    grad = msh.tensor_parallel_grad(spec, lf, tp)
    whole = lambda flat: msh.gather_flat(flat, spec, tp).numpy()
    na = ("data",)
    topo = binary_tree(mesh.shape["data"])
    batches = tuple(torch.from_numpy(a) for a in data)
    node = mesh.coords["data"]
    mine = tuple(t[node] for t in batches)
    (loss0, g0), routes = _routes(lambda: grad(ravel(spec, local), mine,
                                               None))
    fspec = make_ravel_spec(full)
    _, whole_routes = _routes(lambda: value_and_grad(fspec, lf)(
        ravel(fspec, full), mine, None))
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
           "partial": sorted("/".join(b) for b in tp.partial),
           "expert_parallel": tp.expert_parallel,
           "shapes": {"/".join(k): shape
                      for k, shape in zip(spec.paths, spec.shapes)},
           "replicated_paths": ["/".join(p) for p, _, _ in rep],
           "replicated": np.concatenate([st.x[0, o:o + n].numpy()
                                         for _, o, n in rep]),
           "routes": routes, "whole_routes": whole_routes,
           "coll": {k: v["calls"]
                    for k, v in collective_stats()["by_name"].items()}}
    out.update({f: whole(getattr(st, f)[0]) for f in FIELDS})
    if audit:
        out["audit"] = [d.code for d in torchlint.audit_tensor_parallel_round(
            lambda s: rf(s, blk), st, subject="tp_moe_round")]
    return out


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _leaf_errors(cfg, full, tp, batch):
    """The tensor-parallel gradient gathered whole against the unsharded
    one: the relative error (to each one's largest entry) of the whole
    vector and of the router's and MLA's down-projections' leaves."""
    lf = lambda p, b, k: loss_fn(cfg, p, b[0], b[1], remat=True)
    local = msh.local_tree(full, tp)
    spec = make_ravel_spec(local)
    _, g = msh.tensor_parallel_grad(spec, lf, tp)(ravel(spec, local), batch,
                                                   None)
    fspec = make_ravel_spec(full)
    _, gd = value_and_grad(fspec, lf)(ravel(fspec, full), batch, None)
    gw = msh.gather_flat(g, spec, tp)
    out = {"whole": _rel(gw, gd)}
    for path, shape, off in zip(fspec.paths, fspec.shapes, fspec.offsets):
        if path[-1] in ("router",) + MLA_DOWN:
            n = int(np.prod(shape))
            out[path[-1]] = _rel(gw[off:off + n], gd[off:off + n])
    return out


def _traps_rank(tree):
    """Ranks 0-1 on a (1, 2) mesh, deepseek-v2 reduced, no sequence
    parallelism: the gradient right, and with each trap sprung."""
    mesh = make_sweep_mesh(lanes=1, param_shards=2, ranks=range(2))
    if mesh.coords is None:
        return None
    cfg = _cfg("dsv2")
    full, _ = params_from_jax(tree, device="cpu")
    rng = np.random.default_rng(7)
    batch = tuple(torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))).int()
                  for _ in range(2))
    tp = msh.tensor_parallel(cfg, full, mesh, seq_parallel=False)
    router = {p for p in tp.partial if p[-1] == "router"}
    out = {"right": _leaf_errors(cfg, full, tp, batch),
           # MUTATION: the router's partial gradients left unsummed
           "router_unsummed": _leaf_errors(cfg, full, dc.replace(
               tp, partial=tp.partial - router), batch),
           # MUTATION: MLA's down-projections' partial gradients unsummed
           "mla_unsummed": _leaf_errors(cfg, full, dc.replace(
               tp, partial=router), batch)}
    balance, router_loss = moe_mod._balance_loss, msh.router_loss
    try:        # MUTATION: every rank's router loss over all the experts
        moe_mod._balance_loss = lambda c, p, t, e: balance(c, p, t,
                                                           slice(None))
        msh.router_loss = lambda aux: aux
        out["aux_whole"] = _leaf_errors(cfg, full, tp, batch)
    finally:
        moe_mod._balance_loss, msh.router_loss = balance, router_loss
    return out


def _tp_rank(trees, data):
    outs = []
    for i, (key, (D, M), sp) in enumerate(CASES):
        mesh = make_sweep_mesh(lanes=D, param_shards=M)
        outs.append(_case_rank(_cfg(key), mesh, trees[key], data[(key, D)],
                               sp, audit=i == 0))
    return {"cases": outs, "traps": _traps_rank(trees["dsv2"])}


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
        if len(leaf.shape) >= 2:
            return z / np.sqrt(leaf.shape[-2])
        return 0.1 * z
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_side(key, tree, data):
    """For one config, per node count: JAX's unsharded
    ``value_and_grad`` of every node at x0, and the dense round's state
    after 3 rounds from the reference's init, as flat numpy rows in the
    ravel order."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.core import binary_tree as jbinary_tree
    from repro.core.protocol import init_protocol_state
    from repro.core.runtime import edge_arrays, make_rfast_round
    from repro.models.transformer import loss_fn as jloss
    jcfg = _cfg(key, jget)
    params = jax.tree.map(jnp.asarray, tree)
    vg = jax.jit(jax.value_and_grad(lambda p, b, k: jloss(jcfg, p, b[0],
                                                          b[1])))

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
    mla = cfg.attention == "mla"
    misaligned = cfg.n_heads % M or (not mla and cfg.n_kv_heads % M)
    for r in _ranks(outs, i):
        assert r["gathered"] == (["layers/attn"] if misaligned else [])
        assert r["expert_parallel"]
        assert r["partial"] == sorted(
            ["layers/mlp/router"]
            + [f"layers/attn/{k}" for k in MLA_DOWN if mla])


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_replicated_leaves_bitwise_across_the_model_group(spawned, i):
    outs, _ = spawned
    by_node: dict = {}
    for r in _ranks(outs, i):
        assert "layers/mlp/router" in r["replicated_paths"]
        by_node.setdefault(r["node"], []).append(r["replicated"])
    for reps in by_node.values():
        assert len(reps) == CASES[i][1][1] and reps[0].size > 0
        for rep in reps[1:]:
            assert np.array_equal(rep, reps[0])


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_every_rank_routes_as_the_unsharded_model(spawned, i):
    outs, _ = spawned
    key, (D, M), _ = CASES[i]
    cfg = _cfg(key)
    drops: dict = {}
    for r in _ranks(outs, i):
        # the layers once forward and once recomputed (remat)
        assert len(r["routes"]) == 2 * cfg.n_layers
        assert len(r["whole_routes"]) == 2 * cfg.n_layers
        for (e, k), (we, wk) in zip(r["routes"], r["whole_routes"]):
            assert np.array_equal(e, we) and np.array_equal(k, wk)
        drops.setdefault(r["node"], set()).add(
            sum(int((~k).sum()) for _, k in r["routes"]))
    # one drop count a node (its model group)
    assert all(len(d) == 1 for d in drops.values()), drops
    if cfg.capacity_factor < 1:
        # C = 8 slots an expert for 32 tokens at top-2 of 4: tokens dropped
        assert moe_mod._capacity(cfg, B * S) == 8
        assert all(min(d) > 0 for d in drops.values()), drops


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
            # E / M experts a rank, the router whole
            assert r["shapes"]["layers/mlp/experts/wi"][1] == \
                cfg.moe_experts // M
            assert r["shapes"]["layers/mlp/router"] == (
                cfg.n_layers, cfg.d_model, cfg.moe_experts)


def test_collectives_and_rf206(spawned):
    outs, _ = spawned
    for r in _ranks(outs, 0):             # phi (2, 2), sequence parallel
        assert r["audit"] == []
    for i, (key, _, sp) in enumerate(CASES):
        for r in _ranks(outs, i):
            assert ("reduce_scatter_seq" in r["coll"]) == sp, (key, sp)
            # the cross entropy's max: one a gradient, one a round
            assert r["coll"]["all_reduce_max"] == ROUNDS


def test_phi_moe_train_4k_meta_arguments_are_the_shard_rows():
    from repro_torch.launch.dryrun import _gspmd, run_case
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shardings import RULES_BASE
    arch = "phi3.5-moe-42b-a6.6b"
    fn, args = specs.input_specs(arch, "train_4k")
    state, batch, _ = args
    per_rank = _gspmd(get_config(arch), make_production_mesh(),
                      RULES_BASE)["param_shard_elements_per_rank"]
    batch_bytes = sum(t.numel() * t.element_size() for t in batch)
    assert fn.info["model_axis"] == "tensor" and fn.info["p"] == per_rank
    assert fn.info["tensor_parallel"] == {"ranks": 8, "gathered": [],
                                          "vocab_parallel": True}
    assert _distinct_bytes(specs.tensors_of(args)) == \
        7 * per_rank * 2 + batch_bytes
    del fn, args, state, batch
    rec = run_case(arch, "train_4k", fit=False, verbose=False,
                   cfg=dc.replace(get_config(arch), n_layers=2))
    assert rec["ok"] and rec["model_axis"] == "tensor"
    # sequence parallel: the router loss, the cross entropy's sum of
    # exponentials and target logit, the replicated leaves' gradients
    # (the router's among them), and the max
    assert rec["collectives_scanned"]["all-reduce"]["count"] == 5


def test_deepseek_v2_build_train_is_tensor_parallel():
    from repro_torch.launch.mesh import describe_mesh
    cfg = get_config("deepseek-v2-236b").reduced()
    assert msh.tensor_parallel_supported(cfg)
    fn, _ = specs.build_train(cfg, describe_mesh((2, 2), ("data", "model")),
                              seq=16, global_batch=4)
    assert fn.info["model_axis"] == "tensor"
    assert fn.info["tensor_parallel"] == {"ranks": 2, "gathered": [],
                                          "vocab_parallel": True}
    assert fn.tensor_parallel.partial == frozenset(
        [("layers", "mlp", "router")]
        + [("layers", "attn", k) for k in MLA_DOWN])


def test_traps_of_the_router_and_the_mla_down_projections(spawned):
    """The router's and MLA's down-projections' gradients summed once
    over the model group, the router loss split by expert; each trap
    sprung wrong (the mutations miss the tolerance)."""
    outs, _ = spawned
    traps = [o["traps"] for o in outs if o["traps"] is not None]
    assert len(traps) == 2
    for t in traps:
        assert max(t["right"].values()) <= TOL, t["right"]
        assert min(t[k]["whole"] for k in ("router_unsummed", "mla_unsummed",
                                           "aux_whole")) > TOL, t
        assert t["router_unsummed"]["router"] > TOL, t["router_unsummed"]
        assert min(t["mla_unsummed"][k] for k in MLA_DOWN) > TOL, \
            t["mla_unsummed"]
        assert t["aux_whole"]["router"] > TOL, t["aux_whole"]
