"""The port's sharding specs against the reference's, leaf by leaf.

``repro_torch.launch.shardings`` and ``repro_torch.models.sharding`` are
copies of the reference's pure functions over leaf paths, shapes and a
mesh's sizes.  For all eleven archs, every parameter leaf's
PartitionSpec (the port's shapes from ``param_shapes`` on the meta
device, the reference's from ``jax.eval_shape(init_params)``) and every
decode cache leaf's (with and without ``seq_shard``) equals the
reference's, exactly, under ``RULES_BASE`` and ``RULES_FSDP``, on
``AbstractMesh`` (16, 16), (2, 16, 16), (32, 8) and (2, 32, 8) beside
the port's described meshes of the same sizes.  Shard shapes equal
``NamedSharding.shard_shape``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS
from repro.configs import get_config as jget
from repro.launch import mesh as jmesh
from repro.launch import shardings as jsh
from repro.models import sharding as jmsh
from repro.models.transformer import init_cache as jinit_cache
from repro.models.transformer import init_params as jinit
from repro_torch.configs import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shardings as tsh
from repro_torch.models import sharding as tmsh
from repro_torch.models.transformer import init_cache, param_shapes

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((32, 8), ("data", "model")),
          ((2, 32, 8), ("pod", "data", "model"))]
RULES = [(tsh.RULES_BASE, jsh.RULES_BASE), (tsh.RULES_FSDP, jsh.RULES_FSDP)]
DECODE = [("decode_32k", 32768, 128), ("long_500k", 524288, 1)]


def _meshes():
    return [(tmesh.describe_mesh(s, n), AbstractMesh(s, n)) for s, n in MESHES]


def _jflat(tree):
    """{key path: leaf} of a reference tree (dict keys only)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(str(getattr(p, "key", p)) for p in path)] = leaf
    return out


def _tflat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tflat(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


def _same(port, ref) -> bool:
    return isinstance(port, tmsh.PartitionSpec) and tuple(port) == tuple(ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch):
    cfg = get_config(arch)
    ptree = param_shapes(cfg, torch.bfloat16)
    rtree = jax.eval_shape(lambda k: jinit(jget(arch), k, jnp.bfloat16),
                           jax.random.PRNGKey(0))
    pshapes, rshapes = _tflat(ptree), _jflat(rtree)
    assert {k: tuple(v.shape) for k, v in pshapes.items()} == {
        k: tuple(v.shape) for k, v in rshapes.items()}
    for tm, jm in _meshes():
        for trules, jrules in RULES:
            port = _tflat(tsh.tree_pspecs(ptree, tm, trules))
            ref = _jflat(jsh.tree_pspecs(rtree, jm, jrules))
            assert port.keys() == ref.keys()
            bad = {k: (port[k], ref[k]) for k in ref
                   if not _same(port[k], ref[k])}
            assert not bad, (tm.shape, bad)
            lay = _tflat(tsh.tree_shardings(ptree, tm, trules))
            for k, (spec, block) in lay.items():
                assert block == NamedSharding(jm, JP(*spec)).shard_shape(
                    tuple(pshapes[k].shape)), k


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    ptree = param_shapes(cfg, torch.bfloat16)
    rtree = jax.eval_shape(lambda k: jinit(jcfg, k, jnp.bfloat16),
                           jax.random.PRNGKey(0))
    fd = (cfg.frontend_seq, cfg.frontend_dim or cfg.d_model)
    for shape, seq, batch in DECODE:
        if shape == "long_500k" and cfg.enc_dec:
            continue
        fr = (torch.empty((batch,) + fd, dtype=torch.bfloat16,
                          device="meta") if cfg.frontend else None)
        jfr = (jax.ShapeDtypeStruct((batch,) + fd, jnp.bfloat16)
               if cfg.frontend else None)
        pcache = init_cache(cfg, ptree, batch, seq, torch.bfloat16, fr)
        rcache = jax.eval_shape(
            lambda p, f: jinit_cache(jcfg, p, batch, seq, jnp.bfloat16, f),
            rtree, jfr)
        assert {k: tuple(v.shape) for k, v in _tflat(pcache).items()} == {
            k: tuple(v.shape) for k, v in _jflat(rcache).items()}
        for tm, jm in _meshes():
            baxes = tuple(a for a in tm.axis_names if a != "model")
            for seq_shard in (False, True):
                port = _tflat(tsh.cache_pspecs(pcache, tm, baxes,
                                               seq_shard=seq_shard))
                ref = _jflat(jsh.cache_pspecs(rcache, jm, baxes,
                                              seq_shard=seq_shard))
                bad = {k: (port[k], ref[k]) for k in ref
                       if not _same(port[k], ref[k])}
                assert not bad, (shape, tm.shape, seq_shard, bad)


def test_batch_specs_and_logical_specs_match_reference():
    for tm, jm in _meshes():
        for axes in [(), ("data",), tuple(a for a in tm.axis_names
                                          if a != "model")]:
            for shape in [(256, 4096), (32, 1), (1, 1), (48, 7, 3)]:
                p = tsh.batch_pspec(len(shape), tm, axes, shape)
                r = jsh.batch_pspec(len(shape), jm, axes, shape)
                assert _same(p, r), (tm.shape, axes, shape, p, r)
        rules = [(tmsh.DEFAULT_RULES, jmsh.DEFAULT_RULES),
                 (tmsh.FSDP_RULES, jmsh.FSDP_RULES)]
        cases = [(("batch", "seq", "embed"), (256, 4096, 4096)),
                 (("batch", "seq", "heads", "head_dim"), (8, 128, 32, 128)),
                 (("expert", "cap", "mlp"), (160, 64, 1536)),
                 (("vocab", "embed"), (51866, 1280)),
                 (("batch", "node", "embed"), (64, 32, 4096)),
                 ((None, "ssm_inner", "ssm_state"), (4, 3200, 16))]
        for (tr, jr) in rules:
            for axes, shape in cases:
                assert _same(tmsh.logical_to_spec(axes, tr, shape, tm),
                             jmsh.logical_to_spec(axes, jr, shape, jm))
                assert _same(tmsh.logical_to_spec(axes, tr),
                             jmsh.logical_to_spec(axes, jr))
                assert _same(tmsh.named_sharding(tm, tr, *axes).spec,
                             jmsh.named_sharding(jm, jr, *axes).spec)
    for parts in [(("pod", "data"), None, "model"), (("data",),), ((),),
                  (["a", "b"],), ()]:
        assert repr(tmsh.PartitionSpec(*parts)) == repr(JP(*parts))
        assert tuple(tmsh.PartitionSpec(*parts)) == tuple(JP(*parts))


def test_shard_raises_as_the_reference_does():
    x = np.zeros((2, 3))
    t = torch.zeros(2, 3)
    # no active mesh: a no-op in both, whatever the axes
    assert jmsh.shard(jnp.asarray(x), "batch") is not None
    assert tmsh.shard(t, "batch") is t
    jm = jax.make_mesh((1, 1), ("data", "model"))
    tm = tmesh.describe_mesh((1, 1), ("data", "model"))
    with jmsh.mesh_rules(jm), pytest.raises(ValueError, match="rank 2"):
        jmsh.shard(jnp.asarray(x), "batch")
    with tmsh.mesh_rules(tm), pytest.raises(ValueError, match="rank 2"):
        tmsh.shard(t, "batch")
    with tmsh.mesh_rules(tm):
        assert tmsh.shard(t, "batch", "embed") is t
        assert tmsh.current_rules() == (tm, tmsh.DEFAULT_RULES)
    assert tmsh.current_rules() is None


def test_production_mesh_and_hw():
    for multi_pod in (False, True):
        m = tmesh.make_production_mesh(multi_pod=multi_pod)
        names = ("pod", "data", "model") if multi_pod else ("data", "model")
        sizes = (2, 32, 8) if multi_pod else (32, 8)
        assert m.axis_names == names
        assert tuple(m.shape[a] for a in names) == sizes
        assert len(m.ranks) == (512 if multi_pod else 256)
        jm = AbstractMesh(sizes, names)
        assert tmesh.node_axes_for(m) == jmesh.node_axes_for(jm)
        if multi_pod:
            assert tmesh.node_axes_for(m, n_nodes=2) == ("pod",) == \
                jmesh.node_axes_for(jm, n_nodes=2)
        # the model axis is one host's 8 cards; the node axes cross hosts
        assert m.group("model").intra_host
        assert not m.group(tmesh.node_axes_for(m)).intra_host
    m = tmesh.make_production_mesh(rank=77)
    assert m.coords == {"data": 9, "model": 5}
    assert m.group("data").index == 9 and m.group("model").index == 5
    assert set(tmesh.HW) >= set(jmesh.HW) | {"ib_bw"}
    assert tmesh.HW == {"peak_flops_bf16": 989e12, "hbm_bw": 3.35e12,
                        "ici_bw": 450e9, "ib_bw": 50e9}
    with pytest.raises(ValueError):
        tmesh.describe_mesh((2, 2), ("data", "data"))
