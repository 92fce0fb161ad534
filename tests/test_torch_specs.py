"""The port's ``launch.specs`` against the reference's, on a 1 × 1 mesh.

For every (arch × shape) that ``shape_supported`` allows, at
``.reduced()`` configs, the arguments of the port's ``build_case`` (meta
tensors, one rank) have the global shapes and dtypes of the reference's
``build_case`` arguments (``ShapeDtypeStruct`` stand-ins): on a 1 × 1
mesh one rank holds everything.  Parameter trees and caches match leaf
by leaf; the train state is the port's flat vector, so each field's
rows hold exactly the reference's leaves' elements, with the leading
node / slot dims equal, in the one dtype of the reference's leaves
(``FP32_LEAVES`` aside).  The reference's per-node PRNG keys have no
counterpart (the port's gradient takes no key).  ``_long_variant``,
``act_rules`` and ``shape_supported`` equal the reference's.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as jget
from repro.launch import specs as jspecs
from repro_torch.configs import get_config
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import describe_mesh, make_production_mesh
from repro_torch.models.transformer import FP32_LEAVES


CASES = [(a, s) for a in ARCHS for s in tspecs.SHAPES
         if tspecs.shape_supported(get_config(a), s)[0]]


def _jflat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(str(getattr(p, "key", getattr(p, "name", p)))
                  for p in path)] = leaf
    return out


def _tflat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tflat(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


def _sd(leaf):
    return tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")


def _leaves_equal(port: dict, ref: dict):
    assert {k: _sd(v) for k, v in _tflat(port).items()} == {
        k: _sd(v) for k, v in _jflat(ref).items()}


def _state_matches(port_state, ref_state, dtype: str):
    assert port_state._fields == ref_state._fields
    for f in port_state._fields[1:]:
        t, r = getattr(port_state, f), getattr(ref_state, f)
        if r is None:
            assert t is None, f
            continue
        leaves = _jflat(r)
        lead = {v.shape[:t.dim() - 1] for v in leaves.values()}
        assert lead == {tuple(t.shape[:-1])}, (f, lead, t.shape)
        n_lead = t.dim() - 1
        assert t.shape[-1] == sum(int(np.prod(v.shape[n_lead:]))
                                  for v in leaves.values()), f
        assert str(t.dtype).replace("torch.", "") == dtype
        assert {str(v.dtype) for k, v in leaves.items()
                if k[-1] not in FP32_LEAVES} == {dtype}, f


@pytest.mark.parametrize("arch,shape", CASES)
def test_build_case_matches_reference(arch, shape):
    jcfg = jget(arch).reduced()
    cfg = get_config(arch).reduced()
    jfn, jargs = jspecs.build_case(jcfg, jax.make_mesh((1, 1),
                                                       ("data", "model")),
                                   shape)
    tfn, targs = tspecs.build_case(cfg, describe_mesh((1, 1),
                                                      ("data", "model")),
                                   shape)
    assert all(t.device.type == "meta" for t in tspecs.tensors_of(targs))
    kind = tspecs.SHAPES[shape]["kind"]
    assert tfn.info["kind"] == kind and tfn.info["model_axis"] == "replicated"
    if kind == "train":
        state, batch, keys = targs
        rstate, rbatch, rkeys = jargs
        _state_matches(state, rstate, "bfloat16")
        assert keys is None and rkeys.shape == (1, 2)
        names = ["tokens", "labels"] + (["frontend"] if cfg.frontend else [])
        assert sorted(rbatch) == sorted(names)
        assert [_sd(t) for t in batch] == [_sd(rbatch[k]) for k in names]
    elif kind == "prefill":
        assert len(targs) == len(jargs)
        _leaves_equal(targs[0], jargs[0])
        assert [_sd(t) for t in targs[1:]] == [_sd(r) for r in jargs[1:]]
    else:
        _leaves_equal(targs[0], jargs[0])
        _leaves_equal(targs[1], jargs[1])
        assert _sd(targs[2]) == _sd(jargs[2])


@pytest.mark.parametrize("arch", ARCHS)
def test_variants_and_rules_match_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    lv, jlv = tspecs._long_variant(cfg), jspecs._long_variant(jcfg)
    assert (lv.attn_window, lv.mixer, lv.name) == (jlv.attn_window,
                                                   jlv.mixer, jlv.name)
    for shape in tspecs.SHAPES:
        assert tspecs.shape_supported(cfg, shape) == \
            jspecs.shape_supported(jcfg, shape)
    assert tspecs.SHAPES == jspecs.SHAPES
    assert tspecs.LONG_WINDOW == jspecs.LONG_WINDOW
    assert tspecs.SEQ_PARALLEL_OPT_OUT == jspecs.SEQ_PARALLEL_OPT_OUT
    for axes in [(), ("data",), ("pod", "data")]:
        for sp in (False, True):
            assert tspecs.act_rules(axes, sp) == jspecs.act_rules(axes, sp)


def test_train_case_on_the_production_mesh_is_one_rank():
    """ppermute: one node's flat rows a rank (its blocks of the
    tensor-parallel tree), its whole batch; dense: the whole round; a
    described mesh materializes only the dense case."""
    cfg = get_config("rfast-100m").reduced()
    fn, (state, batch, _) = tspecs.build_case(cfg, make_production_mesh(), "train_4k")
    p, p_whole = fn.info["p"], fn.info["p_whole"]
    assert state.x.shape == (1, p) and state.rho_out.shape[::2] == (1, p)
    assert fn.info["model_axis"] == "tensor" and p < p_whole
    assert batch[0].shape == (1, 256 // 32, 4096)
    assert fn.info["n_nodes"] == 32 and fn.info["comm"] == "ppermute"
    fn, (state, batch, _) = tspecs.build_case(cfg, make_production_mesh(), "train_4k",
                                              comm="dense")
    assert state.x.shape == (32, p_whole) and batch[0].shape == (32, 8, 4096)
    with pytest.raises(ValueError, match="dense"):
        tspecs.build_train(cfg, make_production_mesh(), seq=16, global_batch=64,
                           device="cpu")
    fn, (params, toks) = tspecs.build_case(cfg, make_production_mesh(), "prefill_32k")
    assert toks.shape == (1, 32768) and toks.dtype == torch.int32
    fn, (params, cache, tok) = tspecs.build_case(cfg, make_production_mesh(),
                                                 "long_500k")
    assert tok.shape == (1, 1)      # batch 1 does not divide: replicated


def test_dtype_is_never_changed_quietly():
    cfg = get_config("hymba-1.5b").reduced()
    mesh = describe_mesh((2, 1), ("data", "model"))
    fn, (state, batch, _) = tspecs.build_train(cfg, mesh, seq=32,
                                               global_batch=4)
    assert state.x.dtype == torch.bfloat16
    assert fn.info["dtype"] == fn.info["state_dtype"] == "bfloat16"
    fn, (params, _) = tspecs.build_prefill(cfg, mesh, seq=32, global_batch=4,
                                           dtype=torch.float32)
    assert {t.dtype for t in tspecs.tensors_of(params)} == {torch.float32}
    assert fn.info["dtype"] == "float32"
