"""Port SSM and hybrid models vs the JAX ones, on reduced configs.

Reduced ``hymba-1.5b`` (attention and a Mamba head in parallel, dense MLP)
and ``falcon-mamba-7b`` (attention-free, no MLP), with JAX's
``init_params(PRNGKey(0))`` weights carried into the port by
``params_from_jax``: the flat vectors are bitwise equal, ``ssm_apply``
(and its decode state) agrees with ``models/ssm.py::ssm_apply`` at 1e-5,
the logits at 1e-5, and loss and flat gradient at rtol 1e-4 / atol 1e-5 —
tests/test_torch_model.py's tolerances (fp32 on both sides; only the
order of sums differs, the scan's included).  The model's scan goes
through the kernel wrapper, once per SSM layer.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.paramvec import make_ravel_spec as j_make_ravel_spec
from repro.core.paramvec import ravel as j_ravel
from repro.models import ssm as jssm
from repro.models import transformer as jt
from repro_torch.configs import get_config
from repro_torch.core.paramvec import make_ravel_spec, ravel, unravel
from repro_torch.kernels.rfast_update import dispatch
from repro_torch.kernels.ssm_scan import kernel as sk
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tt

PAD = 1000
ARCHS = ["hymba-1.5b", "falcon-mamba-7b"]


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg = j_get_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    jparams = jax.jit(lambda k: jt.init_params(jcfg, k))(
        jax.random.PRNGKey(0))
    params, flat = tt.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      pad_to=PAD, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (3, 17)).astype(
        np.int32)
    return jcfg, cfg, jparams, params, flat, toks


def test_configs_are_the_reference_configs():
    for arch in ARCHS:
        assert (dataclasses.asdict(get_config(arch))
                == dataclasses.asdict(j_get_config(arch)))


def test_ravel_order_matches_jax(setup):
    jcfg, cfg, jparams, params, flat, _ = setup
    jspec = j_make_ravel_spec(jparams, pad_to=PAD)
    jflat = np.asarray(j_ravel(jspec, jparams))
    np.testing.assert_array_equal(flat.numpy(), jflat)
    spec = make_ravel_spec(params, pad_to=PAD)
    np.testing.assert_array_equal(ravel(spec, params).numpy(), jflat)
    own = make_ravel_spec(tt.init_params(cfg, torch.Generator()
                                         .manual_seed(0)), pad_to=PAD)
    jpaths = tuple(tuple(k.key for k in path) for path, _ in
                   jax.tree_util.tree_flatten_with_path(jparams)[0])
    assert own.paths == jpaths
    assert own.shapes == jspec.shapes and own.p == jspec.p
    assert ("layers", "ssm", "A_log") in own.paths
    assert (("layers", "attn", "wq") in own.paths) == (cfg.mixer == "hybrid")
    assert (("layers", "mlp", "wi") in own.paths) == bool(cfg.d_ff)


def test_port_ssm_init_values_and_distributions(setup):
    _, cfg, _, _, _, _ = setup
    p = tt.init_params(cfg, torch.Generator().manual_seed(3))["layers"]["ssm"]
    L, di, N, K = cfg.n_layers, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    want_A = torch.log(torch.arange(1, N + 1, dtype=torch.float32))
    assert torch.equal(p["A_log"], want_A.expand(L, di, N))
    assert torch.equal(p["dt_bias"], torch.full((L, di), -4.6))
    assert torch.equal(p["D"], torch.ones(L, di))
    assert torch.equal(p["conv_b"], torch.zeros(L, di))
    assert abs(float(p["conv_w"].std()) - K ** -0.5) < 0.05 * K ** -0.5
    s = float(p["in_proj"].std())
    assert abs(s - cfg.d_model ** -0.5) < 0.05 * cfg.d_model ** -0.5


@pytest.mark.parametrize("S", [2, 17])
@pytest.mark.parametrize("return_state", [False, True])
def test_ssm_apply_matches_jax(setup, return_state, S):
    """Layer 0's SSM block on random input; S = 2 < K − 1 pads the
    decode window."""
    jcfg, cfg, jparams, params, _, _ = setup
    x = np.random.default_rng(5).normal(size=(2, S, cfg.d_model)).astype(
        np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["ssm"])
    tp = {k: v[0] for k, v in params["layers"]["ssm"].items()}
    jout = jssm.ssm_apply(jcfg, jp, jnp.asarray(x), return_state=return_state)
    tout = tssm.ssm_apply(cfg, tp, torch.from_numpy(x),
                          return_state=return_state)
    if not return_state:
        jout, tout = (jout, {}), (tout, {})
    np.testing.assert_allclose(tout[0].detach().numpy(), np.asarray(jout[0]),
                               atol=1e-5, rtol=0)
    assert sorted(tout[1]) == sorted(jout[1])
    for k in tout[1]:
        assert tout[1][k].shape == jout[1][k].shape
        np.testing.assert_allclose(tout[1][k].detach().numpy(),
                                   np.asarray(jout[1][k]), atol=1e-5, rtol=0,
                                   err_msg=k)


def test_logits_match_jax(setup):
    jcfg, cfg, jparams, params, _, toks = setup
    jl, _ = jt.forward(jcfg, jparams, jnp.asarray(toks[:, :-1]))
    tl, aux = tt.forward(cfg, params, torch.from_numpy(toks[:, :-1]))
    assert float(aux) == 0.0
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=1e-5, rtol=0)


def test_loss_and_flat_grad_match_jax(setup):
    jcfg, cfg, jparams, params, flat, toks = setup
    jspec = j_make_ravel_spec(jparams, pad_to=PAD)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jt.loss_fn(jcfg, p, jnp.asarray(toks[:, :-1]),
                             jnp.asarray(toks[:, 1:]))))(jparams)
    jg = np.asarray(j_ravel(jspec, jgrads))
    spec = make_ravel_spec(params, pad_to=PAD)
    lane = flat.clone().requires_grad_(True)
    loss = tt.loss_fn(cfg, unravel(spec, lane),
                      torch.from_numpy(toks[:, :-1]),
                      torch.from_numpy(toks[:, 1:]))
    (g,) = torch.autograd.grad(loss, lane)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4, atol=1e-5)
    assert not g[spec.p_model:].any()
    # every SSM parameter gets a gradient (A_log and D through the scan)
    gp = unravel(spec, g)["layers"]["ssm"]
    assert all(bool(v.abs().sum() > 0) for v in gp.values())


def test_model_scan_goes_through_the_kernel_wrapper(setup, monkeypatch):
    """One ``ssm_scan`` call per SSM layer per forward; on CPU tensors it
    runs the plain twin and records no launch."""
    _, cfg, _, params, _, toks = setup
    calls = []
    real = sk.ssm_scan

    def counting(*a):
        calls.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr("repro_torch.kernels.ssm_scan.ops.ssm_scan",
                        counting)
    dispatch.clear()
    tt.forward(cfg, params, torch.from_numpy(toks[:, :-1]))
    assert calls == [(3, 16, cfg.d_inner)] * cfg.n_layers
    assert dispatch.launches("ssm_scan") == 0


def test_what_is_not_ported_raises():
    """Nothing of the model is left unported: the enc-dec, frontend and
    no-RoPE variants of the hybrid and SSM configs init with the
    reference's leaves (the encoder's attention layers beside the
    hybrid decoder, ``frontend_proj``), and the no-RoPE one runs."""
    cfg = get_config("falcon-mamba-7b").reduced()
    # the decode state is ported (serving), and so are MoE MLPs and tied
    # heads, enc-dec, frontends and attention without RoPE
    assert tuple(tssm.ssm_cache(cfg, 1, torch.float32)["h"].shape) == (
        1, cfg.d_inner, cfg.ssm_state)
    hybrid = get_config("hymba-1.5b").reduced()
    enc_dec = dataclasses.replace(hybrid, enc_dec=True, n_enc_layers=1,
                                  frontend="audio", frontend_seq=4)
    p = tt.init_params(enc_dec, torch.Generator())
    assert tuple(p["enc_layers"]["attn"]["wq"].shape) == (
        1, hybrid.d_model, hybrid.n_heads * hybrid.hd)
    assert "cross" in p["layers"] and "ssm" in p["layers"]
    assert tuple(p["frontend_proj"].shape) == (hybrid.d_model,
                                               hybrid.d_model)
    front = dataclasses.replace(cfg, frontend="audio", frontend_seq=4,
                                frontend_dim=16)
    p = tt.init_params(front, torch.Generator())
    assert tuple(p["frontend_proj"].shape) == (16, cfg.d_model)
    assert "enc_layers" not in p
    no_rope = dataclasses.replace(hybrid, use_rope=False)
    p = tt.init_params(no_rope, torch.Generator())
    logits, _ = tt.forward(no_rope, p, torch.zeros(1, 5, dtype=torch.int64))
    assert torch.isfinite(logits).all()
    tied_moe = dataclasses.replace(cfg, moe_experts=4, moe_top_k=2,
                                   d_ff=32, tie_embeddings=True)
    p = tt.init_params(tied_moe, torch.Generator())
    assert "lm_head" not in p
    assert tuple(p["layers"]["mlp"]["experts"]["wi"].shape) == (
        cfg.n_layers, 4, cfg.d_model, 32)
