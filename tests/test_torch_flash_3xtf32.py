"""The fp32 flash kernels' 3xTF32 arithmetic, emulated in torch on the CPU,
against the JAX package's fp32 Pallas kernels in the interpreter.

``flash_fwd_3xtf32.cu`` and ``flash_bwd_3xtf32.cu`` take every fp32
product on the TF32 tensor cores as three: each operand x is split into
hi = x rounded to TF32 (to nearest, ties away from zero: add half a TF32
ulp to the magnitude's bits, clear the 13 bits TF32 drops) and
lo = x - hi, of which the tensor core reads the top 19 bits, and
a b = lo_a hi_b + hi_a lo_b + hi_a hi_b with fp32 sums.  Here every
product of the plain forward and backward is taken so, on the same
inputs as the reference, and held to tests/test_kernels.py's fp32
tolerances (2e-5 forward, 2e-4 gradients).  One TF32 product alone
(hi_a hi_b) misses them: the tests pin that choice where no kernel
runs.  The kernels themselves are held to the plain twins on the card
(tests/test_torch_gpu.py, chip_smoke.py).  The last test holds the fp32
wrappers' head-dim padding (to a multiple of 4, for 16-byte copies)
exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import backward as jax_backward
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro_torch.kernels.flash_attention.backward import flash_bwd_plain
from repro_torch.kernels.flash_attention.kernel import (NEG, flash_fwd_plain,
                                                        pad_head_dim)

FWD_TOL, GRAD_TOL = 2e-5, 2e-4
# (B, H, KV, S, D): tests/test_torch_flash_attention.py's parity shapes
# (MHA, GQA 4:1, MQA), then one D = 128 causal case at S = 512
FWD_SHAPES = [(1, 4, 4, 128, 64), (2, 8, 2, 256, 64), (1, 4, 1, 512, 128)]
MASKS = [(True, None), (False, None), (True, 128)]
WIDE = (1, 4, 2, 512, 128)
# (B, H, S, D): its backward cases
BWD_SHAPES = [(1, 2, 128, 32), (2, 2, 256, 64)]
BWD_MASKS = [(True, None), (True, 64), (False, None)]


def tf32_rna(x):
    """x rounded to TF32, to nearest with ties away from zero (cvt.rna)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x):
    """The top 19 bits of x: what the tensor core reads of an fp32 word."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_trunc(x - hi)


def mm3(spec, a, b):
    """einsum in 3xTF32: three TF32 products, fp32 sums."""
    (ah, al), (bh, bl) = split(a), split(b)
    return (torch.einsum(spec, al, bh) + torch.einsum(spec, ah, bl)
            + torch.einsum(spec, ah, bh))


def mm1(spec, a, b):
    """einsum with one TF32 product."""
    return torch.einsum(spec, tf32_rna(a), tf32_rna(b))


def scores(q, k, causal, window, mm):
    """s = q kᵀ scale by ``mm``, NEG where the kernels mask (Sq = Sk)."""
    s = mm("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5
    if causal:
        i = torch.arange(q.shape[2])
        keep = i[None, :] <= i[:, None]
        if window is not None:
            keep &= i[None, :] > i[:, None] - window
        s = s.masked_fill(~keep, NEG)
    return s


def fwd(q, k, v, causal, window, mm):
    """The plain forward (kernel.flash_fwd_plain) with its two products
    taken by ``mm``: (o, lse).  k, v repeated to q's heads."""
    s = scores(q, k, causal, window, mm)
    lse = torch.logsumexp(s, -1)
    return mm("bhqk,bhkd->bhqd", torch.exp(s - lse[..., None]), v), lse


def bwd(q, k, v, do, lse, delta, causal, window, mm):
    """The plain backward (backward.flash_bwd_plain) with its five
    products taken by ``mm``: (dq, dk, dv)."""
    scale = q.shape[-1] ** -0.5
    p = torch.exp(scores(q, k, causal, window, mm) - lse[..., None])
    dp = mm("bhqd,bhkd->bhqk", do, v)
    ds = p * (dp - delta[..., None]) * scale
    return (mm("bhqk,bhkd->bhqd", ds, k), mm("bhqk,bhqd->bhkd", ds, q),
            mm("bhqk,bhqd->bhkd", p, do))


def _np(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _max_err(jax_out, torch_out):
    return float(np.abs(np.asarray(jax_out, np.float32)
                        - torch_out.numpy()).max())


def _forward_case(B, H, KV, S, D, causal, window, mm):
    """(max abs error of o, of lse) against JAX's Pallas forward."""
    q, k, v = _np((B, H, S, D), 0), _np((B, KV, S, D), 1), \
        _np((B, KV, S, D), 2)
    o_j = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 window=window, interpret=True)
    kr, vr = (np.repeat(t, H // KV, axis=1) for t in (k, v))
    _, (_, _, _, lse_j, _) = jax_backward._fwd(
        jnp.asarray(q), jnp.asarray(kr), jnp.asarray(vr), causal, window,
        None, 128, 128, True)
    o, lse = fwd(*(torch.from_numpy(t) for t in (q, kr, vr)), causal,
                 window, mm)
    return _max_err(o_j, o), _max_err(lse_j, lse)


def _backward_case(B, H, S, D, causal, window, mm):
    """The largest max abs error of dq, dk, dv against JAX's Pallas
    ``_run_dq`` and ``_run_dkv``."""
    q, k, v, do = (_np((B, H, S, D), 40 + i) for i in range(4))
    qj, kj, vj = (jnp.asarray(t) for t in (q, k, v))
    _, (_, _, _, lse, o) = jax_backward._fwd(qj, kj, vj, causal, window,
                                             None, 64, 64, True)
    delta = np.sum(do * np.asarray(o), axis=-1)
    kw = dict(scale=D ** -0.5, causal=causal, window=window, bq=64, bk=64)
    want = (jax_backward._run_dq(qj, kj, vj, jnp.asarray(do), lse,
                                 jnp.asarray(delta), interpret=True, **kw),
            *jax_backward._run_dkv(qj, kj, vj, jnp.asarray(do), lse,
                                   jnp.asarray(delta), interpret=True, **kw))
    got = bwd(*(torch.from_numpy(t) for t in (q, k, v, do)),
              torch.from_numpy(np.array(lse)), torch.from_numpy(delta),
              causal, window, mm)
    return max(_max_err(w, g) for w, g in zip(want, got))


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("B,H,KV,S,D", FWD_SHAPES)
def test_3xtf32_forward_matches_jax_pallas(B, H, KV, S, D, causal, window):
    e_o, e_lse = _forward_case(B, H, KV, S, D, causal, window, mm3)
    assert e_o <= FWD_TOL and e_lse <= FWD_TOL, (e_o, e_lse)


@pytest.mark.parametrize("causal,window", BWD_MASKS)
@pytest.mark.parametrize("B,H,S,D", BWD_SHAPES + [WIDE[:2] + WIDE[3:]])
def test_3xtf32_backward_matches_jax_dq_dkv(B, H, S, D, causal, window):
    e = _backward_case(B, H, S, D, causal, window, mm3)
    assert e <= GRAD_TOL, e


@pytest.mark.parametrize("part", ["forward", "backward"])
def test_one_tf32_product_misses_the_fp32_tolerance(part):
    """At D = 128, S = 512, causal: one TF32 product a product is out of
    tolerance where three are within it."""
    B, H, KV, S, D = WIDE
    if part == "forward":
        errs = [_forward_case(B, H, KV, S, D, True, None, mm)[0]
                for mm in (mm3, mm1)]
        tol = FWD_TOL
    else:
        errs = [_backward_case(B, H, S, D, True, None, mm)
                for mm in (mm3, mm1)]
        tol = GRAD_TOL
    assert errs[0] <= tol < errs[1], errs


def test_tf32_split_is_exact_and_rounds_to_nearest():
    """hi + lo is x itself before the tensor core truncates lo; hi keeps
    10 mantissa bits and is the nearest such value, ties away from 0."""
    x = torch.from_numpy(_np((4096,), 7)) * 1e3
    hi = tf32_rna(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(hi + (x - hi), x)
    ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 11)
    assert bool(((x - hi).abs() <= ulp / 2).all())
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert tf32_rna(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]


@pytest.mark.parametrize("D", [33, 35])
@pytest.mark.parametrize("causal,window", BWD_MASKS)
def test_fp32_pad_head_dim_leaves_attention_unchanged(D, causal, window):
    """What the fp32 kernels' wrappers do to a head dim that is not a
    multiple of 4: zero columns up to the next one (the scale stays the
    true D's), then slice the outputs.  o, lse and the three gradients of
    the plain twins on the padded tensors, sliced, equal the unpadded
    ones to 1e-6, and the padded columns are 0."""
    B, H, KV, S = 1, 4, 2, 128
    q, k, v, do = (torch.from_numpy(_np((B, h, S, D), 70 + i))
                   for i, h in enumerate((H, KV, KV, H)))
    padded = [pad_head_dim(t) for t in (q, k, v, do)]
    Dp = D + (-D % 4)
    for t, u in zip(padded, (q, k, v, do)):
        assert t.shape[-1] == Dp and t.is_contiguous()
        assert torch.equal(t[..., :D], u) and not t[..., D:].any()
    kw = dict(causal=causal, window=window, scale=D ** -0.5, bq=64, bk=64)
    o, lse = flash_fwd_plain(q, k, v, **kw)
    o_p, lse_p = flash_fwd_plain(*padded[:3], **kw)
    torch.testing.assert_close(o_p[..., :D], o, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse_p, lse, rtol=1e-6, atol=1e-6)
    assert not o_p[..., D:].any()
    kr, vr = (t.repeat_interleave(H // KV, 1) for t in (k, v))
    kpr, vpr = (t.repeat_interleave(H // KV, 1) for t in padded[1:3])
    delta = (do * o).sum(-1)
    want = flash_bwd_plain(q, kr, vr, do, lse, delta, **kw)
    got = flash_bwd_plain(padded[0], kpr, vpr, padded[3], lse, delta, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g[..., :D], w, rtol=1e-6, atol=1e-6)
        assert not g[..., D:].any()
