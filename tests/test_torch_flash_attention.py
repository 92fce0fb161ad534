"""Port flash attention (CPU: the kernels' plain twins) vs the JAX package.

Inputs are made with numpy from a seed and fed to both packages.  JAX
runs its Pallas kernels in the interpreter (``flash_attention(impl=
"pallas")``, ``flash_attention_vjp(..., interpret=True)``), as
tests/test_kernels.py does; tolerances are that file's: 2e-5 for the
fp32 forward, 2e-2 for bf16, 2e-4 for gradients.  The CUDA kernels are
held to these plain twins on the card by chip_smoke.py and
tests/test_torch_gpu.py: ``flash_bwd_plain`` is what the fused bf16
backward kernel is held to, and ``pad_head_dim`` is what the bf16
kernels' wrappers do to a head dim that is not a multiple of 8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import backward as jax_backward
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention.backward import (
    flash_attention_vjp, flash_bwd, flash_bwd_plain, flash_dkv, flash_dq)
from repro_torch.kernels.flash_attention.kernel import (flash_fwd,
                                                        flash_fwd_plain,
                                                        pad_head_dim)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rfast_update import dispatch

SHAPES = [(1, 128, 4, 4, 64),     # MHA          (B, S, H, KV, D)
          (2, 256, 8, 2, 64),     # GQA 4:1
          (1, 512, 4, 1, 128)]    # MQA
MASKS = [(True, None), (False, None), (True, 128)]
DTYPES = [("float32", 2e-5), ("bfloat16", 2e-2)]


@pytest.fixture(autouse=True)
def _fp32_matmul():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dispatch.clear()


def _np(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _both(x, dtype):
    """The same values in both packages (bf16 rounds identically)."""
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _qkv(B, Sq, Sk, H, KV, D, dtype, seed=0):
    (qj, qt), (kj, kt), (vj, vt) = (
        _both(_np(s, seed + i), dtype)
        for i, s in enumerate([(B, Sq, H, D), (B, Sk, KV, D),
                               (B, Sk, KV, D)]))
    return (qj, kj, vj), (qt, kt, vt)


def _close(jax_out, torch_out, tol):
    np.testing.assert_allclose(np.asarray(jax_out, np.float32),
                               torch_out.float().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,H,KV,D", SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_flash_kernel_path_matches_jax_pallas(B, S, H, KV, D, causal, window,
                                              dtype, tol):
    (qj, kj, vj), (qt, kt, vt) = _qkv(B, S, S, H, KV, D, dtype)
    want = jax_flash(qj, kj, vj, causal=causal, window=window,
                     impl="pallas", bq=128, bk=128)
    got = flash_attention(qt, kt, vt, causal=causal, window=window,
                          impl="kernel", bq=128, bk=128)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(want, got, tol)


@pytest.mark.parametrize("B,S,H,KV,D", SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_attention_ref_matches_jax_ref(B, S, H, KV, D, causal, window,
                                       dtype, tol):
    (qj, kj, vj), (qt, kt, vt) = _qkv(B, S, S, H, KV, D, dtype, seed=3)
    want = jax_ref(qj, kj, vj, causal=causal, window=window)
    got = flash_attention(qt, kt, vt, causal=causal, window=window,
                          impl="ref")
    assert got.dtype == qt.dtype
    _close(want, got, tol)


@pytest.mark.parametrize("Sq,Sk,KV,window", [(128, 256, 2, None),
                                             (256, 128, 4, None),
                                             (128, 256, 1, 64)])
def test_flash_kernel_path_sq_ne_sk_matches_jax_kernel(Sq, Sk, KV, window):
    """The kernels mask ki <= qi with no Sk - Sq offset; the port's kernel
    path follows JAX's Pallas kernel there, not the reference oracle."""
    (qj, kj, vj), (qt, kt, vt) = _qkv(1, Sq, Sk, 4, KV, 64, "float32", 5)
    want = jax_flash(qj, kj, vj, causal=True, window=window, impl="pallas",
                     bq=64, bk=64)
    got = flash_attention(qt, kt, vt, causal=True, window=window,
                          impl="kernel", bq=64, bk=64)
    _close(want, got, 2e-5)
    ref = jax_ref(qj, kj, vj, causal=True, window=window)
    assert not np.allclose(np.asarray(ref), np.asarray(want), atol=1e-3)


@pytest.mark.parametrize("Sq,Sk", [(128, 256), (256, 128)])
def test_attention_ref_sq_ne_sk_matches_jax_ref(Sq, Sk):
    (qj, kj, vj), (qt, kt, vt) = _qkv(2, Sq, Sk, 4, 2, 32, "float32", 6)
    _close(jax_ref(qj, kj, vj, causal=True),
           attention_ref(qt, kt, vt, causal=True), 2e-5)


@pytest.mark.parametrize("window", [5, 100])
@pytest.mark.parametrize("bk", [64, 128])
def test_flash_window_below_and_across_tiles_matches_jax(window, bk):
    """A window smaller than one tile and one that is no multiple of it:
    a row's first visited tile can be fully masked (NEG, not -inf)."""
    (qj, kj, vj), (qt, kt, vt) = _qkv(1, 256, 256, 4, 2, 32, "float32", 7)
    want = jax_flash(qj, kj, vj, causal=True, window=window, impl="pallas",
                     bq=64, bk=bk)
    got = flash_attention(qt, kt, vt, causal=True, window=window,
                          impl="kernel", bq=64, bk=bk)
    _close(want, got, 2e-5)


@pytest.mark.parametrize("causal,window", MASKS + [(True, 5)])
def test_flash_lse_is_logsumexp_of_masked_scores(causal, window):
    """lse of the forward's plain twin against the JAX package's own
    (``backward._fwd``: logsumexp of the NEG-masked scores), at 1e-5."""
    B, H, S, D = 2, 3, 192, 32
    (qj, qt), (kj, kt), (vj, vt) = (_both(_np((B, H, S, D), s), "float32")
                                    for s in (10, 11, 12))
    _, (_, _, _, lse_j, o_j) = jax_backward._fwd(
        qj, kj, vj, causal, window, None, 64, 64, True)
    o, lse = flash_fwd(qt, kt, vt, causal=causal, window=window, bq=64,
                       bk=64, out_dtype=torch.float32)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    _close(lse_j, lse, 1e-5)
    _close(o_j, o, 2e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, None)])
@pytest.mark.parametrize("B,H,S,D", [(1, 2, 128, 32), (2, 2, 256, 64)])
def test_flash_vjp_grads_match_jax_interpret(B, H, S, D, causal, window):
    """Grads of the port's autograd function (CPU: plain twins) against
    jax.grad of the JAX custom VJP with its Pallas dq / dkv kernels in
    the interpreter (tests/test_kernels.py's backward cases)."""
    arrs = [_np((B, H, S, D), 20 + i) for i in range(4)]
    qj, kj, vj, wj = (jnp.asarray(a) for a in arrs)

    def f(q_, k_, v_):
        return jnp.sum(jax_backward.flash_attention_vjp(
            q_, k_, v_, causal, window, None, 64, 64, True) * wj)

    want = jax.grad(f, argnums=(0, 1, 2))(qj, kj, vj)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrs[:3]]
    o = flash_attention_vjp(*leaves, causal, window, None, 64, 64)
    (o * torch.from_numpy(arrs[3])).sum().backward()
    for w, t in zip(want, leaves):
        _close(w, t.grad, 2e-4)


def test_flash_vjp_bf16_and_gqa_repeat_match_jax_interpret():
    """bf16 inputs (grads back in bf16) with the caller's GQA repeat: the
    kv gradients sum over each group in both packages."""
    B, H, KV, S, D = 1, 4, 2, 128, 32
    arrs = [_np((B, H, S, D), 30), _np((B, KV, S, D), 31),
            _np((B, KV, S, D), 32), _np((B, H, S, D), 33)]
    qj, kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in arrs[:3])
    wj = jnp.asarray(arrs[3])

    def f(q_, k_, v_):
        o = jax_backward.flash_attention_vjp(
            q_, jnp.repeat(k_, H // KV, axis=1), jnp.repeat(v_, H // KV, 1),
            True, None, None, 64, 64, True)
        return jnp.sum(o.astype(jnp.float32) * wj)

    want = jax.grad(f, argnums=(0, 1, 2))(qj, kj, vj)
    leaves = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
              for a in arrs[:3]]
    q, k, v = leaves
    o = flash_attention_vjp(q, k.repeat_interleave(H // KV, 1),
                            v.repeat_interleave(H // KV, 1), True, None,
                            None, 64, 64)
    (o.float() * torch.from_numpy(arrs[3])).sum().backward()
    for w, t in zip(want, leaves):
        assert t.grad.dtype == torch.bfloat16
        _close(w, t.grad, 2e-2)


@pytest.mark.parametrize("causal,window", MASKS + [(True, 3)])
def test_flash_vjp_gradcheck_plain_path_fp64(causal, window):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 16, 8, generator=g, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda a, b, c: flash_attention_vjp(a, b, c, causal, window, None,
                                            8, 8), (q, k, v))


def test_cpu_tensors_launch_nothing():
    (_, _, _), (qt, kt, vt) = _qkv(1, 64, 64, 4, 2, 32, "float32")
    q, k, v = (t.transpose(1, 2).requires_grad_() for t in (qt, kt, vt))
    flash_attention(qt, kt, vt, impl="kernel")
    _, lse = flash_fwd(q, k, v)
    kr, vr = k.repeat_interleave(2, 1), v.repeat_interleave(2, 1)
    flash_attention_vjp(q, kr, vr).sum().backward()
    flash_dq(q, kr, vr, q.detach(), lse, lse, scale=0.1)
    flash_dkv(q, kr, vr, q.detach(), lse, lse, scale=0.1)
    flash_bwd(q, kr, vr, q.detach(), lse, lse, scale=0.1)
    assert dispatch.stats() == {"launches": 0, "by_kernel": {}}


def test_same_calls_fail_as_in_jax():
    """S % min(b, S) != 0 fails in both packages (an assertion in JAX's
    kernel, a ValueError here), and so do the port's own limits."""
    (qj, kj, vj), (qt, kt, vt) = _qkv(1, 192, 192, 2, 2, 32, "float32")
    with pytest.raises(AssertionError):
        jax_flash(qj, kj, vj, impl="pallas", bq=128, bk=128)
    with pytest.raises(ValueError):
        flash_attention(qt, kt, vt, impl="kernel", bq=128, bk=128)
    flash_attention(qt, kt, vt, impl="kernel", bq=64, bk=64)
    wide = torch.zeros(1, 2, 64, 160)
    with pytest.raises(ValueError):
        flash_fwd(wide, wide, wide)
    with pytest.raises(ValueError):
        flash_fwd_plain(qt.transpose(1, 2), kt.transpose(1, 2)[:, :1],
                        vt.transpose(1, 2), window=0)
    with pytest.raises(ValueError):
        flash_attention(qt, kt, vt, impl="pallas")
    with pytest.raises(ValueError):
        flash_attention_vjp(qt.transpose(1, 2), kt.transpose(1, 2)[:, :1],
                            vt.transpose(1, 2)[:, :1])


BWD_CASES = [(1, 2, 128, 32), (2, 2, 256, 64)]
BWD_MASKS = [(True, None), (True, 64), (False, None)]


@pytest.mark.parametrize("causal,window", BWD_MASKS)
@pytest.mark.parametrize("B,H,S,D", BWD_CASES)
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 2e-2)])
def test_flash_bwd_plain_matches_jax_dq_dkv_kernels(B, H, S, D, causal,
                                                    window, dtype, tol):
    """``flash_bwd_plain`` — the dense (dq, dk, dv) in one call, the twin
    of the fused bf16 kernel — against JAX's ``_run_dq`` and ``_run_dkv``
    Pallas kernels in the interpreter, on the same q, k, v (fp32 or
    bf16), dO (rounded to that dtype), lse and δ."""
    (qj, qt), (kj, kt), (vj, vt) = (_both(_np((B, H, S, D), 40 + i), dtype)
                                    for i in range(3))
    do = np.array(jnp.asarray(_np((B, H, S, D), 43), getattr(jnp, dtype))
                  .astype(jnp.float32))
    _, (_, _, _, lse, o) = jax_backward._fwd(qj, kj, vj, causal, window,
                                             None, 64, 64, True)
    delta = np.sum(do * np.asarray(o), axis=-1)
    kw = dict(scale=D ** -0.5, causal=causal, window=window, bq=64, bk=64)
    want = (jax_backward._run_dq(qj, kj, vj, jnp.asarray(do), lse,
                                 jnp.asarray(delta), interpret=True, **kw),
            *jax_backward._run_dkv(qj, kj, vj, jnp.asarray(do), lse,
                                   jnp.asarray(delta), interpret=True, **kw))
    got = flash_bwd_plain(qt, kt, vt,
                          torch.from_numpy(do).to(getattr(torch, dtype)),
                          torch.from_numpy(np.array(lse)),
                          torch.from_numpy(delta), **kw)
    for w, t in zip(want, got):
        assert t.dtype == torch.float32 and t.shape == (B, H, S, D)
        _close(w, t, tol)


@pytest.mark.parametrize("D", [36, 44])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 64)])
def test_pad_head_dim_leaves_attention_unchanged(D, causal, window):
    """What the bf16 kernels' wrappers do to a head dim that is not a
    multiple of 8: zero columns up to the next one (the scale stays the
    true D's), then slice the outputs.  The plain forward and backward on
    the padded tensors, sliced, equal the unpadded ones, and the padded
    columns of every gradient are 0."""
    B, H, KV, S = 1, 4, 2, 128
    q, k, v, do = (torch.from_numpy(_np((B, h, S, D), 50 + i))
                   for i, h in enumerate((H, KV, KV, H)))
    padded = [pad_head_dim(t) for t in (q, k, v, do)]
    Dp = D + (-D % 8)
    for t, u in zip(padded, (q, k, v, do)):
        assert t.shape[-1] == Dp and t.is_contiguous()
        assert torch.equal(t[..., :D], u) and not t[..., D:].any()
    kw = dict(causal=causal, window=window, scale=D ** -0.5, bq=64, bk=64)
    o, lse = flash_fwd_plain(q, k, v, **kw)
    o_p, lse_p = flash_fwd_plain(*padded[:3], **kw)
    torch.testing.assert_close(o_p[..., :D], o, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse_p, lse, rtol=1e-6, atol=1e-6)
    assert not o_p[..., D:].any()
    kr, vr = k.repeat_interleave(H // KV, 1), v.repeat_interleave(H // KV, 1)
    kpr, vpr = (t.repeat_interleave(H // KV, 1) for t in padded[1:3])
    delta = (do * o).sum(-1)
    want = flash_bwd_plain(q, kr, vr, do, lse, delta, **kw)
    got = flash_bwd_plain(padded[0], kpr, vpr, padded[3], lse, delta, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g[..., :D], w, rtol=1e-6, atol=1e-6)
        assert not g[..., D:].any()
    assert pad_head_dim(padded[0]) is padded[0]


@pytest.mark.parametrize("causal,window", BWD_MASKS)
def test_flash_vjp_bf16_grads_match_jax_bf16_vjp(causal, window):
    """``FlashAttentionFn`` with bf16 inputs on the CPU (the plain twins of
    the two bf16 tensor-core kernels; the cotangent stays bf16, δ is fp32)
    against ``jax.grad`` of the JAX custom VJP with bf16 inputs and its
    Pallas dq / dk/dv kernels in the interpreter."""
    B, H, S, D = 1, 2, 128, 64
    arrs = [_np((B, H, S, D), 60 + i) for i in range(4)]
    qj, kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in arrs[:3])
    wj = jnp.asarray(arrs[3])

    def f(q_, k_, v_):
        o = jax_backward.flash_attention_vjp(q_, k_, v_, causal, window,
                                             None, 64, 64, True)
        return jnp.sum(o.astype(jnp.float32) * wj)

    want = jax.grad(f, argnums=(0, 1, 2))(qj, kj, vj)
    leaves = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
              for a in arrs[:3]]
    o = flash_attention_vjp(*leaves, causal, window, None, 64, 64)
    assert o.dtype == torch.bfloat16
    (o.float() * torch.from_numpy(arrs[3])).sum().backward()
    for w, t in zip(want, leaves):
        assert t.grad.dtype == torch.bfloat16
        _close(w, t.grad, 2e-2)
