"""The port's per-node update and commit against the JAX package's.

The port's ``ops.rfast_update`` / ``ops.rfast_commit`` (the kernel route,
which on CPU tensors runs the plain twins, and ``oracle=True``, the
per-node commit kernel's twin) are held to JAX's ``impl="pallas"`` with
``interpret=True`` (the Pallas kernels in the interpreter) on the
operands of tests/test_kernels.py, at its tolerances: 1e-5 in fp32,
3e-2 in bf16.  A bounded property holds the kernel routes to the port's
own ``ref`` at 1e-4, as tests/test_kernels.py does for the reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.rfast_update.ops import rfast_commit as j_rfast_commit
from repro.kernels.rfast_update.ops import rfast_update as j_rfast_update
from repro_torch.kernels.rfast_update import dispatch, ops
from repro_torch.kernels.rfast_update.kernel import (rfast_commit_node,
                                                     rfast_commit_node_bytes,
                                                     rfast_update_node,
                                                     rfast_update_node_bytes)

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
COMMIT_KEYS = ("z", "g_new", "g_old", "rho_in", "rho_buf", "mask",
               "rho_out", "a_out")


def _operands(P, dtype, seed=0, Kw=2, Ka=3, Ko=2):
    """The operands of tests/test_kernels.py::test_rfast_update_sweep, as
    numpy (float32 values rounded to ``dtype`` on both sides)."""
    r = np.random.default_rng(seed)
    a = lambda *s: r.normal(0, 1, s).astype(np.float32)
    return dict(x=a(P), z=a(P), g_new=a(P), g_old=a(P), v_in=a(Kw, P),
                w_in=np.asarray([0.25, 0.25][:Kw], np.float32),
                rho_in=a(Ka, P), rho_buf=a(Ka, P),
                mask=np.asarray([1.0, 0.0, 1.0][:Ka], np.float32),
                rho_out=a(Ko, P),
                a_out=np.asarray([0.3, 0.2][:Ko], np.float32))


def _jax(ops_np, dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    small = ("w_in", "mask", "a_out")
    return {k: jnp.asarray(v) if k in small else jnp.asarray(v, jdt)
            for k, v in ops_np.items()}


def _torch(ops_np, dtype):
    tdt = getattr(torch, dtype)
    small = ("w_in", "mask", "a_out")
    return {k: torch.from_numpy(v) if k in small
            else torch.from_numpy(v).to(tdt) for k, v in ops_np.items()}


def _close(got, want, tol):
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.float().numpy(), w, rtol=tol, atol=tol)


SCAL = dict(gamma=0.01, w_self=0.5, a_self=0.5)


@pytest.mark.parametrize("P", [37, 1000, 32768, 100_001])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rfast_update_matches_jax_pallas(P, dtype):
    o = _operands(P, dtype)
    want = j_rfast_update(**_jax(o, dtype), **SCAL, impl="pallas",
                          interpret=True)
    got = ops.rfast_update(**_torch(o, dtype), **SCAL, impl="kernel")
    assert all(g.dtype == getattr(torch, dtype) for g in got)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("P", [37, 1000, 32768, 100_001])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rfast_commit_matches_jax_pallas(P, dtype):
    o = _operands(P, dtype)
    jo, to = _jax(o, dtype), _torch(o, dtype)
    want = j_rfast_commit(**{k: jo[k] for k in COMMIT_KEYS}, a_self=0.5,
                          impl="pallas", interpret=True)
    for oracle in (False, True):
        got = ops.rfast_commit(**{k: to[k] for k in COMMIT_KEYS},
                               a_self=0.5, impl="kernel", oracle=oracle)
        _close(got, want, TOL[dtype])
    # outputs="commit" of the full op is the same commit
    got = ops.rfast_update(**to, **SCAL, impl="kernel", outputs="commit")
    _close(got, want, TOL[dtype])


def test_ref_matches_jax_ref_and_keeps_its_dtypes():
    o = _operands(999, "float32", seed=3)
    want = j_rfast_update(**_jax(o, "float32"), **SCAL, impl="ref")
    got = ops.rfast_update(**_torch(o, "float32"), **SCAL, impl="ref")
    _close(got, want, 1e-6)
    # every output in x's dtype except ρ̃', which keeps rho_buf's
    to = _torch(o, "float32")
    to["rho_buf"] = to["rho_buf"].to(torch.bfloat16)
    got = ops.rfast_update(**to, **SCAL, impl="ref")
    assert [g.dtype for g in got] == [torch.float32] * 4 + [torch.bfloat16]


def test_cpu_routes_launch_no_kernel():
    dispatch.clear()
    to = _torch(_operands(64, "float32"), "float32")
    ops.rfast_update(**to, **SCAL, impl="kernel")
    ops.rfast_commit(**{k: to[k] for k in COMMIT_KEYS}, a_self=0.5,
                     impl="kernel", oracle=True)
    assert dispatch.stats()["launches"] == 0


@settings(max_examples=10, deadline=None)
@given(P=st.integers(1, 5000), Kw=st.integers(1, 4), Ka=st.integers(1, 4),
       Ko=st.integers(1, 4), seed=st.integers(0, 100))
def test_rfast_update_property(P, Kw, Ka, Ko, seed):
    r = np.random.default_rng(seed)
    a = lambda *s: torch.from_numpy(r.normal(0, 1, s).astype(np.float32))
    f = lambda *s: torch.from_numpy(r.uniform(0, .5, s).astype(np.float32))
    kw = dict(x=a(P), z=a(P), g_new=a(P), g_old=a(P), v_in=a(Kw, P),
              w_in=f(Kw), rho_in=a(Ka, P), rho_buf=a(Ka, P),
              mask=torch.from_numpy(r.integers(0, 2, Ka).astype(np.float32)),
              rho_out=a(Ko, P), a_out=f(Ko),
              gamma=float(r.uniform(0, .1)), w_self=0.5, a_self=0.5)
    ref = ops.rfast_update(**kw, impl="ref")
    for got in (ops.rfast_update(**kw, impl="kernel"),
                (None, None) + ops.rfast_commit(
                    *(kw[k] for k in COMMIT_KEYS), a_self=0.5,
                    impl="kernel", oracle=True),
                (None, None) + ops.rfast_commit(
                    *(kw[k] for k in COMMIT_KEYS), a_self=0.5,
                    impl="kernel")):
        for x, y in zip(ref, got):
            if y is not None:
                torch.testing.assert_close(y, x, rtol=1e-4, atol=1e-4)


def test_mixed_dtypes_raise():
    to = _torch(_operands(50, "float32"), "float32")
    bad = dict(to, rho_out=to["rho_out"].to(torch.bfloat16))
    with pytest.raises(ValueError, match="one dtype"):
        rfast_update_node(**bad, **SCAL)
    with pytest.raises(ValueError, match="one dtype"):
        rfast_commit_node(**{k: bad[k] for k in COMMIT_KEYS}, a_self=0.5)
    for oracle in (False, True):
        with pytest.raises(ValueError, match="one dtype"):
            ops.rfast_commit(**{k: bad[k] for k in COMMIT_KEYS}, a_self=0.5,
                             impl="kernel", oracle=oracle)
    with pytest.raises(ValueError, match="impl"):
        ops.rfast_update(**to, **SCAL, impl="pallas")


def test_bound_formulas():
    # full width, binary tree (kw = 1, ka = 2, ko = 1), fp32: 16 and 12
    # rows of P, the bytes the kernels' bounds are taken from
    P = 124_668_672
    assert rfast_update_node_bytes(1, 2, 1, P, 4) == 16 * P * 4
    assert rfast_commit_node_bytes(2, 1, P, 4) == 12 * P * 4
