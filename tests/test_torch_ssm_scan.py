"""The port's selective scan against the JAX package's, on the CPU.

The same numpy inputs go through JAX's ``selective_scan`` (``impl="ref"``,
and ``impl="pallas"`` in interpret mode) and through the port's
``selective_scan(impl="ref")`` and the CUDA kernel's plain twin
``ssm_scan_plain``, at the cases of tests/test_kernels.py's scan sweep and
one with the model's inputs (dt = softplus(N(0,1) − 4.6), A = −(1..N)).
y and h_last agree within that test's tolerances: 1e-4 in fp32 and 3e-2
with bf16 inputs (fp32 sums on both sides; only the order of the y sum
and the fused multiply-adds differ).  The twin's staging depth leaves its
result unchanged (1e-5, as the reference's chunking test), the ref takes
an ``h0``, and ``SelectiveScanFn``'s gradients of all six inputs agree with
``jax.grad`` of JAX's ``selective_scan_ref`` at 1e-4.  On CPU tensors the
op runs the twin and records no kernel launch.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ops import selective_scan as j_selective_scan
from repro.models.ssm import selective_scan_ref as j_scan_ref
from repro_torch.kernels import meta
from repro_torch.kernels.rfast_update import dispatch
from repro_torch.kernels.ssm_scan import kernel as sk
from repro_torch.kernels.ssm_scan.ops import SelectiveScanFn, selective_scan
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

# (B, S, di, N, chunk, bd): tests/test_kernels.py:228-232, then the
# model's inputs at a ragged S (33) the Pallas kernel accepts
CASES = [(1, 64, 16, 8, 16, 16), (2, 128, 64, 16, 32, 32),
         (1, 256, 32, 16, 256, 32), (2, 33, 48, 16, 11, 16)]
MODEL_CASE = 3
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
PORT = {"ref": lambda *a: selective_scan(*a, impl="ref"),
        "plain": sk.ssm_scan_plain}


def _inputs(ci: int, seed: int = 0):
    """u, dt, A, B, C, D as fp32 numpy arrays for case ``ci``."""
    Bsz, S, di, N = CASES[ci][:4]
    r = np.random.default_rng(seed + ci)
    f = lambda *s: r.normal(size=s).astype(np.float32)
    if ci == MODEL_CASE:
        dt = np.log1p(np.exp(r.normal(size=(Bsz, S, di)) - 4.6))
        A = -np.tile(np.arange(1, N + 1, dtype=np.float32), (di, 1))
    else:
        dt = r.uniform(1e-3, 0.1, (Bsz, S, di))
        A = -r.uniform(0.5, 2, (di, N))
    return (f(Bsz, S, di), dt.astype(np.float32), A.astype(np.float32),
            f(Bsz, S, N), f(Bsz, S, N), f(di))


def _rounded(ci: int, dname: str):
    """The inputs with u, dt, B and C rounded to ``dname`` (exact in
    fp32, so both packages see the same values)."""
    u, dt, A, B, C, D = _inputs(ci)
    rd = lambda a: np.array(jnp.asarray(a, JDT[dname]).astype(jnp.float32))
    return rd(u), rd(dt), A, rd(B), rd(C), D


@functools.lru_cache(maxsize=None)
def _jax(ci: int, dname: str):
    """JAX's ref and Pallas (interpret) outputs as numpy."""
    u, dt, A, B, C, D = _rounded(ci, dname)
    cast = lambda a: jnp.asarray(a, JDT[dname])
    args = (cast(u), cast(dt), jnp.asarray(A), cast(B), cast(C),
            jnp.asarray(D))
    chunk, bd = CASES[ci][4:]
    out = {"ref": j_selective_scan(*args, impl="ref"),
           "pallas": j_selective_scan(*args, impl="pallas", chunk=chunk,
                                      bd=bd, interpret=True)}
    return {k: tuple(np.asarray(a) for a in v) for k, v in out.items()}


def _torch(ci: int, dname: str):
    u, dt, A, B, C, D = (torch.from_numpy(a) for a in _rounded(ci, dname))
    t = lambda a: a.to(TDT[dname])
    return t(u), t(dt), A, t(B), t(C), D


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("ci", range(len(CASES)))
@pytest.mark.parametrize("port", sorted(PORT))
def test_scan_matches_jax_ref_and_pallas(port, ci, dname):
    y, h = PORT[port](*_torch(ci, dname))
    assert y.dtype == h.dtype == torch.float32
    Bsz, S, di, N = CASES[ci][:4]
    assert y.shape == (Bsz, S, di) and h.shape == (Bsz, di, N)
    tol = TOL[dname]
    for j_impl, (yj, hj) in _jax(ci, dname).items():
        np.testing.assert_allclose(y.numpy(), yj, rtol=tol, atol=tol,
                                   err_msg=f"y: {port} vs JAX {j_impl}")
        np.testing.assert_allclose(h.numpy(), hj, rtol=tol, atol=tol,
                                   err_msg=f"h: {port} vs JAX {j_impl}")


@pytest.mark.parametrize("chunk", [1, 32, 100, 128, sk.SCAN_CHUNK])
def test_twin_staging_depth_leaves_the_result(chunk):
    """tests/test_kernels.py's chunking invariance, on the twin's staging
    depth (B 1, S 128, di 16, N 8; 1e-5 against a depth of 8)."""
    r = np.random.default_rng(7)
    u = torch.from_numpy(r.normal(size=(1, 128, 16)).astype(np.float32))
    dt = torch.from_numpy(r.uniform(1e-3, 0.1, (1, 128, 16))
                          .astype(np.float32))
    A = -torch.from_numpy(r.uniform(0.5, 2, (16, 8)).astype(np.float32))
    B, C = (torch.from_numpy(r.normal(size=(1, 128, 8)).astype(np.float32))
            for _ in range(2))
    D = torch.from_numpy(r.normal(size=16).astype(np.float32))
    y8, h8 = sk.ssm_scan_plain(u, dt, A, B, C, D, chunk=8)
    y, h = sk.ssm_scan_plain(u, dt, A, B, C, D, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), y8.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), h8.numpy(), rtol=1e-5, atol=1e-5)


def test_ref_takes_h0_as_jax_does():
    u, dt, A, B, C, D = _inputs(1)
    h0 = np.random.default_rng(3).normal(size=(2, 64, 16)).astype(np.float32)
    yj, hj = j_scan_ref(*map(jnp.asarray, (u, dt, A, B, C, D, h0)))
    t = [torch.from_numpy(a) for a in (u, dt, A, B, C, D, h0)]
    y, h = selective_scan_ref(*t)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), rtol=1e-4,
                               atol=1e-4)
    # a scan split in two, the second half from the first's h_last
    y1, h1 = selective_scan_ref(*(a[:, :50] for a in t[:2]), t[2],
                                *(a[:, :50] for a in t[3:5]), t[5])
    y2, h2 = selective_scan_ref(*(a[:, 50:] for a in t[:2]), t[2],
                                *(a[:, 50:] for a in t[3:5]), t[5], h1)
    yw, hw = selective_scan_ref(*t[:6])
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), yw.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(h2.numpy(), hw.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("with_h", [True, False])
@pytest.mark.parametrize("ci", [1, MODEL_CASE])
def test_scan_fn_gradients_match_jax_grad(ci, with_h):
    """Gradients of Σ y·gy (+ Σ h·gh) in u, dt, A, B, C and D."""
    ins = _inputs(ci)
    r = np.random.default_rng(11)
    Bsz, S, di, N = CASES[ci][:4]
    gy = r.normal(size=(Bsz, S, di)).astype(np.float32)
    gh = r.normal(size=(Bsz, di, N)).astype(np.float32) if with_h else None

    def j_loss(*a):
        y, h = j_scan_ref(*a)
        return jnp.sum(y * gy) + (jnp.sum(h * gh) if with_h else 0.0)

    jg = jax.grad(j_loss, argnums=tuple(range(6)))(*map(jnp.asarray, ins))
    leaves = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, h = SelectiveScanFn.apply(*leaves)
    loss = (y * torch.from_numpy(gy)).sum()
    if with_h:
        loss = loss + (h * torch.from_numpy(gh)).sum()
    grads = torch.autograd.grad(loss, leaves)
    for name, g, w in zip("u dt A B C D".split(), grads, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=f"d{name}")


def test_scan_fn_takes_strided_b_and_c_and_only_needed_grads():
    """B and C as column slices of one projection (the model's layout),
    gradients asked for u and B only."""
    u, dt, A, B, C, D = _inputs(MODEL_CASE)
    proj = torch.from_numpy(np.concatenate([B, C], -1)).requires_grad_()
    Bs, Cs = proj[..., :16], proj[..., 16:]
    assert not Bs.is_contiguous()
    ut = torch.from_numpy(u).requires_grad_()
    rest = [torch.from_numpy(a) for a in (dt, A, D)]
    y, h = SelectiveScanFn.apply(ut, rest[0], rest[1], Bs, Cs, rest[2])
    yw, hw = selective_scan_ref(*(torch.from_numpy(a)
                                  for a in (u, dt, A, B, C, D)))
    np.testing.assert_allclose(y.detach().numpy(), yw.numpy(), rtol=1e-4,
                               atol=1e-4)
    gu, gp = torch.autograd.grad(y.sum(), [ut, proj])
    j = jax.grad(lambda a, b, c: jnp.sum(j_scan_ref(
        a, jnp.asarray(dt), jnp.asarray(A), b, c, jnp.asarray(D))[0]),
        argnums=(0, 1, 2))(*map(jnp.asarray, (u, B, C)))
    np.testing.assert_allclose(gu.numpy(), np.asarray(j[0]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(gp.numpy(), np.concatenate(
        [np.asarray(j[1]), np.asarray(j[2])], -1), rtol=1e-4, atol=1e-4)


def test_cpu_op_runs_the_twin_and_launches_nothing():
    args = _torch(MODEL_CASE, "float32")
    dispatch.clear()
    got = selective_scan(*args, impl="kernel")
    direct = sk.ssm_scan(*args)
    want = sk.ssm_scan_plain(*args)
    for a, b in zip(got + direct, want + want):
        assert torch.equal(a, b)
    assert dispatch.launches("ssm_scan") == 0
    assert dispatch.stats()["launches"] == 0


def test_scan_rejects_what_it_does_not_run():
    args = _torch(0, "float32")
    with pytest.raises(ValueError, match="impl"):
        selective_scan(*args, impl="pallas")
    # on meta tensors (the launch tooling's dry-run) nothing runs: empty
    # meta outputs of the kernel's shapes, one noted launch; what the
    # kernel refuses is refused there too
    want = sk.ssm_scan(*args)
    with meta.recording() as calls:
        got = sk.ssm_scan(*(a.to("meta") for a in args))
    assert [(g.device.type, g.shape) for g in got] == [
        ("meta", w.shape) for w in want]
    assert [c["name"] for c in calls] == ["ssm_scan"]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        sk.ssm_scan(*(a.to("meta", torch.float64) for a in args))
    with pytest.raises(ValueError, match="chunk"):
        sk.ssm_scan_plain(*args, chunk=0)


def test_scan_bytes_count_each_input_and_output_once():
    # u, dt (2·2·3·5 bf16), B, C (2·2·3·4 bf16), A (5·4), D (5),
    # y (2·3·5), h_last (2·5·4) fp32
    assert sk.ssm_scan_bytes(2, 3, 5, 4, 2) == (
        2 * 2 * 3 * 5 * 2 + 2 * 2 * 3 * 4 * 2 + 4 * (20 + 5)
        + 4 * (30 + 40))
