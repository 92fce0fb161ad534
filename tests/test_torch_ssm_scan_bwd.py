"""The scan's backward and its checkpoints against the JAX package, on the
CPU.

JAX has no backward scan kernel: it differentiates ``selective_scan_ref``
(``lax.scan``).  The port computes that gradient from the forward's
checkpoints, with a CUDA kernel on the card and the plain twin
``ssm_scan_bwd_plain`` here.  At tests/test_torch_ssm_scan.py's cases
(ragged S 33 and the model's inputs among them) the twin's six gradients
agree with ``jax.grad`` of JAX's ``selective_scan_ref`` at 1e-4 with and
without a gradient of h_last, and do not depend on the checkpoint spacing
(1e-5); the forward twin's checkpoints are JAX's ref run on prefixes
(1e-4); bf16 inputs give bf16
gradients within 3e-2 of the fp32 twin on the rounded inputs; and
``SelectiveScanFn`` runs both twins on CPU tensors and records no launch.
The twin split as the kernel splits its time axis (2, 3 and 5 segments
on checkpoint bounds, S not a multiple of the segment length in most
cases: pass A from a zero carry, the combine, pass B) agrees with
``jax.grad`` at 1e-4 and with the unsplit twin at 1e-5 of each gradient's
largest entry (the combine rounds differently from the sequential
chain: ~2e-7 of it), and in bf16 within 3e-2 of the fp32 twin; the
backward's split rule and its counts of work and shared memory follow
the kernel.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import selective_scan_ref as j_scan_ref
from repro_torch.kernels import meta
from repro_torch.kernels.rfast_update import dispatch
from repro_torch.kernels.ssm_scan import backward as sb
from repro_torch.kernels.ssm_scan import kernel as sk
from repro_torch.kernels.ssm_scan.ops import SelectiveScanFn
from test_torch_ssm_scan import CASES, MODEL_CASE, _inputs, _rounded

NAMES = "u dt A B C D".split()


def _cotangents(ci: int):
    Bsz, S, di, N = CASES[ci][:4]
    r = np.random.default_rng(100 + ci)
    return (r.normal(size=(Bsz, S, di)).astype(np.float32),
            r.normal(size=(Bsz, di, N)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_grads(ci: int, with_h: bool):
    gy, gh = _cotangents(ci)

    def loss(*a):
        y, h = j_scan_ref(*a)
        return jnp.sum(y * gy) + (jnp.sum(h * gh) if with_h else 0.0)

    g = jax.grad(loss, argnums=tuple(range(6)))(
        *map(jnp.asarray, _inputs(ci)))
    return tuple(np.asarray(a) for a in g)


def _twin_grads(args, ci, with_h, every, dtype=torch.float32, segments=1):
    gy, gh = _cotangents(ci)
    t = [a.to(dtype) if i in (0, 1, 3, 4) else a for i, a in enumerate(args)]
    _, _, ckpt = sk.ssm_scan_plain(*t, ckpt_every=every)
    return sb.ssm_scan_bwd_plain(
        *t, torch.from_numpy(gy), torch.from_numpy(gh) if with_h else None,
        ckpt, ckpt_every=every, segments=segments)


def _tensors(ci):
    return [torch.from_numpy(a) for a in _inputs(ci)]


@pytest.mark.parametrize("with_h", [True, False])
@pytest.mark.parametrize("ci", range(len(CASES)))
def test_bwd_twin_matches_jax_grad(ci, with_h):
    grads = _twin_grads(_tensors(ci), ci, with_h, sk.CKPT_EVERY)
    for name, g, w in zip(NAMES, grads, _jax_grads(ci, with_h)):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4,
                                   err_msg=f"d{name}")


SPLITS = [2, 3, 5]


@pytest.mark.parametrize("segments", SPLITS)
@pytest.mark.parametrize("with_h", [True, False])
@pytest.mark.parametrize("ci", range(len(CASES)))
def test_bwd_split_twin_matches_jax_grad(ci, with_h, segments):
    grads = _twin_grads(_tensors(ci), ci, with_h, sk.CKPT_EVERY,
                        segments=segments)
    for name, g, w in zip(NAMES, grads, _jax_grads(ci, with_h)):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("segments", SPLITS)
@pytest.mark.parametrize("with_h", [True, False])
@pytest.mark.parametrize("ci", range(len(CASES)))
def test_bwd_split_twin_matches_the_unsplit_twin(ci, with_h, segments):
    S = CASES[ci][1]
    seg = sk.bwd_segment_length(S, segments, sk.CKPT_EVERY)
    assert seg % sk.CKPT_EVERY == 0 and -(-S // seg) > 1
    args = _tensors(ci)
    want = _twin_grads(args, ci, with_h, sk.CKPT_EVERY)
    got = _twin_grads(args, ci, with_h, sk.CKPT_EVERY, segments=segments)
    for name, g, w in zip(NAMES, got, want):
        scale = max(1.0, float(w.abs().max()))
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=f"d{name}")


@pytest.mark.parametrize("segments", SPLITS)
@pytest.mark.parametrize("ci", range(len(CASES)))
def test_bwd_split_twin_bf16_gradients_near_the_fp32_twin(ci, segments):
    rounded = [torch.from_numpy(a) for a in _rounded(ci, "bfloat16")]
    want = _twin_grads(rounded, ci, True, sk.CKPT_EVERY)
    got = _twin_grads(rounded, ci, True, sk.CKPT_EVERY, torch.bfloat16,
                      segments=segments)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == (torch.float32 if name in "AD" else
                           torch.bfloat16), name
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=3e-2,
                                   atol=3e-2, err_msg=f"d{name}")


@pytest.mark.parametrize("every", [1, 7, 64, "S"])
@pytest.mark.parametrize("ci", [1, MODEL_CASE])
def test_bwd_twin_checkpoint_spacing_leaves_the_gradients(ci, every):
    S = CASES[ci][1]
    args = _tensors(ci)
    want = _twin_grads(args, ci, True, sk.CKPT_EVERY)
    got = _twin_grads(args, ci, True, S if every == "S" else every)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("every", [7, sk.CKPT_EVERY])
@pytest.mark.parametrize("ci", range(len(CASES)))
def test_forward_checkpoints_are_the_ref_on_prefixes(ci, every):
    u, dt, A, B, C, D = _inputs(ci)
    y, h, ckpt = sk.ssm_scan_plain(*_tensors(ci), ckpt_every=every)
    S = u.shape[1]
    assert ckpt.shape == (u.shape[0], -(-S // every), *A.shape)
    assert torch.count_nonzero(ckpt[:, 0]) == 0
    for k in range(1, ckpt.shape[1]):
        t = k * every
        _, hj = j_scan_ref(*map(jnp.asarray, (u[:, :t], dt[:, :t], A,
                                              B[:, :t], C[:, :t], D)))
        np.testing.assert_allclose(ckpt[:, k].numpy(), np.asarray(hj),
                                   rtol=1e-4, atol=1e-4, err_msg=f"k {k}")
    y0, h0 = sk.ssm_scan_plain(*_tensors(ci))
    assert torch.equal(y, y0) and torch.equal(h, h0)


@pytest.mark.parametrize("ci", range(len(CASES)))
def test_bwd_twin_bf16_gradients_near_the_fp32_twin(ci):
    rounded = [torch.from_numpy(a) for a in _rounded(ci, "bfloat16")]
    want = _twin_grads(rounded, ci, True, sk.CKPT_EVERY)
    got = _twin_grads(rounded, ci, True, sk.CKPT_EVERY, torch.bfloat16)
    for name, g, w, dtype in zip(NAMES, got, want,
                                 [torch.bfloat16] * 2 + [torch.float32]
                                 + [torch.bfloat16] * 2 + [torch.float32]):
        assert g.dtype == dtype, name
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=3e-2,
                                   atol=3e-2, err_msg=f"d{name}")


@pytest.mark.parametrize("with_h", [True, False])
@pytest.mark.parametrize("ci", [0, 2])
def test_scan_fn_gradients_match_jax_grad_at_the_other_cases(ci, with_h):
    """tests/test_torch_ssm_scan.py holds cases 1 and 3; these are the
    other two."""
    gy, gh = _cotangents(ci)
    leaves = [t.requires_grad_() for t in _tensors(ci)]
    y, h = SelectiveScanFn.apply(*leaves)
    loss = (y * torch.from_numpy(gy)).sum()
    if with_h:
        loss = loss + (h * torch.from_numpy(gh)).sum()
    for name, g, w in zip(NAMES, torch.autograd.grad(loss, leaves),
                          _jax_grads(ci, with_h)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4,
                                   err_msg=f"d{name}")


def test_scan_fn_on_cpu_runs_the_twins_and_launches_nothing():
    gy, gh = _cotangents(MODEL_CASE)
    leaves = [t.requires_grad_() for t in _tensors(MODEL_CASE)]
    dispatch.clear()
    y, h = SelectiveScanFn.apply(*leaves)
    grads = torch.autograd.grad(
        (y * torch.from_numpy(gy)).sum() + (h * torch.from_numpy(gh)).sum(),
        leaves)
    want = _twin_grads([t.detach() for t in leaves], MODEL_CASE, True,
                       sk.CKPT_EVERY)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    assert dispatch.stats()["launches"] == 0


def test_scan_fn_gradient_of_h_alone_and_of_some_inputs():
    """Only h_last reaches the loss (gy absent), and only A and C ask for
    a gradient: the others come back None."""
    _, gh = _cotangents(1)
    u, dt, A, B, C, D = _tensors(1)
    A.requires_grad_()
    C.requires_grad_()
    ctx_grads = []

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *a):
            return SelectiveScanFn.forward(ctx, *a)

        @staticmethod
        def backward(ctx, gy_, gh_):
            out = SelectiveScanFn.backward(ctx, gy_, gh_)
            ctx_grads.append(out)
            return out

    _, h = Probe.apply(u, dt, A, B, C, D)
    gA, gC = torch.autograd.grad((h * torch.from_numpy(gh)).sum(), [A, C])
    assert [g is None for g in ctx_grads[0]] == [True, True, False, True,
                                                  False, True]
    j = jax.grad(lambda a, c: jnp.sum(j_scan_ref(
        *map(jnp.asarray, (_inputs(1)[0], _inputs(1)[1])), a,
        jnp.asarray(_inputs(1)[3]), c, jnp.asarray(_inputs(1)[5]))[1] * gh),
        argnums=(0, 1))(jnp.asarray(_inputs(1)[2]),
                        jnp.asarray(_inputs(1)[4]))
    np.testing.assert_allclose(gA.numpy(), np.asarray(j[0]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(gC.numpy(), np.asarray(j[1]), rtol=1e-4,
                               atol=1e-4)
    # C takes no part in h_last
    assert torch.count_nonzero(gC) == 0


def test_cpu_wrappers_run_the_twins_and_check_their_arguments():
    args = _tensors(MODEL_CASE)
    dispatch.clear()
    got = sk.ssm_scan(*args, ckpt_every=5)
    want = sk.ssm_scan_plain(*args, ckpt_every=5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    gy, _ = _cotangents(MODEL_CASE)
    g = sb.ssm_scan_bwd(*args, torch.from_numpy(gy), None, got[2],
                        ckpt_every=5)
    w = sb.ssm_scan_bwd_plain(*args, torch.from_numpy(gy), None, got[2],
                              ckpt_every=5)
    assert all(torch.equal(a, b) for a, b in zip(g, w))
    assert dispatch.stats()["launches"] == 0
    with pytest.raises(ValueError, match="ckpt_every"):
        sk.ssm_scan_plain(*args, ckpt_every=0)
    with pytest.raises(ValueError, match="segments"):
        sk.ssm_scan(*args, segments=2)
    with pytest.raises(ValueError, match="checkpoints"):
        sb.ssm_scan_bwd_plain(*args, torch.from_numpy(gy), None, got[2],
                              ckpt_every=6)
    # meta tensors (the launch tooling's dry-run): nothing runs, empty
    # meta gradients of the inputs' shapes, one noted launch, no count
    with meta.recording() as calls:
        mg = sb.ssm_scan_bwd(*(a.to("meta") for a in args),
                             torch.from_numpy(gy).to("meta"), None,
                             got[2].to("meta"), ckpt_every=5)
    assert [(m.device.type, m.shape, m.dtype) for m in mg] == [
        ("meta", a.shape, a.dtype) for a in args]
    assert [c["name"] for c in calls] == ["ssm_scan_bwd"]
    assert dispatch.stats()["launches"] == 0


def test_split_rule_fills_the_card_and_keeps_segments_long():
    sms = 132
    # hymba-1.5b's train shape gives 1600 warps: no split
    assert sk.scan_segments(4, 128, 3200, 16, sms) == 1
    # hymba-1.5b's op width gives 400 warps, falcon-mamba-7b's 1024 (two
    # a sub-partition): the first splits in 8, the second not at all
    assert sk.scan_segments(1, 4096, 3200, 16, sms) == 8
    assert sk.scan_segments(1, 4096, 8192, 16, sms) == 1
    # short sequences are never split
    assert sk.scan_segments(1, sk.MIN_SEGMENT, 64, 16, sms) == 1
    for Bsz, S, di in [(1, 4096, 64), (2, 1000, 96), (1, 2100, 32),
                       (1, 70_000, 32), (1, 70_000, 32 * 600)]:
        nseg = sk.scan_segments(Bsz, S, di, 16, sms)
        seg = sk.segment_length(S, nseg)
        assert nseg == 1 or (nseg == -(-S // seg) >= sk.MIN_SEGMENTS
                             and seg >= sk.MIN_SEGMENT)
        warps = Bsz * -(-di // sk.SCAN_TILE) * 4
        if warps >= sk.SPLIT_BELOW_WARPS_PER_SM * sms:
            assert nseg == 1


def test_bwd_split_rule_splits_the_op_widths_on_checkpoint_bounds():
    sms = 132
    # hymba-1.5b's op width (100 rows of blocks): one wave of pass-B
    # blocks, 5 segments; falcon-mamba-7b's (256 rows): two waves, 4; the
    # tensor-parallel ranks' shapes (64 and 200 rows at S 128): 8 and 4
    assert sk.scan_bwd_segments(1, 4096, 3200, 16, sms) == 5
    assert sk.scan_bwd_segments(1, 4096, 8192, 16, sms) == 4
    assert sk.scan_bwd_segments(1, 128, 2048, 16, sms) == 8
    assert sk.scan_bwd_segments(4, 128, 1600, 16, sms) == 4
    # the train shape's 400 rows fill the card: no split; nor a short S
    assert sk.scan_bwd_segments(4, 128, 3200, 16, sms) == 1
    assert sk.scan_bwd_segments(1, sk.BWD_MIN_SEGMENT, 64, 16, sms) == 1
    assert sk.scan_bwd_segments(1, 0, 64, 16, sms) == 1
    slots = sk.BWD_BLOCKS_PER_SM * sms
    for Bsz, S, di, N in [(1, 4096, 64, 16), (2, 1000, 96, 16),
                          (1, 2100, 32, 4), (1, 70_000, 32, 16),
                          (1, 129, 3200, 16), (1, 70_000, 32 * 600, 8),
                          (3, 333, 200, 5)]:
        nseg = sk.scan_bwd_segments(Bsz, S, di, N, sms)
        seg = sk.bwd_segment_length(S, nseg, sk.CKPT_EVERY)
        rows = Bsz * -(-di // sk.SCAN_TILE)
        # every bound on a checkpoint, every segment non-empty, at most
        # two waves of pass-B blocks
        assert seg % sk.CKPT_EVERY == 0 and nseg == -(-S // seg)
        assert nseg == 1 or (seg >= sk.BWD_MIN_SEGMENT
                             and nseg * rows <= 2 * slots)
        if 2 * rows > slots:
            assert nseg == 1


def test_bwd_ops_count_the_split_kernels_work():
    Bsz, S, di, N = 2, 100, 40, 16
    base = sb.ssm_scan_bwd_ops(Bsz, S, di, N)
    assert base == (Bsz * S * di * (19 * N + 9), Bsz * S * di * N)
    assert sb.ssm_scan_bwd_ops(Bsz, S, di, N, segments=1) == base
    # 3 segments of 40 steps (on the 8-step checkpoints): pass A runs the
    # last 60 steps once more (4 operations and an exponential a state,
    # Σ dt a channel), the two decays, and 3 · 2 / 2 combines of 2
    ops, exps = sb.ssm_scan_bwd_ops(Bsz, S, di, N, segments=3)
    planes = Bsz * di * N
    assert ops - base[0] == (Bsz * 60 * di * (4 * N + 1) + 2 * planes
                             + 6 * planes)
    assert exps - base[1] == Bsz * 60 * di * N + 2 * planes


def test_bwd_bytes_and_shared_memory_count_what_the_kernel_moves():
    # u, dt (2·3·5 bf16 each), B, C (2·3·4 bf16 each); gy (2·3·5), 2
    # checkpoints (2·2·5·4), gh (2·5·4), A (5·4), D (5) fp32 read; du, ddt
    # (2·3·5), dA (5·4), dB, dC (2·3·4), dD (5) fp32 written
    assert sb.ssm_scan_bwd_bytes(2, 3, 5, 4, 2, 2) == (
        2 * 2 * 3 * 5 * 2 + 2 * 2 * 3 * 4 * 2
        + 4 * (30 + 80 + 40 + 20 + 5) + 4 * (60 + 20 + 48 + 5))
    assert sb.ssm_scan_bwd_bytes(2, 3, 5, 4, 2, 2, with_h=False) == (
        sb.ssm_scan_bwd_bytes(2, 3, 5, 4, 2, 2) - 4 * 40)
    # two staging buffers of 8 steps: gy (32 fp32), the checkpoint (32 ×
    # 16 fp32), u, dt (32 of 4 bytes), B, C (16 of 4 bytes); the dB, dC
    # partials of 8 steps × 4 warps × 32 floats; the ticket: 16 KB, so the
    # shared memory leaves four blocks an SM (the registers decide)
    assert sb.bwd_smem_bytes(16) == 2 * (8 * 128 + 32 * 64 + 2 * 8 * 128
                                         + 2 * 8 * 64) + 8 * 4 * 128 + 4
    assert sb.bwd_smem_bytes(16) == 16388
    assert 4 * sb.bwd_smem_bytes(16) <= 228 * 1024
    assert sb.bwd_smem_bytes(4, 2) == 2 * (8 * 128 + 32 * 64 + 2 * 8 * 64
                                           + 2 * 8 * 32) + 8 * 1 * 128 + 4
