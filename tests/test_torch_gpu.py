"""Card-only tests of the port (marked ``gpu``; they skip without CUDA).

They import nothing of JAX, so they run on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The CUDA ``commit_grid`` is held to its plain PyTorch version on the
same card tensors (fp32 at 1e-5, the reference's own tolerance; bf16 at
3e-2, its bf16 tolerance), and the engine's two commit backends are
held to each other.  The flash attention kernels are held to their plain
twins at the tolerances of tests/test_kernels.py (2e-5 for the fp32
forward, 2e-4 for fp32 gradients, 2e-2 for bf16), on odd shapes: head
dims 16, 32, 35, 36, 40, 48, 64, 100 and 128 (35 is padded to 36 by the
fp32 wrappers, 35, 36 and 100 to a multiple of 8 by the bf16 ones), GQA
ratios 1, 4 and 5, causal, full and windowed (a window below the 64-row
tile and a ragged one), Sq != Sk, and sequence lengths that are not a
multiple of the tile: fp32 inputs run ``flash_fwd_3xtf32`` and the fused
``flash_bwd_3xtf32`` (mma.sync in 3xTF32), bf16 inputs ``flash_fwd_tc``
(wgmma, TMA) and the fused ``flash_bwd_tc`` (mma.sync); both backward
kernels sum dq by atomics, so dq is only held to a tolerance, never
bitwise.  The per-node
``rfast_update_node`` and ``rfast_commit_node`` kernels are held to their
plain twins at odd P (1e-5 fp32, 3e-2 bf16, random weights and 0/1
masks, binary-tree and wider slot counts), and the three routes of the
protocol round (``kernel``, ``kernel`` with ``oracle=True``, ``plain``)
to each other on the card.  The ``ssm_scan`` kernel is held to its plain
twin (y and h_last; 1e-4 fp32, 3e-2 bf16, tests/test_kernels.py's scan
tolerances) at tests/test_kernels.py's cases and at ragged di, S and N,
with B and C as strided column slices, with its checkpoints and with its
time axis split; the ``ssm_scan_bwd`` kernel to its plain twin (the six
gradients, with and without a gradient of h_last, at odd and ragged
cases with strided B and C; 1e-4 fp32, 3e-2 bf16; dA, dB, dC and dD are
summed by atomics, so only to a tolerance); ``SelectiveScanFn`` launches
one of each and its gradients match plain autograd of the ref at 1e-4;
and a reduced hymba-1.5b sync train launches both once per layer per
gradient.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.scenario import get_scenario
from repro_torch.core.simulator import run_rfast, tracked_mass
from repro_torch.core.topology import get_topology
from repro_torch.kernels.flash_attention.backward import (
    flash_attention_vjp, flash_bwd, flash_bwd_plain, flash_dkv, flash_dq)
from repro_torch.kernels.flash_attention.kernel import (flash_fwd,
                                                        flash_fwd_plain)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rfast_update import dispatch
from repro_torch.kernels.rfast_update.grid import (commit_grid,
                                                   commit_grid_plain)
from repro_torch.kernels.rfast_update.kernel import (
    rfast_commit_node, rfast_commit_node_plain, rfast_update_node,
    rfast_update_node_plain)
from repro_torch.kernels.ssm_scan.backward import (ssm_scan_bwd,
                                                   ssm_scan_bwd_plain)
from repro_torch.kernels.ssm_scan.kernel import (CKPT_EVERY, scan_segments,
                                                 ssm_scan, ssm_scan_plain)
from repro_torch.kernels.ssm_scan.ops import SelectiveScanFn
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dispatch.clear()
    return torch.device("cuda")


def _case(P, dtype, B=5, ka=3, ko=2, seed=0):
    r = np.random.default_rng(seed)
    a = lambda *s: torch.from_numpy(r.normal(0, 1, s).astype(np.float32)
                                    ).to("cuda", dtype)
    i = lambda hi, *s: torch.from_numpy(r.integers(0, hi, s).astype(
        np.int32)).cuda()
    return dict(idx_z=i(20, B), idx_g=i(20, B), idx_ri=i(40, B, ka),
                idx_rb=i(16, B, ka), idx_ro=i(16, B, ko),
                a_self=a(B).float(), mask=i(2, B, ka).float(),
                a_out=a(B, ko).float(), z_src=a(20, P), g_new=a(B, P),
                go_src=a(20, P), ri_src=a(40, P), rb_src=a(16, P),
                ro_src=a(16, P))


@pytest.mark.parametrize("P", [1, 37, 4097, 100_001])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
def test_commit_grid_kernel_matches_plain(cuda, P, dtype, tol):
    kw = _case(P, dtype)
    kw["idx_ri"][0, 0] = 10_000            # drop sentinels clamp
    kw["idx_ro"][1, 0] = -4
    got = commit_grid(**kw)
    assert dispatch.launches("commit_grid") == 1
    want = commit_grid_plain(**kw)
    assert dispatch.launches("commit_grid") == 1   # plain: no launch
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.is_cuda
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)


def test_commit_grid_kernel_rejects_what_it_does_not_take(cuda):
    kw = _case(64, torch.float32)
    with pytest.raises(ValueError):
        commit_grid(**{**kw, "ro_src": kw["ro_src"].to(torch.bfloat16)})
    with pytest.raises(ValueError):
        commit_grid(**{**kw, "ri_src": kw["ri_src"].t().contiguous().t()})
    with pytest.raises(TypeError):
        commit_grid(**{k: (v.double() if k.endswith("src") or k == "g_new"
                           else v) for k, v in kw.items()})
    assert dispatch.launches("commit_grid") == 0


@pytest.mark.parametrize("topo_name,scen", [("binary_tree", "straggler"),
                                            ("exponential", "packet_loss")])
def test_engine_backends_agree_on_card(cuda, topo_name, scen):
    n, p = 5, 3000
    rng = np.random.default_rng(0)
    C = torch.from_numpy(rng.normal(0, 1, (n, p)).astype(np.float32)).cuda()
    S = torch.from_numpy(rng.uniform(0.5, 2, (n, 1)).astype(np.float32)
                         ).cuda()
    gfn = lambda i, x, gen: S[i] * (x - C[i])
    topo = get_topology(topo_name, n)
    sched = get_scenario(scen, n).realize(topo, 6 * n, seed=1).schedule
    x0 = torch.zeros(p, device="cuda")
    finals = {}
    for impl in ("plain", "kernel"):
        dispatch.clear()
        st, m = run_rfast(topo, sched, gfn, x0, 0.05, eval_every=2 * n,
                          eval_fn=lambda s, t: {}, impl=impl)
        waves = sum(x["waves"] for x in m)
        assert dispatch.launches("commit_grid") == (
            waves if impl == "kernel" else 0)
        torch.testing.assert_close(tracked_mass(st), st.g_prev.sum(0),
                                   rtol=1e-5, atol=1e-5)
        finals[impl] = [t.clone() for t in st[1:]]
    for a, b in zip(finals["kernel"], finals["plain"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_train_runs_on_the_card_by_default(cuda):
    from repro_torch.launch import train
    res = train.main(["--reduced", "--nodes", "4", "--steps", "3",
                      "--seq", "16", "--batch-per-node", "2",
                      "--scenario", "straggler", "--log-every", "1"])
    assert all(np.isfinite(res["losses"]))
    assert dispatch.launches("commit_grid") == res["waves"] > 0
    assert res["mass_rel"] < 1e-4


def test_sync_train_reports_its_memory_on_the_card(cuda):
    from repro_torch.launch import train
    dispatch.clear()
    res = train.main(["--reduced", "--nodes", "4", "--steps", "2",
                      "--seq", "16", "--batch-per-node", "2"])
    assert res["mode"] == "sync" and all(np.isfinite(res["losses"]))
    assert dispatch.launches("commit_grid") == res["rounds"] == 2
    mem = res["memory"]
    assert set(mem) == {"init", "round1"}
    assert mem["init"]["allocated"] >= res["state_bytes"]
    assert (mem["round1"]["peak_allocated"]
            >= mem["init"]["peak_allocated"] >= mem["init"]["allocated"])


# (B, H, KV, Sq, Sk, D, causal, window); bq = bk = 8 divides every S
# (or is cut to it)
FLASH_CASES = [
    (1, 4, 4, 128, 128, 32, True, None),
    (2, 8, 2, 256, 256, 64, False, None),
    (1, 5, 1, 192, 192, 128, True, 128),
    (1, 10, 2, 128, 256, 64, True, None),     # Sq < Sk, GQA 5
    (1, 4, 1, 256, 128, 32, True, None),      # Sq > Sk
    (1, 5, 5, 200, 200, 64, True, 5),         # window below one tile
    (2, 4, 4, 200, 200, 48, True, 100),       # ragged window, D = 48
    (1, 8, 2, 1, 1, 64, True, None),          # one query, one key
    (1, 2, 1, 64, 296, 100, False, None),     # D = 100, ragged Sk
    (3, 3, 3, 8, 72, 16, True, 7),            # D = 16, Sq < Sk, window
    (1, 4, 2, 136, 136, 36, True, None),      # D % 8 != 0
    (2, 4, 2, 136, 72, 40, True, 96),         # D % 16 != 0, Sq > Sk
    (1, 3, 1, 104, 104, 35, True, 50),        # D % 4 != 0
]
FLASH_DTYPES = [(torch.float32, 2e-5, 2e-4), (torch.bfloat16, 2e-2, 2e-2)]


def _flash_inputs(B, H, KV, Sq, Sk, D, dtype, seed=0):
    r = np.random.default_rng(seed)
    a = lambda *s: torch.from_numpy(r.normal(0, 1, s).astype(np.float32)
                                    ).cuda()
    return (a(B, H, Sq, D).to(dtype), a(B, KV, Sk, D).to(dtype),
            a(B, KV, Sk, D).to(dtype), a(B, H, Sq, D))


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype,tol,_", FLASH_DTYPES)
def test_flash_fwd_kernel_matches_plain(cuda, case, dtype, tol, _):
    B, H, KV, Sq, Sk, D, causal, window = case
    q, k, v, _do = _flash_inputs(B, H, KV, Sq, Sk, D, dtype)
    kw = dict(causal=causal, window=window, bq=8, bk=8)
    name = "flash_fwd_3xtf32" if dtype == torch.float32 else "flash_fwd_tc"
    o, lse = flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert dispatch.stats()["by_kernel"] == {name: 1}
    o_w, lse_w = flash_fwd_plain(q, k, v, **kw)
    assert dispatch.stats()["by_kernel"] == {name: 1}
    assert o.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(o.float(), o_w.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, lse_w, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype,_,tol", FLASH_DTYPES)
def test_flash_bwd_kernels_match_plain(cuda, case, dtype, _, tol):
    B, H, KV, Sq, Sk, D, causal, window = case
    q, k, v, do = _flash_inputs(B, H, KV, Sq, Sk, D, dtype)
    do = do.to(dtype)
    k, v = k.repeat_interleave(H // KV, 1), v.repeat_interleave(H // KV, 1)
    kw = dict(scale=D ** -0.5, causal=causal, window=window, bq=8, bk=8)
    o, lse = flash_fwd_plain(q, k, v, causal=causal, window=window, bq=8,
                             bk=8, out_dtype=torch.float32)
    delta = (do.float() * o).sum(-1)
    got = flash_bwd(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert dispatch.stats()["by_kernel"] == (
        {"flash_bwd_3xtf32": 1} if dtype == torch.float32
        else {"flash_bwd_tc": 1})
    want = flash_bwd_plain(q, k, v, do, lse, delta, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
def test_flash_vjp_through_kernels_with_gqa_repeat(cuda, dtype, tol):
    """Autograd through the two kernels; the GQA repeat is the caller's
    and its gradient sums over each group."""
    B, H, KV, S, D = 2, 8, 2, 192, 64
    q, k, v, w = _flash_inputs(B, H, KV, S, S, D, dtype, seed=1)
    grads = {}
    for path in ("kernel", "plain"):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        qq, kk, vv = leaves
        kk, vv = kk.repeat_interleave(4, 1), vv.repeat_interleave(4, 1)
        if path == "kernel":
            dispatch.clear()
            o = flash_attention_vjp(qq, kk, vv, True, 64, None, 64, 64)
        else:
            o = flash_fwd_plain(qq, kk, vv, window=64, bq=64, bk=64)[0]
        (o.float() * w).sum().backward()
        grads[path] = [t.grad for t in leaves]
        if path == "kernel":
            assert dispatch.stats()["by_kernel"] == (
                {"flash_fwd_3xtf32": 1, "flash_bwd_3xtf32": 1}
                if dtype == torch.float32 else
                {"flash_fwd_tc": 1, "flash_bwd_tc": 1})
    for g, p in zip(grads["kernel"], grads["plain"]):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), p.float(), rtol=tol, atol=tol)


def test_flash_op_kernel_matches_ref_on_card(cuda):
    q, k, v, _ = _flash_inputs(2, 8, 2, 256, 256, 64, torch.float32)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    for window in (None, 100):
        got = flash_attention(q, k, v, window=window, impl="kernel")
        want = flash_attention(q, k, v, window=window, impl="ref")
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert dispatch.launches("flash_fwd_3xtf32") == 2


def test_flash_kernels_reject_what_they_do_not_take(cuda):
    q, k, v, do = _flash_inputs(1, 2, 2, 128, 128, 64, torch.float32)
    wide = torch.zeros(1, 2, 128, 160, device="cuda")
    with pytest.raises(ValueError):
        flash_fwd(wide, wide, wide)                          # D > 128
    with pytest.raises(ValueError):
        flash_fwd(q, k.to(torch.bfloat16), v)                # mixed dtypes
    with pytest.raises(ValueError):
        flash_fwd(q[:, :, :120], k, v, bq=64)                # 120 % 64
    with pytest.raises(TypeError):
        flash_fwd(q.double(), k.double(), v.double())
    lse = torch.zeros(1, 2, 128, device="cuda")
    kw = dict(scale=0.125)
    with pytest.raises(ValueError):
        flash_bwd(wide, wide, wide, wide, lse, lse, **kw)    # D > 128
    with pytest.raises(ValueError):
        flash_bwd(q, k.to(torch.bfloat16), v, do, lse, lse, **kw)
    with pytest.raises(ValueError):
        flash_bwd(q, k, v, do, lse, lse, bk=96, **kw)        # 128 % 96
    with pytest.raises(ValueError):
        flash_bwd(q, k, v, do.to(torch.bfloat16), lse, lse, **kw)
    for fn in (flash_dq, flash_dkv):                         # fused only
        for dt in (torch.float32, torch.bfloat16):
            with pytest.raises(TypeError, match="flash_bwd"):
                fn(*(t.to(dt) for t in (q, k, v, do)), lse, lse, **kw)
    bq, bk, bv, bdo = (t.to(torch.bfloat16) for t in (q, k, v, do))
    with pytest.raises(ValueError):
        flash_bwd(bq, bk, bv, bdo, lse.to(torch.bfloat16), lse, **kw)
    with pytest.raises(ValueError):
        flash_bwd(wide.to(torch.bfloat16), wide.to(torch.bfloat16),
                  wide.to(torch.bfloat16), wide.to(torch.bfloat16), lse,
                  lse, **kw)                                 # D > 128
    assert dispatch.stats()["launches"] == 0


def test_flash_fwd_tc_writes_o_in_fp32_on_request(cuda):
    """bf16 inputs with ``out_dtype=float32`` (what the autograd forward
    asks for): o in fp32 from the same kernel, within the bf16 tolerance
    of the twin's fp32 o (p is rounded to bf16 before p·v)."""
    q, k, v, _ = _flash_inputs(1, 8, 2, 200, 200, 128, torch.bfloat16, 5)
    kw = dict(window=64, bq=8, bk=8, out_dtype=torch.float32)
    o, lse = flash_fwd(q, k, v, **kw)
    o_w, lse_w = flash_fwd_plain(q, k, v, **kw)
    assert dispatch.stats()["by_kernel"] == {"flash_fwd_tc": 1}
    assert o.dtype == torch.float32
    torch.testing.assert_close(o, o_w, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, lse_w, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype,tol,grad_tol", FLASH_DTYPES)
def test_flash_tc_kernels_take_strided_and_misaligned_inputs(cuda, dtype,
                                                             tol, grad_tol):
    """TMA and 16-byte cp.async copies need contiguous rows and 16-byte
    aligned addresses: the wrappers copy a transposed view and a tensor
    that starts one element into its storage, and give the twins'
    answers (bf16: the tensor-core kernels; fp32: the 3xTF32 ones)."""
    B, H, S, D = 1, 4, 136, 64
    flat = torch.randn(B * H * S * D + 1, device="cuda").to(dtype)
    q = flat[1:].view(B, H, S, D)                      # one element off
    assert q.data_ptr() % 16
    k = torch.randn(B, S, H, D, device="cuda").to(dtype)
    k = k.transpose(1, 2)                              # strided view
    v = torch.randn(B, H, S, D, device="cuda").to(dtype)
    do = torch.randn(B, H, S, D, device="cuda").to(dtype)
    kw = dict(bq=8, bk=8)
    o, lse = flash_fwd(q, k, v, **kw)
    o_w, lse_w = flash_fwd_plain(q, k, v, **kw)
    torch.testing.assert_close(o.float(), o_w.float(), rtol=tol, atol=tol)
    delta = (do.float() * flash_fwd_plain(q, k, v, out_dtype=torch.float32,
                                          **kw)[0]).sum(-1)
    got = flash_bwd(q, k, v, do, lse_w, delta, scale=D ** -0.5, **kw)
    want = flash_bwd_plain(q, k, v, do, lse_w, delta, scale=D ** -0.5, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=grad_tol, atol=grad_tol)
    assert dispatch.stats()["by_kernel"] == (
        {"flash_fwd_3xtf32": 1, "flash_bwd_3xtf32": 1}
        if dtype == torch.float32 else
        {"flash_fwd_tc": 1, "flash_bwd_tc": 1})


def test_flash_bwd_rounds_an_fp32_cotangent_once(cuda):
    """A direct bf16 call with an fp32 dO: the wrapper rounds it to bf16
    once, so the result is the bf16 cotangent's (dk, dv bitwise; dq, summed
    by atomics in a run-dependent order, within fp32 rounding)."""
    q, k, v, do = _flash_inputs(1, 4, 4, 200, 200, 64, torch.bfloat16, 3)
    o, lse = flash_fwd_plain(q, k, v, window=100, bq=8, bk=8,
                             out_dtype=torch.float32)
    delta = (do * o).sum(-1)
    kw = dict(scale=0.125, window=100, bq=8, bk=8)
    a = flash_bwd(q, k, v, do, lse, delta, **kw)
    b = flash_bwd(q, k, v, do.to(torch.bfloat16), lse, delta, **kw)
    assert dispatch.stats()["by_kernel"] == {"flash_bwd_tc": 2}
    torch.testing.assert_close(a[0], b[0], rtol=1e-5, atol=1e-5)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


def test_flash_bwd_fp32_runs_one_fused_kernel(cuda):
    """flash_bwd on fp32 tensors is one flash_bwd_3xtf32 launch a call:
    dk and dv bitwise repeatable, dq (summed by atomics in a run-dependent
    order) within fp32 rounding, all within 2e-4 of the plain twin."""
    q, k, v, do = _flash_inputs(2, 4, 4, 136, 136, 48, torch.float32, 4)
    o, lse = flash_fwd_plain(q, k, v, bq=8, bk=8)
    delta = (do * o).sum(-1)
    kw = dict(scale=48 ** -0.5, bq=8, bk=8)
    a = flash_bwd(q, k, v, do, lse, delta, **kw)
    b = flash_bwd(q, k, v, do, lse, delta, **kw)
    assert dispatch.stats()["by_kernel"] == {"flash_bwd_3xtf32": 2}
    torch.testing.assert_close(a[0], b[0], rtol=1e-5, atol=1e-5)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    for g, w in zip(a, flash_bwd_plain(q, k, v, do, lse, delta, **kw)):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4)


def _node_case(P, dtype, kw, ka, ko, seed=0):
    r = np.random.default_rng(seed)
    a = lambda *s: torch.from_numpy(r.normal(0, 1, s).astype(np.float32)
                                    ).to("cuda", dtype)
    w = lambda *s: torch.from_numpy(np.asarray(r.uniform(0, 1, s),
                                               np.float32)).cuda()
    return dict(x=a(P), z=a(P), g_new=a(P), g_old=a(P), v_in=a(kw, P),
                w_in=w(kw), rho_in=a(ka, P), rho_buf=a(ka, P),
                mask=torch.from_numpy(r.integers(0, 2, ka).astype(
                    np.float32)).cuda(), rho_out=a(ko, P), a_out=w(ko),
                gamma=float(r.uniform(0, 0.1)), w_self=w(),
                a_self=float(r.uniform(0, 1)))


COMMIT_KEYS = ("z", "g_new", "g_old", "rho_in", "rho_buf", "mask",
               "rho_out", "a_out", "a_self")


@pytest.mark.parametrize("P", [1, 37, 4097, 100_001])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("kw,ka,ko", [(1, 2, 1), (2, 3, 2)])
def test_node_kernels_match_plain(cuda, P, dtype, tol, kw, ka, ko):
    case = _node_case(P, dtype, kw, ka, ko)
    got = rfast_update_node(**case)
    torch.cuda.synchronize()
    assert dispatch.launches("rfast_update_node") == 1
    want = rfast_update_node_plain(**case)
    commit = {k: case[k] for k in COMMIT_KEYS}
    got_c = rfast_commit_node(**commit)
    torch.cuda.synchronize()
    assert dispatch.launches("rfast_commit_node") == 1
    want_c = rfast_commit_node_plain(**commit)
    for g, w in zip(got + got_c, want + want_c):
        assert g.dtype == dtype and g.is_cuda and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)


def test_node_kernels_reject_what_they_do_not_take(cuda):
    case = _node_case(64, torch.float32, 1, 2, 1)
    commit = {k: case[k] for k in COMMIT_KEYS}
    with pytest.raises(ValueError, match="one dtype"):
        rfast_update_node(**{**case, "v_in": case["v_in"].bfloat16()})
    with pytest.raises(ValueError, match="one dtype"):
        rfast_commit_node(**{**commit,
                             "rho_buf": commit["rho_buf"].bfloat16()})
    with pytest.raises(ValueError, match="contiguous"):
        rfast_commit_node(**{**commit, "rho_in": torch.randn(
            64, 2, device="cuda").t()})
    with pytest.raises(ValueError, match="<="):
        rfast_commit_node(**{**commit, "rho_in": torch.randn(
            9, 64, device="cuda"), "rho_buf": torch.randn(9, 64,
                                                          device="cuda"),
            "mask": torch.ones(9, device="cuda")})
    with pytest.raises(TypeError):
        rfast_update_node(**{k: (v.double() if torch.is_tensor(v)
                                 and v.dim() and v.shape[-1] == 64 else v)
                             for k, v in case.items()})
    assert dispatch.stats()["launches"] == 0


def test_node_ops_route_through_the_kernels(cuda):
    from repro_torch.kernels.rfast_update import ops
    case = _node_case(100_001, torch.float32, 1, 2, 1, seed=2)
    commit = {k: case[k] for k in COMMIT_KEYS}
    want = ops.rfast_update(**case, impl="ref")
    got = ops.rfast_update(**case, impl="kernel")
    assert dispatch.stats()["by_kernel"] == {"rfast_update_node": 1}
    for oracle, name in ((False, "commit_grid"), (True, "rfast_commit_node")):
        dispatch.clear()
        got_c = ops.rfast_commit(**commit, impl="kernel", oracle=oracle)
        assert dispatch.stats()["by_kernel"] == {name: 1}
        for g, w in zip(got_c, want[2:]):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_round_routes_agree_on_card(cuda):
    from repro_torch.core.runtime import (edge_arrays, init_node_state,
                                          make_rfast_round,
                                          runtime_tracked_mass)
    n, p = 7, 5000
    rng = np.random.default_rng(0)
    C = torch.from_numpy(rng.normal(0, 1, (n, p)).astype(np.float32)).cuda()
    S = torch.from_numpy(rng.uniform(0.5, 2, (n, 1)).astype(np.float32)
                         ).cuda()
    gfn = lambda x, b, k: (0.5 * torch.sum(b[1] * (x - b[0]) ** 2),
                           b[1] * (x - b[0]))
    spec = edge_arrays(get_topology("binary_tree", n))
    masks = [torch.from_numpy((rng.uniform(size=spec.e_pad) > 0.4).astype(
        np.float32)).cuda() for _ in range(6)]
    finals = {}
    for impl, oracle in (("kernel", False), ("kernel", True),
                         ("plain", False)):
        st = init_node_state(spec, torch.zeros(p, device="cuda"), gfn,
                             (C, S), robust=True, momentum=0.5)
        rf = make_rfast_round(spec, gfn, gamma=0.05, robust=True,
                              momentum=0.5, impl=impl, oracle=oracle,
                              donate=True)
        dispatch.clear()
        for mk in masks:
            st, _ = rf(st, (C, S), None, mk)
        torch.cuda.synchronize()
        assert dispatch.launches("commit_grid") == (
            len(masks) if impl == "kernel" and not oracle else 0)
        assert dispatch.launches("rfast_commit_node") == (
            len(masks) * n if oracle else 0)
        torch.testing.assert_close(runtime_tracked_mass(st),
                                   st.g_prev.sum(0), rtol=1e-4, atol=1e-4)
        finals[(impl, oracle)] = [st.x, st.z, st.rho, st.rho_buf]
    ref = finals.pop(("plain", False))
    for got in finals.values():
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# (B, S, di, N): tests/test_kernels.py's scan cases, then ragged di, S, N
SCAN_CASES = [(1, 64, 16, 8), (2, 128, 64, 16), (1, 256, 32, 16),
              (2, 1, 200, 4), (2, 100, 200, 16), (1, 129, 3200, 4),
              (3, 129, 33, 5), (1, 65, 1, 1)]


def _scan_inputs(Bsz, S, di, N, dtype, seed=0, strided=False):
    """u, dt (softplus(N(0,1) − 4.6), as the model feeds it), A = −(0.5..2),
    B, C (column slices of one projection when ``strided``), D."""
    r = np.random.default_rng(seed)
    a = lambda *s: torch.from_numpy(r.normal(0, 1, s).astype(np.float32)
                                    ).cuda()
    u = a(Bsz, S, di).to(dtype)
    dt = torch.nn.functional.softplus(a(Bsz, S, di) - 4.6).to(dtype)
    A = -torch.from_numpy(r.uniform(0.5, 2, (di, N)).astype(np.float32)
                          ).cuda()
    proj = a(Bsz, S, 3 + 2 * N).to(dtype)
    if strided:
        B, C = proj[..., 3:3 + N], proj[..., 3 + N:]
    else:
        B, C = proj[..., 3:3 + N].contiguous(), proj[..., 3 + N:].contiguous()
    return u, dt, A, B, C, a(di)


@pytest.mark.parametrize("case", SCAN_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("strided", [False, True])
def test_ssm_scan_kernel_matches_plain(cuda, case, dtype, tol, strided):
    args = _scan_inputs(*case, dtype, strided=strided)
    y, h = ssm_scan(*args)
    torch.cuda.synchronize()
    assert dispatch.launches("ssm_scan") == 1
    y_w, h_w = ssm_scan_plain(*args)
    assert dispatch.launches("ssm_scan") == 1      # the twin: no launch
    assert y.dtype == h.dtype == torch.float32
    torch.testing.assert_close(y, y_w, rtol=tol, atol=tol)
    torch.testing.assert_close(h, h_w, rtol=tol, atol=tol)


def test_ssm_scan_kernel_rejects_what_it_does_not_take(cuda):
    u, dt, A, B, C, D = _scan_inputs(2, 10, 40, 16, torch.float32)
    bad = [
        (TypeError, (u.double(), dt, A, B, C, D)),
        (TypeError, (u, dt.to(torch.bfloat16), A, B, C, D)),
        (TypeError, (u, dt, A.double(), B, C, D)),
        (ValueError, (u, dt, A, B.cpu(), C, D)),
        (ValueError, (u.transpose(1, 2).contiguous().transpose(1, 2), dt, A,
                      B, C, D)),
        (ValueError, (u, dt, A, B.transpose(1, 2).contiguous()
                      .transpose(1, 2), C, D)),
        (ValueError, (u, dt, A[:, :8], B, C, D)),
        (ValueError, _scan_inputs(1, 4, 8, 17, torch.float32)),
    ]
    for err, args in bad:
        with pytest.raises(err):
            ssm_scan(*args)
    assert dispatch.launches("ssm_scan") == 0


@pytest.mark.parametrize("case", SCAN_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("every,segments", [(CKPT_EVERY, 1), (7, 3)])
def test_ssm_scan_kernel_checkpoints_and_split_match_plain(
        cuda, case, dtype, tol, every, segments):
    args = _scan_inputs(*case, dtype, seed=1, strided=True)
    got = ssm_scan(*args, ckpt_every=every, segments=segments)
    torch.cuda.synchronize()
    assert dispatch.launches("ssm_scan") == 1
    want = ssm_scan_plain(*args, ckpt_every=every)
    assert len(got) == 3 and got[2].shape == want[2].shape
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)


def test_ssm_scan_split_takes_many_segments(cuda):
    """A long S split into up to 64 segments (the pass-B blocks of the
    last segments wait on 63 pass-A blocks each), and an S just past a
    segment boundary."""
    for S, segments in ((4096, 64), (1000, 5), (33, 2)):
        args = _scan_inputs(2, S, 100, 16, torch.float32, seed=S)
        dispatch.clear()
        y, h = ssm_scan(*args, segments=segments)
        torch.cuda.synchronize()
        assert dispatch.launches("ssm_scan") == 1
        y_w, h_w = ssm_scan_plain(*args, chunk=256)
        torch.testing.assert_close(y, y_w, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(h, h_w, rtol=1e-4, atol=1e-4)


def _bwd_case(case, dtype, seed, with_h, every=CKPT_EVERY):
    args = _scan_inputs(*case, dtype, seed=seed, strided=True)
    _, _, ckpt = ssm_scan_plain(*args, ckpt_every=every)
    r = torch.Generator(device="cuda").manual_seed(seed + 1)
    Bsz, S, di, N = case
    gy = torch.randn(Bsz, S, di, generator=r, device="cuda")
    gh = (torch.randn(Bsz, di, N, generator=r, device="cuda") if with_h
          else None)
    return (*args, gy, gh, ckpt)


@pytest.mark.parametrize("case", SCAN_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("with_h", [True, False])
def test_ssm_scan_bwd_kernel_matches_plain(cuda, case, dtype, tol, with_h):
    bargs = _bwd_case(case, dtype, 5, with_h)
    got = ssm_scan_bwd(*bargs, ckpt_every=CKPT_EVERY)
    torch.cuda.synchronize()
    assert dispatch.launches("ssm_scan_bwd") == 1
    want = ssm_scan_bwd_plain(*bargs, ckpt_every=CKPT_EVERY)
    assert dispatch.launches("ssm_scan_bwd") == 1   # the twin: no launch
    for name, g, w, x in zip("u dt A B C D".split(), got, want, bargs):
        assert g.dtype == w.dtype == x.dtype and g.shape == x.shape, name
        # relative to the gradient's size: dA, dD sum B·S terms
        scale = max(1.0, float(w.float().abs().max()))
        torch.testing.assert_close(g.float(), w.float(), rtol=tol,
                                   atol=tol * scale, msg=f"d{name}")


@pytest.mark.parametrize("every", [1, 7, 32])
def test_ssm_scan_bwd_kernel_at_other_checkpoint_spacings(cuda, every):
    bargs = _bwd_case((2, 100, 200, 16), torch.float32, 9, True, every)
    got = ssm_scan_bwd(*bargs, ckpt_every=every)
    want = ssm_scan_bwd_plain(*bargs, ckpt_every=every)
    for g, w in zip(got, want):
        scale = max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * scale)


def test_ssm_scan_bwd_kernel_rejects_what_it_does_not_take(cuda):
    u, dt, A, B, C, D, gy, gh, ck = _bwd_case((2, 10, 40, 16), torch.float32,
                                              0, True)
    bad = [
        (TypeError, (u.double(), dt, A, B, C, D, gy, gh, ck), CKPT_EVERY),
        (TypeError, (u, dt.to(torch.bfloat16), A, B, C, D, gy, gh, ck),
         CKPT_EVERY),
        (ValueError, (u, dt, A, B.cpu(), C, D, gy, gh, ck), CKPT_EVERY),
        (ValueError, (u, dt, A, B, C, D, gy.cpu(), gh, ck), CKPT_EVERY),
        (ValueError, (u, dt, A, B, C, D, gy[:, :5], gh, ck), CKPT_EVERY),
        (ValueError, (u, dt, A, B, C, D, gy, gh[:, :, :8], ck), CKPT_EVERY),
        (ValueError, (u, dt, A, B, C, D, gy, gh, ck), 3),   # 4 chunks
        (ValueError, (u, dt, A, B, C, D, gy, gh, ck.double()), CKPT_EVERY),
        (ValueError, (u, dt, A, B, C, D, gy, gh, ck), 0),
        (ValueError, (u, dt, A, B, C, D, gy, gh,
                      ssm_scan_plain(u, dt, A, B, C, D, ckpt_every=100)[2]),
         100),                       # more shared memory than a block has
        (ValueError, (u.transpose(1, 2).contiguous().transpose(1, 2), dt, A,
                      B, C, D, gy, gh, ck), CKPT_EVERY),
    ]
    for err, args, every in bad:
        with pytest.raises(err):
            ssm_scan_bwd(*args, ckpt_every=every)
    assert dispatch.launches("ssm_scan_bwd") == 0


@pytest.mark.parametrize("with_h", [True, False])
def test_selective_scan_fn_gradient_matches_plain_autograd(cuda, with_h):
    args = _scan_inputs(2, 70, 96, 16, torch.float32, seed=3, strided=True)
    leaves = [t.detach().requires_grad_() for t in args]
    r = torch.Generator(device="cuda").manual_seed(4)
    gy = torch.randn(2, 70, 96, generator=r, device="cuda")
    gh = torch.randn(2, 96, 16, generator=r, device="cuda")

    def loss(y, h):
        return (y * gy).sum() + ((h * gh).sum() if with_h else 0.0)

    got = torch.autograd.grad(loss(*SelectiveScanFn.apply(*leaves)), leaves)
    assert dispatch.launches("ssm_scan") == 1
    assert dispatch.launches("ssm_scan_bwd") == 1
    want = torch.autograd.grad(loss(*selective_scan_ref(*leaves)), leaves)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_selective_scan_fn_launches_one_forward_and_one_backward(cuda):
    """Strided B and C (the model's slices) in bf16: one launch of each
    kernel, gradients in the inputs' dtypes, no launch without a grad."""
    args = _scan_inputs(1, 129, 3200, 16, torch.bfloat16, strided=True)
    with torch.no_grad():
        SelectiveScanFn.apply(*args)
    assert dispatch.stats()["by_kernel"] == {"ssm_scan": 1}
    dispatch.clear()
    leaves = [t.detach().requires_grad_() for t in args]
    y, h = SelectiveScanFn.apply(*leaves)
    grads = torch.autograd.grad(y.sum() + h.sum(), leaves)
    torch.cuda.synchronize()
    assert dispatch.stats()["by_kernel"] == {"ssm_scan": 1,
                                             "ssm_scan_bwd": 1}
    assert [g.dtype for g in grads] == [a.dtype for a in args]
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads)


def test_selective_scan_fn_splits_a_long_sequence(cuda):
    """Few channel tiles and a long S, as a batch of one at S 4096 gives
    hymba-1.5b's layers: the autograd function's forward takes the split
    time axis (each segment's checkpoints from its true carry-in), and its
    gradients agree with the twins' from the unsplit scan."""
    Bsz, S, di, N = 1, 2048, 256, 16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert scan_segments(Bsz, S, di, N, sms) > 1
    args = _scan_inputs(Bsz, S, di, N, torch.float32, seed=7, strided=True)
    leaves = [t.detach().requires_grad_() for t in args]
    gy = torch.randn(Bsz, S, di, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(8))
    y, h = SelectiveScanFn.apply(*leaves)
    got = torch.autograd.grad((y * gy).sum() + h.sum(), leaves)
    torch.cuda.synchronize()
    assert dispatch.stats()["by_kernel"] == {"ssm_scan": 1,
                                             "ssm_scan_bwd": 1}
    y_w, h_w, ckpt = ssm_scan_plain(*args, chunk=256, ckpt_every=CKPT_EVERY)
    torch.testing.assert_close(y, y_w, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, h_w, rtol=1e-4, atol=1e-4)
    want = ssm_scan_bwd_plain(*args, gy, torch.ones_like(h_w), ckpt,
                              ckpt_every=CKPT_EVERY)
    for g, w in zip(got, want):
        scale = max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g / scale, w / scale, rtol=1e-4,
                                   atol=1e-4)


def test_hymba_sync_train_launches_the_scan_per_layer_and_gradient(cuda):
    from repro_torch.launch import train
    dispatch.clear()
    res = train.main(["--arch", "hymba-1.5b", "--reduced", "--nodes", "4",
                      "--steps", "2", "--seq", "16", "--batch-per-node",
                      "2", "--loss-prob", "0.2"])
    assert all(np.isfinite(res["losses"])) and res["mass_rel"] < 1e-4
    # 2 layers x 4 nodes x (init + 2 rounds)
    assert dispatch.stats()["by_kernel"] == {"ssm_scan": 2 * 4 * 3,
                                             "ssm_scan_bwd": 2 * 4 * 3,
                                             "commit_grid": 2}
