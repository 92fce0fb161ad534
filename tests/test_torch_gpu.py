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
cases with strided B and C, its time axis unsplit, split in 2, 3 and as
``scan_bwd_segments`` splits it, and at a long S the rule splits; 1e-4
fp32, 3e-2 bf16; dA, dB, dC and dD are summed by atomics, so only to a
tolerance); ``SelectiveScanFn`` launches
one of each and its gradients match plain autograd of the ref at 1e-4;
and a reduced hymba-1.5b sync train launches both once per layer per
gradient.  The fleet sweep launches one ``commit_grid`` per fleet wave
and its lanes match the plain backend and ``run_rfast`` at 1e-5; the
event engine launches nothing and matches the wavefront kernel route at
1e-4.  The epochized engine (``run_epochs`` on ``root_failover`` and
``churn``) launches one ``commit_grid`` per non-empty wave of every
epoch and matches its plain backend at 1e-5; card tensors survive a
checkpoint round trip bitwise, back on the card, and a run resumed from
a chunk boundary on the card is bitwise the uninterrupted one.  Serving:
``init_params`` draws on a CUDA generator's device; ``prefill_cache`` +
``decode_step`` on the card match the CPU at 1e-4 of the largest |logit|
(reduced rfast-100m, hymba-1.5b, falcon-mamba-7b), the SSM layers'
prefill launching ``ssm_scan`` once each and a decode step none; and the
serving engine on the card serves the CPU's tokens (one argmax tie
allowed) with 1 decode + one prefill entry per bucket used.  The model
zoo: reduced olmo-1b, phi3.5-moe-42b-a6.6b (MoE) and deepseek-v2-236b
(MLA + MoE) decode on the card as on the CPU, ``decode_step_slots``
(each slot's MoE routed alone) too, and the stable sort that assigns a
token its slot in an expert, and so the tokens a full expert drops,
agrees with the CPU's on the card.  Multi-device on the one card: a
world-1 NCCL group's 1 x 1 mesh sweep is bitwise the unsharded run; two
ranks sharing the card over a gloo group run a (1, 2) mesh at an odd
shard width (``commit_grid`` at Pf = p_loc) within 2e-5 of the unsharded
run, and a two-node ppermute round (point-to-point staged through pinned
host buffers) within 1e-4 of the dense round.
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
from repro_torch.kernels.ssm_scan.kernel import (CKPT_EVERY,
                                                 scan_bwd_segments,
                                                 scan_segments, ssm_scan,
                                                 ssm_scan_plain)
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


def _logistic_fleet(n=7, K=140):
    from repro_torch.data import make_logistic_problem
    prob = make_logistic_problem(n, m=700, d=12, batch=8, heterogeneous=True)
    topo = get_topology("binary_tree", n)
    scheds = [get_scenario(sc, n).realize(topo, K, seed=s).schedule
              for s, sc in enumerate(["straggler", "packet_loss", "uniform"])]
    return prob, topo, scheds


def test_fleet_kernel_matches_plain_on_card(cuda):
    """One ``commit_grid`` launch per fleet wave (not per lane wave), and
    the fleet's lanes equal ``run_rfast(seed=s)`` on the card."""
    from repro_torch.core.simulator import run_sweep
    prob, topo, scheds = _logistic_fleet()
    finals = {}
    for impl in ("plain", "kernel"):
        dispatch.clear()
        states, metrics = run_sweep([topo] * 3, scheds, prob,
                                    torch.zeros(prob.p), 2e-3,
                                    seeds=[0, 1, 2], eval_every=35,
                                    eval_fn=lambda st, t: {}, impl=impl)
        waves = sum(m["waves"] for m in metrics[0])
        assert dispatch.launches("commit_grid") == (
            waves if impl == "kernel" else 0)
        finals[impl] = [[t.clone() for t in st[1:7]] for st in states]
    lane_waves = 0
    for s, sched in enumerate(scheds):
        dispatch.clear()
        ref, rm = run_rfast(topo, sched, prob, torch.zeros(prob.p), 2e-3,
                            seed=s, eval_every=35, eval_fn=lambda st, t: {})
        lane_waves += dispatch.launches("commit_grid")
        for a, b, c in zip(finals["kernel"][s], finals["plain"][s], ref[1:7]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5)
    assert waves < lane_waves


def test_event_matches_wavefront_on_card(cuda):
    """The event oracle on CUDA tensors launches nothing and gives the
    wavefront kernel route's trajectory (same generators per event)."""
    prob, topo, scheds = _logistic_fleet()
    finals = {}
    for mode in ("event", "wavefront"):
        dispatch.clear()
        st, m = run_rfast(topo, scheds[0], prob, torch.zeros(prob.p), 2e-3,
                          seed=3, mode=mode, eval_every=35,
                          eval_fn=lambda st, t: {})
        assert dispatch.launches("commit_grid") == sum(
            x.get("waves", 0) for x in m)
        assert (dispatch.launches("commit_grid") > 0) == (mode != "event")
        assert st.x.is_cuda
        finals[mode] = [t.clone() for t in st[1:7]]
        torch.testing.assert_close(tracked_mass(st), st.g_prev.sum(0),
                                   rtol=1e-4, atol=1e-4)
    for a, b in zip(finals["event"], finals["wavefront"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


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
@pytest.mark.parametrize("segments", [1, 2, 3, None])   # None: the rule's
def test_ssm_scan_bwd_kernel_matches_plain(cuda, case, dtype, tol, with_h,
                                           segments):
    bargs = _bwd_case(case, dtype, 5, with_h)
    got = ssm_scan_bwd(*bargs, ckpt_every=CKPT_EVERY, segments=segments)
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


@pytest.mark.parametrize("every", [1, 3, 7])
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
         100),                       # chunks longer than the kernel's 8
        (ValueError, (u, dt, A, B, C, D, gy, gh,
                      ssm_scan_plain(u, dt, A, B, C, D, ckpt_every=9)[2]), 9),
        (ValueError, (u, dt, A, B, C, D, gy, gh, ck), CKPT_EVERY, 0),
        (ValueError, (u.transpose(1, 2).contiguous().transpose(1, 2), dt, A,
                      B, C, D, gy, gh, ck), CKPT_EVERY),
    ]
    for err, args, every, *segments in bad:
        with pytest.raises(err):
            ssm_scan_bwd(*args, ckpt_every=every,
                         segments=segments[0] if segments else None)
    assert dispatch.launches("ssm_scan_bwd") == 0


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_ssm_scan_bwd_kernel_splits_a_long_sequence(cuda, dtype, tol):
    """A batch of one at a long S over few channel tiles, which the rule
    splits (pass-B blocks of the first segments wait on many pass-A
    blocks), and a split into segments of one checkpoint chunk each."""
    case = (1, 2048, 256, 16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rule = scan_bwd_segments(*case, sms)
    assert rule > 1
    bargs = _bwd_case(case, dtype, 11, True)
    want = ssm_scan_bwd_plain(*bargs, ckpt_every=CKPT_EVERY)
    for segments in (None, case[1] // CKPT_EVERY):
        dispatch.clear()
        got = ssm_scan_bwd(*bargs, ckpt_every=CKPT_EVERY, segments=segments)
        torch.cuda.synchronize()
        assert dispatch.launches("ssm_scan_bwd") == 1
        for name, g, w in zip("u dt A B C D".split(), got, want):
            scale = max(1.0, float(w.float().abs().max()))
            torch.testing.assert_close(g.float(), w.float(), rtol=tol,
                                       atol=tol * scale, msg=f"d{name}")


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


@pytest.mark.parametrize("scen,topo_name,n", [
    ("root_failover", "robust_tree", 8), ("churn", "binary_tree", 4)])
def test_run_epochs_kernel_matches_plain_on_card(cuda, scen, topo_name, n):
    from repro_torch.core.simulator import run_epochs
    from repro_torch.data import make_logistic_problem
    prob = make_logistic_problem(n, m=700, d=12, batch=8, heterogeneous=True)
    et = get_scenario(scen, n).realize_epochs(get_topology(topo_name, n),
                                              40 * n, seed=0)
    assert len(et.epochs) > 1
    finals = {}
    for impl in ("plain", "kernel"):
        dispatch.clear()
        st, m = run_epochs(et, prob, torch.zeros(prob.p), 2e-3, seed=1,
                           eval_every=5 * n, eval_fn=lambda s, t: {},
                           impl=impl)
        waves = sum(x["waves"] for x in m)
        assert dispatch.launches("commit_grid") == (
            waves if impl == "kernel" else 0)
        assert st.x.is_cuda
        torch.testing.assert_close(tracked_mass(st), st.g_prev.sum(0),
                                   rtol=1e-4, atol=1e-4)
        finals[impl] = [t.clone() for t in st[1:7]]
    for a, b in zip(finals["kernel"], finals["plain"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_checkpoint_round_trip_of_card_tensors(cuda, tmp_path):
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.core.simulator import zeros_state
    topo = get_topology("binary_tree", 4)
    like = zeros_state(topo, 1000, 6)
    assert like.x.is_cuda
    g = torch.Generator(device="cuda").manual_seed(0)
    st = like._replace(k=12, **{f: torch.randn(getattr(like, f).shape,
                                               generator=g, device="cuda")
                                for f in like._fields[1:]})
    save_checkpoint(str(tmp_path), 12, st)
    back = load_checkpoint(str(tmp_path), like)
    assert back.k == 12
    for f in like._fields[1:]:
        assert getattr(back, f).is_cuda
        assert torch.equal(getattr(back, f), getattr(st, f)), f


def test_resumed_run_is_bitwise_on_card(cuda):
    prob, topo, scheds = _logistic_fleet()
    saved = {}

    def keep(st, k):
        if k == 70:
            saved["st"] = st._replace(**{f: getattr(st, f).clone()
                                         for f in st._fields[1:]})

    st, _ = run_rfast(topo, scheds[0], prob, torch.zeros(prob.p), 2e-3,
                      seed=2, eval_every=35, chunk_cb=keep)
    st2, _ = run_rfast(topo, scheds[0], prob, None, 2e-3, seed=2,
                       eval_every=35, state0=saved["st"])
    for f in st._fields[1:]:
        assert torch.equal(getattr(st, f), getattr(st2, f)), f


def _to_card(tree: dict) -> dict:
    return {k: _to_card(v) if isinstance(v, dict) else v.cuda()
            for k, v in tree.items()}


def _serve_model(arch: str):
    """A reduced arch's weights on the CPU and the same on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    cfg = get_config(arch).reduced()
    cpu = init_params(cfg, torch.Generator().manual_seed(0))
    return cfg, cpu, _to_card(cpu)


def test_init_params_draws_on_a_cuda_generator(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    cfg = get_config("hymba-1.5b").reduced()
    p = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    leaves = [p["embed"], p["lm_head"], p["final_norm"]["scale"]] + [
        t for sub in p["layers"].values() for t in sub.values()]
    assert all(t.is_cuda and t.dtype == torch.float32 for t in leaves)
    assert abs(float(p["embed"].std()) - 0.02) < 2e-3


@pytest.mark.parametrize("arch", ["rfast-100m", "hymba-1.5b",
                                  "falcon-mamba-7b", "olmo-1b",
                                  "phi3.5-moe-42b-a6.6b",
                                  "deepseek-v2-236b", "whisper-large-v3",
                                  "pixtral-12b"])
def test_prefill_and_decode_on_the_card_match_the_cpu(cuda, arch):
    """prefill_cache + decode_step on the card against the same on the
    CPU (the scan's plain twin there) at 1e-4 of the largest |logit|; the
    SSM layers' prefill launches ssm_scan once each, decode none.  A
    frontend arch prefills with its frames (whisper: the encoder and the
    cross caches) or patches (pixtral: prepended to the prompt)."""
    from repro_torch.models import transformer as tt
    cfg, cpu, card = _serve_model(arch)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12)))
    front, max_len = None, 12
    if cfg.frontend:
        front = torch.from_numpy(rng.standard_normal(
            (2, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32))
        max_len += 0 if cfg.enc_dec else cfg.frontend_seq
    c0, l0 = tt.prefill_cache(cfg, cpu, toks[:, :6], max_len,
                              frontend=front)
    dispatch.clear()
    c1, l1 = tt.prefill_cache(cfg, card, toks[:, :6].cuda(), max_len,
                              frontend=None if front is None
                              else front.cuda())
    ssm_layers = cfg.n_layers if cfg.mixer != "attn" else 0
    assert dispatch.launches("ssm_scan") == ssm_layers
    assert (l1.cpu() - l0).abs().max() <= 1e-4 * l0.abs().max()
    for t in range(6, 12):
        l0, c0 = tt.decode_step(cfg, cpu, c0, toks[:, t:t + 1])
        l1, c1 = tt.decode_step(cfg, card, c1, toks[:, t:t + 1].cuda())
        assert (l1.cpu() - l0).abs().max() <= 1e-4 * l0.abs().max(), t
    assert dispatch.launches("ssm_scan") == ssm_layers


def test_engine_on_the_card_serves_the_cpus_tokens(cuda):
    from repro_torch.serve import ServeEngine, cache as serve_cache
    from repro_torch.serve import make_workload
    cfg, cpu, card = _serve_model("rfast-100m")
    kw = dict(n_requests=20, vocab=cfg.vocab, max_prompt=16, max_gen=6,
              seed=2)
    out = {}
    for name, params in (("cpu", cpu), ("cuda", card)):
        serve_cache.clear()
        reqs = make_workload(**kw)
        eng = ServeEngine(cfg, params, batch=4, max_len=32,
                          buckets=(4, 8, 16))
        eng.run(reqs)
        assert eng.device.type == name and all(r.done for r in reqs)
        assert serve_cache.stats()["entries"] == 1 + len(
            {eng.bucket_for(len(r.prompt)) for r in reqs})
        out[name] = [r.tokens for r in reqs]
    same = sum(a == b for a, b in zip(out["cpu"], out["cuda"]))
    assert same >= len(out["cpu"]) - 1      # an argmax tie may flip one


def test_decode_step_slots_on_the_card_matches_the_cpu(cuda):
    """MLA + MoE: three slots at their own positions, each slot's MoE
    routed alone, five steps on the card against the same on the CPU at
    1e-4 of the largest |logit|."""
    from repro_torch.models import transformer as tt
    cfg, cpu, card = _serve_model("deepseek-v2-236b")
    rng = np.random.default_rng(1)
    idx = [0, 3, 11]
    C = 8
    sp = np.full((3, C), -1, np.int32)
    for b, n in enumerate(idx):
        for p in range(max(0, n - C), n):
            sp[b, p % C] = p
    layers = tt.init_cache(cfg, cpu, 3, C)["layers"]
    for t in layers["attn"].values():
        t.copy_(torch.from_numpy(rng.standard_normal(tuple(t.shape))
                                 .astype(np.float32)))
    c0 = {"idx": torch.tensor(idx, dtype=torch.int32),
          "slot_pos": torch.from_numpy(sp), "layers": layers}
    c1 = {"idx": c0["idx"].cuda(), "slot_pos": c0["slot_pos"].cuda(),
          "layers": _to_card({"attn": {k: v.clone() for k, v in
                                       layers["attn"].items()}})}
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (5, 3, 1)))
    for t in range(5):
        l0, c0 = tt.decode_step_slots(cfg, cpu, c0, toks[t])
        l1, c1 = tt.decode_step_slots(cfg, card, c1, toks[t].cuda())
        assert (l1.cpu() - l0).abs().max() <= 1e-4 * l0.abs().max(), t
    assert torch.equal(c1["idx"].cpu(), c0["idx"])


def test_stable_sort_and_moe_dispatch_on_the_card_match_the_cpu(cuda):
    """``torch.argsort(stable=True)`` of expert ids with many ties gives
    the CPU's order on the card, so a capacity-bound MoE drops the same
    tokens: its output on the card matches the CPU's at 1e-5."""
    import dataclasses
    from repro_torch.models import moe
    from repro_torch.models.config import ModelConfig
    rng = np.random.default_rng(2)
    keys = torch.from_numpy(rng.integers(0, 6, 100_003))
    assert torch.equal(torch.argsort(keys.cuda(), stable=True).cpu(),
                       torch.argsort(keys, stable=True))
    cfg = ModelConfig(name="moe-card", n_layers=1, d_model=64, n_heads=4,
                      n_kv_heads=4, d_ff=96, vocab=64, moe_experts=8,
                      moe_top_k=2, moe_shared=1, capacity_factor=0.5)
    p = moe.moe_init(cfg, torch.Generator().manual_seed(3))
    x = torch.from_numpy(rng.standard_normal((4, 96, 64)).astype(
        np.float32))
    y0, a0 = moe.moe_apply(cfg, p, x)
    y1, a1 = moe.moe_apply(cfg, _to_card(p), x.cuda())
    assert (y1.cpu() - y0).abs().max() <= 1e-5 * y0.abs().max()
    assert abs(float(a1) - float(a0)) <= 1e-6
    lifted, _ = moe.moe_apply(dataclasses.replace(cfg, capacity_factor=100),
                              p, x)
    assert (lifted - y0).abs().max() > 1e-3        # tokens were dropped
    r0, _ = moe.moe_apply_rows(cfg, p, x)
    r1, _ = moe.moe_apply_rows(cfg, _to_card(p), x.cuda())
    assert (r1.cpu() - r0).abs().max() <= 1e-5 * r0.abs().max()


def test_audit_engines_clean_on_the_card(cuda):
    """torchlint over the engines on the card, the kernel route included:
    no diagnostic, nothing skipped, ``commit_grid`` launched once per
    non-empty wave of every replay; the kernel wave loops run with no
    host synchronisation (``set_sync_debug_mode("error")``)."""
    from repro_torch.analysis import torchlint
    diags, audited, skipped = torchlint.audit_engines(device="cuda")
    assert diags == [] and skipped == []
    assert {"wave_loop[kernel]", "fleet_wave_loop[kernel]",
            "commit_grid[dispatch]"} <= set(audited)
    for loop in torchlint.engine_loops(device="cuda", impls=("kernel",)):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loop.run(loop.state)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


def test_verify_plans_kernel_route_is_the_same_run_on_the_card(cuda):
    n, p = 5, 3000
    rng = np.random.default_rng(0)
    C = torch.from_numpy(rng.normal(0, 1, (n, p)).astype(np.float32)).cuda()
    gfn = lambda i, x, gen: x - C[i]
    topo = get_topology("binary_tree", n)
    sched = get_scenario("straggler", n).realize(topo, 6 * n,
                                                 seed=1).schedule
    x0 = torch.zeros(p, device="cuda")
    finals, launches = [], []
    for verify in (True, False):
        dispatch.clear()
        st, _ = run_rfast(topo, sched, gfn, x0, 0.05, eval_every=2 * n,
                          verify_plans=verify)
        launches.append(dispatch.launches("commit_grid"))
        finals.append([t.clone() for t in st[1:]])
    assert launches[0] == launches[1] > 0
    for a, b in zip(*finals):
        assert torch.equal(a, b)


# --------------------------------------------------------------------- #
# multi-device: ranks of this one card (spawned, so workers are module
# functions)
# --------------------------------------------------------------------- #
def _mesh_case(mesh, p=3001):
    """A two-lane fleet (binary tree, line) at ``p``: the mesh run (each
    lane's fields as the rank holds them) and the unsharded run of the
    same lanes on the card, with their launches."""
    from repro_torch.core.plan import build_comm_plan
    from repro_torch.core.simulator import run_sweep
    n = 5
    rng = np.random.default_rng(0)
    C = torch.from_numpy(rng.normal(0, 1, (n, p)).astype(np.float32)).cuda()
    gfn = lambda i, x, gen: x - C[i]
    topos = [get_topology("binary_tree", n), get_topology("line", n)]
    scheds = [get_scenario(sc, n).realize(t, 40, seed=1).schedule
              for sc, t in (("uniform", topos[0]), ("straggler", topos[1]))]
    runs = []
    for m in (mesh, None):
        dispatch.clear()
        sts, _ = run_sweep([build_comm_plan(t) for t in topos], scheds, gfn,
                           torch.zeros(p, device="cuda"), 0.05, seeds=[0, 1],
                           eval_every=20, mesh=m)
        runs.append(([None if st is None else [t.clone() for t in st[1:]]
                      for st in sts], dispatch.launches("commit_grid")))
    return runs


def _world1_nccl_rank():
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_sweep_mesh
    (got, l_got), (want, l_want) = _mesh_case(make_sweep_mesh())
    return {"backend": dist.get_backend(), "launches": (l_got, l_want),
            "bitwise": all(torch.equal(a, b) for g, w in zip(got, want)
                           for a, b in zip(g, w))}


def _gloo_pair_rank():
    import torch.distributed as dist
    from repro_torch.core import binary_tree
    from repro_torch.core.runtime import (edge_arrays, init_node_state,
                                          make_rfast_round)
    from repro_torch.core.runtime_sharded import (
        collective_stats, init_sharded_state, make_sharded_round,
        node_index, shard_state)
    from repro_torch.launch.mesh import make_sweep_mesh
    rank = dist.get_rank()
    (got, l_got), (want, l_want) = _mesh_case(
        make_sweep_mesh(lanes=1, param_shards=2))
    p_loc = 1501                                   # p 3001 -> p_pad 3002
    cols = slice(rank * p_loc, min(3001, (rank + 1) * p_loc))
    err = max(float((a[..., :cols.stop - cols.start] - b[..., cols]).abs()
                    .max()) for g, w in zip(got, want)
              for a, b in zip(g, w))
    widths = {int(t.shape[-1]) for g in got for t in g}
    # a two-node ppermute round against the dense round
    mesh = make_sweep_mesh(lanes=2)
    topo = binary_tree(2)
    C = torch.linspace(-1, 1, 2 * 16, device="cuda").reshape(2, 16)
    gf = lambda x, c, key: (0.5 * ((x - c) ** 2).sum(), x - c)
    st = shard_state(init_sharded_state(topo, torch.zeros(16, device="cuda"),
                                        gf, C), mesh, ("data",))
    rf = make_sharded_round(topo, gf, mesh, gamma=0.1, node_axes=("data",))
    spec = edge_arrays(topo)
    dense = init_node_state(spec, torch.zeros(16, device="cuda"), gf, C)
    drf = make_rfast_round(spec, gf, gamma=0.1)
    blk = shard_state(C, mesh, ("data",))
    for _ in range(50):
        st, _ = rf(st, blk)
        dense, _ = drf(dense, C, None, None)
    i = node_index(mesh, ("data",))
    return {"backend": dist.get_backend(), "launches": (l_got, l_want),
            "err": err, "widths": sorted(widths),
            "round_err": float((st.x[0] - dense.x[i]).abs().max()),
            "staged": collective_stats()["staged_bytes"]}


def test_world1_nccl_mesh_is_the_unsharded_run(cuda):
    from repro_torch.launch.multihost import spawn_local
    out = spawn_local(_world1_nccl_rank, 1, backend=None, timeout_s=120,
                      join_s=300)[0]
    assert out["backend"] == "nccl"
    assert out["launches"][0] == out["launches"][1] > 0
    assert out["bitwise"]


def test_gloo_ranks_share_the_card(cuda):
    from repro_torch.launch.multihost import spawn_local
    for out in spawn_local(_gloo_pair_rank, 2, backend="gloo", timeout_s=120,
                           join_s=300):
        assert out["backend"] == "gloo"
        assert out["launches"][0] == out["launches"][1] > 0
        assert out["widths"] == [1501] and out["err"] <= 2e-5
        assert out["round_err"] <= 1e-4 and out["staged"] > 0


def test_launch_tooling_predicts_the_round_on_the_card(cuda):
    """chip_smoke.py phase 31(a) at 2 layers: phase 11's cell (full-width
    rfast-100m cut to 2 layers, 4 nodes, seq 128, global batch 16, dense,
    fp32) on meta, then on the card from seed 0: the argument bytes
    exactly, one ``commit_grid`` launch a round as the meta record
    counts, the aten FLOPs exactly, and the allocator's peak above the
    arguments within 15 % (+ 1 MiB) of the meta temp."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import describe_mesh
    cfg = dc.replace(get_config("rfast-100m"), n_layers=2)
    mesh = describe_mesh((4, 1), ("data", "model"))
    kw = dict(seq=128, global_batch=16, comm="dense", impl="kernel",
              dtype=torch.float32)
    rec = dryrun.measure(*specs.build_train(cfg, mesh, **kw))
    fn, args = specs.build_train(cfg, mesh, device="cuda", **kw)
    live = dryrun.run_live(fn, args, runs=2)
    assert live["argument_size_in_bytes"] == \
        rec["memory"]["argument_size_in_bytes"]
    assert live["launches"] == [{"commit_grid": 1}] * 2
    assert rec["kernels"]["commit_grid"]["launches"] == 1
    assert live["flops_aten"] == rec["flops_aten"]
    temp = rec["memory"]["temp_size_in_bytes"]
    assert abs(live["peak_above_args_bytes"][-1] - temp) <= 0.15 * temp + 2**20
