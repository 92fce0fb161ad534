"""Card-only tests of the port (marked ``gpu``; they skip without CUDA).

They import nothing of JAX, so they run on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The CUDA ``commit_grid`` is held to its plain PyTorch version on the
same card tensors (fp32 at 1e-5, the reference's own tolerance; bf16 at
3e-2, its bf16 tolerance), and the engine's two commit backends are
held to each other.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.scenario import get_scenario
from repro_torch.core.simulator import run_rfast, tracked_mass
from repro_torch.core.topology import get_topology
from repro_torch.kernels.rfast_update import dispatch
from repro_torch.kernels.rfast_update.grid import (commit_grid,
                                                   commit_grid_plain)

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
