"""The inputs made from the seed, and the reading of a profiler trace."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import inputs, trace  # noqa: E402


@pytest.mark.parametrize("n", [1, 3, 4, 7])
def test_binary_tree_weights(n):
    W, A = inputs.binary_tree(n)
    assert np.allclose(W.sum(1), 1) and np.allclose(A.sum(0), 1)
    for i in range(1, n):
        assert W[i, (i - 1) // 2] > 0 and A[(i - 1) // 2, i] > 0


def test_inputs_repeat_from_the_seed_and_differ_between_steps():
    cdf = inputs.zipf_cdf(50, 1.2, "cpu")
    a = inputs.token_batch(2**40 + 3, 2, 1, 3, 9, cdf)
    b = inputs.token_batch(2**40 + 3, 2, 1, 3, 9, cdf)
    c = inputs.token_batch(2**40 + 3, 3, 1, 3, 9, cdf)
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    assert torch.equal(a[0][:, 1:], a[1][:, :-1])
    assert int(a[0].max()) < 50
    m = inputs.round_masks(7, 1, 3, 4, 0.5)
    assert m.shape == (4,) and m[3] == 1 and set(m) <= {0.0, 1.0}
    assert np.array_equal(m, inputs.round_masks(7, 1, 3, 4, 0.5))


def test_zipf_law_ranks_tokens():
    cdf = inputs.zipf_cdf(1000, 1.2, "cpu")
    t, _ = inputs.token_batch(1, 0, 0, 64, 255, cdf)
    counts = torch.bincount(t.flatten(), minlength=1000)
    assert counts[0] > counts[10] > counts[500]


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_schedule_keeps_its_staleness_bound(seed):
    W, A = inputs.binary_tree(3)
    s = inputs.realize_schedule(W, A, 400, seed=seed, compute_time=1.0,
                                jitter=0.2, latency=0.3, loss=0.1, D_max=6)
    inputs.check_schedule(s, W, A)
    assert set(np.unique(s.agent)) == {0, 1, 2}
    assert np.all(np.diff(s.times) >= 0)
    assert 3 <= s.activation_gap(3) <= 400


def test_check_schedule_refuses_a_stale_read():
    W, A = inputs.binary_tree(3)
    s = inputs.realize_schedule(W, A, 50, seed=1, compute_time=1.0,
                                jitter=0.2, latency=0.3, loss=0.0, D_max=6)
    k = int(np.nonzero(s.agent == 1)[0][-1])
    s.stamp_v[k:, 0] = 0
    with pytest.raises(ValueError):
        inputs.check_schedule(s, W, A)


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": args.pop("tid", 1), "args": args}


def test_trace_summary_by_hand():
    ev = [_ev("user_annotation", "perfbench.window", 0, 1000),
          _ev("user_annotation", "perfbench.grad", 100, 290),
          _ev("cpu_op", "aten::mm", 120, 10),
          _ev("cuda_runtime", "cudaLaunchKernel", 125, 2, correlation=1),
          _ev("cuda_runtime", "cudaLaunchKernel", 450, 2, correlation=2),
          _ev("cpu_op", "aten::item", 395, 600),
          _ev("kernel", "gemm", 200, 100, correlation=1),
          _ev("kernel", "commit_grid_kernel", 250, 150, correlation=2),
          _ev("gpu_memcpy", "Memcpy DtoD", 990, 30, correlation=3)]
    t = trace.summarize(ev)
    assert t.window_s == pytest.approx(1e-3)
    # device busy: [200, 400) and [990, 1000) clipped to the window
    assert t.busy_s == pytest.approx(210e-6)
    assert t.grad_spans == [pytest.approx(290e-6)]
    assert t.grad_device_s == pytest.approx(100e-6)
    assert t.kernel("commit_grid") == (pytest.approx(150e-6), 1)
    idle = t.idle_by_host
    # each idle gap is labelled by what the host ran at its start
    assert idle["aten::item"] == pytest.approx(590e-6)
    assert idle["perfbench.window"] == pytest.approx(200e-6)
    assert sum(idle.values()) == pytest.approx(1e-3 - 210e-6)
    assert trace.summarize(ev[1:]).window_s == 0
