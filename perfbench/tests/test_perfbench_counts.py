"""The yardstick's counts against hand counts at tiny sizes."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import counts  # noqa: E402


@pytest.mark.parametrize("S, window, pairs", [
    (1, None, 1), (4, None, 10), (4, 2, 1 + 2 + 2 + 2), (5, 3, 1 + 2 + 3 * 3),
    (4, 8, 10)])
def test_attention_pairs(S, window, pairs):
    brute = sum(min(q + 1, window or q + 1) for q in range(S))
    assert counts.attention_pairs(S, window) == pairs == brute


def test_grad_flops_dense_by_hand():
    cfg = {"d_model": 8, "n_heads": 2, "n_kv_heads": 1, "head_dim": 4,
           "d_ff": 16, "vocab": 10, "n_layers": 3, "mixer": "attn"}
    B, S = 2, 3
    proj = 8 * 8 + 8 * 4 + 8 * 4 + 8 * 8          # q, k, v, o
    mlp = 3 * 8 * 16
    fwd = 2 * B * S * (3 * (proj + mlp) + 8 * 10)
    fwd += 3 * B * 4 * 2 * 4 * 6                   # QK and PV, 6 pairs
    assert counts.grad_flops(cfg, B, S) == 3 * fwd


def test_grad_flops_hybrid_adds_the_ssm_projections():
    base = {"d_model": 32, "n_heads": 2, "n_kv_heads": 2, "head_dim": 16,
            "d_ff": 8, "vocab": 5, "n_layers": 1, "mixer": "attn",
            "attn_window": 2}
    hyb = dict(base, mixer="hybrid", ssm_state=4, ssm_expand=2)
    di, r = 64, 2                                  # d_inner, ceil(32 / 16)
    ssm = 32 * 2 * di + di * (r + 8) + r * di + di * 32
    assert counts.grad_flops(hyb, 1, 7) - counts.grad_flops(base, 1, 7) \
        == 3 * 2 * 7 * ssm


@pytest.mark.parametrize("args, rows", [
    ((0, 0, 1), 6), ((2, 2, 0), 10), ((2, 1, 0), 9), ((1, 0, 1), 8)])
def test_commit_lane_rows(args, rows):
    assert counts.commit_lane_rows(*args) == rows


def test_scan_needs_by_hand():
    B, S, di, N = 2, 3, 4, 5
    nbytes, flops, exps = counts.scan_fwd_need(B, S, di, N)
    assert nbytes == 4 * (2 * 3 * 4 * 2 + 2 * 3 * 5 * 2 + 4 * 5 + 4
                          + 2 * 3 * 4)
    assert flops == 2 * 3 * 4 * (6 * 5 + 3) and exps == 2 * 3 * 4 * 5
    nbytes, flops, exps = counts.scan_bwd_need(B, S, di, N)
    reads = 2 * 3 * (4 + 4 + 5 + 5) + 2 * 3 * 4 + 4 * 5 + 4
    writes = 2 * 2 * 3 * 4 + 4 * 5 + 2 * 2 * 3 * 5 + 4
    assert nbytes == 4 * (reads + writes)
    assert flops == 2 * 3 * 4 * (19 * 5 + 9) and exps == 2 * 3 * 4 * 5


def test_bound_takes_the_largest_term():
    assert counts.bound_s(int(3.35e12), 0) == pytest.approx(1.0)
    assert counts.bound_s(0, int(67e12)) == pytest.approx(1.0)
    assert counts.bound_s(0, 0, int(counts.MUFU_EXP_PER_S)) == \
        pytest.approx(1.0)


@pytest.mark.parametrize("busy_s, grads, expect", [
    (2.0, 4, 100.0 * 4 * 1e12 / 2.0 / 67e12), (0.0, 4, None),
    (2.0, 0, None)])
def test_step_mfu_reads_the_card_busy_time(busy_s, grads, expect,
                                           monkeypatch):
    from types import SimpleNamespace
    from bench import cell
    monkeypatch.setattr(counts, "grad_flops", lambda cfg, B, S: 1e12)
    ctx = SimpleNamespace(
        trace=SimpleNamespace(busy_s=busy_s, window_s=10.0),
        window=SimpleNamespace(grads=grads), cfg={},
        traffic={"batch": 1, "seq": 1})
    got = cell.reader("step_mfu")(ctx)
    assert got == (None if expect is None else pytest.approx(expect))
