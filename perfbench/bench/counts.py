"""The yardstick: the card's peaks, and the operations and bytes the
timed work needs, counted from the shapes and the inputs.

Peaks are NVIDIA's data-sheet rates for the H100 SXM at its 700 W limit:
67 TFLOP/s in fp32 outside the tensor cores, 3.35 TB/s of HBM, and the
special-function units' exponentials (16 a clock on each of 132 SMs at the
1,980 MHz boost clock).  A share of a peak is the least time these counts
allow, divided by the time measured.
"""
from __future__ import annotations

__all__ = ["FP32_FLOP_PER_S", "HBM_BYTES_PER_S", "MUFU_EXP_PER_S",
           "attention_pairs", "grad_flops", "commit_lane_rows",
           "scan_fwd_need", "scan_bwd_need", "bound_s"]

FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
MUFU_EXP_PER_S = 16 * 132 * 1.98e9


def attention_pairs(S: int, window: int | None) -> int:
    """(query, key) pairs causal attention over S positions needs, each
    query reading itself and the ``window − 1`` positions before it."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def grad_flops(cfg: dict, batch: int, seq: int) -> int:
    """Matmul operations of one gradient (forward and backward, 3× the
    forward) of ``batch`` sequences of ``seq`` tokens: every projection,
    the MLP, the SSM's projections, the head, and attention's QKᵀ and PV
    over the pairs :func:`attention_pairs` counts.  No recompute, no
    embedding lookup, no elementwise work, no scan."""
    d, H, KV, ff, V = (cfg[k] for k in ("d_model", "n_heads", "n_kv_heads",
                                         "d_ff", "vocab"))
    hd = cfg.get("head_dim") or d // H
    per_layer = d * H * hd * 2 + 2 * d * KV * hd + 3 * d * ff
    if cfg["mixer"] == "hybrid":
        di, N = cfg["ssm_expand"] * d, cfg["ssm_state"]
        r = -(-d // 16)
        per_layer += d * 2 * di + di * (r + 2 * N) + r * di + di * d
    tokens = batch * seq
    fwd = 2 * tokens * (cfg["n_layers"] * per_layer + d * V)
    fwd += cfg["n_layers"] * batch * 4 * H * hd * attention_pairs(
        seq, cfg.get("attn_window"))
    return 3 * fwd


def commit_lane_rows(in_real: int, in_delivered: int, out_real: int) -> int:
    """Rows of p elements one lane of the R-FAST commit needs: z, the new
    and the old gradient read and z' written (4); on each real in-edge the
    buffer read and written (2) and the running sum read where it was
    delivered; on each real out-edge the running sum read and written
    (2).  Padding slots are not needed."""
    return 4 + 2 * in_real + in_delivered + 2 * out_real


def scan_fwd_need(B: int, S: int, di: int, N: int) -> tuple[int, int, int]:
    """(bytes, fp32 operations, exponentials) the selective scan's forward
    needs in fp32: u, dt, B, C, A, D read once and y written once; per
    (b, t, d, n) dt·A, the three of the h update, h·C and its share of
    the n sum, one exponential; per (b, t, d) dt·u and D·u's
    multiply-add."""
    nbytes = 4 * (B * S * (2 * di + 2 * N) + di * N + di + B * S * di)
    return nbytes, B * S * di * (6 * N + 3), B * S * di * N


def scan_bwd_need(B: int, S: int, di: int, N: int) -> tuple[int, int, int]:
    """(bytes, fp32 operations, exponentials) its backward needs: u, dt,
    B, C, the output's gradient, A and D read once, the six gradients
    written once; per (b, t, d, n) the rerun's dt·A and h update (4), the
    sweep's 13 and the d sums of dB, dC (2), one exponential; per (b, t,
    d) 9.  The kernel's own checkpoints are not counted."""
    nbytes = 4 * (B * S * (2 * di + 2 * N) + B * S * di + di * N + di
                  + 2 * B * S * di + di * N + 2 * B * S * N + di)
    return nbytes, B * S * di * (19 * N + 9), B * S * di * N


def bound_s(nbytes: int, flops: int, exps: int = 0) -> float:
    """The least seconds: the largest of the bytes at HBM bandwidth, the
    operations at the fp32 rate and the exponentials at the MUFU rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S,
               exps / MUFU_EXP_PER_S)
