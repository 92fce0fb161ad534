"""The whole step's share of the card's fp32 peak while the card was busy:
the matmul operations of every gradient the traced window computed
(``bench.counts.grad_flops``) over the card's busy seconds in that window
(the union of every kernel, copy and fill, from the device trace), at
67 TFLOP/s.  Idle time is ``device_idle_pct``'s, not this metric's."""
from bench import counts


def read(ctx):
    t = ctx.trace
    if not t.busy_s or not ctx.window.grads:
        return None
    flops = ctx.window.grads * counts.grad_flops(
        ctx.cfg, ctx.traffic["batch"], ctx.traffic["seq"])
    return 100.0 * flops / t.busy_s / counts.FP32_FLOP_PER_S
