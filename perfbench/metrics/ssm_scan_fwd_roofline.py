"""The selective scan forward kernel's share of its bound
(``bench.counts.scan_fwd_need`` at the cell's scan shape: the larger of
its bytes, its fp32 operations and its exponentials at the card's rates),
over its device time in the traced window."""
from bench import counts


def read(ctx):
    s, n = ctx.trace.kernel("ssm_scan_fwd_kernel")
    if not n or not s:
        return None
    c, t = ctx.cfg, ctx.traffic
    need = counts.scan_fwd_need(t["batch"], t["seq"],
                                c["ssm_expand"] * c["d_model"],
                                c["ssm_state"])
    return 100.0 * n * counts.bound_s(*need) / s
