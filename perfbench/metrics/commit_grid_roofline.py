"""``commit_grid``'s share of its bandwidth bound: the bytes the traced
window's commits need (``bench.counts.commit_lane_rows`` of every lane,
from the benchmark's own masks and graphs) at 3.35 TB/s, over the
kernel's device time.  Read only when the trace holds exactly the
launches the program counted."""
from bench import counts


def read(ctx):
    s, n = ctx.trace.kernel("commit_grid_kernel")
    if not n or n != ctx.window.commit_launches or not s:
        return None
    nbytes = ctx.window.commit_rows * ctx.p * 4
    return 100.0 * nbytes / counts.HBM_BYTES_PER_S / s
