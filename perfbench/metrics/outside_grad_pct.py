"""Share of the traced window in which the card was not computing a
gradient: 100 − the device time of the operations launched inside the
gradient spans, over the window.  The rest is the engine's device work
(descent, mix, commit, row copies, the feed) and the card's idle time."""


def read(ctx):
    t = ctx.trace
    if not t.window_s or not t.grad_spans:
        return None
    return 100.0 * (1.0 - t.grad_device_s / t.window_s)
