"""Device milliseconds of one gradient: the device operations launched
inside the benchmark's gradient spans, over the gradients in the traced
window."""


def read(ctx):
    t = ctx.trace
    if not t.grad_spans or not t.grad_device_s:
        return None
    return 1e3 * t.grad_device_s / len(t.grad_spans)
