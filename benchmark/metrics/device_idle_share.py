"""1 - the union of the device's kernel, copy and memset intervals over
the profiler window, in %."""


def read(ctx):
    w = ctx.window
    if w is None or not w.kernels:
        return None
    return 100.0 * (1.0 - w.busy_ns() / w.window_ns)
