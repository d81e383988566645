"""Device time of the flash kernels (K1-K3, either route) over the
device's busy time in the profiler window, in %."""


def read(ctx):
    w = ctx.window
    if w is None or not w.kernels:
        return None
    launches = w.flash_launches()
    if not launches:
        return None
    return 100.0 * sum(sum(v) for v in launches.values()) / w.busy_ns()
