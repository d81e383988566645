"""Device kernels launched in the profiler window, over its updates."""


def read(ctx):
    if ctx.window is None or not ctx.window.kernels or not ctx.updates:
        return None
    return len(ctx.window.kernels) / ctx.updates
