"""From the process's start to the window's: imports, the CUDA context,
the kernels' libraries (built on a checkout's first run), the weights,
the program's set-up and its first, checked updates (host clock)."""


def read(ctx):
    return ctx.setup_s
