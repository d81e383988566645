"""``torch.cuda.max_memory_allocated()`` over the whole run, set-up and
window, in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
