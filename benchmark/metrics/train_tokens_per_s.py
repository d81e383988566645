"""The real (unpadded) tokens of every update finished in the window, over
the time from the window's start to the end of its last update, the card
synchronized (host clock)."""


def read(ctx):
    return ctx.tokens / ctx.window_s if ctx.updates else None
