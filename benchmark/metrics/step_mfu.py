"""Model FLOPs utilization of the whole update: the analytic training
FLOPs of the window's updates (``yardstick/flops.py``: real tokens only,
attention over each row's own length, halved when causal, GPT's tied head)
over the window's host time, over the card's dense bfloat16 peak, in %.
The same peak in every cell."""


def read(ctx):
    if ctx.peaks is None or not ctx.updates:
        return None
    return 100.0 * ctx.model_flops / ctx.window_s / ctx.peaks["bf16"]
