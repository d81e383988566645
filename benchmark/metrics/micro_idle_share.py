"""The device's idle time while the program's innermost span is
``train/forward`` or ``train/backward`` (the model's loss and its
gradient, each micro-batch), in % of the profiler window
(``yardstick/spans.py``)."""

from benchmark.yardstick import spans


def read(ctx):
    return spans.read_share(ctx, "micro")
