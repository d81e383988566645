"""The device's idle time while the program's innermost span is
``train/optimizer`` (AdamW's update), in % of the profiler window
(``yardstick/spans.py``)."""

from benchmark.yardstick import spans


def read(ctx):
    return spans.read_share(ctx, "optimizer")
