"""The device's idle time while the program's innermost span is
``train/accumulate`` or ``train/clip`` (the guard and the fold of each
micro-batch into the accumulators, the window's zeroed buffer, the
normalization and the global-norm clip), in % of the profiler window
(``yardstick/spans.py``)."""

from benchmark.yardstick import spans


def read(ctx):
    return spans.read_share(ctx, "accum")
