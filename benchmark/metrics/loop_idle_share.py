"""The device's idle time in ``train/step``'s own time (no span inside it
open) or outside any ``train/step`` (``Estimator.train``'s loop between
updates), in % of the profiler window (``yardstick/spans.py``). With the
other four idle shares it sums to ``device_idle_share``."""

from benchmark.yardstick import spans


def read(ctx):
    return spans.read_share(ctx, "loop")
