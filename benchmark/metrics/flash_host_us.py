"""The flash wrapper's host time a launch, in µs: from the program's
``flash`` counter (``ops/flash_attention.py :: launch_host_ns``, each
wrapper's entry to its launch's return), Δ host ns over Δ launches between
its last event at or before the window's start and its last inside the
window (``yardstick/spans.py``)."""

from benchmark.yardstick import spans


def read(ctx):
    if ctx.window is None:
        return None
    return spans.flash_host_us(ctx.window, spans.program_events())
