"""The device's idle time while the program's innermost span is
``train/upload`` (``Estimator._prep_batch``: the pageable copies to the
card, the stacking, the generator), in % of the profiler window
(``yardstick/spans.py``). Prints the whole idle split by span, in seconds,
the share of the window's kernel launches inside a ``train/step``, and
the other runtime calls (copies, syncs) by the span they fall in."""

from benchmark.yardstick import spans


def read(ctx):
    w = ctx.window
    if w is None or not w.kernels:
        return None
    found = spans.train_spans(w, spans.program_events())
    if not found:
        return None
    split = spans.idle_split(w, found)
    inside, calls = spans.launches_inside_steps(w, found)
    print("[bench] idle split (s): " + "; ".join(
        f"{name} {ns / 1e9:.6f}" for name, ns in sorted(split.items(), key=lambda kv: -kv[1]))
        + f"; kernel launches inside train/step: {inside} of {calls}", file=ctx.log)
    print("[bench] runtime calls other than launches by span: " + "; ".join(
        f"{name} " + ", ".join(f"{call} {n}" for call, n in counts.most_common())
        for name, counts in sorted(spans.calls_by_span(w, found).items())), file=ctx.log)
    return spans.shares(w, found)["upload"]
