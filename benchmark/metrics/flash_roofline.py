"""The flash kernels' share of their roofline, in %: over every K1-K3
launch in the profiler window, the sum of each launch's least time (the
larger of its operations over the peak and its bytes over the memory's
bandwidth, ``yardstick/flops.py``) over the sum of its device time. The
peak is the dense bfloat16 rate for the bfloat16 kernels and a third of
TF32's for the float32 (3xTF32) ones. A window whose launches are not one
of each kind per layer and micro-batch, or in which the trace holds fewer
than the port's own launch counters (``ops/flash_attention.py ::
launch_counts``) say ran, reads nothing."""

from benchmark.yardstick import flops


def read(ctx):
    w = ctx.window
    if w is None or ctx.peaks is None:
        return None
    launches = w.flash_launches()
    if not launches:
        return None
    layers, heads = ctx.rcfg["layers"], ctx.rcfg["heads"]
    head_dim = ctx.rcfg["hidden"] // heads
    dtype = "bf16" if ctx.precision == "bf16" else "f32"
    peak = ctx.peaks["bf16"] if dtype == "bf16" else ctx.peaks["f32x3"]
    elem = 2 if dtype == "bf16" else 4
    want = layers * len(ctx.micro_lengths)
    got = {key: len(v) for key, v in launches.items()}
    if got != {(kind, dtype): want for kind in flops.PRODUCTS}:
        print(f"[bench] flash_roofline: launches {got}, {want} of each {dtype} kind "
              f"expected; not read", file=ctx.log)
        return None
    counted = {(k.replace("flash_bwd_", "").replace("flash_", ""), dtype): n
               for k, n in (ctx.flash_launched or {}).items()}
    if counted != got:
        print(f"[bench] flash_roofline: the trace holds {got}, the counters say {counted}; "
              f"not read", file=ctx.log)
        return None
    least = 0.0
    for kind in flops.PRODUCTS:
        for lengths in ctx.micro_lengths:
            work = flops.flash_launch(kind, lengths, ctx.seq, heads, head_dim, elem,
                                      ctx.causal, ctx.masked)
            least += layers * flops.least_seconds(work, peak, ctx.peaks["hbm"])
    spent = sum(sum(v) for v in launches.values()) / 1e9
    return 100.0 * least / spent
