"""Device time in matrix-product kernels (cuBLAS, CUTLASS, xmma, nvjet, by
kernel name) over the device's busy time in the profiler window, in %.
The names matched go to standard error."""

from benchmark.yardstick.profile import GEMM


def read(ctx):
    w = ctx.window
    if w is None or not w.kernels:
        return None
    by_name = w.kernel_ns_by_name()
    matched = {n: ns for n, ns in by_name.items() if GEMM.search(n)}
    top = sorted(matched.items(), key=lambda kv: -kv[1])[:8]
    print(f"[bench] gemm_share matched {len(matched)} kernel names, e.g. "
          + "; ".join(f"{n[:100]} {ns / 1e6:.3f} ms" for n, ns in top), file=ctx.log)
    return 100.0 * sum(matched.values()) / w.busy_ns()
