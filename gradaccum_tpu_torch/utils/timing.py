"""Device-step timing and the latency series (the port of
``gradaccum_tpu/utils/timing.py``).

:func:`time_device_steps` times a train step by two-point timing: N and
N/5 iterations, each closed by ``torch.cuda.synchronize`` and a read of the
loss and of the smallest parameter (where JAX reads them back with
``device_get``), and divides the difference, which cancels the constant
cost of each measurement. :class:`LatencySeries` is the sample series
behind every percentile the obs registry reports.

``configure_fast_prng`` (JAX's switch to XLA's hardware RNG for dropout
masks) has no counterpart: the port's dropout draws from explicit
``torch.Generator`` objects and the flash kernels hash their own keep mask,
so there is no default generator to switch.
"""

from __future__ import annotations

import time

import torch


def time_device_steps(step, state, step_args, iters: int):
    """Seconds per ``state, aux = step(state, *step_args)`` call.

    ``aux`` must carry a scalar ``"loss"``; ``state.params`` must be a
    ``{name: tensor}`` dict. The caller warms up (and drains) before
    calling. Returns ``(seconds_per_step, state)``.
    """
    smallest = min(state.params, key=lambda name: state.params[name].numel())

    def run(n, state):
        t0 = time.perf_counter()
        aux = None
        for _ in range(n):
            state, aux = step(state, *step_args)
        loss = aux["loss"]
        if loss.device.type == "cuda":
            torch.cuda.synchronize(loss.device)
        float(loss)
        state.params[smallest].cpu()
        return time.perf_counter() - t0, state

    n_small = max(1, iters // 5)
    dt_big, state = run(iters, state)
    if iters > n_small:
        dt_small, state = run(n_small, state)
        per_step = (dt_big - dt_small) / (iters - n_small)
    else:
        per_step = dt_big / iters
    if per_step <= 0:  # timing noise swamped the two-point difference
        per_step = dt_big / iters
    return per_step, state


class LatencySeries:
    """A scalar sample series with the summary the serving path reports
    everywhere (mean / p50 / p90 / p99 / count). The obs metrics
    registry's histograms use it, so every percentile is computed the same
    way (numpy linear interpolation).

    ``window=N`` bounds the series to the most recent N samples (a ring):
    percentiles then describe CURRENT behavior instead of everything since
    boot — what SLO evaluation needs, where a cumulative p99 would bury a
    fresh latency cliff under hours of healthy history. The default
    (``window=None``) keeps every sample, exactly as before.
    """

    def __init__(self, window=None):
        if window is not None and int(window) < 1:
            raise ValueError(f"window must be >= 1 samples, got {window}")
        self.window = None if window is None else int(window)
        if self.window is None:
            self._xs = []
        else:
            from collections import deque

            self._xs = deque(maxlen=self.window)

    def add(self, x: float) -> None:
        self._xs.append(float(x))

    def extend(self, xs) -> None:
        self._xs.extend(float(x) for x in xs)

    def samples(self) -> list:
        """A copy of the current samples (the whole ring when windowed) —
        for consumers that merge several series (e.g. a fleet-wide
        percentile over per-replica latency series)."""
        return list(self._xs)

    def __len__(self) -> int:
        return len(self._xs)

    def percentiles(self, qs=(50, 90, 99)) -> dict:
        """``{"p50": ..., "p90": ..., ...}`` for the requested quantiles
        (None-valued when the series is empty).

        Computed as numpy's default linear interpolation — ``pos = (n-1) *
        q/100`` between the two bracketing order statistics — but by hand:
        ``np.percentile`` spends ~60 µs/call on argument handling, which
        the SLO evaluator would pay per objective per tick; the direct
        sort+lerp is the same arithmetic at a fraction of the cost."""
        import numpy as np

        if not self._xs:
            return {f"p{q:g}": None for q in qs}
        a = np.fromiter(self._xs, np.float64, len(self._xs))
        a.sort()
        n = a.size
        out = {}
        for q in qs:
            pos = (n - 1) * (float(q) / 100.0)
            lo = int(pos)
            hi = min(lo + 1, n - 1)
            out[f"p{q:g}"] = float(a[lo] + (a[hi] - a[lo]) * (pos - lo))
        return out

    def summary(self) -> dict:
        import numpy as np

        if not self._xs:
            return {"count": 0, "mean": None,
                    "p50": None, "p90": None, "p99": None}
        a = np.asarray(self._xs, np.float64)
        out = {"count": int(a.size), "mean": float(a.mean())}
        out.update(self.percentiles())
        return out
