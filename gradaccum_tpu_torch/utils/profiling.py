"""Profiling hooks on ``torch.profiler`` (the port of
``gradaccum_tpu/utils/profiling.py``).

The reference's only observability is wall-clock timing and Estimator's
steps/sec logging; the harness keeps those and adds a profiler trace of
the host and card timeline, written as Chrome trace JSON (load it in
``chrome://tracing`` or https://ui.perfetto.dev; the card's kernels appear
under their own names).

- :func:`start_trace` / :func:`stop_trace` — one process-wide trace, as
  ``jax.profiler`` has; ``stop_trace`` writes ``<log_dir>/trace-NNNN.json``
  (numbered past the files already there) and returns its path.
- :func:`trace` — context manager for ad-hoc profiling of any code region.
- ``RunConfig(profile_dir=..., profile_start_step=, profile_num_steps=)`` —
  the Estimator traces that window of train steps with
  :class:`StepWindowProfiler`.

A profiler that cannot start (one already running, an unwritable
directory) degrades to a no-op, never an error in training.
"""

from __future__ import annotations

import contextlib
import os
import re
from typing import Iterator, Optional

_TRACE_RE = re.compile(r"^trace-(\d+)\.json$")
_active = None  # (torch.profiler.profile, log_dir) while a trace runs


def start_trace(log_dir: str) -> None:
    """Start the process-wide trace: host activity, and the card's kernels
    when CUDA is available. Raises if a trace is already running."""
    global _active
    import torch

    if _active is not None:
        raise RuntimeError("a profiler trace is already running")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _active = (prof, log_dir)


def stop_trace() -> str:
    """Stop the running trace and write it; returns the JSON's path."""
    global _active
    if _active is None:
        raise RuntimeError("no profiler trace is running")
    import torch

    prof, log_dir = _active
    _active = None
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()  # the window's kernels end inside the trace
    prof.stop()
    taken = [int(m.group(1)) for m in map(_TRACE_RE.match, os.listdir(log_dir)) if m]
    path = os.path.join(log_dir, f"trace-{max(taken, default=0) + 1:04d}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Trace the enclosed region into ``log_dir``.

    Exception-safe around the profiler itself: if ``start_trace`` raises
    the region still runs — profiling degrades to a no-op instead of
    erroring — and ``stop_trace`` is only ever called against a trace that
    actually started."""
    started = False
    try:
        start_trace(log_dir)
        started = True
    except Exception as e:  # noqa: BLE001 — observability, never fatal
        print(f"[profile] trace unavailable ({e}); running unprofiled")
    try:
        yield
    finally:
        if started:
            try:
                stop_trace()
            except Exception as e:  # noqa: BLE001
                print(f"[profile] stop_trace failed ({e})")


class StepWindowProfiler:
    """Start/stop a trace when the step counter crosses a window.
    Host-side, cheap when idle; used by the Estimator train loop."""

    def __init__(self, log_dir: Optional[str], start_step: int, num_steps: int):
        self.log_dir = log_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._active = False
        self._done = log_dir is None or num_steps <= 0
        self.trace_path: Optional[str] = None  # the written trace, once closed

    def observe(self, step: int) -> None:
        """Call BEFORE dispatching the step for ``step`` counter value.

        Stop is only considered while already active, so even when the
        counter jumps past the whole window in one hop (scan mode with
        K > num_steps) at least one dispatched step lands inside the trace.
        """
        if self._done:
            return
        if self._active:
            if step >= self.stop_step:
                self.close()
            return
        if step >= self.start_step:
            try:
                start_trace(self.log_dir)
            except Exception as e:  # noqa: BLE001 — degrade, don't kill training
                print(f"[profile] trace unavailable ({e}); window skipped")
                self._done = True
                return
            self._active = True

    def close(self) -> None:
        if self._active:
            self._active = False
            try:
                self.trace_path = stop_trace()
                print(f"[profile] trace written to {self.trace_path}")
            except Exception as e:  # noqa: BLE001
                print(f"[profile] stop_trace failed ({e})")
        self._done = True
