"""Stall detection for the serving engine's tick loop (the port of
``gradaccum_tpu/resilience/watchdog.py``, same semantics).

A tick that hangs (deadlocked collective, wedged device, runaway host
callback) would otherwise leave every client blocked in
``StreamHandle.result()`` forever — the engine thread is stuck inside the
dispatch, so no code path ever fails the handles. The :class:`Watchdog` is
a tiny monitor thread with arm/disarm semantics: the serving loop arms it
right before each tick dispatch and disarms on return, so idle periods
(no traffic, nothing armed) can never false-positive. If a single armed
window exceeds ``timeout`` the ``on_stall`` callback runs ON THE WATCHDOG
THREAD — it must not block on locks the stalled thread might hold (the
serving server only flips its error flag and fails handles).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Optional

from gradaccum_tpu_torch.obs import trace as obs_trace


class Watchdog:
    """Fires ``on_stall(elapsed_seconds)`` once per armed window that
    exceeds ``timeout``; re-arming starts a fresh window.

    :meth:`suspend` pauses the stall clock across PLANNED long
    operations — a live reconfiguration's preempt-all + pool rebuild, or
    a swap-heavy preemption burst — so a multi-second maintenance window
    can never read as a wedged dispatch. While suspended, arming is a
    no-op and the monitor never fires; on exit the next ``arm()`` starts
    a fresh window (whatever window was open when suspension began is
    forgotten — the time already spent was planned work, not a stall)."""

    def __init__(
        self,
        timeout: float,
        on_stall: Callable[[float], None],
        poll: Optional[float] = None,
        tracer=None,
    ):
        if timeout <= 0:
            raise ValueError(f"timeout must be > 0, got {timeout}")
        self.timeout = timeout
        self._on_stall = on_stall
        # obs tracer for the stall event (None = the process-global one,
        # resolved at fire time so a tracer installed later still sees it)
        self._tracer = tracer
        self._poll = poll if poll is not None else max(timeout / 4, 1e-3)
        self._armed_at: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # reentrant suspension depth (reconfig suspends server-side AND
        # engine-side around the same rebuild); int mutation under the
        # GIL, read by the monitor thread — worst case one extra poll
        self._suspended = 0

    def arm(self) -> None:
        if self._suspended:
            return  # a planned long operation is in progress
        self._armed_at = time.monotonic()

    def disarm(self) -> None:
        self._armed_at = None

    @contextlib.contextmanager
    def suspend(self):
        """Pause stall detection for a planned long operation
        (reentrant). A window open at entry RESTARTS fresh when the
        outermost suspension exits — the planned work's duration never
        counts against the stall budget, but the remainder of the armed
        dispatch (e.g. the decode after a mid-tick swap burst) keeps its
        stall detection instead of running unwatched."""
        was_armed = self._armed_at is not None
        self._suspended += 1
        self._armed_at = None
        try:
            yield self
        finally:
            self._suspended -= 1
            if self._suspended == 0 and was_armed:
                self._armed_at = time.monotonic()

    def start(self) -> "Watchdog":
        if self._thread is not None:
            raise RuntimeError("watchdog already started")
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="serving-watchdog"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            armed_at = self._armed_at
            if armed_at is None or self._suspended:
                continue
            elapsed = time.monotonic() - armed_at
            if elapsed > self.timeout:
                self._armed_at = None  # one firing per stalled window
                tr = obs_trace.resolve(self._tracer)
                if tr.enabled:
                    tr.event("watchdog/stall", cat="resilience",
                             elapsed_s=round(elapsed, 3),
                             timeout_s=self.timeout)
                try:
                    self._on_stall(elapsed)
                except Exception:
                    pass  # the monitor must survive a failing callback
