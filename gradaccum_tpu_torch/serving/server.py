"""Front-ends for the engine: a threaded server and a deterministic driver.

The port of ``gradaccum_tpu/serving/server.py``:

- :class:`ServingServer` — a background thread owns the engine and runs its
  ticks (it drives the card); ``submit(prompt) -> StreamHandle`` is
  thread-safe, and the handle yields tokens as the engine emits them or
  blocks for the whole result. Callers never see ticks, slots or batches.
- :class:`SimulationDriver` — the same traffic without threads or wall time:
  seeded arrival traces (drawn from numpy with JAX's draws, so a seed gives
  JAX's trace) replayed on the logical tick clock.

Failure contract: an exception out of ``engine.step()`` never strands a
caller. The running requests are recovered with ``engine.recover()`` and
REQUEUED, at most ``max_requeues`` times each; greedy and seeded decoding
make the replayed generation token for token the unfaulted one (a
streaming consumer of a requeued request may see a duplicated prefix;
``result()`` returns exactly the final generation). After
``max_engine_faults`` consecutive faulted ticks the server gives up: every
pending :class:`StreamHandle` fails with the error (``result()`` raises),
``submit`` refuses, readiness drops and ``stop()`` re-raises. A tick that
outlives ``watchdog_timeout`` fails the handles the same way, from the
watchdog's own thread. A CUDA error that poisons the context fails every
tick after it, so the consecutive-fault bound is what ends that server.

The live ops plane rides on the loop: a ``sentinel`` (heartbeats, tick
durations, accept/preemption/tier rates, faults; its remediations reach
:meth:`ServingServer.request_recover` and
:meth:`ServingServer.request_reconfig`), an ``slo`` evaluator bound to the
engine's registry and ticked per clean tick, and ``telemetry_port``'s
read-only HTTP endpoints.

Live reconfiguration (``request_reconfig``) runs on a loop thread under the
engine lock, with the watchdog suspended and the sentinel in maintenance.
Behind a ``ReplicatedEngine`` the server runs the fleet in lockstep, or with
``free_running`` one loop thread per replica, each with its own lock,
watchdog window, heartbeat and fault budget. A ``healer``
(``resilience/healer.py``) is polled on the loop thread(s) next to the
sentinel's checks; its rungs act through ``request_recover`` and
``request_reconfig``.

A server over a multi-rank serving mesh (an ``Engine`` whose ``mesh`` has
``model`` wider than 1, or a ``ReplicatedEngine(tp > 1)``) is not ported:
its client threads reach rank 0 alone, and the other ranks would need every
tick's submits, cancels and reconfigurations from it (a leader/follower
protocol that JAX's single process never needed). It raises
``NotImplementedError`` naming :data:`MESH_SERVER_ITEM`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np

from gradaccum_tpu_torch.resilience.watchdog import Watchdog
from gradaccum_tpu_torch.serving.engine import Engine
from gradaccum_tpu_torch.serving.scheduler import QueueFull

_DONE = object()  # sentinel closing a handle's token stream

MESH_SERVER_ITEM = ("ROADMAP.md item 5j: the server over a multi-rank serving mesh "
                    "(rank 0 broadcasts each tick's commands, the other ranks apply them)")


def _mesh_width(engine) -> int:
    """The widest model axis among ``engine`` and its replicas (1 without a
    mesh)."""
    engines = getattr(engine, "replicas", None) or [engine]
    return max(getattr(e, "tp", 1) for e in engines)


class StreamHandle:
    """One request's streamed output. Iterate for tokens as they arrive;
    ``result()`` blocks for the complete generation."""

    def __init__(self, request_id: int):
        self.request_id = request_id
        self._q: "queue.Queue" = queue.Queue()  # (epoch, token) | _DONE
        self._tokens: List[int] = []
        self._reason: Optional[str] = None
        self._error: Optional[BaseException] = None
        self._closed = threading.Event()
        self._drained = False  # the _DONE sentinel has been consumed
        # the epoch guards _restart against a concurrent consumer: a token
        # dequeued before the restart carries the old epoch and is dropped
        # under _mutex, so result() never glues a pre-fault token onto the
        # replayed generation
        self._epoch = 0
        self._mutex = threading.Lock()

    def _put(self, token: int) -> None:
        self._q.put((self._epoch, token))

    def _finish(self, reason: str) -> None:
        self._reason = reason
        self._closed.set()
        self._q.put(_DONE)

    def _fail(self, error: BaseException) -> None:
        """Engine death reaches the caller: ``result()`` raises, iteration
        ends."""
        self._error = error
        self._finish("error")

    def _restart(self) -> None:
        """Drop buffered output before a requeue re-runs the request from
        scratch (so ``result()`` returns exactly the final generation)."""
        with self._mutex:
            self._epoch += 1
            self._tokens.clear()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def _consume(self, item) -> Optional[int]:
        """Append a dequeued item unless a restart made it stale."""
        epoch, token = item
        with self._mutex:
            if epoch != self._epoch:
                return None
            self._tokens.append(token)
        return token

    def __iter__(self):
        while not self._drained:
            item = self._q.get()
            if item is _DONE:
                self._drained = True
                return
            token = self._consume(item)
            if token is not None:
                yield token

    def result(self, timeout: Optional[float] = None) -> Tuple[List[int], str]:
        """Drain the stream; returns ``(tokens, finish_reason)``. Raises
        TimeoutError if the request has not finished within ``timeout``
        seconds (``None`` blocks), and RuntimeError chained to the engine's
        exception if it failed. Idempotent once finished."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._drained:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                raise TimeoutError(f"request {self.request_id} still running after "
                                   f"{timeout}s") from None
            if item is _DONE:
                self._drained = True
                break
            self._consume(item)
        if self._error is not None:
            raise RuntimeError(f"request {self.request_id} failed: engine error") \
                from self._error
        return list(self._tokens), self._reason

    @property
    def done(self) -> bool:
        return self._closed.is_set()

    @property
    def error(self) -> Optional[BaseException]:
        return self._error


class SentinelRemediation(RuntimeError):
    """The exception a requested recover is routed through: it enters
    :meth:`ServingServer._handle_engine_fault` exactly as an engine fault
    would, so a remediation reuses the recover → bounded requeue path
    instead of growing a second one."""


class ServingServer:
    """Threaded front-end: one engine thread, many submitting threads.

    ``max_requeues``: how many times one request may be recovered and
    resubmitted after an engine fault before its handle fails.
    ``max_engine_faults``: consecutive faulted ticks tolerated before the
    server gives up (every handle fails, ``stop()`` re-raises).
    ``watchdog_timeout``: seconds one tick may run before the loop is
    declared stalled; the pending handles then fail at once instead of
    blocking on a wedged dispatch.
    ``flight``: an optional ``obs/flight.py :: FlightRecorder``; every
    recovered fault, the give-up, a watchdog fire and a reconfiguration
    dump the recent-event ring as a postmortem.
    ``sentinel``: an optional ``obs/sentinel.py :: Sentinel``; the loop
    feeds it heartbeats, tick durations and the engine's accept, preemption
    and tier-spill rates (per replica behind a ``ReplicatedEngine``), real
    faults are noted on it, and its remediations may call
    :meth:`request_recover` or :meth:`request_reconfig`. With
    ``check_interval`` set, :meth:`start` runs its background lease checker
    too.
    ``slo``: an optional ``obs/slo.py :: SLOEvaluator``, bound to the
    engine's registry and ticked once per clean tick.
    ``telemetry_port``: when set (0 = ephemeral), :meth:`start` brings up
    ``obs/telemetry.py``'s endpoints on ``telemetry_host``: ``/metrics``
    scrapes the engine's registry, ``/healthz`` and ``/readyz`` reflect the
    loop, the fault state, the drain and firing anomalies, ``/varz`` is
    :meth:`stats`, ``/trace`` the span ring, ``/slo`` and ``/sentinel``
    their owners' status.
    ``free_running``: with a ``ReplicatedEngine``, ONE loop thread per
    replica instead of lockstep fleet ticks, so a replica mid-prefill never
    stalls its neighbors' streams. Each replica has its own engine lock
    (submits route to a replica under that replica's lock), watchdog
    window, sentinel heartbeat and fault budget. A single engine runs
    lockstep whatever the flag.
    ``healer``: an optional ``resilience/healer.py :: Healer`` built over the
    same ``sentinel``: the autonomous escalation ladder. The loop thread(s)
    poll it after every sentinel check, idle passes included (verification
    windows keep expiring while the engine has nothing to decode); its
    actions route through :meth:`request_recover` and
    :meth:`request_reconfig` (a free-running fleet runs them under the
    owning replica's lock, as an operator's), its ladder policy lands in the
    engine's or fleet's manifest and its live state in ``stats()["healer"]``.

    **Live reconfiguration**: :meth:`request_reconfig` queues a
    ``serving/reconfig.py`` spec (pool resize, checkpoint swap, replica
    drain, activate, excise or add) for a loop thread to apply under the
    engine lock, with the watchdogs suspended and the sentinel in
    maintenance: in-flight streams park and resume token for token, fresh
    traffic waits behind a ``reconfiguring`` stall label, and a drained
    replica's requests re-dispatch across the fleet with their
    :class:`StreamHandle` rebound."""

    def __init__(self, engine, idle_sleep: float = 1e-3, max_requeues: int = 1,
                 max_engine_faults: int = 3, watchdog_timeout: Optional[float] = None,
                 flight=None, sentinel=None, slo=None, healer=None,
                 telemetry_port: Optional[int] = None, telemetry_host: str = "127.0.0.1",
                 free_running: bool = False):
        if _mesh_width(engine) > 1:
            raise NotImplementedError(
                f"ServingServer over a serving mesh of model={_mesh_width(engine)} (free_running="
                f"{bool(free_running)}) waits for {MESH_SERVER_ITEM}")
        self._engine = engine
        self._flight = flight
        self._sentinel = sentinel
        self._slo = slo
        self._healer = None
        if healer is not None:
            self._attach_healer_checked(healer, engine, sentinel)
        # a ReplicatedEngine owns one fleet registry (its metrics facade has
        # none); a single Engine reaches it through ServingMetrics
        self._registry = (getattr(engine, "registry", None)
                          or getattr(engine.metrics, "registry", None))
        if slo is not None and self._registry is not None:
            slo.bind_registry(self._registry)
        self._telemetry_port = telemetry_port
        self._telemetry_host = telemetry_host
        self._telemetry = None
        # requested recovers (sentinel remediations), one pending per target
        # replica (None: untargeted, or the lockstep engine), honored by the
        # loop threads; guarded by _hlock
        self._nudges: Dict[Optional[int], str] = {}
        # pending live reconfigurations (spec, Future), run by the first loop
        # thread to poll; guarded by _hlock
        self._reconfigs: "deque" = deque()
        # a fleet heartbeats per replica itself from its step()
        if sentinel is not None and hasattr(engine, "replicas") \
                and getattr(engine, "sentinel", None) is None:
            engine.sentinel = sentinel
        self._idle_sleep = idle_sleep
        self._max_requeues = max_requeues
        self._max_engine_faults = max_engine_faults
        # _lock guards the engine (not thread-safe); _hlock the handle
        # registry, the requeue counts, the error flag and the pending
        # nudges and reconfigurations. Separate on purpose: the watchdog must
        # fail handles while the engine thread may be wedged INSIDE a step()
        # holding _lock. Lock order: _lock (or the replica locks, in index
        # order), then _hlock.
        self._lock = threading.Lock()
        self._hlock = threading.Lock()
        self._handles: Dict[int, StreamHandle] = {}
        self._requeues: Dict[int, int] = {}  # request_id -> times requeued
        self._faults = 0  # consecutive faulted ticks
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._threads: List[threading.Thread] = []
        self._error: Optional[BaseException] = None
        self._watchdog_timeout = watchdog_timeout
        # free running: per-replica engine locks, fault budgets and watchdog
        # windows (one watchdog cannot time N concurrent ticks)
        self._free_running = bool(free_running) and hasattr(engine, "replicas")
        if self._free_running:
            n = len(engine.replicas)
            self._rlocks = [threading.Lock() for _ in range(n)]
            self._rfaults = [0] * n
            self._watchdog = None
            self._watchdogs = (None if watchdog_timeout is None else
                               [self._new_watchdog() for _ in range(n)])
        else:
            self._rlocks = None
            self._rfaults = None
            self._watchdogs = None
            self._watchdog = None if watchdog_timeout is None else self._new_watchdog()

    def _attach_healer_checked(self, healer, engine, sentinel) -> None:
        if sentinel is None:
            raise ValueError("a healer needs the sentinel it was built over passed as "
                             "sentinel=")
        if healer.sentinel is not sentinel:
            raise ValueError("healer was built over a different sentinel than this server's")
        if self._healer is not None and self._healer is not healer:
            # the replaced ladder must stop reacting: its hooks stay on the
            # shared sentinel otherwise, and a ghost ladder's flap detector
            # can fire a false page
            self._healer.detach()
        self._healer = healer
        # the ladder policy is part of the serving shape: the manifest
        # records it like every other knob
        engine.healer_knobs = healer.manifest()

    def attach_healer(self, healer) -> "ServingServer":
        """Attach (or replace) the self-healing escalation ladder. The rung
        factories (``resilience/remediation.py``) close over the server, so
        the natural order is: the sentinel, the server around it, the
        ``Healer`` over server-bound rungs, then attach. Equivalent to the
        ``healer=`` knob once the ladder exists up front."""
        self._attach_healer_checked(healer, self._engine, self._sentinel)
        return self

    def _poll_healer(self) -> None:
        """One ladder pass on this loop thread: apply, escalate and freeze
        decisions happen here; the actions are claimed at the top of a later
        iteration (the healer locks internally)."""
        if self._healer is not None:
            self._healer.poll()

    def _new_watchdog(self) -> Watchdog:
        # pins only an explicitly injected engine tracer; None resolves the
        # global one when it fires, as the engine does
        return Watchdog(self._watchdog_timeout, self._on_stall, tracer=self._engine._tracer)

    def start(self) -> "ServingServer":
        if self._thread is not None or self._threads:
            raise RuntimeError("server already started")
        if self._stop.is_set():
            raise RuntimeError("server was stopped and cannot be restarted; build a new "
                               "ServingServer around the engine")
        if self._free_running:
            if self._watchdogs is not None:
                # each engine suspends its own window across planned long
                # operations
                for e, wd in zip(self._engine.replicas, self._watchdogs):
                    e.watchdog = wd
            self._threads = [threading.Thread(target=self._replica_loop, args=(i,), daemon=True,
                                              name=f"serving-replica-{i}")
                             for i in range(len(self._engine.replicas))]
            for th in self._threads:
                th.start()
            for wd in self._watchdogs or ():
                wd.start()
        else:
            if self._watchdog is not None:
                for e in getattr(self._engine, "replicas", [self._engine]):
                    e.watchdog = self._watchdog
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="serving-engine")
            self._thread.start()
            if self._watchdog is not None:
                self._watchdog.start()
        if self._sentinel is not None and self._sentinel.check_interval is not None:
            # the lease backstop for a loop wedged inside a tick
            self._sentinel.start()
        if self._telemetry_port is not None:
            from gradaccum_tpu_torch.obs.telemetry import TelemetryServer

            self._telemetry = TelemetryServer(
                port=self._telemetry_port, host=self._telemetry_host,
                registry=self._registry, tracer=self._engine._tracer, varz=self.stats,
                health=self._health, ready=self._ready, slo=self._slo,
                sentinel=self._sentinel).start()
        return self

    @property
    def telemetry(self):
        """The live ``TelemetryServer`` (None when not configured or after
        ``stop()``); ``server.telemetry.port`` is the bound port."""
        return self._telemetry

    def _health(self):
        """Liveness: the loop thread(s) exist and have not died. A server
        that gave up is no longer alive."""
        with self._hlock:
            error = self._error
        if self._free_running:
            alive = bool(self._threads) and all(t.is_alive() for t in self._threads)
            tick = max(e.tick_count for e in self._engine.replicas)
            faults = max(self._rfaults)
        else:
            alive = self._thread is not None and self._thread.is_alive()
            tick = self._engine.tick_count
            faults = self._faults
        detail = {
            "engine_thread": bool(alive),
            "consecutive_faults": faults,
            "tick": tick,
            "error": None if error is None else repr(error),
        }
        return (alive and error is None), detail

    def _ready(self):
        """Readiness: healthy AND taking traffic: not draining (``stop()``
        sets the flag before joining), not given up, no anomaly firing."""
        ok, detail = self._health()
        draining = self._stop.is_set()
        detail["draining"] = draining
        if self._sentinel is not None:
            firing = self._sentinel.firing()
            detail["anomalies_firing"] = [{"kind": k, "replica": r} for k, r in firing]
            ok = ok and not firing
        return (ok and not draining), detail

    def request_recover(self, reason: str, replica: Optional[int] = None) -> None:
        """Ask a loop thread to run the engine-fault recovery (recover →
        bounded requeue → flight dump) at its next iteration: the sentinel
        remediation entry point. Safe from any thread; a no-op once the
        server failed. ``replica`` targets one free-running replica's loop
        (an untargeted nudge goes to the first loop to poll); the lockstep
        server recovers its whole engine. Pending nudges are per target, so
        one parked on a wedged replica never blocks the others. A loop
        wedged inside a tick never honors it: that is the watchdog's job."""
        with self._hlock:
            if self._error is None and replica not in self._nudges:
                self._nudges[replica] = reason

    # -- live reconfiguration ---------------------------------------------

    def request_reconfig(self, spec) -> Future:
        """Queue a live reconfiguration (a ``serving/reconfig.py`` spec) for
        a loop thread to apply at its next iteration, under the engine lock
        with the watchdogs suspended and the sentinel in maintenance. Safe
        from any thread. Returns a Future of the ``ReconfigResult``, or of
        what the reconfiguration raised (a refused spec's ``ReconfigError``,
        a crash point's injected fault after the fault contract logged it).
        A drained or excised replica's requests re-dispatch across the fleet
        with their handles rebound."""
        fut: Future = Future()
        with self._hlock:
            if self._error is not None:
                raise RuntimeError("serving engine thread died") from self._error
            self._reconfigs.append((spec, fut))
        return fut

    def reconfigure(self, spec, timeout: Optional[float] = 60.0):
        """Blocking :meth:`request_reconfig`: the result once applied."""
        return self.request_reconfig(spec).result(timeout)

    @contextlib.contextmanager
    def _maintenance(self):
        """Every tick watchdog suspended (a rebuild is not a wedged dispatch)
        and the sentinel's lease clock paused (the loops stop heartbeating
        while the rebuild holds the engine lock: a planned silence)."""
        wds = ([self._watchdog] if self._watchdog is not None else []) \
            + list(self._watchdogs or [])
        with contextlib.ExitStack() as stack:
            for wd in wds:
                stack.enter_context(wd.suspend())
            if self._sentinel is not None:
                stack.enter_context(self._sentinel.maintenance())
            yield

    @contextlib.contextmanager
    def _engine_locked(self):
        """The whole engine: the lockstep lock, or every replica lock in
        index order (a free-running loop holds at most its own, so the
        ordered acquisition cannot deadlock)."""
        with contextlib.ExitStack() as stack:
            for lk in (self._rlocks if self._free_running else [self._lock]):
                stack.enter_context(lk)
            yield

    @staticmethod
    def _settle(fut: Future, result=None, exc: Optional[BaseException] = None) -> None:
        """Resolve a reconfiguration's future, tolerating one the caller
        already cancelled (an InvalidStateError here would kill the loop)."""
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)
        except Exception:  # noqa: BLE001 — cancelled by the caller
            pass

    def _execute_reconfig(self, spec, fut: Future) -> None:
        """Run one queued reconfiguration on a loop thread. A crash-point kill
        goes through the fault contract (the lockstep engine recovers; a
        free-running fleet logs it, its replicas are clean either way), then
        fails the future. The future always settles before this returns."""
        from gradaccum_tpu_torch.serving import reconfig as reconfig_lib

        eng = self._engine
        fleet = hasattr(eng, "replicas")
        try:
            try:
                with self._maintenance():
                    if (fleet and spec.kind == reconfig_lib.REPLICA_SCALE
                            and spec.action in ("drain", "excise")):
                        # the displaced work re-dispatches with its handles
                        # REBOUND, which only the server can do; a refused
                        # excise comes back ok=False with nothing displaced
                        replica = eng._check_replica(spec.replica)
                        with self._engine_locked():
                            src_tick = eng.replicas[replica].tick_count
                            result = eng.reconfigure(spec, resubmit=False)
                        displaced = result.detail.pop("displaced", [])
                        moved, failed = self._requeue_displaced(displaced, src_tick)
                        result.detail["resubmitted"] = moved
                        result.detail["failed"] = failed
                        if failed:
                            result.ok = False
                            result.reason = (f"{len(failed)} displaced request(s) found "
                                             "no sibling capacity")
                    elif (fleet and spec.kind == reconfig_lib.REPLICA_SCALE
                            and spec.action == "add" and self._free_running):
                        result = self._execute_replica_add(spec)
                    else:
                        with self._engine_locked():
                            result = eng.reconfigure(spec)
            except (reconfig_lib.ReconfigError, ValueError) as exc:
                # a REFUSED spec changed nothing: no fault is charged
                self._settle(fut, exc=exc)
                return
            except BaseException as exc:  # noqa: BLE001 — the fault contract logs it
                if not self._free_running:
                    self._handle_engine_fault(exc)
                else:
                    # the crash points leave each replica clean with its work
                    # parked, and a fleet-wide recover would race the other
                    # loops: log the fault, keep serving
                    if self._sentinel is not None:
                        self._sentinel.note_fault(error=type(exc).__name__)
                    self._dump("reconfig-fault", {"error": repr(exc)})
                self._settle(fut, exc=exc)
                return
            self._dump("reconfig", result.to_dict())
            self._settle(fut, result=result)
        finally:
            if not fut.done():
                self._settle(fut, exc=RuntimeError("reconfiguration did not settle its future"))

    def _dump(self, reason: str, extra: Dict) -> None:
        """A flight-recorder postmortem, best effort: a failed dump must not
        turn a handled event into a loop error."""
        if self._flight is not None:
            try:
                self._flight.dump(reason, extra=extra)
            except Exception:  # noqa: BLE001
                pass

    def _requeue_displaced(self, displaced, src_tick: int):
        """Re-dispatch a drained replica's displaced requests across the
        fleet, rebinding each handle to its request's new id (they replay
        from scratch; greedy replay is token for token)."""
        moved: Dict[int, int] = {}
        failed: List[int] = []
        for req in displaced:
            with self._hlock:
                handle = self._handles.pop(req.request_id, None)
                n = self._requeues.pop(req.request_id, 0)
            if handle is None:
                continue  # finished or cancelled meanwhile
            handle._restart()
            remaining = (None if req.deadline_tick is None
                         else max(0, req.deadline_tick - src_tick))
            kw = dict(eos_id=req.eos_id, rng_seed=req.rng_seed, deadline_ticks=remaining)
            try:
                if self._free_running:
                    rid, _ = self._dispatch_free(req.prompt, req.max_new_tokens,
                                                 handle=handle, **kw)
                else:
                    with self._lock:
                        rid = self._engine.submit(req.prompt, req.max_new_tokens, **kw)
                    with self._hlock:
                        handle.request_id = rid
                        self._handles[rid] = handle
            except Exception as exc:  # noqa: BLE001 — no sibling capacity
                handle._fail(exc)
                failed.append(req.request_id)
                continue
            moved[req.request_id] = rid
            if n:
                with self._hlock:
                    if rid in self._handles:
                        self._requeues[rid] = n
        return moved, failed

    def _execute_replica_add(self, spec):
        """Free-running live ADD: the new member's seat (its lock, fault
        budget, watchdog window and loop thread) exists before the fleet can
        name it as a candidate, and goes again if the fleet refuses."""
        self._rlocks.append(threading.Lock())
        self._rfaults.append(0)
        try:
            with self._engine_locked():
                result = self._engine.reconfigure(spec)
        except BaseException:
            self._rlocks.pop()
            self._rfaults.pop()
            raise
        if not result.ok:
            self._rlocks.pop()
            self._rfaults.pop()
            return result
        idx = result.detail["replica"]
        if self._watchdogs is not None:
            wd = self._new_watchdog()
            self._engine.replicas[idx].watchdog = wd
            self._watchdogs.append(wd)
            wd.start()
        th = threading.Thread(target=self._replica_loop, args=(idx,), daemon=True,
                              name=f"serving-replica-{idx}")
        self._threads.append(th)
        th.start()
        return result

    def stop(self) -> None:
        """Stop the loop(s) and close the engine; requests still in flight
        finish "aborted" and unapplied reconfigurations fail. Re-raises
        (wrapped) an engine failure the server gave up on. With a watchdog, a
        thread wedged INSIDE a tick is abandoned after a bounded join (it
        holds the engine lock, so closing the engine would deadlock)."""
        self._stop.set()
        # the ops plane goes down first: /readyz already answers unready
        if self._telemetry is not None:
            self._telemetry.stop()
            self._telemetry = None
        if self._sentinel is not None:
            self._sentinel.stop()
        wedged = False
        join_timeout = (None if self._watchdog_timeout is None
                        else max(2 * self._watchdog_timeout, 1.0))
        if self._thread is not None:
            self._thread.join(join_timeout)
            wedged = self._thread.is_alive()
            self._thread = None
        for th in self._threads:
            th.join(join_timeout)
            wedged = wedged or th.is_alive()
        self._threads = []
        for wd in ([self._watchdog] if self._watchdog is not None else []) \
                + list(self._watchdogs or []):
            wd.stop()
        self._abort_handles("aborted")
        with self._hlock:
            jobs = list(self._reconfigs)
            self._reconfigs.clear()
        for _, fut in jobs:
            self._settle(fut, exc=RuntimeError("server stopped before the reconfiguration ran"))
        if wedged:
            # a daemon thread stuck in a dispatch holding the engine lock dies
            # with the process; touching the engine would deadlock
            with self._hlock:
                if self._error is None:
                    self._error = TimeoutError("engine thread still wedged in a tick at stop()")
        else:
            with self._engine_locked():
                self._engine.close()
        if self._error is not None:
            raise RuntimeError("serving engine failed; pending requests were failed") \
                from self._error

    def __enter__(self) -> "ServingServer":
        return self.start()

    def __exit__(self, exc_type, exc_value, traceback) -> None:
        try:
            self.stop()
        except RuntimeError:
            if exc_type is None:  # never mask an exception already on its way
                raise

    @staticmethod
    def _engine_stats(engine: Engine) -> Dict:
        """One engine's live snapshot (the caller holds the engine lock)."""
        pool = engine.pool
        out = {
            "metrics": engine.metrics.summary(),
            "tick": engine.tick_count,
            "queue_depth": engine.scheduler.depth,
            "admission_stalls": dict(engine.scheduler.stalls),
            "active_slots": pool.active_count,
            "num_slots": pool.num_slots,
        }
        if engine.replica_id is not None:
            out["replica_id"] = engine.replica_id
        if engine.mesh is not None:
            out["mesh"] = {n: int(engine.mesh.shape[n]) for n in engine.mesh.axis_names}
        if engine.paged:
            out["free_kv_blocks"] = pool.free_blocks
            out["num_kv_blocks"] = pool.num_blocks
            out["kv_token_capacity"] = pool.token_capacity
        m = engine.metrics
        if engine.prefix_cache is not None:
            # live sharing and the prefill the prefix cache saved so far
            out["prefix"] = {
                "indexed_chunks": len(engine.prefix_cache),
                "shared_kv_blocks": pool.shared_blocks,
                "prefix_hit_rate": m.prefix_hit_rate(),
                "blocks_saved": m.blocks_saved,
                "prefill_tokens_skipped": m.prefill_tokens_skipped,
            }
            if engine.cow_tails:
                out["prefix"]["cow"] = {
                    "adoptions": m.cow_adoptions,
                    "tokens_shared": m.cow_tokens_shared,
                    "forks": m.cow_forks,
                    "forks_elided": m.cow_forks_elided,
                    "resume_prefill_tokens_saved": m.resume_prefill_tokens_saved,
                }
        policy = engine.admission_policy
        if policy is not None:
            # how optimistic the gate runs, the preemption bill, the backlog
            out["admission"] = {
                **policy.status(),
                "parked": engine.scheduler.parked_depth,
                "swap_ins": m.swap_ins,
                "reprefills": m.reprefills,
                "swap_fallbacks": m.swap_fallbacks,
                "swap_bytes_out": m.swap_bytes_out,
                "swap_bytes_in": m.swap_bytes_in,
                "governed": policy.governed(engine.tick_count),
            }
        store = engine._swap_store
        if store is not None:
            # the bounded host store: what parked K/V holds against its cap
            out["swap_store"] = {
                "held_bytes": store.held_bytes,
                "max_bytes": store.max_bytes,
                "records": len(store),
                "evictions": store.evictions,
            }
        out["memory"] = engine.memory_stats()
        if engine.last_reconfig is not None:
            out["last_reconfig"] = engine.last_reconfig.to_dict()
        if m.reconfigs:
            out["reconfigs"] = dict(m.reconfigs)
        return out

    def stats(self) -> Dict:
        """Thread-safe operator snapshot: the metrics summary, slot and block
        occupancy, and why admission stalled. Behind a ``ReplicatedEngine``
        the fleet totals plus ``per_replica`` blocks (each marked with its
        membership state) and the supervisor's status. Free running, each
        replica's block is taken under its own lock, so replicas may show
        different ticks; the lockstep fleet shows one tick. With a healer,
        ``healer`` holds its whole ladder state."""
        if self._free_running:
            per = []
            for i, e in enumerate(self._engine.replicas):
                with self._rlocks[i]:
                    per.append(self._engine_stats(e))
            out = self._fleet_stats(per, max(p["tick"] for p in per), free_running=True)
        else:
            with self._lock:
                replicas = getattr(self._engine, "replicas", None)
                if replicas is None:
                    out = self._engine_stats(self._engine)
                else:
                    out = self._fleet_stats([self._engine_stats(e) for e in replicas],
                                            self._engine.tick_count)
        if self._healer is not None:
            out["healer"] = self._healer.status()
        return out

    def _fleet_stats(self, per: List[Dict], tick: int, free_running: bool = False) -> Dict:
        fleet = self._engine
        for i, p in enumerate(per):
            # an excised member reads as excised, not as a quiet replica
            p["membership"] = fleet.fleet.state(i)
            if i in fleet._excised:
                p["excised"] = True
        out = {"replicas": len(per), "tick": tick}
        if free_running:
            out["free_running"] = True
        out.update({
            "queue_depth": sum(p["queue_depth"] for p in per),
            "active_slots": sum(p["active_slots"] for p in per),
            "num_slots": sum(p["num_slots"] for p in per),
            "per_replica": per,
        })
        if fleet.paged:
            out["free_kv_blocks"] = sum(p["free_kv_blocks"] for p in per)
            out["num_kv_blocks"] = sum(p["num_kv_blocks"] for p in per)
        out["fleet"] = fleet.fleet.status()
        out["excised_replicas"] = sorted(fleet._excised)
        return out

    def cancel(self, request_id: int) -> bool:
        """Thread-safe cancel of a queued or running request: its handle
        finishes "cancelled" with the tokens already streamed. It runs under
        the engine lock (free running: the owning replica's), between ticks:
        a running request's private blocks and reservation come back at
        once, and the prefix blocks it shares stay alive for their other
        users."""
        lock = (self._rlocks[self._engine._owner(request_id)] if self._free_running
                else self._lock)
        with lock:
            ok = self._engine.cancel(request_id)
            if ok:
                self._engine.pop_result(request_id)  # the handle owns the output
        if not ok:
            return False
        with self._hlock:
            handle = self._handles.pop(request_id, None)
            self._requeues.pop(request_id, None)
        if handle is not None:
            handle._finish("cancelled")
        return True

    def submit(self, prompt, max_new_tokens: int, **kwargs) -> StreamHandle:
        """Thread-safe; raises ``QueueFull`` under backpressure and
        RuntimeError once the engine has failed."""
        with self._hlock:
            if self._error is not None:
                raise RuntimeError("serving engine thread died") from self._error
        if self._free_running:
            return self._dispatch_free(prompt, max_new_tokens, **kwargs)[1]
        # submission and registration are atomic with respect to the loop:
        # no tick can retire the request before its handle exists
        with self._lock:
            rid = self._engine.submit(prompt, max_new_tokens, **kwargs)
            handle = StreamHandle(rid)
            with self._hlock:
                if self._error is not None:
                    raise RuntimeError("serving engine thread died") from self._error
                self._handles[rid] = handle
        return handle

    def _dispatch_free(self, prompt, max_new_tokens: int,
                       handle: Optional[StreamHandle] = None,
                       **kwargs) -> Tuple[int, StreamHandle]:
        """Free-running dispatch: the fleet's candidate order probed replica
        by replica, each under ITS lock only, so a submit never waits on an
        unrelated replica's tick. The handle (fresh, or a requeued one) is
        registered before the owner's lock is released, so its loop cannot
        retire the request first. ``QueueFull`` only when every replica
        refuses, charged once to the best candidate as
        ``ReplicatedEngine.submit`` charges it. Returns ``(rid, handle)``."""
        fleet = self._engine
        order = fleet._candidates(np.asarray(prompt, np.int32).reshape(-1))
        for idx, quiet in [(idx, True) for idx in order] + [(order[0], False)]:
            with self._rlocks[idx]:
                try:
                    rid = fleet.replicas[idx].submit(prompt, max_new_tokens,
                                                     _quiet_full=quiet, **kwargs)
                except QueueFull as exc:
                    if quiet:
                        continue
                    if fleet._excised:
                        # backpressure on a shrunken fleet says so
                        gone = ", ".join(f"replica {r} excised" for r in sorted(fleet._excised))
                        raise QueueFull(f"{exc} ({gone}; {len(fleet.active_replicas)} "
                                        "active)") from None
                    raise
                # these submits bypass ReplicatedEngine.submit: advance the
                # warm-up ramp here
                fleet._note_warmup_admit(idx)
                h = handle if handle is not None else StreamHandle(rid)
                h.request_id = rid
                with self._hlock:
                    if self._error is not None:
                        raise RuntimeError("serving engine thread died") from self._error
                    self._handles[rid] = h
                return rid, h
        raise AssertionError("unreachable: the last attempt raises or returns")

    def _abort_handles(self, reason: str) -> None:
        with self._hlock:
            handles = list(self._handles.values())
            self._handles.clear()
            self._requeues.clear()
        for handle in handles:
            handle._finish(reason)

    def _fail_handles(self, error: BaseException) -> None:
        with self._hlock:
            if self._error is None:
                self._error = error
            handles = list(self._handles.values())
            self._handles.clear()
            self._requeues.clear()
            jobs = list(self._reconfigs)
            self._reconfigs.clear()
        for handle in handles:
            handle._fail(error)
        for _, fut in jobs:  # a dead loop can never apply them
            self._settle(fut, exc=error)

    def _on_stall(self, elapsed: float) -> None:
        # runs on the watchdog thread: it must not take an engine lock (the
        # stalled engine thread may hold it forever)
        self._fail_handles(TimeoutError(f"engine tick stalled for {elapsed:.2f}s "
                                        f"(watchdog timeout {self._watchdog_timeout}s)"))
        self._dump("watchdog-stall", {"elapsed_s": round(elapsed, 3),
                                      **self._engine.obs_tags()})

    def _handle_engine_fault(self, exc: BaseException, replica: Optional[int] = None) -> None:
        """Recover the engine, requeue the in-flight requests (bounded),
        fail the rest. Gives up (fails everything, poisons the server) after
        ``max_engine_faults`` consecutive faulted ticks. ``replica`` scopes
        it to one free-running replica: only its engine recovers (under its
        lock), only its requests reconcile, and they re-dispatch across the
        fleet."""
        eng = self._engine if replica is None else self._engine.replicas[replica]
        elock = self._lock if replica is None else self._rlocks[replica]
        if replica is None:
            self._faults += 1
            consecutive = self._faults
        else:
            self._rfaults[replica] += 1
            consecutive = self._rfaults[replica]
        give_up = consecutive > self._max_engine_faults
        tr = eng.tracer
        if tr.enabled:
            tr.event("serve/engine_fault", cat="resilience", error=type(exc).__name__,
                     consecutive=consecutive, give_up=give_up,
                     **({} if replica is None else {"replica": replica}))
        if self._sentinel is not None and not isinstance(exc, SentinelRemediation):
            # real faults land in the anomaly log; a requested recover is
            # the remediation itself and does not note itself
            self._sentinel.note_fault(error=type(exc).__name__, replica=replica)
        with self._hlock:
            known = [rid for rid in self._handles
                     if replica is None or self._engine._owner(rid) == replica]
        retired = []
        with elock:
            failed = eng.recover()
            for req in failed:  # the handles own the output now
                eng.results.pop(req.request_id, None)
                eng.status.pop(req.request_id, None)
            # requests the faulted tick retired BEFORE raising (deadline
            # expiry, a finish at admission) lost their StepEvents with the
            # exception: reconcile them from the engine's status
            for rid in known:
                if eng.status.get(rid) in ("done", "timeout", "cancelled"):
                    tokens, status = eng.pop_result(rid)
                    retired.append((rid, tokens, status))
        for rid, tokens, status in retired:
            with self._hlock:
                handle = self._handles.pop(rid, None)
                self._requeues.pop(rid, None)
            if handle is not None:
                # the engine holds the whole generation; the handle may hold
                # earlier ticks' tokens, so reset before replaying it all
                handle._restart()
                for token in tokens:
                    handle._put(token)
                # "done", not eos/length: the finer reason died with the tick
                handle._finish(status)
        dead: List[StreamHandle] = []
        plans = []
        dead_jobs = []
        with self._hlock:
            for req in failed:
                n = self._requeues.pop(req.request_id, 0)
                handle = self._handles.pop(req.request_id, None)
                if handle is None:
                    continue
                if give_up or n >= self._max_requeues:
                    dead.append(handle)
                else:
                    plans.append((req, n, handle))
            if give_up:
                if self._error is None:
                    self._error = exc
                dead.extend(self._handles.values())
                self._handles.clear()
                self._requeues.clear()
                plans = []
                # the loops exit on _error: queued reconfigurations can never
                # run, so their futures fail now
                dead_jobs = list(self._reconfigs)
                self._reconfigs.clear()
        for _, fut in dead_jobs:
            self._settle(fut, exc=exc)
        for req, n, handle in plans:
            handle._restart()  # the generation re-runs from scratch
            remaining = (None if req.deadline_tick is None
                         else max(0, req.deadline_tick - eng.tick_count))
            kw = dict(eos_id=req.eos_id, rng_seed=req.rng_seed, deadline_ticks=remaining)
            try:
                if replica is None:
                    with self._lock:
                        rid = self._engine.submit(req.prompt, req.max_new_tokens, **kw)
                else:
                    # re-dispatched across the whole fleet; registered inside,
                    # under the new owner's lock
                    rid, _ = self._dispatch_free(req.prompt, req.max_new_tokens,
                                                 handle=handle, **kw)
            except Exception as resubmit_exc:  # noqa: BLE001 — e.g. QueueFull
                handle._fail(resubmit_exc)
                continue
            with self._hlock:
                if self._error is not None:
                    dead.append(handle)
                    continue
                handle.request_id = rid
                if replica is None:
                    self._handles[rid] = handle
                elif rid not in self._handles:
                    # the new owner's loop already finished it
                    continue
                self._requeues[rid] = n + 1
            if tr.enabled:
                tr.event("req/requeue", cat="resilience", rid=rid, prior_rid=req.request_id,
                         attempt=n + 1)
        for handle in dead:
            if handle.error is None:
                handle._fail(exc)
        # every fault ships its postmortem
        self._dump("engine-fault-giveup" if give_up else "engine-fault",
                   {"error": repr(exc), **eng.obs_tags()})

    def _observe(self, eng, t0: Optional[float], replica: Optional[int] = None) -> None:
        """Feed the sentinel one engine's windowed rates (and, given ``t0``,
        its tick's wall time)."""
        snt = self._sentinel
        rid = eng.replica_id if replica is None else replica
        if t0 is not None:
            snt.observe_tick(time.monotonic() - t0, replica=replica)
        if eng.speculate_k:
            snt.observe_accept(eng.metrics.recent_accept_rate(), replica=rid)
        if eng.admission_policy is not None:
            snt.observe_preemptions(eng.metrics.recent_preemption_rate(), replica=rid)
        if eng.swap_mode == "tiered":
            snt.observe_tier_spills(eng.metrics.recent_tier_spill_rate(), replica=rid)

    def _claim(self, replica: Optional[int] = None):
        """Under _hlock: ``(stop, nudge, job)`` for this loop. A free-running
        replica claims only a nudge for itself or an untargeted one; the
        lockstep loop any. A reconfiguration goes to the first loop to poll."""
        with self._hlock:
            if self._error is not None:
                return True, None, None  # a stall or the give-up failed the handles
            if replica is None:
                nudge = self._nudges.pop(next(iter(self._nudges))) if self._nudges else None
            else:
                nudge = self._nudges.pop(replica, None)
                if nudge is None and None in self._nudges:
                    nudge = self._nudges.pop(None)
            job = self._reconfigs.popleft() if nudge is None and self._reconfigs else None
        return False, nudge, job

    def _deliver(self, events, lock) -> None:
        """Stream one tick's tokens and finishes to their handles."""
        for rid, tok in events.emitted:
            with self._hlock:
                handle = self._handles.get(rid)
            if handle is not None:
                handle._put(tok)
        for rid, reason in events.finished:
            with self._hlock:
                handle = self._handles.pop(rid, None)
                self._requeues.pop(rid, None)
            if handle is not None:
                handle._finish(reason)
            with lock:
                self._engine.pop_result(rid)  # the handle holds the tokens

    def _loop(self) -> None:
        snt, wd, eng = self._sentinel, self._watchdog, self._engine
        fleet = hasattr(eng, "replicas")
        try:
            while not self._stop.is_set():
                stop, nudge, job = self._claim()
                if stop:
                    return
                if nudge is not None:
                    # a remediation: the fault path, on the loop thread where
                    # the engine lock is safe to take
                    self._handle_engine_fault(SentinelRemediation(nudge))
                    continue
                if job is not None:
                    self._execute_reconfig(*job)
                    continue
                try:
                    with self._lock:
                        if eng.idle:
                            events = None
                        else:
                            if wd is not None:
                                wd.arm()
                            t0 = time.monotonic()
                            try:
                                events = eng.step()
                            finally:
                                if wd is not None:
                                    wd.disarm()
                except Exception as e:  # noqa: BLE001 — the fault contract
                    self._handle_engine_fault(e)
                    continue
                if events is None:
                    if snt is not None:
                        # an idle engine is not stalled: park the lease
                        snt.heartbeat(tick=eng.tick_count, busy=False)
                        snt.check()
                    # verification windows and cooldowns keep expiring while
                    # the engine has nothing to decode
                    self._poll_healer()
                    self._stop.wait(self._idle_sleep)
                    continue
                self._faults = 0  # a clean tick resets the consecutive budget
                if snt is not None:
                    if fleet:
                        # the fleet heartbeats per replica from its step();
                        # rates per replica, so one replica's thrash cannot
                        # hide behind the fleet's average
                        for e in eng.replicas:
                            self._observe(e, None)
                        snt.observe_tick(time.monotonic() - t0)
                    else:
                        snt.heartbeat(tick=eng.tick_count, busy=not eng.idle)
                        self._observe(eng, None)
                        snt.observe_tick(time.monotonic() - t0)
                    snt.check()
                self._poll_healer()
                if self._slo is not None:
                    self._slo.tick()
                self._deliver(events, self._lock)
                # threading.Lock is not fair: a host-bound loop that takes the
                # engine lock straight back starves submit/cancel/stats
                # waiting on it. Yield the interpreter once per tick.
                time.sleep(0)
        except BaseException as e:  # a dead loop must not strand callers
            self._fail_handles(e)
            raise

    def _fleet_steward(self) -> int:
        """The replica whose loop runs the fleet's singleton duties (the
        supervision cadence, SLO ticks) this pass: the lowest member neither
        halted nor excised, re-resolved every pass so the duties fail over
        when the steward dies."""
        fleet = self._engine
        for j in range(len(fleet.replicas)):
            if j not in fleet._excised and not fleet.fleet.halted(j):
                return j
        return 0  # a fleet of corpses: nothing left to steward

    def _steward_duties(self, i: int, sup_n: int) -> int:
        """Every fourth pass of the steward's loop, supervise the fleet
        (hedging touches other replicas' schedulers: every lock, in order).
        Returns the loop's new cadence count."""
        if i != self._fleet_steward():
            return sup_n
        sup_n += 1
        if sup_n >= 4:
            sup_n = 0
            with self._engine_locked():
                self._engine.supervise()
        return sup_n

    def _replica_loop(self, i: int) -> None:
        """One free-running replica's loop: tick MY engine under MY lock at
        my own pace, with my own watchdog window, sentinel heartbeat and
        fault budget (a give-up still poisons the whole server). The steward
        replica also supervises the fleet and ticks the SLO evaluator."""
        fleet = self._engine
        eng = fleet.replicas[i]
        lock = self._rlocks[i]
        wd = self._watchdogs[i] if self._watchdogs is not None else None
        snt = self._sentinel
        sup = fleet.fleet
        sup_n = 0
        try:
            while not self._stop.is_set():
                if i in fleet._excised:
                    return  # excision is terminal: this loop retires
                if sup.halted(i):
                    # a killed or wedged member stops ticking: its silence is
                    # what the membership leases detect
                    self._stop.wait(self._idle_sleep)
                    continue
                stop, nudge, job = self._claim(i)
                if stop:
                    return
                if nudge is not None:
                    self._handle_engine_fault(SentinelRemediation(nudge), replica=i)
                    continue
                if job is not None:
                    # a fleet-wide reconfiguration takes every replica lock in
                    # order; the other loops wait on their own meanwhile
                    self._execute_reconfig(*job)
                    continue
                try:
                    with lock:
                        if eng.idle:
                            events = None
                        else:
                            if wd is not None:
                                wd.arm()
                            t0 = time.monotonic()
                            try:
                                events = eng.step()
                            finally:
                                if wd is not None:
                                    wd.disarm()
                except Exception as e:  # noqa: BLE001 — the fault contract
                    self._handle_engine_fault(e, replica=i)
                    continue
                # a clean or idle pass renews MY lease: the fleet clock is the
                # furthest tick, so an idle member must renew while a
                # neighbor decodes or it ages into a false SUSPECT
                sup.heartbeat(i)
                if events is None:
                    if snt is not None:
                        snt.heartbeat(replica=i, tick=eng.tick_count, busy=False)
                        snt.check()
                    sup_n = self._steward_duties(i, sup_n)
                    # every replica loop advances the ladder; a rung aimed at
                    # replica j is claimed by j's loop
                    self._poll_healer()
                    if self._slo is not None and i == self._fleet_steward():
                        self._slo.tick()
                    self._stop.wait(self._idle_sleep)
                    continue
                self._rfaults[i] = 0  # a clean tick resets this budget
                sup_n = self._steward_duties(i, sup_n)
                if snt is not None:
                    snt.heartbeat(replica=i, tick=eng.tick_count, busy=not eng.idle)
                    self._observe(eng, t0, replica=i)
                    snt.check()
                self._poll_healer()
                if self._slo is not None and i == self._fleet_steward():
                    self._slo.tick()
                self._deliver(events, lock)
                time.sleep(0)  # the replica lock is not fair either
        except BaseException as e:  # a dead replica loop must not strand callers
            self._fail_handles(e)
            raise


@dataclasses.dataclass
class TraceItem:
    """One arrival in a synthetic trace (ticks, not wall time)."""

    arrival_tick: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int] = None
    rng_seed: int = 0
    deadline_ticks: Optional[int] = None


class SimulationDriver:
    """Replays seeded arrival traces on the logical tick clock.

    Rewires the engine's metrics clock to tick counts (TTFT and latency come
    out in ticks), and a deterministic tracer's clock too. Arrivals that hit
    backpressure retry on the next tick (closed loop)."""

    def __init__(self, engine: Engine, seed: int = 0):
        self.engine = engine
        self.seed = seed
        engine.metrics.clock = lambda: float(engine.tick_count)
        tracer = getattr(engine, "tracer", None)
        if tracer is not None and getattr(tracer, "deterministic", False):
            tracer.clock = lambda: float(engine.tick_count)

    def make_trace(self, n_requests: int, vocab_size: Optional[int] = None,
                   arrival_rate: float = 0.5, prompt_len: Tuple[int, int] = (1, 12),
                   max_new: Tuple[int, int] = (1, 12),
                   eos_id: Optional[int] = None) -> List[TraceItem]:
        """Geometric inter-arrival gaps at ``arrival_rate`` requests per tick,
        uniform prompt lengths, contents and budgets: JAX's draws, in JAX's
        order."""
        rng = np.random.default_rng(self.seed)
        vocab = vocab_size or self.engine.cfg.vocab_size
        items, t = [], 0
        for i in range(n_requests):
            t += int(rng.geometric(min(max(arrival_rate, 1e-6), 1.0))) - 1
            n = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
            items.append(TraceItem(
                arrival_tick=t,
                prompt=rng.integers(0, vocab, size=(n,)).astype(np.int32),
                max_new_tokens=int(rng.integers(max_new[0], max_new[1] + 1)),
                eos_id=eos_id,
                rng_seed=i,
            ))
        return items

    def run(self, trace: List[TraceItem], max_ticks: int = 100_000) -> List[dict]:
        """Run to completion; one record per trace item, in trace order:
        ``{"request_id", "prompt", "tokens", "status"}``."""
        engine = self.engine
        pending = sorted(enumerate(trace), key=lambda it: it[1].arrival_tick)
        records: List[Optional[dict]] = [None] * len(trace)
        ticks = 0
        while pending or not engine.idle:
            if ticks >= max_ticks:
                raise RuntimeError(f"trace not drained after {max_ticks} ticks")
            still = []
            for idx, item in pending:
                if item.arrival_tick > engine.tick_count:
                    still.append((idx, item))
                    continue
                try:
                    rid = engine.submit(item.prompt, item.max_new_tokens,
                                        eos_id=item.eos_id, rng_seed=item.rng_seed,
                                        deadline_ticks=item.deadline_ticks)
                except QueueFull:
                    still.append((idx, item))  # backpressure: retry next tick
                    continue
                records[idx] = {"request_id": rid, "prompt": item.prompt}
            pending = still
            engine.step()
            ticks += 1
        for rec in records:
            if rec is not None:
                tokens, status = engine.pop_result(rec["request_id"])
                rec["tokens"] = list(tokens)
                rec["status"] = status
        return records
