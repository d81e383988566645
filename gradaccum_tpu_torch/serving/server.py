"""Front-ends for the engine: a threaded server and a deterministic driver.

The port of ``gradaccum_tpu/serving/server.py`` for one engine:

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
:meth:`ServingServer.request_recover`), an ``slo`` evaluator bound to the
engine's registry and ticked per clean tick, and ``telemetry_port``'s
read-only HTTP endpoints. The self-healing ladder (``healer``) waits for
ROADMAP.md item 5h's second half, live reconfiguration for 5g's first
half, replica fleets and ``free_running`` for 5g's second half; each
raises ``NotImplementedError`` naming its item.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from gradaccum_tpu_torch.resilience.watchdog import Watchdog
from gradaccum_tpu_torch.serving.engine import (
    FLEET_ITEM,
    HEALER_ITEM,
    RECONFIG_ITEM,
    Engine,
)
from gradaccum_tpu_torch.serving.scheduler import QueueFull

_DONE = object()  # sentinel closing a handle's token stream


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
    recovered fault, the give-up and a watchdog fire dump the recent-event
    ring as a postmortem.
    ``sentinel``: an optional ``obs/sentinel.py :: Sentinel``; the loop
    feeds it heartbeats, tick durations and the engine's accept, preemption
    and tier-spill rates, real faults are noted on it, and its remediations
    may call :meth:`request_recover`. With ``check_interval`` set,
    :meth:`start` runs its background lease checker too.
    ``slo``: an optional ``obs/slo.py :: SLOEvaluator``, bound to the
    engine's registry and ticked once per clean tick.
    ``telemetry_port``: when set (0 = ephemeral), :meth:`start` brings up
    ``obs/telemetry.py``'s endpoints on ``telemetry_host``: ``/metrics``
    scrapes the engine's registry, ``/healthz`` and ``/readyz`` reflect the
    loop, the fault state, the drain and firing anomalies, ``/varz`` is
    :meth:`stats`, ``/trace`` the span ring, ``/slo`` and ``/sentinel``
    their owners' status.
    ``healer`` and ``free_running`` (and an engine with ``replicas``) raise
    ``NotImplementedError``."""

    def __init__(self, engine: Engine, idle_sleep: float = 1e-3, max_requeues: int = 1,
                 max_engine_faults: int = 3, watchdog_timeout: Optional[float] = None,
                 flight=None, sentinel=None, slo=None, healer=None,
                 telemetry_port: Optional[int] = None, telemetry_host: str = "127.0.0.1",
                 free_running: bool = False):
        if healer is not None:
            raise NotImplementedError(f"ServingServer(healer=...) waits for {HEALER_ITEM}")
        if bool(free_running) or hasattr(engine, "replicas"):
            raise NotImplementedError(f"ServingServer(replicas=...) waits for {FLEET_ITEM}")
        self._engine = engine
        self._flight = flight
        self._sentinel = sentinel
        self._slo = slo
        self._registry = getattr(engine.metrics, "registry", None)
        if slo is not None and self._registry is not None:
            slo.bind_registry(self._registry)
        self._telemetry_port = telemetry_port
        self._telemetry_host = telemetry_host
        self._telemetry = None
        # a requested recover (a sentinel remediation), honored by the loop
        # at its next iteration; guarded by _hlock
        self._nudge: Optional[str] = None
        self._idle_sleep = idle_sleep
        self._max_requeues = max_requeues
        self._max_engine_faults = max_engine_faults
        # _lock guards the engine (not thread-safe); _hlock the handle
        # registry, the requeue counts and the error flag. Separate on
        # purpose: the watchdog must fail handles while the engine thread
        # may be wedged INSIDE a step() holding _lock. Lock order: _lock,
        # then _hlock.
        self._lock = threading.Lock()
        self._hlock = threading.Lock()
        self._handles: Dict[int, StreamHandle] = {}
        self._requeues: Dict[int, int] = {}  # request_id -> times requeued
        self._faults = 0  # consecutive faulted ticks
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._watchdog_timeout = watchdog_timeout
        # the watchdog pins only an explicitly injected engine tracer; None
        # resolves the global one when it fires, as the engine does
        self._watchdog = (None if watchdog_timeout is None else
                          Watchdog(watchdog_timeout, self._on_stall, tracer=engine._tracer))

    def start(self) -> "ServingServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        if self._stop.is_set():
            raise RuntimeError("server was stopped and cannot be restarted; build a new "
                               "ServingServer around the engine")
        if self._watchdog is not None:
            # the engine suspends it across planned long operations
            self._engine.watchdog = self._watchdog
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
        """Liveness: the engine thread exists and has not died. A server
        that gave up is no longer alive."""
        with self._hlock:
            error = self._error
        alive = self._thread is not None and self._thread.is_alive()
        detail = {
            "engine_thread": bool(alive),
            "consecutive_faults": self._faults,
            "tick": self._engine.tick_count,
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
        """Ask the loop thread to run the engine-fault recovery (recover →
        bounded requeue → flight dump) at its next iteration: the sentinel
        remediation entry point. Safe from any thread; a no-op once the
        server failed or while a request is already pending. ``replica`` is
        accepted for the remediation's signature; one engine recovers whole.
        A loop wedged inside a tick never honors it: that is the watchdog's
        job."""
        with self._hlock:
            if self._error is None and self._nudge is None:
                self._nudge = reason

    def request_reconfig(self, spec):
        raise NotImplementedError(f"request_reconfig waits for {RECONFIG_ITEM}")

    def reconfigure(self, spec, timeout: Optional[float] = 60.0):
        raise NotImplementedError(f"reconfigure waits for {RECONFIG_ITEM}")

    def stop(self) -> None:
        """Stop the loop and close the engine; requests still in flight
        finish "aborted". Re-raises (wrapped) an engine failure the server
        gave up on. With a watchdog, a thread wedged INSIDE a tick is
        abandoned after a bounded join (it holds the engine lock, so
        closing the engine would deadlock)."""
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
        if self._watchdog is not None:
            self._watchdog.stop()
        self._abort_handles("aborted")
        if wedged:
            # a daemon thread stuck in a dispatch holding _lock dies with
            # the process; touching the engine would deadlock
            with self._hlock:
                if self._error is None:
                    self._error = TimeoutError("engine thread still wedged in a tick at stop()")
        else:
            with self._lock:
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
        return out

    def stats(self) -> Dict:
        """Thread-safe operator snapshot: the metrics summary, slot and block
        occupancy, and why admission stalled."""
        with self._lock:
            return self._engine_stats(self._engine)

    def cancel(self, request_id: int) -> bool:
        """Thread-safe cancel of a queued or running request: its handle
        finishes "cancelled" with the tokens already streamed. It runs under
        the engine lock, between ticks: a running request's private blocks
        and reservation come back at once, and the prefix blocks it shares
        stay alive for their other users."""
        with self._lock:
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
        for handle in handles:
            handle._fail(error)

    def _on_stall(self, elapsed: float) -> None:
        # runs on the watchdog thread: it must not take self._lock (the
        # stalled engine thread may hold it forever)
        self._fail_handles(TimeoutError(f"engine tick stalled for {elapsed:.2f}s "
                                        f"(watchdog timeout {self._watchdog_timeout}s)"))
        if self._flight is not None:
            try:  # best effort: the stall is already the story
                self._flight.dump("watchdog-stall",
                                  extra={"elapsed_s": round(elapsed, 3),
                                         **self._engine.obs_tags()})
            except Exception:  # noqa: BLE001
                pass

    def _handle_engine_fault(self, exc: BaseException) -> None:
        """Recover the engine, requeue the in-flight requests (bounded),
        fail the rest. Gives up (fails everything, poisons the server) after
        ``max_engine_faults`` consecutive faulted ticks."""
        eng = self._engine
        self._faults += 1
        consecutive = self._faults
        give_up = consecutive > self._max_engine_faults
        tr = eng.tracer
        if tr.enabled:
            tr.event("serve/engine_fault", cat="resilience", error=type(exc).__name__,
                     consecutive=consecutive, give_up=give_up)
        if self._sentinel is not None and not isinstance(exc, SentinelRemediation):
            # real faults land in the anomaly log; a requested recover is
            # the remediation itself and does not note itself
            self._sentinel.note_fault(error=type(exc).__name__)
        with self._hlock:
            known = list(self._handles)
        retired = []
        with self._lock:
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
        for req, n, handle in plans:
            handle._restart()  # the generation re-runs from scratch
            remaining = (None if req.deadline_tick is None
                         else max(0, req.deadline_tick - eng.tick_count))
            try:
                with self._lock:
                    rid = eng.submit(req.prompt, req.max_new_tokens, eos_id=req.eos_id,
                                     rng_seed=req.rng_seed, deadline_ticks=remaining)
            except Exception as resubmit_exc:  # noqa: BLE001 — e.g. QueueFull
                handle._fail(resubmit_exc)
                continue
            with self._hlock:
                if self._error is not None:
                    dead.append(handle)
                    continue
                handle.request_id = rid
                self._handles[rid] = handle
                self._requeues[rid] = n + 1
            if tr.enabled:
                tr.event("req/requeue", cat="resilience", rid=rid, prior_rid=req.request_id,
                         attempt=n + 1)
        for handle in dead:
            if handle.error is None:
                handle._fail(exc)
        if self._flight is not None:
            # every fault ships its postmortem; a failed dump must not turn a
            # recovered fault into a fatal loop error
            try:
                self._flight.dump("engine-fault-giveup" if give_up else "engine-fault",
                                  extra={"error": repr(exc), **eng.obs_tags()})
            except Exception:  # noqa: BLE001
                pass

    def _observe_tick(self, t0: float) -> None:
        """Feed the sentinel one clean tick: the heartbeat, the engine's
        windowed rates, the tick's wall time, then the lease check."""
        snt, eng = self._sentinel, self._engine
        snt.heartbeat(tick=eng.tick_count, busy=not eng.idle)
        if eng.speculate_k:
            snt.observe_accept(eng.metrics.recent_accept_rate(), replica=eng.replica_id)
        if eng.admission_policy is not None:
            snt.observe_preemptions(eng.metrics.recent_preemption_rate(),
                                    replica=eng.replica_id)
        if eng.swap_mode == "tiered":
            snt.observe_tier_spills(eng.metrics.recent_tier_spill_rate(),
                                    replica=eng.replica_id)
        snt.observe_tick(time.monotonic() - t0)
        snt.check()

    def _loop(self) -> None:
        snt, wd = self._sentinel, self._watchdog
        try:
            while not self._stop.is_set():
                with self._hlock:
                    if self._error is not None:
                        return  # a stall or the give-up already failed the handles
                    nudge, self._nudge = self._nudge, None
                if nudge is not None:
                    # a remediation: the fault path, on the loop thread where
                    # the engine lock is safe to take
                    self._handle_engine_fault(SentinelRemediation(nudge))
                    continue
                try:
                    with self._lock:
                        if self._engine.idle:
                            events = None
                        else:
                            if wd is not None:
                                wd.arm()
                            t0 = time.monotonic()
                            try:
                                events = self._engine.step()
                            finally:
                                if wd is not None:
                                    wd.disarm()
                except Exception as e:  # noqa: BLE001 — the fault contract
                    self._handle_engine_fault(e)
                    continue
                if events is None:
                    if snt is not None:
                        # an idle engine is not stalled: park the lease
                        snt.heartbeat(tick=self._engine.tick_count, busy=False)
                        snt.check()
                    self._stop.wait(self._idle_sleep)
                    continue
                self._faults = 0  # a clean tick resets the consecutive budget
                if snt is not None:
                    self._observe_tick(t0)
                if self._slo is not None:
                    self._slo.tick()
                for rid, tok in events.emitted:
                    handle = self._handles.get(rid)
                    if handle is not None:
                        handle._put(tok)
                for rid, reason in events.finished:
                    with self._hlock:
                        handle = self._handles.pop(rid, None)
                        self._requeues.pop(rid, None)
                    if handle is not None:
                        handle._finish(reason)
                    with self._lock:
                        self._engine.pop_result(rid)  # the handle holds the tokens
                # threading.Lock is not fair: a host-bound loop that takes the
                # engine lock straight back starves submit/cancel/stats
                # waiting on it. Yield the interpreter once per tick.
                time.sleep(0)
        except BaseException as e:  # a dead loop must not strand callers
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
