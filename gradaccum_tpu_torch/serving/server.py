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
caller: every pending :class:`StreamHandle` fails with it (``result()``
raises) and ``stop()`` re-raises it. JAX's server first recovers the engine
and requeues the running requests; that waits for ``Engine.recover``
(ROADMAP.md item 5h), as do the watchdog, the healer, the sentinel, the
SLO evaluator and the telemetry endpoints; replica fleets and
``free_running`` wait for item 5g. Each raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from gradaccum_tpu_torch.serving.engine import FLEET_ITEM, RECOVER_ITEM, Engine
from gradaccum_tpu_torch.serving.scheduler import QueueFull

OBS_ITEM = "obs/{slo,sentinel,telemetry}.py (ROADMAP.md item 5f)"
_DONE = object()  # sentinel closing a handle's token stream


class StreamHandle:
    """One request's streamed output. Iterate for tokens as they arrive;
    ``result()`` blocks for the complete generation."""

    def __init__(self, request_id: int):
        self.request_id = request_id
        self._q: "queue.Queue" = queue.Queue()  # token | _DONE
        self._tokens: List[int] = []
        self._reason: Optional[str] = None
        self._error: Optional[BaseException] = None
        self._closed = threading.Event()
        self._drained = False  # the _DONE sentinel has been consumed

    def _put(self, token: int) -> None:
        self._q.put(token)

    def _finish(self, reason: str) -> None:
        self._reason = reason
        self._closed.set()
        self._q.put(_DONE)

    def _fail(self, error: BaseException) -> None:
        """Engine death reaches the caller: ``result()`` raises, iteration
        ends."""
        self._error = error
        self._finish("error")

    def __iter__(self):
        while not self._drained:
            item = self._q.get()
            if item is _DONE:
                self._drained = True
                return
            self._tokens.append(item)
            yield item

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
            self._tokens.append(item)
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


class ServingServer:
    """Threaded front-end: one engine thread, many submitting threads.

    ``flight``: an optional ``obs/flight.py :: FlightRecorder``; an engine
    fault dumps the recent-event ring as a postmortem."""

    def __init__(self, engine: Engine, idle_sleep: float = 1e-3, flight=None,
                 watchdog_timeout: Optional[float] = None, sentinel=None, slo=None,
                 healer=None, telemetry_port: Optional[int] = None,
                 free_running: bool = False):
        refused = [(watchdog_timeout is not None, "watchdog_timeout", RECOVER_ITEM),
                   (healer is not None, "healer", RECOVER_ITEM),
                   (sentinel is not None, "sentinel", OBS_ITEM),
                   (slo is not None, "slo", OBS_ITEM),
                   (telemetry_port is not None, "telemetry_port", OBS_ITEM),
                   (bool(free_running) or hasattr(engine, "replicas"), "replicas",
                    FLEET_ITEM)]
        for hit, knob, item in refused:
            if hit:
                raise NotImplementedError(f"ServingServer({knob}=...) waits for {item}")
        self._engine = engine
        self._flight = flight
        self._idle_sleep = idle_sleep
        # _lock guards the engine (not thread-safe); _hlock the handle
        # registry and the error flag. Lock order: _lock, then _hlock.
        self._lock = threading.Lock()
        self._hlock = threading.Lock()
        self._handles: Dict[int, StreamHandle] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def start(self) -> "ServingServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        if self._stop.is_set():
            raise RuntimeError("server was stopped and cannot be restarted; build a new "
                               "ServingServer around the engine")
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serving-engine")
        self._thread.start()
        return self

    def request_recover(self, reason: str, replica=None):
        raise NotImplementedError(f"request_recover waits for {RECOVER_ITEM}")

    def request_reconfig(self, spec):
        raise NotImplementedError(f"request_reconfig waits for {FLEET_ITEM}")

    def reconfigure(self, spec, timeout: Optional[float] = 60.0):
        raise NotImplementedError(f"reconfigure waits for {FLEET_ITEM}")

    def stop(self) -> None:
        """Stop the loop and close the engine; requests still in flight
        finish "aborted". Re-raises (wrapped) an engine failure the loop
        died from."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._abort_handles("aborted")
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
        for handle in handles:
            handle._finish(reason)

    def _fail_handles(self, error: BaseException) -> None:
        with self._hlock:
            if self._error is None:
                self._error = error
            handles = list(self._handles.values())
            self._handles.clear()
        for handle in handles:
            handle._fail(error)

    def _handle_engine_fault(self, exc: BaseException) -> None:
        """Fail every pending handle and the server; dump the flight ring."""
        tr = self._engine.tracer
        if tr.enabled:
            tr.event("serve/engine_fault", cat="resilience", error=type(exc).__name__,
                     consecutive=1, give_up=True)
        self._fail_handles(exc)
        if self._flight is not None:
            try:  # best effort: the fault is already the story
                self._flight.dump("engine-fault-giveup",
                                  extra={"error": repr(exc), **self._engine.obs_tags()})
            except Exception:  # noqa: BLE001
                pass

    def _loop(self) -> None:
        try:
            while not self._stop.is_set():
                with self._hlock:
                    if self._error is not None:
                        return
                try:
                    with self._lock:
                        events = None if self._engine.idle else self._engine.step()
                except Exception as e:
                    self._handle_engine_fault(e)
                    return
                if events is None:
                    self._stop.wait(self._idle_sleep)
                    continue
                for rid, tok in events.emitted:
                    handle = self._handles.get(rid)
                    if handle is not None:
                        handle._put(tok)
                for rid, reason in events.finished:
                    with self._hlock:
                        handle = self._handles.pop(rid, None)
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
