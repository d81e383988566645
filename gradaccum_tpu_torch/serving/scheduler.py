"""Admission control: bounded FIFO queue, backpressure, deadlines, policy.

The port of ``gradaccum_tpu/serving/scheduler.py``, whole (host-side, no
torch). The queue is intentionally boring — what the device needs is static
shapes downstream. What matters here is the contract
with callers: ``submit`` REJECTS when the queue is full (raising
:class:`QueueFull`) instead of buffering unboundedly, queued requests whose
deadline passes are expired without ever touching the device, and the
prefill/decode interleaving knobs bound how much prefill work any single
tick can inject ahead of running decodes (a long admission burst otherwise
stalls every active request's next token).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np


class QueueFull(RuntimeError):
    """Backpressure signal: the admission queue is at capacity — retry
    later or shed load upstream. Deliberately an exception, not a silent
    drop, so front-ends must decide."""


@dataclasses.dataclass
class Request:
    """One generation request as the scheduler/engine see it.

    ``deadline_tick`` bounds QUEUE time: a request still queued past it is
    expired with reason "timeout" (once admitted it runs to completion —
    slots are cheap, re-queueing is not). ``rng_seed`` feeds the per-request
    sampling stream (``fold_in(PRNGKey(seed), token_index)``), matching
    ``generate_cached(rng=PRNGKey(seed))`` token-for-token.
    """

    request_id: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int
    eos_id: Optional[int] = None
    rng_seed: int = 0
    deadline_tick: Optional[int] = None
    submit_tick: int = 0


class Scheduler:
    """Bounded FIFO with reject-when-full and prefill/decode interleaving.

    ``max_queue``: queue capacity (beyond the slots already running).
    ``max_prefill_per_tick``: cap on admissions per tick — bounds the
    prefill batch (and therefore the prefill program's batch axis).
    ``prefill_interval``: admit only every N-th tick; between admission
    ticks the engine runs pure decode ticks, trading TTFT for smoother
    per-token latency under load (``Engine(overlap_prefill=True)``
    attacks the same contention without rationing admission ticks).

    Queue-wait accounting contract: the engine records a request's queue
    wait at the admission POP (``ServingMetrics.record_admit``) — every
    admitted request contributes its full submit→admit wait exactly once,
    whatever interval phase or overlap mode the tick runs under — and a
    deadline expiry records its terminal wait too
    (``record_expired``), so the queue-wait SLO series cannot undercount
    exactly when off-phase ticks leave requests waiting.
    """

    def __init__(
        self,
        max_queue: int = 64,
        max_prefill_per_tick: Optional[int] = None,
        prefill_interval: int = 1,
    ):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if prefill_interval < 1:
            raise ValueError(
                f"prefill_interval must be >= 1, got {prefill_interval}"
            )
        self.max_queue = max_queue
        self.max_prefill_per_tick = max_prefill_per_tick
        self.prefill_interval = prefill_interval
        self._queue: Deque[Request] = deque()
        # preempted requests waiting to RE-enter a slot. Strictly ahead of
        # new admissions (the engine resumes parked heads before admitting
        # fresh traffic, and holds fresh admission while any are parked):
        # they already consumed prefill + decode work, and admitting around
        # them is exactly the thrash an admission policy must not feed.
        # Does not count against max_queue — parking is the ENGINE shedding
        # load onto the host, not a caller submitting more.
        self._parked: Deque[Request] = deque()
        # why admission stalled, per tick it stalled: "no_free_slots" vs
        # "no_free_blocks" tells an operator which resource to grow;
        # admission-policy engines add "held_by_quantile_gate" (blocks
        # exist but the policy's budget gate refused) and
        # "parked_queue_ahead" (preempted requests resume first);
        # a live reconfiguration records "reconfiguring" while fresh
        # traffic waits out the quiesce. A
        # replica engine sets ``label`` ("replica 2") so fleet-level stall
        # keys also say WHICH engine is saturated; None keeps the
        # single-engine keys exactly as they always were.
        self.stalls: Dict[str, int] = {}
        self.label: Optional[str] = None
        # obs span tracer; an owning Engine built with an injected tracer
        # wires it in so stall events land on that engine's timeline —
        # otherwise the process-global tracer is resolved per use
        self._tracer = None

    @property
    def tracer(self):
        from gradaccum_tpu_torch.obs import trace as obs_trace

        return obs_trace.resolve(self._tracer)

    @tracer.setter
    def tracer(self, tracer) -> None:
        self._tracer = tracer

    def record_stall(self, reason: str) -> None:
        if self.label is not None:
            reason = f"{self.label}: {reason}"
        self.stalls[reason] = self.stalls.get(reason, 0) + 1
        tr = self.tracer
        if tr.enabled:
            tr.event("serve/admission_stall", cat="serving", reason=reason,
                     depth=len(self._queue))

    @property
    def depth(self) -> int:
        return len(self._queue)

    @property
    def parked_depth(self) -> int:
        return len(self._parked)

    def peek(self) -> Optional[Request]:
        """The request next in line for admission (None when empty)."""
        return self._queue[0] if self._queue else None

    def pending(self) -> List[Request]:
        """A copy of the fresh queue in admission order — reconfiguration
        sizes its shrink-refusal demand from it without reaching into the
        deque."""
        return list(self._queue)

    def drain_queue(self) -> List[Request]:
        """Pop EVERY queued request (admission order) — the replica-drain
        path re-dispatches them across sibling replicas. Parked requests
        are popped through the usual ``pop_parked`` so the engine can
        clean their resume state alongside."""
        out = list(self._queue)
        self._queue.clear()
        return out

    # -- the parked (preemption) queue ------------------------------------

    def park(self, request: Request) -> None:
        """Queue a PREEMPTED request for re-admission, FIFO among parked
        (the earliest victim resumes first) and ahead of every fresh
        admission."""
        self._parked.append(request)

    def peek_parked(self) -> Optional[Request]:
        return self._parked[0] if self._parked else None

    def pop_parked(self) -> Request:
        return self._parked.popleft()

    def submit(self, request: Request) -> None:
        if len(self._queue) >= self.max_queue:
            raise QueueFull(
                f"admission queue at capacity ({self.max_queue}); "
                f"request {request.request_id} rejected"
            )
        self._queue.append(request)

    def cancel(self, request_id: int) -> bool:
        """Remove a QUEUED or PARKED request (running ones finish on their
        own; slots are cheap, mid-flight surgery is not). False when in
        neither queue — so a later ``expire`` can never double-report a
        cancelled request. The engine cleans up a parked request's resume
        state (swap record) on top of this."""
        for q in (self._queue, self._parked):
            for r in q:
                if r.request_id == request_id:
                    q.remove(r)
                    return True
        return False

    def expire(self, tick: int) -> List[Request]:
        """Drop queued AND parked requests whose deadline has passed.
        Returns them. A preempted request is back to WAITING — its
        deadline means the same thing it meant in the fresh queue, and
        exempting it would let a governed pool hold expired work forever
        (the engine cleans a parked expiry's resume state on top)."""
        expired = [
            r for q in (self._queue, self._parked) for r in q
            if r.deadline_tick is not None and tick > r.deadline_tick
        ]
        if expired:
            dead = set(id(r) for r in expired)
            self._queue = deque(r for r in self._queue if id(r) not in dead)
            self._parked = deque(r for r in self._parked
                                 if id(r) not in dead)
        return expired

    def admit(self, free_slots: int, tick: int,
              fits: Optional[Callable[[Request], bool]] = None
              ) -> List[Request]:
        """FIFO-pop up to ``free_slots`` requests (policy permitting).

        ``fits`` (optional) is a per-request resource gate — the paged
        engine passes a block-reservation check. Admission stops at the
        FIRST request that doesn't fit (strict FIFO: no reordering around
        a starved head) and records a ``no_free_blocks`` stall.
        """
        if free_slots <= 0 or not self._queue:
            return []
        if tick % self.prefill_interval != 0:
            return []
        n = free_slots
        if self.max_prefill_per_tick is not None:
            n = min(n, self.max_prefill_per_tick)
        admitted = []
        while self._queue and len(admitted) < n:
            if fits is not None and not fits(self._queue[0]):
                self.record_stall("no_free_blocks")
                break
            admitted.append(self._queue.popleft())
        return admitted
