"""SIGTERM/preemption handling: stop training cleanly, land one last checkpoint.

The port of ``gradaccum_tpu/resilience/preemption.py``. A shared card's
scheduler preempts a job with SIGTERM and a grace window. An installed
:class:`PreemptionHandler` turns that signal into a flag the Estimator's
train loop polls once per step: on the next step boundary the loop breaks,
the normal final-save path writes a checkpoint, and the
:class:`~gradaccum_tpu_torch.estimator.checkpoint.AsyncCheckpointer` drains
— so the resumed job restarts from the exact step it was stopped at,
bitwise.

``signal.signal`` only works on the main thread, so ``install()`` must run
there. Handlers CHAIN: installing keeps the previously-registered handler
and forwards every signal to it; ``uninstall()`` restores it — and when
some later code registered its own handler on top of ours, uninstall
leaves the registration in place (restoring would clobber the newer
handler) and simply deactivates this handler's observation while still
forwarding along the chain. The module-level :func:`requested` is what the
training loop polls — a cheap list check when no handler is installed.

**Multi-process drain consensus** (:class:`DrainConsensus`): ``requested()``
is a per-process flag, but one rank's SIGTERM may arrive a step earlier
than another's, and ranks that checkpoint different steps could never
agree on where to resume. ``DrainConsensus.decide(requested, step)`` turns
the local flag into an agreement over the ``torch.distributed`` c10d store
(the one ``init_process_group`` creates; JAX uses its coordination
service's key-value store): every rank learns (a) someone was preempted and
(b) one common target step, the max of the ranks' steps, so every rank
lands the SAME final checkpoint. The in-process transport
(:class:`LocalDrainBus`) gives N simulated hosts in one process the
identical protocol.
"""

from __future__ import annotations

import signal
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_HANDLERS: List["PreemptionHandler"] = []


def requested() -> bool:
    """True once any installed handler has seen its signal."""
    return bool(_HANDLERS) and any(h.triggered for h in _HANDLERS)


def acknowledge() -> None:
    """Reset every triggered handler. The train loop calls this the moment
    it honors a request (it then drains and checkpoints), so a later
    ``train()`` in a process that survived the signal starts fresh instead
    of no-opping at its first step forever. A platform that truly wants
    the process gone re-signals (and ultimately SIGKILLs) anyway."""
    for handler in _HANDLERS:
        handler.reset()


class PreemptionHandler:
    """Installable SIGTERM (by default) listener; context-manager friendly.

    ``with PreemptionHandler().install():`` — or call ``install()`` /
    ``uninstall()`` explicitly. ``trigger()`` sets the flag without a real
    signal (deterministic tests, cooperative shutdown).
    """

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,)):
        self.signals = tuple(signals)
        self._event = threading.Event()
        # sig -> the closure registered with signal.signal for the CURRENT
        # installation. Each registration is its own closure owning its own
        # ``prev`` (captured at install time): a re-install after an
        # out-of-order uninstall creates a FRESH closure chaining to the
        # then-current handler, while the orphaned old closure keeps its
        # original prev — per-instance mutable state here would let the two
        # alias each other into a forwarding cycle.
        self._registered: Dict[int, object] = {}
        self._installed = False

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def trigger(self) -> None:
        self._event.set()

    def reset(self) -> None:
        self._event.clear()

    def _make_handler(self):
        event = self._event

        def handler(signum, frame):
            if handler.active:
                event.set()
            if callable(handler.prev):
                handler.prev(signum, frame)  # chain: observe, don't swallow

        handler.active = True
        handler.prev = None
        return handler

    def install(self) -> "PreemptionHandler":
        if self._installed:
            return self
        for sig in self.signals:
            fn = self._make_handler()
            fn.prev = signal.signal(sig, fn)
            self._registered[sig] = fn
        self._installed = True
        _HANDLERS.append(self)
        return self

    def uninstall(self) -> None:
        """Restore the previously-registered handler — but NEVER clobber a
        handler someone installed on top of this one: if the current
        registration is not ours, the newer handler chains *through* our
        closure, so the registration stays and this handler merely stops
        observing (``active`` gates the event; forwarding to the closure's
        own ``prev`` keeps working, so the chain stays intact)."""
        if not self._installed:
            return
        for sig, fn in self._registered.items():
            fn.active = False
            if signal.getsignal(sig) is fn:
                signal.signal(sig, fn.prev)
        self._registered.clear()
        self._installed = False
        if self in _HANDLERS:
            _HANDLERS.remove(self)

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


# -- multi-host drain consensus ----------------------------------------------


class LocalDrainBus:
    """In-process consensus transport for SIMULATED hosts.

    ``num_hosts`` participants (threads) rendezvous per round: each submits
    ``(requested, step)``, the round resolves to ``(any requested, max
    step)``, and every participant receives the identical result — the
    same semantics as the store transport of :class:`DrainConsensus`,
    minus the processes. The tests' multi-host drain runs on it.

    **Host liveness leases** (``lease_ttl``): every host renews a
    per-host lease key via :meth:`renew` (the serving loop / train loop
    heartbeat). While a round waits for stragglers, the bus distinguishes
    *slow* from *gone*: a missing host whose lease was renewed within
    ``lease_ttl`` is slow — keep waiting — while one whose lease EXPIRED
    (it was alive once and stopped renewing; a never-renewed host is
    merely unknown, maybe late to start, and never shortcuts the
    barrier) is gone, and once every missing host is provably gone the
    round resolves with the survivors' submissions immediately instead
    of waiting out the full barrier ``timeout``. A partially-resolved
    round counts in ``partial_rounds`` and names the absent hosts in
    :meth:`last_partial`. Without ``lease_ttl`` the behavior is exactly
    the old all-or-timeout barrier. ``clock`` is injectable so the
    slow-vs-gone gate is deterministic in tests.

    Partial resolution is for hosts that have terminally departed. A
    declared-gone host that nonetheless returns rejoins at the CURRENT
    round (its submission pairs with the survivors' next decision), so
    one decision may be skewed; callers latch the first positive
    decision (the train loop does) and drain/reconfig decisions are
    any-requested/max-value, which makes the skew benign — pick
    ``lease_ttl`` well above worst-case pauses so a live host is never
    declared gone in the first place.
    """

    def __init__(self, num_hosts: int, timeout: float = 60.0,
                 lease_ttl: Optional[float] = None, clock=None):
        if num_hosts < 1:
            raise ValueError(f"num_hosts must be >= 1, got {num_hosts}")
        if lease_ttl is not None and lease_ttl <= 0:
            raise ValueError(f"lease_ttl must be > 0, got {lease_ttl}")
        self.num_hosts = num_hosts
        self.timeout = timeout
        self.lease_ttl = lease_ttl
        import time as _time

        self.clock = clock if clock is not None else _time.monotonic
        self._cond = threading.Condition()
        self._round = 0
        self._submitted: Dict[int, Tuple[bool, int]] = {}
        self._results: Dict[int, Tuple[bool, int]] = {}
        self._leases: Dict[int, float] = {}
        self.partial_rounds = 0     # rounds resolved without every host
        self._last_partial: Tuple[int, ...] = ()

    # -- liveness leases ---------------------------------------------------

    def renew(self, host_id: int, now: Optional[float] = None) -> None:
        """Renew ``host_id``'s liveness lease (one cheap write per
        heartbeat; hosts renew far more often than they exchange)."""
        t = self.clock() if now is None else float(now)
        with self._cond:
            self._leases[int(host_id)] = t
            self._cond.notify_all()

    def lease_status(self, host_id: int,
                     now: Optional[float] = None) -> str:
        """``"live"`` (renewed within ``lease_ttl``), ``"expired"``, or
        ``"unknown"`` (never renewed). Only EXPIRED counts as gone for
        the partial resolve — an unknown host may not have started yet,
        and only proven departure may shortcut the barrier."""
        if self.lease_ttl is None:
            return "unknown"
        t = self.clock() if now is None else float(now)
        with self._cond:
            at = self._leases.get(int(host_id))
        if at is None:
            return "unknown"
        return "live" if t - at <= self.lease_ttl else "expired"

    def last_partial(self) -> Tuple[int, ...]:
        """Host ids absent from the most recent partially-resolved round
        (empty when every round so far was full)."""
        with self._cond:
            return self._last_partial

    def _gone(self, host_id: int) -> bool:
        """Gone needs PROOF of departure: the host was alive (renewed at
        least once) and then let its lease expire. A never-renewed host
        may simply not have started yet — declaring it gone would
        partial-resolve a round a healthy-but-late host then submits
        into one generation behind, permanently skewing the barrier. It
        degrades to the plain timeout path instead."""
        if self.lease_ttl is None:
            return False
        at = self._leases.get(int(host_id))
        return at is not None and self.clock() - at > self.lease_ttl

    def _resolve_locked(self, this_round: int, partial: bool) -> None:
        reqs = [r for r, _ in self._submitted.values()]
        steps = [s for _, s in self._submitted.values()]
        self._results[this_round] = (any(reqs), max(steps))
        if partial:
            self.partial_rounds += 1
            self._last_partial = tuple(sorted(
                h for h in range(self.num_hosts)
                if h not in self._submitted
            ))
        # keep only a short tail so a long run cannot grow the map
        for old in [r for r in self._results if r < this_round - 1]:
            del self._results[old]
        self._submitted = {}
        self._round += 1
        self._cond.notify_all()

    def exchange(self, host_id: int, requested: bool, step: int
                 ) -> Tuple[bool, int]:
        import time

        # arriving at the barrier is itself proof of life
        if self.lease_ttl is not None:
            self.renew(host_id)
        with self._cond:
            if host_id in self._submitted:
                raise RuntimeError(
                    f"host {host_id} submitted twice in round {self._round} "
                    "— every host must call exchange() exactly once per round"
                )
            this_round = self._round
            self._submitted[host_id] = (bool(requested), int(step))
            if len(self._submitted) == self.num_hosts:
                self._resolve_locked(this_round, partial=False)
            else:
                # bounded wait: a peer that died (crashed step_fn, shorter
                # stream) must not hang the survivors — DrainConsensus
                # treats the timeout like any transport failure and drains
                # locally. With leases armed the wait is sliced so the
                # slow-vs-gone check runs between slices: every missing
                # host provably gone -> resolve with the survivors NOW.
                deadline = time.monotonic() + self.timeout
                slice_s = (self.timeout if self.lease_ttl is None
                           else min(self.timeout, max(self.lease_ttl / 4,
                                                      1e-3)))
                while this_round not in self._results:
                    if (self.lease_ttl is not None
                            and this_round == self._round
                            and self._submitted
                            and all(self._gone(h)
                                    for h in range(self.num_hosts)
                                    if h not in self._submitted)):
                        self._resolve_locked(this_round, partial=True)
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"LocalDrainBus round {this_round}: only "
                            f"{len(self._submitted)}/{self.num_hosts} hosts "
                            f"arrived within {self.timeout}s"
                        )
                    self._cond.wait(min(remaining, slice_s))
            return self._results[this_round]


class DrainConsensus:
    """Cross-host agreement on (drain?, common target step).

    ``decide(requested, step)`` is a COLLECTIVE on the multiprocess path:
    every host must call it at the same cadence (the Estimator polls once
    per loop iteration and latches the first positive decision, so no host
    keeps calling after another stopped). The decision is ``(any host
    requested, max of the hosts' steps)`` — synchronous data-parallel
    training keeps the hosts in lockstep, and max handles any skew by
    letting stragglers catch up to the agreed step before checkpointing.

    Transport: the ``torch.distributed`` c10d store plus a barrier —
    CONTROL-plane, deliberately not a collective on the card. A preemption
    notice must go through even when the data plane is the problem, and it
    works on every backend (gloo on the CPU included). Each round every
    host ``set``s ``requested:step`` under ``{prefix}/{round}/{host}``;
    the store has no barrier, so a ``wait`` on all N keys of the round,
    bounded by ``timeout_ms``, is the round's barrier; then every host
    ``get``s all entries and computes the identical decision, and deletes
    the previous round's keys (best effort). If the transport fails (the
    store gone, a peer dead past the barrier timeout), the host drains
    LOCALLY at its own step — landing a checkpoint beats hanging in a
    grace window.

    ``interval`` throttles the real exchange to every Nth call (all hosts
    count calls in lockstep, so they throttle identically); between
    exchanges ``decide`` returns ``(False, step)``.

    ``multiprocess=None`` auto-detects a default process group of more
    than one rank (its store, rank and world size are used). ``store=``
    with ``host_id=`` and ``num_hosts=`` takes an explicit store client
    instead. With ``multiprocess=False`` the decision goes through a
    :class:`LocalDrainBus` when one is given (N simulated hosts in one
    process), or degenerates to the local flag (a single host IS the
    cluster). ``request()`` marks THIS participant preempted without a real
    signal — deterministic tests, cooperative shutdown; the SIGTERM path
    arrives through the ``requested`` argument instead.

    **Per-host liveness leases** (``lease_ttl``): :meth:`renew_lease`
    publishes a per-HOST heartbeat on the consensus transport (the bus's
    lease map, or the ``{prefix}/lease/{host}`` key of the store) — the
    train loop may renew it every iteration, far more often than it
    exchanges. Survivors then distinguish *slow* (lease renewed late →
    keep waiting) from *gone* (lease expired → proceed without waiting out
    the barrier timeout): the bus transport resolves a round with the
    survivors the moment every missing host is provably gone, and
    :meth:`peer_liveness` gives the store transport's view.
    """

    def __init__(
        self,
        multiprocess: Optional[bool] = None,
        bus: Optional[LocalDrainBus] = None,
        host_id: Optional[int] = None,
        interval: int = 1,
        timeout_ms: int = 60_000,
        key_prefix: str = "gradaccum/drain",
        lease_ttl: Optional[float] = None,
        store=None,
        num_hosts: Optional[int] = None,
    ):
        if store is not None:
            # an explicit c10d store client: this participant is host_id of
            # num_hosts (tests run N threads, each with its own client)
            if host_id is None or num_hosts is None:
                raise ValueError("store= needs host_id= and num_hosts=")
            if multiprocess is False:
                raise ValueError("store= is the multi-process transport")
            multiprocess = True
        if multiprocess is None:
            multiprocess = _dist_world() > 1
        if multiprocess and bus is not None:
            raise ValueError("bus is the in-process fallback transport; it "
                             "cannot combine with multiprocess=True")
        if interval < 1:
            raise ValueError(f"interval must be >= 1, got {interval}")
        if lease_ttl is not None and lease_ttl <= 0:
            raise ValueError(f"lease_ttl must be > 0, got {lease_ttl}")
        self.multiprocess = bool(multiprocess)
        self.bus = bus
        self._store = store
        if self.multiprocess and store is None:
            import torch.distributed as dist

            host_id = dist.get_rank() if host_id is None else host_id
            num_hosts = dist.get_world_size()
        self.host_id = 0 if host_id is None else int(host_id)
        self.num_hosts = num_hosts
        self.interval = interval
        self.timeout_ms = timeout_ms
        self.key_prefix = key_prefix
        self.lease_ttl = lease_ttl
        if bus is not None and lease_ttl is not None \
                and bus.lease_ttl is None:
            # arm the bus's slow-vs-gone gate from this side too, so one
            # constructor knob covers the simulated-host transport
            bus.lease_ttl = lease_ttl
        self._local_request = False
        self._calls = 0
        self._round = 0

    def request(self) -> None:
        """Mark this host preempted (OR'd with the flag passed to decide)."""
        self._local_request = True

    # -- per-host liveness leases -----------------------------------------

    def renew_lease(self, now: Optional[float] = None) -> None:
        """Publish this HOST's liveness heartbeat on the consensus
        transport. Cheap (one KV write / one dict store) — call it every
        loop iteration; a host that stops renewing past ``lease_ttl`` is
        *gone* to its peers, not merely slow. No-op without a transport
        or without ``lease_ttl``."""
        if self.lease_ttl is None:
            return
        if self.bus is not None:
            self.bus.renew(self.host_id, now=now)
            return
        if not self.multiprocess:
            return
        import time

        try:
            self._client().set(
                f"{self.key_prefix}/lease/{self.host_id}",
                repr(time.time() if now is None else float(now)))
        except Exception:  # noqa: BLE001 — a lost lease write is survivable
            pass

    def peer_liveness(self, now: Optional[float] = None) -> Dict[int, str]:
        """Every peer's lease verdict: ``"live"`` / ``"expired"`` /
        ``"unknown"`` (never renewed). The bus transport reads its lease
        map; the KV transport reads the ``lease/`` keys (wall-clock
        timestamps — cluster hosts are NTP-close, and the TTL is seconds,
        not milliseconds). Empty without ``lease_ttl``."""
        if self.lease_ttl is None:
            return {}
        if self.bus is not None:
            return {h: self.bus.lease_status(h, now=now)
                    for h in range(self.bus.num_hosts)}
        if not self.multiprocess:
            return {self.host_id: "live"}
        import time

        t = time.time() if now is None else float(now)
        out: Dict[int, str] = {}
        try:
            client = self._client()
            for p in range(self.num_hosts):
                key = f"{self.key_prefix}/lease/{p}"
                if not client.check([key]):
                    out[p] = "unknown"
                    continue
                try:
                    raw = client.get(key).decode()
                    out[p] = ("live" if t - float(raw) <= self.lease_ttl
                              else "expired")
                except (TypeError, ValueError):
                    out[p] = "unknown"
        except Exception:  # noqa: BLE001 — transport down: nothing to read
            return {}
        return out

    def decide(self, requested: bool, step: int) -> Tuple[bool, int]:
        req = bool(requested) or self._local_request
        self._calls += 1
        if not self.multiprocess and self.bus is None:
            return req, int(step)  # a single host IS the cluster
        if (self._calls - 1) % self.interval:
            return False, int(step)
        try:
            if self.bus is not None:
                drain, target = self.bus.exchange(self.host_id, req,
                                                  int(step))
            else:
                drain, target = self._kv_exchange(req, int(step))
            if drain:
                # the drain VOTE lands on the obs timeline: which host saw
                # the signal, what it voted, what the cluster agreed to
                from gradaccum_tpu_torch.obs import trace as obs_trace

                tr = obs_trace.get_tracer()
                if tr.enabled:
                    tr.event("drain/vote", cat="resilience",
                             host=self.host_id, requested=req,
                             step=int(step), target=int(target))
            return drain, target
        except Exception as e:  # noqa: BLE001 — any transport failure
            # a dead peer / lost coordinator must not strand this host in
            # its grace window: landing a local checkpoint beats hanging
            print(f"[preemption] drain consensus transport failed ({e}); "
                  f"draining locally at step={step}"
                  if req else
                  f"[preemption] drain consensus transport failed ({e}); "
                  f"continuing without consensus")
            return (req, int(step))

    # -- c10d store transport -------------------------------------------

    def _client(self):
        """The c10d store: the explicit client, else the default process
        group's (the store ``init_process_group`` created)."""
        if self._store is not None:
            return self._store
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError(
                "torch.distributed is not initialized — call "
                "parallel.mesh.initialize_multihost() first, pass store=, "
                "or use multiprocess=False")
        from torch.distributed import distributed_c10d

        return distributed_c10d._get_default_store()

    def _kv_exchange(self, req: bool, step: int) -> Tuple[bool, int]:
        import datetime

        client = self._client()
        r = self._round
        self._round += 1
        pid, nproc = self.host_id, self.num_hosts
        keys = [f"{self.key_prefix}/{r}/{p}" for p in range(nproc)]
        client.set(keys[pid], f"{int(req)}:{step}")
        # the store has no barrier: waiting for every host's key of this
        # round is the round's barrier
        client.wait(keys, datetime.timedelta(milliseconds=self.timeout_ms))
        any_req, target = False, step
        for key in keys:
            flag, peer_step = client.get(key).decode().split(":")
            any_req = any_req or flag == "1"
            target = max(target, int(peer_step))
        # best-effort cleanup of the previous round's keys: every host has
        # written this round's key, so none still reads the last round's
        if r > 0:
            try:
                for p in range(nproc):
                    client.delete_key(f"{self.key_prefix}/{r - 1}/{p}")
            except Exception:  # noqa: BLE001 — cleanup only
                pass
        return any_req, target


def _dist_world() -> int:
    """The default process group's world size, 1 without one."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
