"""Admission control: quantile-optimistic admission and the victim policy.

The port of ``gradaccum_tpu/serving/admission.py``, numpy and host logic
copied with their semantics (the same budgets, governor state, victim costs
and tie-breaks as JAX's on the same pool state).

Reservation-gated admission (the paged pool's original contract) makes
mid-stream exhaustion impossible but caps concurrency at the worst case:
every request reserves ``ceil((prompt + max_new_tokens) / page_size)``
blocks, and real traffic finishes near its p50. This module admits beyond
the worst case and preempts when the pool really runs dry:

- :class:`LengthQuantileEstimator`: a windowed estimate of how many tokens
  completed requests generated (a ring of samples and numpy's linear
  quantile, so seeded runs admit identically);
- :class:`AdmissionPolicy`: ``reserve`` (the worst case), ``quantile``
  (``prompt + Q_q(generated)``, the worst case until warmed up) or
  ``optimistic`` (the prompt and one decode page), with a thrash governor:
  ``storm_preempts`` preemptions within ``storm_window`` ticks hold budgets
  at the worst case for ``cooldown`` ticks;
- :func:`pick_victim`: the cheapest slot to preempt on ``PoolPressure``.
  Blocks shared with other slots or live in the prefix cache make a slot
  expensive; a slot with nothing reclaimable is never a victim.
  :func:`deadline_victim_cost` adds progress and queue-wait terms
  (``Engine(victim_score="deadline")``).
"""

from __future__ import annotations

from collections import deque
from typing import Deque, List, Optional, Sequence

import numpy as np

MODES = ("reserve", "quantile", "optimistic")


class LengthQuantileEstimator:
    """Windowed online quantile of completed-request GENERATED lengths.

    ``window`` bounds the sample ring (old traffic ages out, so a shifted
    workload re-trains the estimate); ``min_samples`` is the warmup floor
    — below it :meth:`quantile` returns None and the policy falls back to
    worst case, so a cold engine never overcommits on zero evidence.
    """

    def __init__(self, window: int = 256, min_samples: int = 16):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if min_samples < 1:
            raise ValueError(f"min_samples must be >= 1, got {min_samples}")
        self.window = int(window)
        self.min_samples = int(min_samples)
        self._xs: Deque[int] = deque(maxlen=self.window)
        self.n_observed = 0  # lifetime count (the ring forgets, this doesn't)

    def observe(self, generated: int) -> None:
        self._xs.append(int(generated))
        self.n_observed += 1

    def __len__(self) -> int:
        return len(self._xs)

    def quantile(self, q: float) -> Optional[int]:
        """Ceil'd linear-interpolation quantile of the window (None until
        ``min_samples`` finishes have been observed)."""
        if len(self._xs) < self.min_samples:
            return None
        a = np.fromiter(self._xs, np.float64, len(self._xs))
        return int(np.ceil(np.quantile(a, min(max(float(q), 0.0), 1.0))))


class AdmissionPolicy:
    """The admission budget rule + thrash governor.

    ``mode``:

    - ``"reserve"`` — worst case (``prompt + max_new_tokens``), the
      original never-overcommits gate;
    - ``"quantile"`` — ``prompt + clamp(Q_q(generated), 1, max_new)``;
    - ``"optimistic"`` — ``prompt + page_size`` (one decode page to get
      the first tokens out; everything else on demand).

    ``q`` is the quantile for ``"quantile"`` mode. The governor knobs:
    ``storm_preempts`` preemptions inside ``storm_window`` ticks trigger a
    ``cooldown``-tick fallback to worst-case budgets (:meth:`governed`
    reports the state; operators see it via ``ServingServer.stats()``).

    Everything is tick-clocked and deterministic — the policy is safe to
    run under the seeded :class:`~gradaccum_tpu_torch.serving.server.
    SimulationDriver` (byte-identical admission decisions across runs).
    """

    def __init__(
        self,
        mode: str = "quantile",
        q: float = 0.85,
        window: int = 256,
        min_samples: int = 16,
        storm_window: int = 64,
        storm_preempts: int = 4,
        cooldown: int = 128,
    ):
        if mode not in MODES:
            raise ValueError(f"unknown admission mode {mode!r}; one of {MODES}")
        if not 0.0 < q <= 1.0:
            raise ValueError(f"q must be in (0, 1], got {q}")
        self.mode = mode
        self.q = float(q)
        self.estimator = LengthQuantileEstimator(window=window,
                                                 min_samples=min_samples)
        self.storm_window = int(storm_window)
        self.storm_preempts = int(storm_preempts)
        self.cooldown = int(cooldown)
        self._preempt_ticks: Deque[int] = deque()
        self._governed_until: Optional[int] = None
        self.preemptions = 0  # lifetime count

    # -- feedback ----------------------------------------------------------

    def observe_finish(self, generated: int) -> None:
        """A request completed (eos/length) having generated this many
        tokens — the estimator's only food. Timeouts/cancels don't feed
        it: they say nothing about how long generations RUN."""
        self.estimator.observe(generated)

    def note_preemption(self, tick: int) -> None:
        """One preemption happened at ``tick``; a storm of them arms the
        governor (worst-case budgets for ``cooldown`` ticks)."""
        self.preemptions += 1
        t = int(tick)
        self._preempt_ticks.append(t)
        cutoff = t - self.storm_window
        while self._preempt_ticks and self._preempt_ticks[0] <= cutoff:
            self._preempt_ticks.popleft()
        if len(self._preempt_ticks) >= self.storm_preempts:
            self._governed_until = t + self.cooldown

    def governed(self, tick: int) -> bool:
        """True while the thrash governor holds budgets at worst case."""
        return (self._governed_until is not None
                and int(tick) < self._governed_until)

    def pin(self, tick: int, ticks: Optional[int] = None) -> None:
        """Arm the thrash governor DIRECTLY for ``ticks`` (default: the
        policy's own ``cooldown``) — the self-healing ladder's cheapest
        preemption-storm rung: stop admitting optimistically now, without
        waiting for the storm counter to cross its threshold. Extends an
        already-armed governor, never shortens it."""
        until = int(tick) + int(self.cooldown if ticks is None else ticks)
        if self._governed_until is None or until > self._governed_until:
            self._governed_until = until

    # -- the budget rule ---------------------------------------------------

    def budget_tokens(self, prompt_len: int, max_new_tokens: int,
                      page_size: int, tick: int) -> int:
        """Tokens to RESERVE for a request at admission (the write limit
        stays ``prompt + max_new_tokens`` regardless — the budget bounds
        admission optimism, never what a request may write)."""
        worst = int(prompt_len) + int(max_new_tokens)
        if self.mode == "reserve" or self.governed(tick):
            return worst
        if self.mode == "optimistic":
            return min(int(prompt_len) + int(page_size), worst)
        est = self.estimator.quantile(self.q)
        if est is None:
            return worst  # cold start: no evidence, no optimism
        return min(int(prompt_len) + max(est, 1), worst)

    def status(self) -> dict:
        """Operator view (``ServingServer.stats()`` / telemetry)."""
        return {
            "mode": self.mode,
            "q": self.q if self.mode == "quantile" else None,
            "samples": len(self.estimator),
            "quantile_estimate": self.estimator.quantile(self.q),
            "preemptions": self.preemptions,
            "governed_until": self._governed_until,
        }


def resolve_policy(admission) -> Optional[AdmissionPolicy]:
    """Engine-knob coercion: None -> None (legacy reserve gate untouched),
    a mode string -> a stock policy, a policy instance -> itself."""
    if admission is None:
        return None
    if isinstance(admission, AdmissionPolicy):
        return admission
    if isinstance(admission, str):
        return AdmissionPolicy(mode=admission)
    raise TypeError(
        f"admission must be None, one of {MODES}, or an AdmissionPolicy; "
        f"got {type(admission).__name__}"
    )


# -- victim selection -------------------------------------------------------


def victim_cost(pool, slot: int, prefix_cache) -> tuple:
    """Preemption cost of evicting ``slot``, lower = cheaper. Primary term:
    blocks this slot ALLOCATED that other slots share (freed by preempting
    NO single sharer, and this slot is what keeps them reservation-covered)
    plus blocks live in the prefix cache (tomorrow's prefill savings —
    evicting their holder un-pins a hot prefix). Blocks the slot merely
    ADOPTED (refcount > 1, owned elsewhere — full prefix pages and COW
    tails alike) cost nothing extra: dropping an adopted reference frees
    no memory but harms no one either, and a prefix-aware resume simply
    re-adopts them — cheap for the holder, priced only through the hot
    term for everyone still sharing. Secondary: prefer the victim that
    returns the MOST private blocks, so one preemption resolves the
    pressure. Ties break on slot index for determinism."""
    shared = hot = freeable = 0
    for b in pool.blocks_of(slot):
        refs = pool.refcount(b)
        if refs > 1:
            if pool.owner_of(b) == slot:
                shared += 1
        else:
            freeable += 1
        if prefix_cache is not None and prefix_cache.is_live(b):
            hot += 1
    return (2 * shared + hot, -freeable, slot)


def deadline_victim_cost(pool, slot: int, prefix_cache, *,
                         progress: float, waited: int) -> tuple:
    """The deadline/SLO-aware scorer behind ``Engine(victim_score=
    "deadline")``: the stock refcount/prefix-liveness primary term, then
    PROGRESS (``generated / max_new`` — a request about to finish frees
    its blocks on its own in a moment, and evicting it wastes the most
    completed work) and QUEUE-WAIT (a request that already waited long —
    or was already preempted once — should not be the default victim
    again), then the stock most-freeable tiebreak. All terms are small
    deterministic ints, so seeded simulations pick identical victims
    across runs."""
    base = victim_cost(pool, slot, prefix_cache)
    progress_term = int(round(8 * min(max(float(progress), 0.0), 1.0)))
    wait_term = min(int(waited) // 8, 8)
    return (base[0], progress_term + wait_term) + base[1:]


def pick_victim(pool, candidates: Sequence[int], prefix_cache,
                exclude: Optional[int] = None,
                score=None) -> Optional[int]:
    """Cheapest victim among ``candidates`` (active slots), or None when
    no candidate would actually free a block (a victim whose every page is
    shared frees nothing — evicting it is pure loss). ``score`` swaps the
    cost function (``score(slot) -> tuple``, e.g. the engine's
    deadline-aware closure); the nothing-reclaimable skip is enforced
    HERE, independent of the scorer, so no scoring policy can pick a
    victim whose eviction frees no memory."""
    best: Optional[int] = None
    best_cost: Optional[tuple] = None
    for slot in candidates:
        slot = int(slot)
        if slot == exclude:
            continue
        if not any(pool.refcount(b) == 1 for b in pool.blocks_of(slot)):
            continue  # nothing reclaimable: eviction is pure loss
        cost = (victim_cost(pool, slot, prefix_cache) if score is None
                else tuple(score(slot)))
        if best_cost is None or (cost, slot) < (best_cost, best):
            best, best_cost = slot, cost
    return best
