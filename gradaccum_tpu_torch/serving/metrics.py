"""Serving telemetry: TTFT, per-token latency, throughput, occupancy.

The port of ``gradaccum_tpu/serving/metrics.py``, whole: the counters of
features still to port (speculation, preemption, swap, reconfiguration,
tiers) come along because the module is host-only; nothing records them
until their items land.

All host-side and allocation-free on the decode path — the engine calls in
with plain ints/floats it already has. The clock is injectable so the
deterministic simulation driver can run on the LOGICAL tick clock (results
reproducible bit-for-bit) while the threaded server uses wall time.

Scalars route through one :class:`~gradaccum_tpu.obs.metrics.
MetricsRegistry` (pass your own, or one is built internally), which still
streams to the same :class:`~gradaccum_tpu.estimator.events.EventWriter`
the training loop uses (``model_dir/serving``) — so one ``tensorboard
--logdir`` shows the training curves next to queue depth / occupancy /
tokens-per-second, while ``registry.snapshot()`` /
``registry.to_prometheus()`` expose the same numbers to crash dumps and
scrapers.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from gradaccum_tpu_torch.estimator.events import EventWriter
from gradaccum_tpu_torch.obs.metrics import MetricsRegistry
from gradaccum_tpu_torch.utils.timing import LatencySeries


class ServingMetrics:
    """Aggregates per-request latencies and per-tick engine gauges."""

    def __init__(
        self,
        event_writer: Optional[EventWriter] = None,
        subdir: str = "serving",
        clock: Callable[[], float] = time.monotonic,
        registry: Optional[MetricsRegistry] = None,
        replica_id: Optional[int] = None,
        latency_window: Optional[int] = None,
    ):
        self.clock = clock
        # latency_window bounds the latency series (ttft / token gap /
        # queue wait) to the most recent N samples, so SLO evaluation
        # reads a CURRENT p99 instead of cumulative-since-boot; None (the
        # default) keeps every sample exactly as before
        self.latency_window = latency_window
        # replica_id puts a REPLICA DIMENSION on the existing instruments
        # (same gauge/counter names, labeled {replica="N"}) instead of
        # minting per-replica scalar names — so a ReplicatedEngine fleet
        # can share ONE registry and one Prometheus endpoint shows every
        # replica side by side. None leaves every name exactly as before.
        self.replica_id = None if replica_id is None else int(replica_id)
        self._labels = (None if self.replica_id is None
                        else {"replica": str(self.replica_id)})
        self.registry = registry if registry is not None else \
            MetricsRegistry(event_writer=event_writer, subdir=subdir)
        self.ttft = LatencySeries(window=latency_window)  # submit -> 1st tok
        self.token_latency = LatencySeries(window=latency_window)  # gap/req
        self.queue_wait = LatencySeries(window=latency_window)  # submit->admit
        self.queue_depth = LatencySeries()    # sampled per tick
        self.occupancy = LatencySeries()      # sampled per tick (slots)
        # token-level view, present for BOTH pool kinds so fixed and paged
        # runs land on one dashboard: tokens in flight / pool token
        # capacity, and the bytes the pool actually charges for them (the
        # fixed pool charges a full slot; paged charges allocated pages)
        self.token_occupancy = LatencySeries()   # sampled per tick
        self.kv_bytes_in_use = LatencySeries()   # sampled per tick
        self.tokens_in_flight = LatencySeries()  # sampled per tick
        self._kv_per_token = LatencySeries()     # bytes/token, loaded ticks
        self.block_waterline: Optional[int] = None  # min free blocks seen
        self.decode_block_ticks: Dict[int, int] = {}  # chosen block -> ticks
        # prefill/prefix accounting (cumulative, host ints): what admission
        # actually computed vs what prefix sharing let it skip
        self.prefill_tokens_computed = 0
        self.prefill_tokens_skipped = 0
        self.blocks_saved = 0        # shared-block adoptions (pages not re-stored)
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.shared_blocks = LatencySeries()  # sampled per tick (prefix mode)
        self.shared_blocks_peak: Optional[int] = None
        # copy-on-write tails: sub-page adoptions, the fork bill (real
        # one-block copies vs elided last-reference takeovers), and the
        # prefix-aware-resume bill (tokens a re-prefill resume did NOT
        # recompute because live chunks were re-adopted)
        self.cow_adoptions = 0
        self.cow_tokens_shared = 0
        self.cow_forks = 0
        self.cow_forks_elided = 0
        self.cow_shared_blocks = LatencySeries()  # sampled per tick
        self.cow_shared_blocks_peak: Optional[int] = None
        self.resume_prefill_tokens = 0        # recomputed during resumes
        self.resume_prefill_tokens_saved = 0  # re-adopted instead
        self._submit_t: Dict[int, float] = {}
        self._last_token_t: Dict[int, float] = {}
        self._admitted: set = set()  # rids whose queue wait is recorded
        self.tokens_emitted = 0
        self.ticks = 0
        self.finished: Dict[str, int] = {}  # reason -> count
        self.rejected = 0
        self._t0: Optional[float] = None
        # expose the latency series as registry histograms (shared storage,
        # no double bookkeeping) and keep hot-path counters as bound attrs
        # so record_token stays an attribute load + int add
        reg = self.registry
        for name, series in (
            ("serving/ttft", self.ttft),
            ("serving/token_latency", self.token_latency),
            ("serving/queue_wait", self.queue_wait),
            ("serving/queue_depth_series", self.queue_depth),
            ("serving/occupancy_series", self.occupancy),
        ):
            reg.histogram(name, series=series, labels=self._labels)
        self._c_tokens = reg.counter("serving/tokens_emitted_total",
                                     labels=self._labels)
        self._c_rejected = reg.counter("serving/rejected_total",
                                       labels=self._labels)
        self._c_prefill_computed = reg.counter(
            "serving/prefill_tokens_computed_total", labels=self._labels)
        self._c_prefill_skipped = reg.counter(
            "serving/prefill_tokens_skipped_total", labels=self._labels)
        self._c_cow_adopt = reg.counter("serving/cow_adoptions_total",
                                        labels=self._labels)
        self._c_cow_fork = reg.counter("serving/cow_forks_total",
                                       labels=self._labels)
        self._c_resume_saved = reg.counter(
            "serving/resume_prefill_tokens_saved_total",
            labels=self._labels)
        # speculative decoding: draft proposals vs target acceptances
        # (cumulative counters for /metrics scrapes, a windowed per-tick
        # fraction for the sentinel's degenerate-draft check)
        self.spec_proposed = 0
        self.spec_accepted = 0
        self._c_spec_proposed = reg.counter("serving/spec_proposed_total",
                                            labels=self._labels)
        self._c_spec_accepted = reg.counter("serving/spec_accepted_total",
                                            labels=self._labels)
        self._g_spec_accept = reg.gauge("serving/spec_accept_rate",
                                        labels=self._labels)
        self._spec_window = LatencySeries(window=64)  # per-tick accept frac
        # admission-control plane: preempt -> park -> resume accounting
        # (cumulative host ints + registry counters; the per-tick windowed
        # preemption rate is the sentinel's preemption_storm feed)
        self.preemptions = 0
        self.swap_outs = 0
        self.swap_ins = 0
        self.reprefills = 0
        self.swap_fallbacks = 0  # swap dropped (IO error / sha / dead head)
        self.swap_bytes_out = 0
        self.swap_bytes_in = 0
        self.parked_peak = 0
        self._c_preempt = reg.counter("serving/preemptions_total",
                                      labels=self._labels)
        self._c_swap_out_bytes = reg.counter("serving/swap_bytes_out_total",
                                             labels=self._labels)
        self._c_swap_in_bytes = reg.counter("serving/swap_bytes_in_total",
                                            labels=self._labels)
        self._c_reprefill = reg.counter("serving/resume_reprefills_total",
                                        labels=self._labels)
        self._preempt_window = LatencySeries(window=64)  # preempts/tick
        # live reconfiguration plane: per-kind counters plus the bounded
        # swap store's live footprint (the gauge a preemption storm's
        # host-memory bill shows up on)
        self.reconfigs: Dict[str, int] = {}  # kind -> count
        self.reconfigs_by_initiator: Dict[str, int] = {}  # operator|healer
        self.reconfig_failures = 0           # degraded (ok=False) applies
        self.reconfig_preempted = 0          # slots parked by reconfigs
        self.swap_store_bytes = 0            # last sampled held_bytes
        self._g_swap_store = reg.gauge("serving/swap_store_bytes",
                                       labels=self._labels)
        # memory-ladder plane (memory/tiers.py): last sampled cumulative
        # tier counters plus a windowed per-tick demotion rate — the
        # sentinel's tier_thrash feed (absent for non-tiered engines)
        self.tier_disk_bytes = 0
        self.tier_demotions = 0
        self.tier_promotions = 0
        self._g_tier_disk = reg.gauge("serving/tier_disk_bytes",
                                      labels=self._labels)
        self._tier_window = LatencySeries(window=64)  # demotions/tick

    # -- per-request lifecycle -------------------------------------------

    def record_submit(self, request_id: int) -> None:
        now = self.clock()
        if self._t0 is None:
            self._t0 = now
        self._submit_t[request_id] = now

    def record_reject(self, request_id: int) -> None:
        self.rejected += 1
        self._c_rejected.inc()

    def record_admit(self, request_id: int) -> None:
        """The request left the queue for a slot: its queue wait (submit →
        admission, in clock units) lands in the windowed series the
        queue-wait SLO reads. The engine calls this at the admission POP
        itself — whatever ``Scheduler(prefill_interval)`` phase or
        prefill-overlap mode the tick runs under — so every admitted
        request contributes its full wait exactly once. "Once" is
        enforced HERE: a preempted request re-admits through the same
        dispatch path (and a parked expiry reports through
        record_expired), and neither may add a second, submit-to-resume
        sized sample to the series the queue-wait SLO reads."""
        if request_id in self._admitted:
            return
        if request_id in self._submit_t:
            self._admitted.add(request_id)
            self.queue_wait.add(self.clock() - self._submit_t[request_id])

    def record_expired(self, request_id: int) -> None:
        """A deadline expiry is a TERMINAL queue-wait observation: the
        request waited this long and never got a slot. Without it the
        queue-wait series only sees the (shorter) waits of requests that
        DID get admitted — undercounting waiting exactly when admission is
        starved, e.g. the off-phase ticks of prefill_interval > 1. Same
        observation rule as admission, by construction."""
        self.record_admit(request_id)

    def record_speculation(self, proposed: int, accepted: int) -> None:
        """One speculative cycle's fleet-wide bill: ``proposed`` draft
        tokens offered to the verifier, ``accepted`` of them kept. The
        accept RATE is the knob operators tune k against — visible
        cumulatively on /metrics and windowed via
        :meth:`recent_accept_rate`."""
        self.spec_proposed += int(proposed)
        self.spec_accepted += int(accepted)
        self._c_spec_proposed.inc(int(proposed))
        self._c_spec_accepted.inc(int(accepted))
        if proposed > 0:
            self._spec_window.add(accepted / proposed)
            # the ratio as a first-class gauge too, so a /metrics scrape
            # reads the accept rate without rate() arithmetic
            self._g_spec_accept.set(self.spec_accepted / self.spec_proposed)

    def spec_accept_rate(self) -> Optional[float]:
        """Cumulative draft accept rate (None before any speculation)."""
        if self.spec_proposed == 0:
            return None
        return self.spec_accepted / self.spec_proposed

    def recent_accept_rate(self) -> Optional[float]:
        """Mean accept fraction over the last 64 speculative ticks — what
        the sentinel's degenerate-draft check consumes (a draft can go
        stale mid-run; the cumulative rate would hide it)."""
        return self._spec_window.summary()["mean"]

    def record_preemption(self, swapped: bool, bytes_out: int = 0) -> None:
        """One victim evicted: slot + private blocks reclaimed, request
        parked. ``swapped`` says its K/V went to the host store (vs the
        drop-and-re-prefill path)."""
        self.preemptions += 1
        self._c_preempt.inc()
        if swapped:
            self.swap_outs += 1
            self.swap_bytes_out += int(bytes_out)
            self._c_swap_out_bytes.inc(int(bytes_out))

    def record_resume(self, kind: str, bytes_in: int = 0) -> None:
        """A parked request re-entered a slot: ``kind`` is "swap_in"
        (host bytes scattered back) or "reprefill" (recomputed)."""
        if kind == "swap_in":
            self.swap_ins += 1
            self.swap_bytes_in += int(bytes_in)
            self._c_swap_in_bytes.inc(int(bytes_in))
        else:
            self.reprefills += 1
            self._c_reprefill.inc()

    def record_cow_adopt(self, tokens: int) -> None:
        """One sub-page (copy-on-write) tail adoption: ``tokens`` prompt
        tokens rode an existing partial block instead of being recomputed
        and stored again."""
        self.cow_adoptions += 1
        self.cow_tokens_shared += int(tokens)
        self._c_cow_adopt.inc()

    def record_cow_fork(self, elided: bool = False) -> None:
        """One copy-on-write fork: the first write past a shared tail's
        ``cow_limit`` gave the sharer its private copy (``elided`` = the
        sharer was the last reference and took the block over with no
        copy at all)."""
        self.cow_forks += 1
        if elided:
            self.cow_forks_elided += 1
        self._c_cow_fork.inc()

    def record_resume_prefill(self, computed: int, saved: int) -> None:
        """One prefix-aware re-prefill resume's bill: ``computed`` tokens
        ran through the model again, ``saved`` re-adopted live chunks
        instead (PR-12's resume recomputed everything — this counter is
        the gap it closed)."""
        self.resume_prefill_tokens += int(computed)
        self.resume_prefill_tokens_saved += int(saved)
        self._c_resume_saved.inc(int(saved))

    def record_swap_fallback(self) -> None:
        """A swap record was abandoned (IO error, sha mismatch, capacity
        eviction, or its shared head died) — the request resumes by
        re-prefill instead. Swap is an optimization; this counter is its
        failure bill."""
        self.swap_fallbacks += 1

    def record_reconfig(self, kind: str, ok: bool = True,
                        preempted: int = 0,
                        initiator: str = "operator") -> None:
        """One live reconfiguration applied (or, ``ok=False``, degraded —
        a rejected checkpoint kept the old state serving). Counted per
        kind so /metrics shows resizes next to checkpoint swaps, and per
        ``initiator`` ("operator" vs "healer") so autonomous actions are
        distinguishable from human ones on every dashboard."""
        self.reconfigs[kind] = self.reconfigs.get(kind, 0) + 1
        self.reconfigs_by_initiator[initiator] = \
            self.reconfigs_by_initiator.get(initiator, 0) + 1
        self.reconfig_preempted += int(preempted)
        if not ok:
            self.reconfig_failures += 1
        labels = {"kind": kind, "initiator": initiator,
                  **(self._labels or {})}
        self.registry.counter("serving/reconfigs_total", labels=labels,
                              help="live reconfigurations applied").inc()

    def recent_preemption_rate(self) -> Optional[float]:
        """Mean preemptions/tick over the last 64 ticks — the sentinel's
        ``preemption_storm`` feed (None before any admission-policy
        tick)."""
        return self._preempt_window.summary()["mean"]

    def recent_tier_spill_rate(self) -> Optional[float]:
        """Mean host→disk demotions/tick over the last 64 ticks — the
        sentinel's ``tier_thrash`` feed (None before any tiered-swap
        tick)."""
        return self._tier_window.summary()["mean"]

    def record_token(self, request_id: int, first: bool) -> None:
        now = self.clock()
        if first and request_id in self._submit_t:
            self.ttft.add(now - self._submit_t[request_id])
        elif request_id in self._last_token_t:
            self.token_latency.add(now - self._last_token_t[request_id])
        self._last_token_t[request_id] = now
        self.tokens_emitted += 1
        self._c_tokens.inc()

    def record_finish(self, request_id: int, reason: str) -> None:
        self.finished[reason] = self.finished.get(reason, 0) + 1
        self.registry.counter(f"serving/finished_{reason}_total",
                              labels=self._labels).inc()
        self._submit_t.pop(request_id, None)
        self._last_token_t.pop(request_id, None)
        self._admitted.discard(request_id)

    def record_admission(self, computed_tokens: int, skipped_tokens: int = 0,
                         shared_blocks: int = 0,
                         prefix_hit: Optional[bool] = None) -> None:
        """One admitted request's prefill bill: ``computed_tokens`` ran
        through the model, ``skipped_tokens`` rode on shared prefix blocks
        (``shared_blocks`` of them, adopted instead of re-stored).
        ``prefix_hit`` is None when no prefix cache is configured — the
        hit-rate denominator only counts admissions that COULD have hit."""
        self.prefill_tokens_computed += int(computed_tokens)
        self.prefill_tokens_skipped += int(skipped_tokens)
        self._c_prefill_computed.inc(int(computed_tokens))
        self._c_prefill_skipped.inc(int(skipped_tokens))
        self.blocks_saved += int(shared_blocks)
        if prefix_hit is not None:
            if prefix_hit:
                self.prefix_hits += 1
            else:
                self.prefix_misses += 1

    # -- per-tick gauges --------------------------------------------------

    def record_tick(self, queue_depth: int, active_slots: int,
                    num_slots: int, *,
                    tokens_in_flight: Optional[int] = None,
                    token_capacity: Optional[int] = None,
                    kv_bytes_in_use: Optional[int] = None,
                    free_blocks: Optional[int] = None,
                    decode_block: Optional[int] = None,
                    shared_blocks: Optional[int] = None,
                    cow_shared_blocks: Optional[int] = None,
                    parked: Optional[int] = None,
                    preemptions: Optional[int] = None,
                    swap_store_bytes: Optional[int] = None,
                    tier_disk_bytes: Optional[int] = None,
                    tier_demotions: Optional[int] = None,
                    tier_promotions: Optional[int] = None) -> None:
        self.ticks += 1
        self.queue_depth.add(queue_depth)
        self.occupancy.add(active_slots / num_slots)
        scalars = {
            "serving/queue_depth": float(queue_depth),
            "serving/active_slots": float(active_slots),
            "serving/tokens_emitted": float(self.tokens_emitted),
        }
        if tokens_in_flight is not None:
            self.tokens_in_flight.add(tokens_in_flight)
            scalars["serving/tokens_in_flight"] = float(tokens_in_flight)
            if token_capacity:
                self.token_occupancy.add(tokens_in_flight / token_capacity)
                scalars["serving/token_occupancy"] = (
                    tokens_in_flight / token_capacity
                )
        if kv_bytes_in_use is not None:
            self.kv_bytes_in_use.add(kv_bytes_in_use)
            scalars["serving/kv_bytes_in_use"] = float(kv_bytes_in_use)
            if tokens_in_flight:
                self._kv_per_token.add(kv_bytes_in_use / tokens_in_flight)
        if free_blocks is not None:
            if self.block_waterline is None or free_blocks < self.block_waterline:
                self.block_waterline = free_blocks
            scalars["serving/free_kv_blocks"] = float(free_blocks)
        if decode_block is not None:
            self.decode_block_ticks[decode_block] = (
                self.decode_block_ticks.get(decode_block, 0) + 1
            )
            scalars["serving/decode_block"] = float(decode_block)
        if shared_blocks is not None:
            self.shared_blocks.add(shared_blocks)
            if (self.shared_blocks_peak is None
                    or shared_blocks > self.shared_blocks_peak):
                self.shared_blocks_peak = shared_blocks
            scalars["serving/shared_kv_blocks"] = float(shared_blocks)
        if cow_shared_blocks is not None:
            self.cow_shared_blocks.add(cow_shared_blocks)
            if (self.cow_shared_blocks_peak is None
                    or cow_shared_blocks > self.cow_shared_blocks_peak):
                self.cow_shared_blocks_peak = cow_shared_blocks
            scalars["serving/cow_shared_blocks"] = float(cow_shared_blocks)
        if parked is not None:
            if parked > self.parked_peak:
                self.parked_peak = parked
            scalars["serving/parked_requests"] = float(parked)
        if preemptions is not None:
            # zero ticks count too: the windowed RATE must decay once a
            # storm passes, or the sentinel could never resolve it
            self._preempt_window.add(preemptions)
        if swap_store_bytes is not None:
            self.swap_store_bytes = int(swap_store_bytes)
            self._g_swap_store.set(float(swap_store_bytes))
            scalars["serving/swap_store_bytes"] = float(swap_store_bytes)
        if tier_disk_bytes is not None:
            self.tier_disk_bytes = int(tier_disk_bytes)
            self._g_tier_disk.set(float(tier_disk_bytes))
            scalars["serving/tier_disk_bytes"] = float(tier_disk_bytes)
        if tier_demotions is not None:
            # the engine passes the store's CUMULATIVE counter; the window
            # eats per-tick deltas so the rate decays once a spill storm
            # passes (same resolve contract as the preemption window)
            self._tier_window.add(max(0, int(tier_demotions)
                                      - self.tier_demotions))
            self.tier_demotions = int(tier_demotions)
            scalars["serving/tier_demotions"] = float(tier_demotions)
        if tier_promotions is not None:
            self.tier_promotions = int(tier_promotions)
            scalars["serving/tier_promotions"] = float(tier_promotions)
        # one call: records every scalar as a registry gauge AND streams to
        # the EventWriter when one is attached (replica-labeled in a fleet)
        self.registry.publish(scalars, step=self.ticks, labels=self._labels)

    # -- summary ----------------------------------------------------------

    def tokens_per_second(self) -> Optional[float]:
        if self._t0 is None or self.tokens_emitted == 0:
            return None
        dt = self.clock() - self._t0
        return self.tokens_emitted / dt if dt > 0 else None

    def kv_bytes_per_token_in_flight(self) -> Optional[float]:
        """Mean pool bytes charged per token in flight (over ticks with
        traffic) — THE fixed-vs-paged comparison number (the paged pool's
        reason to exist)."""
        return self._kv_per_token.summary()["mean"]

    def prefix_hit_rate(self) -> Optional[float]:
        """Fraction of prefix-eligible admissions that shared at least one
        block (None until a prefix-cache engine admits something)."""
        n = self.prefix_hits + self.prefix_misses
        return self.prefix_hits / n if n else None

    def summary(self) -> dict:
        return {
            "replica_id": self.replica_id,
            "ttft": self.ttft.summary(),
            "token_latency": self.token_latency.summary(),
            "queue_wait": self.queue_wait.summary(),
            "queue_depth": self.queue_depth.summary(),
            "occupancy": self.occupancy.summary(),
            "token_occupancy": self.token_occupancy.summary(),
            "tokens_in_flight": self.tokens_in_flight.summary(),
            "kv_bytes_in_use": self.kv_bytes_in_use.summary(),
            "kv_bytes_per_token_in_flight": self.kv_bytes_per_token_in_flight(),
            "block_waterline": self.block_waterline,
            "decode_block_ticks": dict(self.decode_block_ticks),
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "prefill_tokens_skipped": self.prefill_tokens_skipped,
            "prefix_hit_rate": self.prefix_hit_rate(),
            "blocks_saved": self.blocks_saved,
            "shared_blocks": self.shared_blocks.summary(),
            "shared_blocks_peak": self.shared_blocks_peak,
            "cow_adoptions": self.cow_adoptions,
            "cow_tokens_shared": self.cow_tokens_shared,
            "cow_forks": self.cow_forks,
            "cow_forks_elided": self.cow_forks_elided,
            "cow_shared_blocks_peak": self.cow_shared_blocks_peak,
            "resume_prefill_tokens": self.resume_prefill_tokens,
            "resume_prefill_tokens_saved": self.resume_prefill_tokens_saved,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "spec_accept_rate": self.spec_accept_rate(),
            "preemptions": self.preemptions,
            "swap_outs": self.swap_outs,
            "swap_ins": self.swap_ins,
            "reprefills": self.reprefills,
            "swap_fallbacks": self.swap_fallbacks,
            "swap_bytes_out": self.swap_bytes_out,
            "swap_bytes_in": self.swap_bytes_in,
            "swap_store_bytes": self.swap_store_bytes,
            "tier_disk_bytes": self.tier_disk_bytes,
            "tier_demotions": self.tier_demotions,
            "tier_promotions": self.tier_promotions,
            "parked_peak": self.parked_peak,
            "reconfigs": dict(self.reconfigs),
            "reconfigs_by_initiator": dict(self.reconfigs_by_initiator),
            "reconfig_failures": self.reconfig_failures,
            "reconfig_preempted": self.reconfig_preempted,
            "tokens_emitted": self.tokens_emitted,
            "tokens_per_second": self.tokens_per_second(),
            "ticks": self.ticks,
            "finished": dict(self.finished),
            "rejected": self.rejected,
        }

    def to_prometheus(self) -> str:
        """Prometheus text exposition of the registry view (counters,
        per-tick gauges, latency quantiles) — what a serving host exposes
        on a metrics endpoint."""
        return self.registry.to_prometheus()

    def flush(self) -> None:
        self.registry.flush()
