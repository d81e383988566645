"""The self-healing control plane in the port, against JAX's.

The port's counterparts of JAX's ``tests/test_healer.py``: (1) ladder
mechanics: a rung gets a verification window and the healer ESCALATES past
it when the anomaly does not resolve, a rung whose apply raises advances
instead of wedging, exhaustion and flap both FREEZE terminally
(``healer_frozen``, operator reset required), cooldowns gate re-entry and the
per-replica remediation budget holds a runaway ladder; (2) the sentinel
lifecycle the healer rides (severity, resolve hooks, ack, the maintenance
window); (3) every rung of ``resilience/remediation.py`` over real engines
and over a stub server: applicability, escalation on a raised, refused or
degraded reconfiguration, ``initiator="healer"``; (4) the closed loop end to
end on a lockstep server and a free-running fleet; (5) the XFAIL_SEEDS
ledger expiry of ``tests/test_torch_chaos.py``.

The ladder and rung scenarios run on JAX's sentinel, healer and rungs and on
the port's (:func:`each`), on a fake clock or a fake server, where both are
exactly deterministic: the actions, transitions, ``heal_log``, ``status()``
and ``manifest()`` are equal, and :func:`test_scripted_sequence_equals_jax`
holds a long scripted sequence's trace bytes, counters and snapshots equal.
The end-to-end cases run the port's threaded server on the tiny GPT carried
from JAX (``interop.py``) with the sentinel and the healer on the engine's
tick clock (windows in ticks); the injected degradation arms itself on a
tick and sleeps 25x the median healthy tick of the case's own warm-up, and
every wait is a handle's result with a timeout. Streams equal JAX's engine
and the port's ``generate_cached``.
"""

import datetime
import importlib
import itertools
import time
import types
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from test_torch_serving_reconfig import (  # noqa: F401 — the lm fixture
    WAIT,
    lm,
    plain,
    prompts_of,
    solo,
    stacks,
    toks,
)

from gradaccum_tpu_torch.examples import chaos_smoke
from gradaccum_tpu_torch.obs import metrics as tmetrics
from gradaccum_tpu_torch.obs import sentinel as tsentinel
from gradaccum_tpu_torch.obs import trace as ttrace
from gradaccum_tpu_torch.resilience import healer as thealer
from gradaccum_tpu_torch.resilience import remediation as tremediation
from gradaccum_tpu_torch.serving import reconfig as treconfig
import gradaccum_tpu_torch.serving as tserving

jsentinel = importlib.import_module("gradaccum_tpu.obs.sentinel")
jmetrics = importlib.import_module("gradaccum_tpu.obs.metrics")
jtrace = importlib.import_module("gradaccum_tpu.obs.trace")
jhealer = importlib.import_module("gradaccum_tpu.resilience.healer")
jremediation = importlib.import_module("gradaccum_tpu.resilience.remediation")
jreconfig = importlib.import_module("gradaccum_tpu.serving.reconfig")
jserving = importlib.import_module("gradaccum_tpu.serving")

pytestmark = [pytest.mark.torch, pytest.mark.healer]
torch.set_num_threads(1)

CLIFF = tsentinel.LATENCY_CLIFF
STALL = tsentinel.STALL
DEAD = tsentinel.DEAD_REPLICA
STORM = tsentinel.PREEMPTION_STORM
FROZEN = tsentinel.HEALER_FROZEN

SIDES = {
    "jax": types.SimpleNamespace(
        name="jax", sentinel=jsentinel, Sentinel=jsentinel.Sentinel, Healer=jhealer.Healer,
        default_ladders=jhealer.default_ladders, remediation=jremediation, reconfig=jreconfig,
        trace=jtrace, registry=lambda: jmetrics.MetricsRegistry(subdir="healer-test")),
    "torch": types.SimpleNamespace(
        name="torch", sentinel=tsentinel, Sentinel=tsentinel.Sentinel, Healer=thealer.Healer,
        default_ladders=thealer.default_ladders, remediation=tremediation, reconfig=treconfig,
        trace=ttrace, registry=lambda: tmetrics.MetricsRegistry(subdir="healer-test")),
}


def each(scenario, lm=None):
    """``scenario(side)`` on JAX's healer stack and the port's (with the
    serving stack of ``lm`` as ``side.stack``); asserts the two results equal
    and returns the port's."""
    got = {}
    for name, side in SIDES.items():
        if lm is not None:
            side = types.SimpleNamespace(**vars(side), stack=stacks(lm)[name])
        got[name] = scenario(side)
    assert plain(got["torch"]) == plain(got["jax"])
    return got["torch"]


def _fake_clock():
    clk = [0.0]
    return clk, (lambda: clk[0])


def _rung(s, name, log=None, fail=False, applies=True):
    def apply(anomaly):
        if fail:
            raise RuntimeError(f"{name} exploded")
        if log is not None:
            log.append((name, anomaly.kind, anomaly.replica))

    return s.remediation.Remediation(name, apply, applies=(lambda a: applies))


def _names(taken):
    return [a["action"] for a in taken]


def _snap(h):
    """What must equal across the two packages after a scenario."""
    return h.status(), h.manifest(), h.heal_log, h.frozen(), h.actions_total


# -- ladder mechanics (fake clock, stub rungs) --------------------------------


def test_verify_timeout_escalates_then_exhaustion_freezes():
    def run(s):
        clk, clock = _fake_clock()
        snt = s.Sentinel(clock=clock)
        log = []
        h = s.Healer(snt, {CLIFF: [_rung(s, "r0", log), _rung(s, "r1", log)]},
                     verify_window=5.0, budget_limit=10)
        snt.fire(CLIFF)
        assert _names(h.poll()) == ["r0"]
        assert h.poll() == []  # window still open: no double apply
        clk[0] = 6.0  # rung 0's window expired, anomaly still firing
        assert _names(h.poll()) == ["r1"]
        clk[0] = 12.0  # past the last rung: out of ideas -> terminal freeze
        assert h.poll() == []
        assert h.frozen() == [{"kind": CLIFF, "replica": None, "why": "exhausted"}]
        assert snt.is_firing(FROZEN)
        before = h.actions_total
        clk[0] = 100.0  # terminal means terminal
        assert h.poll() == [] and h.actions_total == before
        assert log == [("r0", CLIFF, None), ("r1", CLIFF, None)]
        return _snap(h)

    each(run)


def test_resolve_within_window_heals_and_records_mttr():
    def run(s):
        clk, clock = _fake_clock()
        snt = s.Sentinel(clock=clock)
        h = s.Healer(snt, {CLIFF: [_rung(s, "r0")]}, verify_window=8.0, cooldown=4.0)
        snt.fire(CLIFF)
        h.poll()
        clk[0] = 3.0
        snt.resolve(CLIFF)
        assert h.healed_total == 1
        heal = h.heal_log[-1]
        assert heal["mttr"] == 3.0 and heal["rung"] == 0 and heal["action"] == "r0"
        clk[0] = 4.0  # cooldown gates re-entry: a refire inside it waits
        snt.fire(CLIFF)
        assert h.poll() == []
        clk[0] = 7.5  # the cooldown (resolve at 3.0 + 4.0) has passed
        assert _names(h.poll()) == ["r0"]
        return _snap(h)

    each(run)


def test_flap_freeze_is_terminal_until_operator_reset():
    def run(s):
        clk, clock = _fake_clock()
        snt = s.Sentinel(clock=clock)
        h = s.Healer(snt, {CLIFF: [_rung(s, "r0")]}, verify_window=10.0, cooldown=0.5,
                     flap_limit=2, flap_window=100.0)
        for i in range(2):  # two apply -> heal oscillations
            clk[0] = 10.0 * i
            snt.fire(CLIFF)
            h.poll()
            clk[0] = 10.0 * i + 1.0
            snt.resolve(CLIFF)
        assert h.healed_total == 2 and not h.frozen()
        clk[0] = 25.0  # the third fire inside the flap window: freeze, no action
        snt.fire(CLIFF)
        before = h.actions_total
        assert h.poll() == []
        assert h.frozen() == [{"kind": CLIFF, "replica": None, "why": "flap"}]
        assert snt.is_firing(FROZEN)
        fires = [a for a in snt.anomalies if a.kind == FROZEN and a.state == "fire"]
        assert len(fires) == 1 and fires[0].severity == "page"
        assert fires[0].detail["why"] == "flap" and "ladders" in fires[0].detail["healer"]
        for t in (40.0, 60.0, 80.0):  # no oscillation ever again without a human
            clk[0] = t
            snt.resolve(CLIFF)
            snt.fire(CLIFF)
            assert h.poll() == []
        assert h.actions_total == before
        assert h.reset(CLIFF) == 1  # operator reset: the page resolves
        assert not snt.is_firing(FROZEN)
        clk[0] = 90.0
        assert _names(h.poll()) == ["r0"]
        return _snap(h), [a.to_dict() for a in snt.anomalies]

    each(run)


def test_raising_rung_advances_instead_of_wedging():
    def run(s):
        clk, clock = _fake_clock()
        snt = s.Sentinel(clock=clock)
        log = []
        h = s.Healer(snt, {CLIFF: [_rung(s, "boom", fail=True), _rung(s, "r1", log)]},
                     verify_window=50.0)
        snt.fire(CLIFF)
        taken = h.poll()
        assert taken[0]["action"] == "boom" and taken[0]["error"] == "RuntimeError"
        assert _names(h.poll()) == ["r1"]  # no verify-window wait after an error
        assert log == [("r1", CLIFF, None)]
        return taken, _snap(h)

    each(run)


def test_refused_reconfig_mid_escalation_advances():
    """A rung whose request_reconfig is REFUSED (the shrink-demand check)
    raises on apply: the ladder moves to the next rung, not wedges."""
    def run(s):
        clk, clock = _fake_clock()
        snt = s.Sentinel(clock=clock)
        log = []

        def refused(anomaly):
            raise s.reconfig.ReconfigError("cannot shrink to 1 blocks", demand=9, supply=1)

        h = s.Healer(snt, {CLIFF: [s.remediation.Remediation("shrink", refused),
                                   _rung(s, "fallback", log)]}, verify_window=50.0)
        snt.fire(CLIFF)
        assert h.poll()[0]["error"] == "ReconfigError"
        assert _names(h.poll()) == ["fallback"]
        assert log and not h.frozen()
        return _snap(h)

    each(run)


def test_inapplicable_rungs_are_skipped_without_budget_charge():
    def run(s):
        clk, clock = _fake_clock()
        snt = s.Sentinel(clock=clock)
        log = []
        h = s.Healer(snt, {CLIFF: [_rung(s, "nofleet", applies=False), _rung(s, "r1", log)]},
                     verify_window=5.0, budget_limit=10)
        snt.fire(CLIFF)
        assert _names(h.poll()) == ["r1"]
        assert log == [("r1", CLIFF, None)] and h.actions_total == 1  # the skip was free
        return _snap(h)

    each(run)


def test_budget_exhaustion_holds_ladder_until_window_slides():
    def run(s):
        clk, clock = _fake_clock()
        snt = s.Sentinel(clock=clock)
        h = s.Healer(snt, {CLIFF: [_rung(s, f"r{i}") for i in range(4)]},
                     verify_window=2.0, budget_limit=2, budget_window=50.0)
        snt.fire(CLIFF)
        h.poll()             # r0 (action 1)
        clk[0] = 3.0
        h.poll()             # r1 (action 2: budget now exhausted)
        clk[0] = 6.0
        assert h.poll() == []  # r2 HELD, not applied, not skipped
        assert h.actions_total == 2
        st = h.status()["ladders"][CLIFF]
        assert st["rung"] == 1 and not st["frozen"]
        clk[0] = 52.0        # the budget window slid: the ladder resumes
        assert _names(h.poll()) == ["r2"] and h.actions_total == 3
        return _snap(h)

    each(run)


def test_budget_is_per_replica():
    def run(s):
        clk, clock = _fake_clock()
        snt = s.Sentinel(clock=clock)
        h = s.Healer(snt, {CLIFF: [_rung(s, "r0")], DEAD: [_rung(s, "d0")]},
                     budget_limit=1, budget_window=50.0)
        snt.fire(CLIFF, replica=0)
        snt.fire(DEAD, replica=1)
        taken = {a["replica"]: a["action"] for a in h.poll()}
        # one action each: replica 0's spent budget does not starve replica 1
        assert taken == {0: "r0", 1: "d0"}
        return _snap(h)

    each(run)


def test_healer_rejects_bad_ladder_policies():
    def run(s):
        snt = s.Sentinel()
        out = []
        for ladders, match in (({FROZEN: [_rung(s, "r")]}, "healer_frozen"),
                               ({"sharks": [_rung(s, "r")]}, "unknown"),
                               ({CLIFF: []}, "empty")):
            with pytest.raises(ValueError, match=match) as e:
                s.Healer(snt, ladders)
            out.append(str(e.value))
        return out

    each(run)


def test_custom_verify_predicate_rejects_coincidental_resolve():
    def run(s):
        clk, clock = _fake_clock()
        snt = s.Sentinel(clock=clock)
        verdicts = [False, True]
        rung = s.remediation.Remediation("picky", lambda a: None,
                                         verify=lambda a: verdicts.pop(0))
        h = s.Healer(snt, {CLIFF: [rung]}, verify_window=10.0, cooldown=0.0)
        snt.fire(CLIFF)
        h.poll()
        clk[0] = 2.0
        snt.resolve(CLIFF)   # verify says no: not credited as a heal
        assert h.healed_total == 0
        snt.fire(CLIFF)      # refires; the rung still active, its window running
        clk[0] = 4.0
        snt.resolve(CLIFF)   # verify says yes this time
        assert h.healed_total == 1
        return _snap(h)

    each(run)


# -- sentinel lifecycle -------------------------------------------------------


def test_anomaly_severity_defaults_and_overrides():
    def run(s):
        clk, clock = _fake_clock()
        snt = s.Sentinel(clock=clock)
        snt.fire(CLIFF)
        assert snt.anomalies[-1].severity == "warning"
        assert snt.anomalies[-1].to_dict()["severity"] == "warning"
        snt.fire(DEAD, replica=1)
        assert snt.anomalies[-1].severity == "critical"
        snt.resolve(CLIFF)
        assert snt.anomalies[-1].state == "resolve"
        assert snt.anomalies[-1].severity == "warning"  # carried to the resolve
        snt2 = s.Sentinel(severity={CLIFF: "critical"}, clock=clock)
        snt2.fire(CLIFF)
        assert snt2.anomalies[-1].severity == "critical"
        assert snt2.status()["firing"][0]["severity"] == "critical"
        with pytest.raises(ValueError, match="unknown kinds"):
            s.Sentinel(severity={"sharks": "page"})
        return [a.to_dict() for a in snt.anomalies + snt2.anomalies]

    each(run)


def test_ack_records_transition_without_resolving():
    def run(s):
        clk, clock = _fake_clock()
        snt = s.Sentinel(clock=clock)
        assert snt.ack(CLIFF) is False  # nothing firing
        snt.fire(CLIFF)
        clk[0] = 2.0
        assert snt.ack(CLIFF, by="oncall") is True
        assert snt.is_firing(CLIFF)  # acked, NOT resolved
        assert [(a.state, a.acked) for a in snt.anomalies] == [("fire", True), ("ack", True)]
        assert snt.anomalies[-1].detail == {"by": "oncall"}
        return [a.to_dict() for a in snt.anomalies]

    each(run)


def test_resolve_hooks_run_and_are_exception_contained():
    def run(s):
        clk, clock = _fake_clock()
        snt = s.Sentinel(clock=clock)
        seen = []

        def broken(record):
            raise RuntimeError("hook bug")

        snt.on_resolve(CLIFF, broken)
        snt.on_resolve("*", lambda r: seen.append((r.kind, r.state, r.at)))
        snt.fire(CLIFF)
        clk[0] = 5.0
        snt.resolve(CLIFF)
        assert seen == [(CLIFF, "resolve", 5.0)]
        with pytest.raises(ValueError, match="unknown"):
            snt.on_resolve("sharks", lambda r: None)
        return seen

    each(run)


def test_maintenance_suppresses_baseline_feeding():
    """Samples inside a maintenance window (a reconfiguration's quiesce and
    rebuild) neither feed the EWMA latency baseline nor fire a cliff."""
    def run(s):
        clk, clock = _fake_clock()
        snt = s.Sentinel(clock=clock, cliff_warmup=4, cliff_consecutive=2, cliff_score=4.0)
        for _ in range(8):
            snt.observe_tick(1.0)
        base = snt._tick_base[None]
        mean_before, n_before = base.mean, base.n
        with snt.maintenance():
            for _ in range(6):  # rebuild-cost ticks: huge, and planned
                snt.observe_tick(50.0)
        assert not snt.is_firing(CLIFF), "maintenance ticks fired a latency_cliff"
        assert base.n == n_before and base.mean == mean_before
        snt.observe_tick(1.0)  # normal ticks are still normal afterwards
        assert not snt.is_firing(CLIFF)
        snt.observe_tick(30.0)
        snt.observe_tick(30.0)  # a REAL post-maintenance cliff still fires
        assert snt.is_firing(CLIFF)
        return [a.to_dict() for a in snt.anomalies], base.mean, base.n

    each(run)


# -- rung factories over real engines -----------------------------------------


def test_governor_pin_rung_arms_the_thrash_governor(lm):
    def run(s):
        engine = s.stack.engine(num_slots=2, max_len=32, page_size=4, num_blocks=16,
                                admission="optimistic")
        server = s.stack.serving.ServingServer(engine)
        rung = s.remediation.governor_pin_rung(server, ticks=64)
        anomaly = s.sentinel.Anomaly(STORM, "fire", 0.0)
        assert rung.applies(anomaly) and rung.apply(anomaly)
        policy = engine.admission_policy
        out = [policy.governed(engine.tick_count), policy.governed(engine.tick_count + 65)]
        # a pin never shortens an already-armed governor
        policy.pin(engine.tick_count, 128)
        policy.pin(engine.tick_count, 10)
        out.append(policy.governed(engine.tick_count + 100))
        assert out == [True, False, True]
        return out

    each(run, lm)


def test_pool_grow_rung_tags_reconfig_as_healer(lm):
    def run(s):
        engine = s.stack.engine(num_slots=2, max_len=32, page_size=4, num_blocks=12)
        rng = np.random.default_rng(3)
        with s.stack.serving.ServingServer(engine) as server:
            rung = s.remediation.pool_grow_rung(server, factor=1.5, max_blocks=64)
            anomaly = s.sentinel.Anomaly(CLIFF, "fire", 0.0)
            assert rung.applies(anomaly)
            h = server.submit(rng.integers(0, 96, 5).astype(np.int32), 4)
            assert rung.apply(anomaly)
            deadline = time.monotonic() + WAIT
            while engine.num_blocks == 12 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert engine.num_blocks == 18
            tokens, reason = h.result(timeout=WAIT)
            assert engine.last_reconfig.initiator == "healer"
            assert engine.metrics.reconfigs_by_initiator == {"healer": 1}
            # the growth cap: at or above max_blocks the rung reports inapplicable
            capped = s.remediation.pool_grow_rung(server, factor=2.0, max_blocks=18)
            assert capped.apply(anomaly) is False
        return toks(tokens), reason, engine.num_blocks, dict(
            engine.metrics.reconfigs_by_initiator)

    each(run, lm)


def test_operator_reconfig_keeps_operator_initiator(lm):
    def run(s):
        engine = s.stack.engine(num_slots=2, max_len=32, page_size=4, num_blocks=12)
        result = engine.reconfigure(s.stack.serving.pool_resize(16))
        assert result.initiator == "operator" and result.to_dict()["initiator"] == "operator"
        assert engine.metrics.reconfigs_by_initiator == {"operator": 1}
        assert engine.metrics.summary()["reconfigs_by_initiator"] == {"operator": 1}
        return result.to_dict()

    each(run, lm)


def test_drain_replica_rung_needs_fleet_and_replica(lm):
    def run(s):
        server = s.stack.serving.ServingServer(s.stack.engine(num_slots=2, max_len=32))
        rung = s.remediation.drain_replica_rung(server)
        out = [rung.applies(s.sentinel.Anomaly(DEAD, "fire", 0.0, replica=1)),
               rung.applies(s.sentinel.Anomaly(DEAD, "fire", 0.0))]
        assert out == [False, False]
        return out

    each(run, lm)


def test_default_ladders_shape():
    def run(s):
        class _Srv:  # only the rung factories' surface is needed to BUILD
            _engine = None

        consensus = types.SimpleNamespace(request=lambda: None)
        ladders = s.default_ladders(server=_Srv(), checkpoint="ck", consensus=consensus)
        names = {k: [r.name for r in v] for k, v in ladders.items()}
        assert names == {
            CLIFF: ["recover_requeue", "replica_drain", "pool_grow"],
            STALL: ["recover_requeue"],
            DEAD: ["recover_requeue", "replica_excise", "replica_add"],
            STORM: ["governor_pin", "pool_grow"],
            tsentinel.TIER_THRASH: ["governor_pin", "pool_grow"],
            tsentinel.SCALE_STORM: ["checkpoint_rollback", "drain_consensus"],
        }
        # only the ladders whose targets are given are built
        assert {k: [r.name for r in v] for k, v in s.default_ladders(
            consensus=consensus).items()} == {tsentinel.SCALE_STORM: ["drain_consensus"]}
        assert tsentinel.SCALE_STORM not in s.default_ladders(server=_Srv())
        m = s.Healer(s.Sentinel(), ladders).manifest()
        assert m["ladders"][CLIFF] == ["recover_requeue", "replica_drain", "pool_grow"]
        assert m["flap_limit"] == 3 and m["budget_limit"] == 4
        return names, m

    each(run)


# -- every rung against a stub server: skip, escalate, initiator --------------


class _Policy:
    def __init__(self, fail=False):
        self.pins, self.fail = [], fail

    def pin(self, tick, ticks):
        if self.fail:
            raise RuntimeError("governor offline")
        self.pins.append((tick, ticks))


class _StubServer:
    """The surface the rungs reach: ``_engine`` (an engine or a fleet of two
    with ``replicas``, ``_generations`` and ``active_replicas``),
    ``request_recover`` and ``request_reconfig`` (recorded; a Future the
    test settles, or a synchronous refusal under ``mode="raise"``), and a
    drain consensus."""

    def __init__(self, s, fleet=True, paged=True, admission=True, mode="ok", active=2):
        def engine(r):
            return types.SimpleNamespace(
                paged=paged, num_blocks=12, mesh=None, tick_count=5 + r, replica_id=r,
                admission_policy=_Policy(fail=mode == "raise") if admission else None)

        engines = [engine(r) for r in range(2 if fleet else 1)]
        self._engine = (types.SimpleNamespace(replicas=engines, _generations=[(0, 2)],
                                              active_replicas=list(range(active)),
                                              paged=paged)
                        if fleet else engines[0])
        self.side, self.mode, self.calls, self.futures = s, mode, [], []
        self.consensus = types.SimpleNamespace(request=self._drain)

    def _refuse(self):
        raise self.side.reconfig.ReconfigError("refused", demand=9, supply=1)

    def request_recover(self, reason, replica=None):
        self.calls.append(("recover", reason, replica))
        if self.mode == "raise":
            raise RuntimeError("server stopped")

    def request_reconfig(self, spec):
        self.calls.append(("reconfig", spec.to_dict()))
        if self.mode == "raise":
            self._refuse()
        fut = Future()
        self.futures.append(fut)
        return fut

    def _drain(self):
        self.calls.append(("drain",))
        if self.mode == "raise":
            raise RuntimeError("consensus down")


RUNGS = {
    "recover_requeue": lambda r, srv: r.recover_rung(srv),
    "replica_drain": lambda r, srv: r.drain_replica_rung(srv),
    "replica_excise": lambda r, srv: r.excise_replica_rung(srv),
    "replica_add": lambda r, srv: r.add_replica_rung(srv),
    "pool_grow": lambda r, srv: r.pool_grow_rung(srv, factor=1.5, max_blocks=64),
    "governor_pin": lambda r, srv: r.governor_pin_rung(srv, ticks=8),
    "checkpoint_rollback": lambda r, srv: r.rollback_rung(srv, "ck"),
    "drain_consensus": lambda r, srv: r.drain_rung(srv.consensus),
}
RECONFIG_RUNGS = ("replica_drain", "replica_excise", "replica_add", "pool_grow",
                  "checkpoint_rollback")
# the deployment each rung cannot take, as _StubServer keywords
INAPPLICABLE = {"replica_drain": dict(fleet=False), "replica_excise": dict(fleet=False),
                "replica_add": dict(fleet=False), "pool_grow": dict(paged=False),
                "governor_pin": dict(admission=False)}
# ... and where it applies statically but its apply finds nothing to do
AT_CAP = {"replica_add": dict(active=4)}  # construction width 2 + 2


def _ladder_of(s, name, srv, log):
    return s.Healer(s.Sentinel(clock=srv.clock), {DEAD: [RUNGS[name](s.remediation, srv),
                                                         _rung(s, "fallback", log)]},
                    verify_window=50.0, budget_limit=1, budget_window=1e9)


def _stub(s, **kw):
    srv = _StubServer(s, **kw)
    srv.clk, srv.clock = _fake_clock()
    return srv


@pytest.mark.parametrize("name", sorted(RUNGS))
def test_every_rung_skips_without_budget_charge(name):
    """A rung the deployment cannot take is skipped at plan time (or finds
    nothing to do at apply time and is refunded): the fallback behind it
    gets the one budget slot. A rung without an applicability check (the
    recover, the rollback, the drain) applies everywhere and charges one."""
    def run(s):
        out = []
        for kw in (INAPPLICABLE.get(name), AT_CAP.get(name)):
            if kw is None:
                continue
            log = []
            srv = _stub(s, **kw)
            h = _ladder_of(s, name, srv, log)
            h.sentinel.fire(DEAD, replica=1)
            polls = [_names(h.poll()), _names(h.poll())]
            assert ["fallback"] in polls and log and h.actions_total == 1, polls
            assert srv.calls == []  # nothing reached the server
            out.append((polls, _snap(h)))
        if name not in INAPPLICABLE:
            srv = _stub(s)
            h = _ladder_of(s, name, srv, [])
            for kw in (dict(fleet=False), dict(paged=False), dict(admission=False)):
                anomaly = s.sentinel.Anomaly(DEAD, "fire", 0.0, replica=1)
                assert RUNGS[name](s.remediation, _stub(s, **kw)).applies(anomaly)
            h.sentinel.fire(DEAD, replica=1)
            assert _names(h.poll()) == [name] and h.actions_total == 1
            out.append((srv.calls, _snap(h)))
        return out

    each(run)


ESCALATIONS = [(n, m) for n in sorted(RUNGS) for m in ("raise", "refuse", "degrade")
               if m == "raise" or n in RECONFIG_RUNGS]


@pytest.mark.parametrize("name,mode", ESCALATIONS)
def test_every_rung_escalates_on_failure(name, mode):
    """``raise``: the action fails synchronously (a refused reconfiguration,
    a stopped server); ``refuse``/``degrade``: an enqueued reconfiguration's
    Future later fails with ``ReconfigError`` or settles ``ok=False``. Either
    way the next poll escalates to the fallback, with no verify-window wait,
    and a late report after the ladder moved on changes nothing."""
    def run(s):
        log = []
        srv = _stub(s, mode=mode)
        h = _ladder_of(s, name, srv, log)
        h.budget_limit = 4
        h.sentinel.fire(DEAD, replica=1)
        first = h.poll()
        if mode == "raise":
            assert first[0]["action"] == name and "error" in first[0], first
        else:
            assert _names(first) == [name] and h.poll() == []  # nothing settled yet
            if mode == "refuse":
                srv.futures[0].set_exception(s.reconfig.ReconfigError("refused", demand=9,
                                                                      supply=1))
            else:
                srv.futures[0].set_result(types.SimpleNamespace(ok=False))
        assert _names(h.poll()) == ["fallback"] and log
        late = Future()  # a late or duplicate report once the ladder moved on
        s.remediation._watch_reconfig(late, h._escalate_cb((DEAD, 1), 0))
        late.set_exception(s.reconfig.ReconfigError("stale"))
        assert h.poll() == [] and not h.frozen()
        return first, srv.calls, _snap(h)

    each(run)


@pytest.mark.parametrize("name", RECONFIG_RUNGS)
def test_every_reconfig_rung_tags_healer(name):
    """Every reconfiguration a rung asks for carries ``initiator="healer"``
    and targets the anomalous replica where it names one; a successful
    excise chains a healer-tagged ``replica_add`` (below the scale-out cap),
    a refused one does not."""
    def run(s):
        out = []
        for ok in (True, False):
            srv = _stub(s)
            rung = RUNGS[name](s.remediation, srv)
            assert rung.apply(s.sentinel.Anomaly(DEAD, "fire", 0.0, replica=1),
                              escalate=lambda reason: None)
            srv.futures[0].set_result(types.SimpleNamespace(ok=ok))
            specs = [c[1] for c in srv.calls]
            assert specs and all(sp["initiator"] == "healer" for sp in specs), specs
            chained = [sp["action"] for sp in specs[1:]]
            assert chained == (["add"] if name == "replica_excise" and ok else []), chained
            out.append(specs)
        return out

    spec = each(run)[0][0]
    want = {"replica_drain": ("replica_scale", 1), "replica_excise": ("replica_scale", 1),
            "replica_add": ("replica_scale", None), "pool_grow": ("pool_resize", None),
            "checkpoint_rollback": ("checkpoint_swap", None)}[name]
    assert (spec["kind"], spec["replica"]) == want


def test_recover_and_governor_rungs_target_the_replica():
    """The two rungs that reach no reconfiguration: the recover names the
    anomalous replica in its nudge, the pin arms only that replica's
    governor (both on a fleet)."""
    def run(s):
        srv = _stub(s)
        anomaly = s.sentinel.Anomaly(STORM, "fire", 0.0, replica=1)
        assert RUNGS["recover_requeue"](s.remediation, srv).apply(anomaly)
        assert RUNGS["governor_pin"](s.remediation, srv).apply(anomaly)
        pins = [e.admission_policy.pins for e in srv._engine.replicas]
        assert srv.calls == [("recover", f"healer:{STORM} replica 1", 1)]
        assert pins == [[], [(6, 8)]]
        return srv.calls, pins

    each(run)


# -- the closed loop end to end (tick clock) ----------------------------------


DEGRADE_FACTOR = 25.0  # the degraded tick against the warm-up's median healthy tick


def _jax_streams(lm, prompts, n):
    """JAX's engine on the same prompts, no fault: the reference streams."""
    engine = jserving.Engine(lm.params, lm.jcfg, num_slots=2, max_len=64)
    rids = [engine.submit(p, n) for p in prompts]
    engine.run_until_idle()
    return [toks(engine.results[r]) for r in rids]


def test_healer_end_to_end_latency_cliff_recover(lm):
    """A degraded engine's latency cliff healed autonomously through the
    REAL recover + requeue contract on the loop thread: the anomaly fires,
    rung 0 applies, the engine recovers, the cliff resolves inside the
    verification window (ticks), and every stream equals JAX's engine and
    ``generate_cached``."""
    engine = tserving.Engine(lm.tree, lm.tcfg, num_slots=2, max_len=64, device="cpu")
    prompts = prompts_of(3, seed=11, hi=6)
    delay = DEGRADE_FACTOR * chaos_smoke.tick_median(engine, prompts)
    deg = chaos_smoke.degrade(engine, engine.tick_count + 8, delay)
    snt = tsentinel.Sentinel(clock=lambda: float(engine.tick_count), cliff_warmup=4,
                             cliff_consecutive=2, cliff_score=5.0, lease=60.0)
    server = tserving.ServingServer(engine, max_requeues=8, max_engine_faults=8, sentinel=snt)
    healer = thealer.Healer(snt, {CLIFF: [tremediation.recover_rung(server)]},
                            verify_window=30.0, cooldown=0.0)
    server.attach_healer(healer)
    with server:
        results = [h.result(timeout=WAIT) for h in [server.submit(p, 24) for p in prompts]]
        stats = server.stats()
    assert healer.healed_total >= 1, snt.status()
    heal = healer.heal_log[0]
    assert heal["kind"] == CLIFF and heal["action"] == "recover_requeue" and heal["rung"] == 0
    assert heal["mttr"] <= 30.0  # inside the window, in ticks
    assert deg["armed"] and not deg["on"], "the recover rung never reached the engine"
    assert not healer.frozen() and stats["healer"]["healed_total"] >= 1
    assert engine.manifest()["healer"]["ladders"][CLIFF] == ["recover_requeue"]
    want = _jax_streams(lm, prompts, 24)
    for prompt, (tokens, reason), w in zip(prompts, results, want):
        assert reason in ("eos", "length"), reason
        assert toks(tokens) == w == solo(lm, prompt, 24)


def test_healer_free_running_fleet_heals_one_replica(lm):
    """One replica of a free-running fleet degrades, its latency cliff fires
    replica-scoped, the recover rung routes to THAT replica's loop, and the
    fleet's streams stay exact. The ladder runs on the fleet's lease clock
    (its furthest replica tick) with a window no heal can outlast here."""
    fleet = tserving.ReplicatedEngine(lm.tree, lm.tcfg, replicas=2, tp=1, num_slots=2,
                                      max_len=64, device="cpu")
    prompts = prompts_of(4, seed=13, hi=6)
    # warm both replicas outside the watched window; a fleet tick times both
    delay = DEGRADE_FACTOR * chaos_smoke.tick_median(fleet, prompts)
    target = fleet.replicas[1]
    deg = chaos_smoke.degrade(target, target.tick_count + 6, delay)
    snt = tsentinel.Sentinel(clock=lambda: float(max(e.tick_count for e in fleet.replicas)),
                             cliff_warmup=4, cliff_consecutive=2, cliff_score=5.0, lease=1e9)
    server = tserving.ServingServer(fleet, max_requeues=8, max_engine_faults=8, sentinel=snt,
                                    free_running=True)
    healer = thealer.Healer(snt, {CLIFF: [tremediation.recover_rung(server)]},
                            verify_window=1e4, cooldown=0.0)
    server.attach_healer(healer)
    with server:
        results = [h.result(timeout=WAIT) for h in [server.submit(p, 20) for p in prompts]]
    heals = [x for x in healer.heal_log if x["replica"] == 1]
    assert heals and heals[0]["action"] == "recover_requeue", (healer.heal_log, snt.status())
    assert deg["armed"] and not deg["on"] and deg["recovers"] >= 1
    assert fleet.manifest()["healer"]["ladders"][CLIFF] == ["recover_requeue"]
    want = _jax_streams(lm, prompts, 20)
    for prompt, (tokens, reason), w in zip(prompts, results, want):
        assert reason in ("eos", "length"), reason
        assert toks(tokens) == w == solo(lm, prompt, 20)


def test_server_rejects_healer_without_its_sentinel(lm):
    def run(s):
        engine = s.stack.engine(num_slots=2, max_len=32)
        snt = s.Sentinel()
        healer = s.Healer(snt, {CLIFF: [_rung(s, "r")]})
        out = []
        with pytest.raises(ValueError, match="sentinel") as e:
            s.stack.serving.ServingServer(engine, healer=healer)
        out.append(str(e.value))
        with pytest.raises(ValueError, match="different sentinel") as e:
            s.stack.serving.ServingServer(engine, sentinel=s.Sentinel(), healer=healer)
        out.append(str(e.value))
        server = s.stack.serving.ServingServer(engine, sentinel=snt, healer=healer)
        assert server.stats()["healer"]["actions_total"] == 0
        assert engine.manifest()["healer"] == healer.manifest()
        return out

    each(run, lm)


# -- XFAIL_SEEDS ledger expiry (tests/test_torch_chaos.py) --------------------


def test_xfail_ledger_staleness_contract():
    import test_chaos
    import test_torch_chaos

    today = datetime.date(2026, 8, 4)
    fresh = {"issue": "issue #12", "retest_after": "2026-12-01"}
    expired = {"issue": "issue #9", "retest_after": "2026-08-01"}
    legacy = "issue #3"
    missing = {"issue": "issue #5"}
    cases = [({1: fresh, 2: expired, 3: legacy, 4: missing}, today),
             ({7: {"issue": "issue #7", "retest_after": "2026-08-04"}}, today)]
    for ledger, day in cases:  # the port's rule is JAX's, case for case
        assert test_torch_chaos.stale_ledger_entries(ledger, today=day) == \
            test_chaos.stale_ledger_entries(ledger, today=day)
    stale = test_torch_chaos.stale_ledger_entries(cases[0][0], today=today)
    assert 1 not in stale and set(stale) == {2, 3, 4}
    assert "issue #9" in stale[2] and "2026-08-01" in stale[2]
    # the boundary day itself is already stale: retest means retest
    assert 7 in test_torch_chaos.stale_ledger_entries(cases[1][0], today=today)
    # the shipped ledger must never be stale
    assert test_torch_chaos.stale_ledger_entries(test_torch_chaos.XFAIL_SEEDS) == {}


def test_bench_heal_fast_structure(tmp_path):
    """The MTTR bench end to end (--fast) on the CPU, to a file, clearing
    JAX's acceptance: healer MTTR >= 1.5x the operator stub's, parity in both
    legs, the flap freeze terminal. A degraded tick of 0.12 s keeps the cliff
    far above a loaded host's healthy tick."""
    import json

    from gradaccum_tpu_torch.examples import bench_heal

    out = tmp_path / "heal.json"
    result = bench_heal.main(["--fast", "--device", "cpu", "--delay", "0.12",
                              "--json", str(out)])
    with open(out) as f:
        artifact = json.load(f)
    assert artifact["acceptance"]["passed"] is True and result["acceptance"]["passed"]
    assert artifact["mttr_ratio"] >= bench_heal.GATE
    for leg in ("healer", "operator_stub"):
        assert artifact[leg]["parity"] is True and artifact[leg]["anomaly_episodes"] >= 1
    assert artifact["flap"]["terminal"] is True
    assert artifact["flap"]["healer_frozen_fires"] == 1


# -- hardening regressions -----------------------------------------------------


def test_reset_keeps_page_while_another_ladder_frozen():
    """healer_frozen is level-held PER REPLICA: a partial reset must not
    silence the page while a second frozen ladder on the same replica
    remains."""
    def run(s):
        clk, clock = _fake_clock()
        snt = s.Sentinel(clock=clock)
        h = s.Healer(snt, {CLIFF: [_rung(s, "r0")], STALL: [_rung(s, "s0")]},
                     verify_window=2.0)
        snt.fire(CLIFF)
        snt.fire(STALL)
        h.poll()
        clk[0] = 3.0
        h.poll()  # both ladders exhausted -> both frozen, one page held
        assert len(h.frozen()) == 2 and snt.is_firing(FROZEN)
        assert h.reset(CLIFF) == 1
        assert snt.is_firing(FROZEN)  # stall's ladder is still frozen
        assert h.reset(STALL) == 1
        assert not snt.is_firing(FROZEN)
        return _snap(h), [a.to_dict() for a in snt.anomalies if a.kind == FROZEN]

    each(run)


def test_budget_hold_emits_transitions_once_not_per_poll():
    """A budget hold with an expired verify window emits ONE verify_timeout
    and ONE budget_held transition, not one per poll."""
    def run(s):
        clk, clock = _fake_clock()
        snt = s.Sentinel(clock=clock)
        reg = s.registry()
        h = s.Healer(snt, {CLIFF: [_rung(s, "r0"), _rung(s, "r1")]}, verify_window=2.0,
                     budget_limit=1, budget_window=100.0, registry=reg)
        snt.fire(CLIFF)
        h.poll()  # r0: budget spent
        clk[0] = 5.0  # window expired; escalation blocked by the budget
        for _ in range(50):
            h.poll()

        def count(reason):
            return reg.counter("healer/transitions_total", labels={"reason": reason}).value

        assert count("verify_timeout") == 1 and count("budget_held") == 1
        assert h.actions_total == 1
        clk[0] = 150.0  # the budget window slid: the held escalation lands once
        assert _names(h.poll()) == ["r1"]
        return {r: count(r) for r in ("fire", "apply", "verify_timeout", "budget_held")}

    each(run)


def test_async_reconfig_refusal_escalates_ladder():
    """Reconfiguration rungs only ENQUEUE (request_reconfig returns a
    Future): a refusal settled later on the loop thread still advances the
    ladder through the escalate channel."""
    def run(s):
        clk, clock = _fake_clock()
        snt = s.Sentinel(clock=clock)
        log, futs = [], []

        def enqueue_only(anomaly, escalate=None):
            fut = Future()
            futs.append(fut)
            s.remediation._watch_reconfig(fut, escalate)

        h = s.Healer(snt, {CLIFF: [s.remediation.Remediation("grow", enqueue_only),
                                   _rung(s, "fallback", log)]}, verify_window=50.0)
        snt.fire(CLIFF)
        assert _names(h.poll()) == ["grow"]
        assert h.poll() == []  # nothing settled yet: the window holds
        futs[0].set_exception(s.reconfig.ReconfigError("cannot shrink", demand=9, supply=1))
        assert _names(h.poll()) == ["fallback"] and log
        f2 = Future()  # a late or duplicate report after the ladder moved on
        s.remediation._watch_reconfig(f2, h._escalate_cb((CLIFF, None), 0))
        f2.set_exception(s.reconfig.ReconfigError("stale"))
        assert h.poll() == []
        return _snap(h)

    each(run)


def test_async_degraded_result_escalates_too():
    def run(s):
        clk, clock = _fake_clock()
        snt = s.Sentinel(clock=clock)
        log, futs = [], []

        def enqueue_only(anomaly, escalate=None):
            fut = Future()
            futs.append(fut)
            s.remediation._watch_reconfig(fut, escalate)

        h = s.Healer(snt, {CLIFF: [s.remediation.Remediation("roll", enqueue_only),
                                   _rung(s, "next", log)]}, verify_window=50.0)
        snt.fire(CLIFF)
        h.poll()
        futs[0].set_result(types.SimpleNamespace(ok=False))  # quarantined checkpoint
        assert _names(h.poll()) == ["next"]
        return _snap(h)

    each(run)


def test_governor_pin_targets_only_the_anomalous_replica(lm):
    """A replica-scoped preemption_storm pins ONLY that replica's thrash
    governor; an engine-level one pins everywhere."""
    def run(s):
        fleet = s.stack.fleet(replicas=2, tp=1, num_slots=2, max_len=32, page_size=4,
                              num_blocks=16, admission="optimistic")
        server = s.stack.serving.ServingServer(fleet)
        rung = s.remediation.governor_pin_rung(server, ticks=64)

        def governed():
            return [e.admission_policy.governed(e.tick_count) for e in fleet.replicas]

        assert rung.apply(s.sentinel.Anomaly(STORM, "fire", 0.0, replica=1))
        out = [governed()]
        rung.apply(s.sentinel.Anomaly(STORM, "fire", 0.0))
        out.append(governed())
        assert out == [[False, True], [True, True]]
        return out

    each(run, lm)


def test_replaced_healer_detaches_and_stops_reacting(lm):
    """Attaching a replacement ladder DETACHES the old healer's hooks: a
    ghost ladder's flap detector must not trip (and page) on anomalies the
    live ladder owns."""
    def run(s):
        engine = s.stack.engine(num_slots=2, max_len=32)
        clk, clock = _fake_clock()
        snt = s.Sentinel(clock=clock)
        server = s.stack.serving.ServingServer(engine, sentinel=snt)
        old = s.Healer(snt, {CLIFF: [_rung(s, "old")]}, cooldown=0.0, flap_limit=2,
                       flap_window=1e9)
        server.attach_healer(old)
        for i in range(2):  # the old healer heals twice: one more fire would flap
            clk[0] = 10.0 * i
            snt.fire(CLIFF)
            old.poll()
            snt.resolve(CLIFF)
        new = s.Healer(snt, {CLIFF: [_rung(s, "new")]})
        server.attach_healer(new)
        clk[0] = 50.0
        snt.fire(CLIFF)
        assert old.poll() == [] and not old.frozen()
        assert not snt.is_firing(FROZEN)
        assert _names(new.poll()) == ["new"]
        assert engine.manifest()["healer"]["ladders"][CLIFF] == ["new"]
        return _snap(old), _snap(new)

    each(run, lm)


def test_inapplicable_apply_refunds_budget():
    """A rung whose apply returns False at runtime (e.g. pool_grow at its
    cap) consumes no budget slot: skips are budget-free."""
    def run(s):
        clk, clock = _fake_clock()
        snt = s.Sentinel(clock=clock)
        log = []
        capped = s.remediation.Remediation("capped", lambda a: False)
        h = s.Healer(snt, {CLIFF: [capped, _rung(s, "real", log)]}, verify_window=5.0,
                     budget_limit=1, budget_window=100.0)
        snt.fire(CLIFF)
        h.poll()  # capped applies -> False -> refunded, escalate_now
        assert h.actions_total == 0
        assert _names(h.poll()) == ["real"] and h.actions_total == 1
        return _snap(h)

    each(run)


def test_budget_holds_across_kinds_in_one_poll():
    """Two anomaly kinds on one replica planned in the SAME poll must not
    overshoot the per-replica budget."""
    def run(s):
        clk, clock = _fake_clock()
        snt = s.Sentinel(clock=clock)
        h = s.Healer(snt, {CLIFF: [_rung(s, "r0")], STALL: [_rung(s, "s0")]},
                     verify_window=1000.0, budget_limit=1, budget_window=100.0)
        snt.fire(CLIFF, replica=1)
        snt.fire(STALL, replica=1)
        assert len(h.poll()) == 1 and h.actions_total == 1
        clk[0] = 150.0  # the budget window slides: the held kind acts
        assert len(h.poll()) == 1 and h.actions_total == 2
        return _snap(h)

    each(run)


def test_kwargs_only_apply_receives_escalate_by_keyword():
    def run(s):
        clk, clock = _fake_clock()
        snt = s.Sentinel(clock=clock)
        seen = {}

        def kw_apply(anomaly, **kw):
            seen.update(kw)

        h = s.Healer(snt, {CLIFF: [s.remediation.Remediation("kw", kw_apply)]})
        snt.fire(CLIFF)
        taken = h.poll()
        assert taken == [{"kind": CLIFF, "replica": None, "rung": 0, "action": "kw"}]
        assert callable(seen.get("escalate"))
        # a one-argument callable never gets a surprise second argument
        ok = s.remediation.Remediation("plain", lambda a: None)
        assert ok.apply(s.sentinel.Anomaly(CLIFF, "fire", 0.0), escalate=lambda r: None)
        return taken, sorted(seen)

    each(run)


def test_late_refire_after_verify_reject_restarts_at_rung_zero():
    """A rung kept alive by a verify-rejected resolve must not let a much
    later refire (a new incident) skip the cheap rungs."""
    def run(s):
        clk, clock = _fake_clock()
        snt = s.Sentinel(clock=clock)
        log = []
        r0 = s.remediation.Remediation("r0", lambda a: log.append("r0"), verify=lambda a: False)
        h = s.Healer(snt, {CLIFF: [r0, _rung(s, "r1", log)]}, verify_window=10.0)
        snt.fire(CLIFF)
        h.poll()
        clk[0] = 2.0
        snt.resolve(CLIFF)      # verify rejects: rung 0 stays active
        clk[0] = 500.0          # a long quiet: the next fire is a NEW incident
        snt.fire(CLIFF)
        assert _names(h.poll()) == ["r0"] and log == ["r0", "r0"]
        return _snap(h)

    each(run)


# -- parity: one scripted sequence, every observable --------------------------


SCRIPT = [
    # (clock, op, kind, replica): fire, resolve, poll, settle (the newest
    # enqueued reconfiguration is refused) or reset at that time
    (0.0, "fire", CLIFF, None), (0.0, "poll", None, None),
    (0.0, "fire", DEAD, 1), (0.0, "fire", STORM, 0), (1.0, "poll", None, None),
    (2.0, "resolve", CLIFF, None), (3.0, "poll", None, None),
    (4.0, "fire", CLIFF, None), (5.0, "poll", None, None), (9.0, "poll", None, None),
    (12.0, "resolve", DEAD, 1), (13.0, "fire", DEAD, 1), (14.0, "poll", None, None),
    (16.0, "settle", None, None), (16.0, "fire", STALL, 1), (17.0, "poll", None, None),
    (18.0, "resolve", CLIFF, None), (19.0, "fire", CLIFF, None),
    (21.0, "resolve", CLIFF, None), (22.0, "resolve", STORM, 0),
    (25.0, "fire", CLIFF, None), (26.0, "poll", None, None), (30.0, "poll", None, None),
    (31.0, "fire", STORM, 0), (32.0, "poll", None, None), (40.0, "poll", None, None),
    (41.0, "resolve", CLIFF, None), (42.0, "fire", CLIFF, None), (43.0, "poll", None, None),
    (50.0, "resolve", STALL, 1), (51.0, "poll", None, None),
    (61.0, "reset", CLIFF, None), (63.0, "poll", None, None), (80.0, "poll", None, None),
    (81.0, "resolve", CLIFF, None), (81.0, "resolve", DEAD, 1), (82.0, "poll", None, None),
]


def test_scripted_sequence_equals_jax():
    """JAX's Healer and the port's, each over its own package's Sentinel,
    through one scripted fire/resolve/clock sequence with stub rungs of
    every behaviour (plain, raising, inapplicable, refunded, enqueue-only
    with a refusal, a picky verify): every poll's actions, the deterministic
    trace's bytes (every ``healer/transition`` event), the transition
    counters, ``heal_log``, ``status()``, ``manifest()`` and the anomaly log
    are equal."""
    def run(s):
        clk, clock = _fake_clock()
        tick = itertools.count()
        tracer = s.trace.Tracer(deterministic=True, clock=lambda: float(next(tick)),
                                capacity=None)
        reg = s.registry()
        snt = s.Sentinel(clock=clock, tracer=tracer, registry=reg)
        futs, log, verdicts = [], [], itertools.cycle([False, True])

        def enqueue_only(anomaly, escalate=None):
            fut = Future()
            futs.append(fut)
            s.remediation._watch_reconfig(fut, escalate)

        R = s.remediation.Remediation
        ladders = {
            CLIFF: [_rung(s, "recover", log), R("grow", enqueue_only),
                    R("picky", lambda a: log.append("picky"), verify=lambda a: next(verdicts)),
                    _rung(s, "last", log)],
            DEAD: [_rung(s, "boom", fail=True), _rung(s, "nofleet", applies=False),
                   R("capped", lambda a: False), _rung(s, "excise", log)],
            STORM: [_rung(s, "pin", log)],
            STALL: [_rung(s, "s0", log)],
        }
        h = s.Healer(snt, ladders, verify_window=6.0, cooldown=3.0, flap_limit=2,
                     flap_window=30.0, budget_limit=4, budget_window=25.0, tracer=tracer)
        polls = []
        for at, op, kind, replica in SCRIPT:
            clk[0] = at
            if op == "fire":
                snt.fire(kind, replica=replica)
            elif op == "resolve":
                snt.resolve(kind, replica=replica)
            elif op == "reset":
                polls.append(("reset", h.reset(kind)))
            elif op == "settle":
                futs[-1].set_exception(s.reconfig.ReconfigError("refused", demand=9, supply=1))
            else:
                polls.append(h.poll())
        counters = {r: reg.counter("healer/transitions_total", labels={"reason": r}).value
                    for r in ("fire", "apply", "skip", "apply_error", "apply_failed_async",
                              "verify_timeout", "verify_rejected", "healed", "budget_held",
                              "flap_freeze", "exhausted_freeze", "reset")}
        # the script walks every transition the ladder has
        assert all(counters.values()), counters
        return (polls, log, counters, _snap(h), [a.to_dict() for a in snt.anomalies],
                tracer.to_bytes())

    polls, log, counters, snap, anomalies, trace_bytes = each(run)
    status = snap[0]
    assert {"ladders", "budget_in_window", "actions_total", "healed_total", "frozen_total",
            "heals"} <= set(status)
    assert b"healer/transition" in trace_bytes
