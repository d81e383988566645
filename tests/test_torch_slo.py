"""The live ops plane in the port, against JAX's: SLO burn-rate alerts, the
anomaly sentinel, the telemetry endpoints and the remediations.

The port's counterparts of JAX's ``tests/test_slo.py``:

- burn-rate semantics (an alert fires only when every window burns past its
  factor, resolves when one recovers), with the alert stream of a seeded run
  on a logical clock byte for byte JAX's; registry pulls (gauge, counter
  rate, windowed percentile, labeled instruments summed or merged) equal to
  JAX's values; ``status()`` safe against a ticking loop;
- the sentinel: every detector's fire, resolve and level-hold, the anomaly
  log byte for byte JAX's, remediation errors contained, a fire landing on
  the tracer, the flight recorder and the registry;
- the server loop: a requested recover rides the fault contract with token
  parity, real faults are noted on the sentinel, ``/metrics`` equals JAX's
  Prometheus text byte for byte for the same traffic, every endpoint
  answers over 127.0.0.1 on port 0, readiness drops after a give-up, and an
  injected latency cliff fires once, recovers and requeues with token
  parity through ``bind_default_remediations``, then resolves;
- the training side: the nonfinite-skip SLO and ``scale_storm`` fire at
  JAX's steps, and a run with both attached trains bitwise as one without;
- ``examples/slo_check.py`` replays a trace to the same reports as JAX's
  ``tools/slo_check.py``, and ``examples/bench_slo.py`` measures its ratio.

JAX's cases with no counterpart here: the fleet ``stats()`` snapshot
(replicas wait for ROADMAP.md item 5g); the ``tools/obs_report.py`` and
``bench_trend`` cases are in ``tests/test_torch_tools.py``.
"""

import importlib
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.estimator.config import RunConfig
from gradaccum_tpu_torch.estimator.estimator import Estimator, ModelBundle
from gradaccum_tpu_torch.interop import params_from_jax, params_tree
from gradaccum_tpu_torch.models import gpt as tgpt
from gradaccum_tpu_torch.models import gpt_decode as tdec
from gradaccum_tpu_torch.obs import flight as tflight
from gradaccum_tpu_torch.obs import metrics as tmetrics
from gradaccum_tpu_torch.obs import sentinel as tsentinel
from gradaccum_tpu_torch.obs import slo as tslo
from gradaccum_tpu_torch.obs import trace as ttrace
from gradaccum_tpu_torch.ops import accumulation as tacc
from gradaccum_tpu_torch.ops.adamw import sgd
from gradaccum_tpu_torch.ops.loss_scale import LossScaleConfig
from gradaccum_tpu_torch.resilience import faults as tfaults
from gradaccum_tpu_torch.resilience import preemption as tpreemption
from gradaccum_tpu_torch.resilience import remediation as tremediation
from gradaccum_tpu_torch.serving import Engine, ServingServer, SimulationDriver
from gradaccum_tpu_torch.serving.metrics import ServingMetrics
from gradaccum_tpu_torch.utils.timing import LatencySeries

jnp = importlib.import_module("jax.numpy")
jgpt = importlib.import_module("gradaccum_tpu.models.gpt")
jserving = importlib.import_module("gradaccum_tpu.serving")
jslo = importlib.import_module("gradaccum_tpu.obs.slo")
jsentinel = importlib.import_module("gradaccum_tpu.obs.sentinel")
jmetrics = importlib.import_module("gradaccum_tpu.obs.metrics")
jtrace = importlib.import_module("gradaccum_tpu.obs.trace")
jtiming = importlib.import_module("gradaccum_tpu.utils.timing")
jfaults = importlib.import_module("gradaccum_tpu.resilience.faults")
jest = importlib.import_module("gradaccum_tpu.estimator.estimator")
jconfig = importlib.import_module("gradaccum_tpu.estimator.config")
jacc = importlib.import_module("gradaccum_tpu.ops.accumulation")
jopt = importlib.import_module("gradaccum_tpu.ops.adamw")
jls = importlib.import_module("gradaccum_tpu.ops.loss_scale")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 120


@pytest.fixture(scope="module")
def lm():
    jcfg = jgpt.GPTConfig.tiny_for_tests(dropout=0.0)
    params = jgpt.gpt_lm_bundle(jcfg).init(jax.random.PRNGKey(0),
                                           {"input_ids": np.zeros((1, 8), np.int32)})
    tcfg = tgpt.GPTConfig.tiny_for_tests(dropout=0.0)
    model = tgpt.GPTLM(tcfg)
    model.load_state_dict(params_from_jax(jax.device_get(params["params"])))
    return jcfg, params, tcfg, params_tree(model)


def _engine(lm, **kw):
    _, _, tcfg, tree = lm
    return Engine(tree, tcfg, device="cpu", **kw)


def _solo(lm, prompt, n):
    _, _, tcfg, tree = lm
    return tdec.generate_cached(tree, tcfg, prompt, n)[0, len(prompt):].tolist()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


def _objective(mod, **overrides):
    kwargs = dict(name="t", metric="m", threshold=1.0, target=0.9,
                  windows=((10.0, 1.0), (4.0, 1.0)))
    kwargs.update(overrides)
    return mod.Objective(**kwargs)


# -- burn-rate semantics ------------------------------------------------------------


def test_alert_fires_only_when_every_window_burns():
    """The short window trips on a burst; the alert waits for the long
    window too, then resolves on recovery; the stream equals JAX's."""
    streams = []
    for mod in (tslo, jslo):
        ev = mod.SLOEvaluator([_objective(mod, windows=((20.0, 2.0), (4.0, 1.0)))],
                              clock=lambda: 0.0)
        for t in range(16):
            ev.observe("t", 0.5, now=float(t))
        ev.observe("t", 9.0, now=16.0)
        ev.observe("t", 9.0, now=17.0)
        assert ev.firing() == []  # a 2-bad burst: the long window holds
        for t in range(18, 26):
            ev.observe("t", 9.0, now=float(t))
        assert ev.firing() == ["t"]
        for t in range(26, 60):
            ev.observe("t", 0.5, now=float(t))
        assert ev.firing() == []
        assert [a["state"] for a in ev.alerts] == ["fire", "resolve"]
        streams.append(ev.alerts_bytes())
    assert streams[0] == streams[1]


def test_alert_stream_byte_identical_and_op_directions():
    def run(mod):
        ev = mod.SLOEvaluator([_objective(mod, name="hi", op="<="),
                               _objective(mod, name="lo", metric="m2", op=">=",
                                          threshold=5.0)], clock=lambda: 0.0)
        for t in range(40):
            bad = 10 <= t < 20
            ev.observe("hi", 9.0 if bad else 0.5, now=float(t))
            ev.observe("lo", 1.0 if bad else 9.0, now=float(t))
        return ev

    a, b = run(tslo), run(tslo)
    assert a.alerts_bytes() == b.alerts_bytes() == run(jslo).alerts_bytes()
    assert {x["slo"] for x in a.alerts} == {"hi", "lo"}
    assert a.alerts_bytes().startswith(b"[{")


def test_objective_validation_and_spec_roundtrip(tmp_path):
    with pytest.raises(ValueError, match="target"):
        _objective(tslo, target=1.0)
    with pytest.raises(ValueError, match="op"):
        _objective(tslo, op="<")
    with pytest.raises(ValueError, match="window"):
        _objective(tslo, windows=())
    with pytest.raises(ValueError, match="kind"):
        _objective(tslo, kind="median")
    o = _objective(tslo, event="req/queue")
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"objectives": [o.to_dict()]}))
    (loaded,) = tslo.load_spec(str(spec))
    assert loaded == o
    assert o.to_dict() == _objective(jslo, event="req/queue").to_dict()
    with pytest.raises(ValueError, match="objectives"):
        tslo.load_spec({"objectives": []})


def _pulled(mod, reg_mod, timing_mod):
    from_kind = mod.KIND_COUNTER_RATE, mod.KIND_PERCENTILE
    reg = reg_mod.MetricsRegistry()
    reg.gauge("depth").set(3.0)
    c = reg.counter("req_total")
    series = timing_mod.LatencySeries(window=8)
    reg.histogram("lat", series=series)
    ev = mod.SLOEvaluator(
        [_objective(mod, name="depth", metric="depth", threshold=10.0),
         _objective(mod, name="rate", metric="req_total", threshold=5.0, kind=from_kind[0]),
         _objective(mod, name="p99", metric="lat", threshold=1.0, kind=from_kind[1],
                    percentile=99.0)],
        registry=reg, clock=lambda: 0.0)
    for x in (0.1,) * 20 + (50.0,) * 8:  # the window forgets the cheap past
        series.add(x)
    ev.tick(now=0.0)  # primes the counter rate
    c.inc(30)
    ev.tick(now=10.0)
    return {n: t.last_value for n, t in ev.trackers.items()}


def test_evaluator_pulls_gauge_counter_rate_and_windowed_percentile():
    got = _pulled(tslo, tmetrics, sys.modules["gradaccum_tpu_torch.utils.timing"])
    assert got == _pulled(jslo, jmetrics, jtiming)
    assert got["depth"] == 3.0 and got["rate"] == pytest.approx(3.0)
    assert got["p99"] == pytest.approx(50.0)  # the window, not the whole run


def _fleet_pull(mod, reg_mod):
    reg = reg_mod.MetricsRegistry()
    counters = [reg.counter("tok_total", labels={"replica": str(r)}) for r in range(4)]
    hists = [reg.histogram("lat", labels={"replica": str(r)}) for r in range(2)]
    ev = mod.SLOEvaluator(
        [_objective(mod, name="rate", metric="tok_total", threshold=10.0, op=">=",
                    kind=mod.KIND_COUNTER_RATE),
         _objective(mod, name="p99", metric="lat", threshold=1.0,
                    kind=mod.KIND_PERCENTILE, percentile=99.0)],
        registry=reg, clock=lambda: 0.0)
    ev.tick(now=0.0)
    for c in counters:
        c.inc(30)
    hists[0].observe(0.5)
    hists[1].observe(9.0)
    ev.tick(now=10.0)
    return ev.trackers["rate"].last_value, ev.trackers["p99"].last_value


def test_evaluator_aggregates_labeled_fleet_instruments():
    """Labeled instruments of one family: counter rates sum, percentiles
    merge every instrument's samples, as JAX's."""
    got = _fleet_pull(tslo, tmetrics)
    assert got == _fleet_pull(jslo, jmetrics)
    assert got[0] == pytest.approx(12.0) and got[1] == pytest.approx(9.0 - 0.085)


def test_evaluator_status_safe_against_concurrent_ticks():
    ev = tslo.SLOEvaluator([_objective(tslo, windows=((8.0, 1.0), (2.0, 1.0)))],
                           clock=lambda: 0.0)
    stop = threading.Event()
    errors = []

    def reader():
        while not stop.is_set():
            try:
                ev.status(now=1e9)  # evicts aggressively while iterating
                ev.alerts_bytes()
                ev.firing()
            except Exception as e:  # noqa: BLE001 — the failure under test
                errors.append(e)
                return

    threads = [threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    for i in range(4000):
        ev.observe("t", 0.5 if i % 3 else 9.0, now=float(i))
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not errors, errors


def test_evaluator_tick_interval_throttles_pulls():
    reg = tmetrics.MetricsRegistry()
    reg.gauge("depth").set(3.0)
    ev = tslo.SLOEvaluator([_objective(tslo, name="d", metric="depth")], registry=reg,
                           clock=lambda: 0.0, interval=4)
    for t in range(12):
        ev.tick(now=float(t))
    assert ev.trackers["d"].samples == 3  # ticks 0, 4, 8
    with pytest.raises(ValueError, match="interval"):
        tslo.SLOEvaluator([], interval=0)
    with pytest.raises(ValueError, match="duplicate"):
        tslo.SLOEvaluator([_objective(tslo), _objective(tslo)])


def test_latency_series_window_edge():
    s = LatencySeries(window=10)
    s.extend(range(1, 11))
    assert s.percentiles((50,))["p50"] == pytest.approx(5.5)
    s.add(1000.0)  # the 11th sample evicts "1"
    assert len(s) == 10 and s.summary()["count"] == 10
    assert s.percentiles((50,))["p50"] == pytest.approx(6.5)
    c = LatencySeries()
    c.extend(range(1, 12))
    assert len(c) == 11
    with pytest.raises(ValueError):
        LatencySeries(window=0)


def test_serving_metrics_latency_window_bounds_slo_percentiles():
    m = ServingMetrics(latency_window=4)
    for i, rid in enumerate(range(8)):
        m.record_submit(rid)
        m.record_token(rid, first=True)
        m.ttft._xs[-1] = float(i)
    assert len(m.ttft) == 4 and m.queue_wait.window == 4
    _, h = m.registry.find("serving/ttft")
    assert h.series is m.ttft


def test_default_objective_sets_equal_jax():
    for got, want in ((tslo.default_serving_objectives(), jslo.default_serving_objectives()),
                      (tslo.default_training_objectives(),
                       jslo.default_training_objectives())):
        assert [o.to_dict() for o in got] == [o.to_dict() for o in want]


# -- the sentinel ----------------------------------------------------------------------


def test_sentinel_latency_cliff_fires_once_resolves_and_remediates():
    hits = []
    snt = tsentinel.Sentinel(clock=lambda: 0.0, cliff_warmup=4, cliff_consecutive=2)
    snt.on(tsentinel.LATENCY_CLIFF, lambda a: hits.append((a.kind, a.replica)))
    for i in range(8):
        snt.observe_tick(1e-3, now=float(i))
    snt.observe_tick(0.5, now=8.0)
    assert snt.firing() == []  # one slow tick is not a cliff
    for t in (9.0, 10.0, 11.0):
        snt.observe_tick(0.5, now=t)
    assert snt.firing() == [(tsentinel.LATENCY_CLIFF, None)]
    assert hits == [(tsentinel.LATENCY_CLIFF, None)]  # level-held
    snt.observe_tick(1e-3, now=12.0)
    assert snt.firing() == []
    assert [(a.kind, a.state) for a in snt.anomalies] == [
        (tsentinel.LATENCY_CLIFF, "fire"), (tsentinel.LATENCY_CLIFF, "resolve")]


def test_sentinel_cliff_samples_do_not_poison_baseline():
    snt = tsentinel.Sentinel(clock=lambda: 0.0, cliff_warmup=4, cliff_consecutive=2)
    for i in range(8):
        snt.observe_tick(1e-3, now=float(i))
    mean_before = snt._tick_base[None].mean
    for t in range(8, 20):
        snt.observe_tick(0.5, now=float(t))
    assert snt._tick_base[None].mean == mean_before


def test_sentinel_heartbeat_lease_distinguishes_slow_from_gone():
    S = tsentinel
    snt = S.Sentinel(clock=lambda: 0.0, lease=5.0)
    snt.heartbeat(tick=3, busy=True, now=0.0)
    snt.heartbeat(replica=1, tick=3, busy=True, now=0.0)
    snt.heartbeat(replica=2, tick=3, busy=False, now=0.0)  # idle: parked
    assert snt.check(now=4.0) == []
    fired = snt.check(now=6.0)
    assert {(a.kind, a.replica) for a in fired} == {(S.STALL, None), (S.DEAD_REPLICA, 1)}
    assert snt.check(now=7.0) == []  # level-held
    snt.heartbeat(replica=1, tick=4, busy=True, now=8.0)
    assert (S.DEAD_REPLICA, 1) not in snt.firing() and (S.STALL, None) in snt.firing()
    with snt.maintenance():  # a planned silence never expires a lease
        assert snt.check(now=100.0) == []
        snt.observe_tick(9.0, now=100.0)  # and feeds no baseline
    assert None not in snt._tick_base


def test_sentinel_scale_storm_and_drain_remediation():
    """A halving storm fires scale_storm, whose stock remediation requests
    a drain through the consensus (the SIGTERM path)."""
    snt = tsentinel.Sentinel(clock=lambda: 0.0, storm_halvings=3, storm_window=32.0)
    consensus = tpreemption.DrainConsensus(multiprocess=False)
    tremediation.bind_default_remediations(snt, consensus=consensus)
    assert consensus.decide(False, 0) == (False, 0)
    scale = 1024.0
    for t in range(6):
        snt.observe_scale(scale, now=float(2 * t))
        scale /= 2
    assert snt.firing() == [(tsentinel.SCALE_STORM, None)]
    assert consensus.decide(False, 7) == (True, 7)


def test_sentinel_fire_lands_tracer_event_flight_dump_and_counter(tmp_path):
    tracer = ttrace.Tracer(deterministic=True, capacity=None)
    reg = tmetrics.MetricsRegistry()
    recorder = tflight.FlightRecorder(str(tmp_path), tracer=tracer, registry=reg)
    snt = tsentinel.Sentinel(clock=lambda: 0.0, tracer=tracer, flight=recorder,
                             registry=reg, lease=1.0)
    snt.heartbeat(replica=0, tick=1, busy=True, now=0.0)
    snt.check(now=5.0)
    assert "sentinel/anomaly" in [e["name"] for e in tracer.snapshot()]
    dumps = tflight.list_dumps(str(tmp_path))
    assert len(dumps) == 1 and "sentinel-dead_replica" in dumps[0]
    assert tflight.load_dump(dumps[0])["extra"]["kind"] == "dead_replica"
    assert reg.snapshot()["counters"]['sentinel/anomalies_total{kind="dead_replica"}'] == 1


def test_sentinel_remediation_errors_are_contained():
    tracer = ttrace.Tracer(deterministic=True, capacity=None)
    ran = []
    snt = tsentinel.Sentinel(clock=lambda: 0.0, tracer=tracer, lease=1.0)
    snt.on(tsentinel.STALL, lambda a: (_ for _ in ()).throw(RuntimeError("boom")))
    snt.on("*", lambda a: ran.append(a.kind))
    snt.heartbeat(tick=1, busy=True, now=0.0)
    assert [a.kind for a in snt.check(now=5.0)] == [tsentinel.STALL]  # no raise
    assert ran == [tsentinel.STALL]
    errors = [e["args"].get("error") for e in tracer.snapshot()
              if e["name"] == "sentinel/remediation"]
    assert "RuntimeError" in errors
    with pytest.raises(ValueError, match="unknown anomaly kind"):
        snt.on("nope", print)


def _anomaly_log(mod):
    snt = mod.Sentinel(clock=lambda: 0.0, cliff_warmup=4, cliff_consecutive=2, lease=4.0,
                       accept_warmup=2, accept_consecutive=2, preempt_warmup=2,
                       preempt_consecutive=2, thrash_warmup=2, thrash_consecutive=2)
    for t in range(8):
        snt.observe_tick(1e-3, now=float(t))
        snt.heartbeat(tick=t, busy=True, now=float(t))
    for t in range(8, 12):
        snt.observe_tick(0.75, now=float(t))
    for t in range(12, 18):
        snt.observe_accept(0.01, replica=1, now=float(t))
        snt.observe_preemptions(0.9, replica=2, now=float(t))
        snt.observe_tier_spills(3.0, now=float(t))
        snt.observe_scale(2.0 ** (10 - t), now=float(t))
    snt.note_fault(error="InjectedCrash", now=18.0)
    snt.ack(tsentinel.LATENCY_CLIFF if mod is tsentinel else jsentinel.LATENCY_CLIFF,
            now=19.0)
    snt.observe_tick(1e-3, now=19.5)
    snt.check(now=20.0)
    snt.observe_accept(0.9, replica=1, now=21.0)
    snt.heartbeat(tick=21, busy=True, now=21.0)
    return snt.anomalies_bytes(), sorted(snt.firing(), key=repr)


def test_sentinel_anomaly_log_byte_identical():
    """Every detector fires, acks and resolves: the log is byte for byte
    equal across runs and to JAX's."""
    got = _anomaly_log(tsentinel)
    assert got == _anomaly_log(tsentinel) == _anomaly_log(jsentinel)
    kinds = {r["kind"] for r in json.loads(got[0])}
    assert kinds == {"latency_cliff", "degenerate_draft", "preemption_storm", "tier_thrash",
                     "scale_storm", "engine_fault", "stall"}
    assert tsentinel.KINDS == jsentinel.KINDS and tsentinel.SEVERITY == jsentinel.SEVERITY


def test_sentinel_hooks_off_and_background_checker():
    """on_resolve sees the resolve; off detaches; the background checker
    fires a lease expiry with no feeder calling ``check``."""
    snt = tsentinel.Sentinel(lease=0.05, check_interval=0.01)
    resolved, fired = [], []
    snt.on_resolve(tsentinel.STALL, resolved.append)
    snt.on(tsentinel.STALL, fired.append)
    snt.off(tsentinel.STALL, fired.append)
    snt.heartbeat(tick=0, busy=True)
    snt.start()
    try:
        deadline = time.monotonic() + 10
        while not snt.is_firing(tsentinel.STALL) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert snt.is_firing(tsentinel.STALL) and fired == []
        snt.heartbeat(tick=1, busy=False)
        assert [a.state for a in resolved] == ["resolve"]
    finally:
        snt.stop()
    assert snt.status()["anomalies"] == 2


# -- the server loop -----------------------------------------------------------------------


def test_request_recover_requeues_with_token_parity(lm):
    """A recover request mid-stream: the in-flight request rides the fault
    contract and still equals ``generate_cached``."""
    tracer = ttrace.Tracer(capacity=None)
    engine = _engine(lm, num_slots=2, max_len=64, tracer=tracer)
    prompt = np.asarray([3, 1, 4, 1, 5], np.int32)
    with ttrace.installed(tracer):
        server = ServingServer(engine, max_requeues=2)
        handle = server.submit(prompt, 16)
        engine.step()  # mid-stream: one tick in
        server.request_recover("test:latency_cliff")
        server.request_recover("a second nudge while one is pending")
        server.start()
        tokens, reason = handle.result(timeout=WAIT)
        server.stop()
    assert (tokens, reason) == (_solo(lm, prompt, 16), "length")
    events = tracer.snapshot()
    assert "serve/recover" in [e["name"] for e in events]
    faults = [e for e in events if e["name"] == "serve/engine_fault"]
    assert [e["args"]["error"] for e in faults] == ["SentinelRemediation"]


def test_server_notes_real_faults_on_sentinel(lm):
    engine = _engine(lm, num_slots=2, max_len=32)
    snt = tsentinel.Sentinel()
    schedule = tfaults.FaultSchedule([tfaults.FaultSpec(tfaults.MID_DECODE_TICK, at=1)])
    prompt = np.asarray([1, 2, 3], np.int32)
    with tfaults.installed(tfaults.FaultInjector(schedule)):
        server = ServingServer(engine, max_requeues=2, sentinel=snt)
        handle = server.submit(prompt, 5)
        server.start()
        tokens, reason = handle.result(timeout=WAIT)
        server.stop()
    assert (tokens, reason) == (_solo(lm, prompt, 5), "length")
    fired = [a for a in snt.anomalies if a.state == "fire"]
    assert [a.kind for a in fired] == [tsentinel.ENGINE_FAULT]
    assert fired[0].detail["error"] == "InjectedCrash"


def _metrics_text(lm, port: bool):
    """/metrics of a server over an engine that replayed a seeded trace on
    the tick clock."""
    jcfg, params, tcfg, tree = lm
    if port:
        engine, server_cls = Engine(tree, tcfg, num_slots=2, max_len=32, device="cpu"), \
            ServingServer
        driver_cls = SimulationDriver
    else:
        engine, server_cls = jserving.Engine(params, jcfg, num_slots=2, max_len=32), \
            jserving.ServingServer
        driver_cls = jserving.SimulationDriver
    driver = driver_cls(engine, seed=4)
    driver.run(driver.make_trace(6, arrival_rate=0.7))
    server = server_cls(engine, telemetry_port=0).start()
    try:
        status, body = _get(server.telemetry.url("/metrics"))
    finally:
        server.stop()
    assert status == 200
    return body


def test_metrics_endpoint_prometheus_text_equals_jax(lm):
    got = _metrics_text(lm, port=True)
    assert got == _metrics_text(lm, port=False)
    assert "# HELP" in got and "serving_tokens_emitted_total" in got


def test_telemetry_endpoints_through_serving_server(lm):
    engine = _engine(lm, num_slots=2, max_len=32)
    server = ServingServer(engine, sentinel=tsentinel.Sentinel(),
                           slo=tslo.SLOEvaluator(tslo.default_serving_objectives()),
                           telemetry_port=0).start()
    try:
        tel = server.telemetry
        assert tel is not None and tel.port and tel.url("/x").startswith("http://127.0.0.1:")
        server.submit(np.asarray([1, 2, 3], np.int32), 4).result(timeout=WAIT)
        status, body = _get(tel.url("/metrics"))
        assert status == 200 and "# TYPE" in body and "serving_tokens_emitted_total" in body
        status, body = _get(tel.url("/healthz"))
        assert status == 200 and json.loads(body)["ok"] is True
        status, body = _get(tel.url("/readyz"))
        ready = json.loads(body)
        assert status == 200 and ready["draining"] is False
        assert ready["anomalies_firing"] == []
        varz = json.loads(_get(tel.url("/varz"))[1])
        assert varz["num_slots"] == 2 and varz["metrics"]["tokens_emitted"] == 4
        names = {e["name"] for e in json.loads(_get(tel.url("/trace"))[1])["traceEvents"]}
        assert {"serve/tick", "req/decode"} <= names
        assert "serve/ttft_p99" in json.loads(_get(tel.url("/slo"))[1])["objectives"]
        assert json.loads(_get(tel.url("/sentinel"))[1])["firing"] == []
        assert _get(tel.url("/"))[1].split() == ["/metrics", "/healthz", "/readyz", "/varz",
                                                 "/trace", "/slo", "/sentinel"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(tel.url("/nope"))
        assert e.value.code == 404
        url = tel.url("/healthz")
    finally:
        server.stop()
    assert server.telemetry is None  # the ops plane went down with stop()
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(url, timeout=2)


def test_readiness_flips_on_fault_giveup(lm):
    """A server that exhausted its fault budget answers 503 on both probes."""
    engine = _engine(lm, num_slots=1, max_len=32)
    schedule = tfaults.FaultSchedule(
        [tfaults.FaultSpec(tfaults.MID_DECODE_TICK, at=None, count=4)])
    with tfaults.installed(tfaults.FaultInjector(schedule)):
        server = ServingServer(engine, max_requeues=5, max_engine_faults=1,
                               telemetry_port=0).start()
        tel = server.telemetry
        assert _get(tel.url("/readyz"))[0] == 200
        handle = server.submit(np.asarray([1, 2], np.int32), 4)
        with pytest.raises(RuntimeError):
            handle.result(timeout=WAIT)
        for probe in ("/healthz", "/readyz"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(tel.url(probe))
            assert e.value.code == 503, probe
        with pytest.raises(RuntimeError):
            server.stop()


class _TickTime:
    """The server module's clock for the cliff case: every read advances 1 ms
    and a slowed tick adds 1 s, so the tick durations the sentinel sees do
    not depend on the host's load. ``sleep`` is the real one."""

    def __init__(self):
        self.now = 0.0
        self.lock = threading.Lock()
        self.sleep = time.sleep

    def monotonic(self):
        with self.lock:
            self.now += 1e-3
            return self.now


def test_latency_cliff_remediation_recovers_and_resolves(lm, monkeypatch):
    """A latency cliff (two slowed ticks past a warmed baseline) fires
    ``latency_cliff`` once; ``bind_default_remediations`` recovers and
    requeues through the fault contract with token parity, and the anomaly
    resolves once ticks return to baseline. The sentinel runs on the tick
    clock and reads tick durations from a clock the test drives."""
    from gradaccum_tpu_torch.serving import server as server_mod

    clock = _TickTime()
    monkeypatch.setattr(server_mod, "time", clock)
    engine = _engine(lm, num_slots=2, max_len=64)
    snt = tsentinel.Sentinel(clock=lambda: float(engine.tick_count), cliff_warmup=4,
                             cliff_consecutive=2, cliff_score=50.0)
    tracer = ttrace.Tracer(capacity=None)
    prompts = [np.asarray([3, 1, 4, 1, 5], np.int32), np.asarray([2, 7, 1], np.int32)]
    plain = engine.step

    def step():
        if engine.tick_count in (8, 9):  # the cliff: two slow ticks
            with clock.lock:
                clock.now += 1.0
        return plain()

    engine.step = step
    with ttrace.installed(tracer):
        server = ServingServer(engine, max_requeues=2, sentinel=snt)
        tremediation.bind_default_remediations(snt, server=server)
        handles = [server.submit(p, 24) for p in prompts]
        server.start()
        results = [h.result(timeout=WAIT) for h in handles]
        server.stop()
    for p, (toks, reason) in zip(prompts, results):
        assert (toks, reason) == (_solo(lm, p, 24), "length")
    states = [(a.kind, a.state) for a in snt.anomalies]
    assert states == [("latency_cliff", "fire"), ("latency_cliff", "resolve")]
    assert snt.anomalies[0].at == 10.0  # the second slow tick's clock
    names = [e["name"] for e in tracer.snapshot()]
    assert names.count("serve/recover") == 1 and names.count("req/requeue") == 2
    remedies = [e["args"] for e in tracer.snapshot() if e["name"] == "sentinel/remediation"]
    assert [r["action"] for r in remedies] == ["recover_and_requeue"]


def test_remediation_matrix_and_preemption_storm_routes_to_recover():
    """The stock matrix binds the server kinds and the drain; a preemption
    storm on replica 1 asks the server for a recover naming it."""
    recovers = []

    class FakeServer:
        def request_recover(self, reason, replica=None):
            recovers.append((reason, replica))

    snt = tsentinel.Sentinel(preempt_warmup=2, preempt_consecutive=2, preempt_ceiling=0.5)
    tremediation.bind_default_remediations(snt, server=FakeServer())
    assert sorted(snt._remedies) == sorted(["latency_cliff", "stall", "dead_replica",
                                            "preemption_storm", "tier_thrash"])
    for _ in range(4):
        snt.observe_preemptions(0.9, replica=1)
    assert recovers == [("sentinel:preemption_storm replica 1", 1)]


# -- the training side -----------------------------------------------------------------------


class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(3, 1))


def _train(port: bool, tmp_path, specs, slos=None, sentinel=None, loss_scale=False,
           max_steps=32):
    """A streaming regression run with the guard under a PRE_TRAIN_STEP fault
    schedule ``specs`` ((at, kind) pairs); log cadence 1 so every step
    flushes. Returns the Estimator."""
    rng = np.random.default_rng(0)
    batches = [{"x": rng.normal(size=(4, 3)).astype(np.float32),
                "y": rng.normal(size=(4, 1)).astype(np.float32)} for _ in range(max_steps)]
    accum = dict(num_micro_batches=4, skip_nonfinite=True)
    f = tfaults if port else jfaults
    if port:
        if loss_scale:
            accum["loss_scale"] = LossScaleConfig(init_scale=1024.0, growth_interval=1000)
        bundle = ModelBundle(init=lambda seed, device: _Linear().to(device),
                             loss=lambda m, b: torch.mean((b["x"] @ m.w - b["y"]) ** 2),
                             predict=lambda m, b: {"predictions": b["x"] @ m.w},
                             eval_metrics={})
        est = Estimator(bundle, sgd(0.1), tacc.GradAccumConfig(**accum),
                        RunConfig(model_dir=str(tmp_path), log_step_count_steps=1, slos=slos,
                                  sentinel=sentinel), mode="streaming", device="cpu")
    else:
        if loss_scale:
            accum["loss_scale"] = jls.LossScaleConfig(init_scale=1024.0,
                                                      growth_interval=1000)
        bundle = jest.ModelBundle(
            init=lambda r, s: {"w": jnp.zeros((3, 1))},
            loss=lambda p, b: jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2),
            predict=lambda p, b: {"predictions": b["x"] @ p["w"]}, eval_metrics={})
        est = jest.Estimator(bundle, jopt.sgd(0.1), jacc.GradAccumConfig(**accum),
                             jconfig.RunConfig(model_dir=str(tmp_path), log_step_count_steps=1,
                                               slos=slos, sentinel=sentinel),
                             mode="streaming")
    schedule = f.FaultSchedule([f.FaultSpec(f.PRE_TRAIN_STEP, at=at, kind=kind)
                                for at, kind in specs])
    with f.installed(f.FaultInjector(schedule)):
        est.train(batches, max_steps=max_steps)
    est.close()
    return est


def test_estimator_training_slo_fires_on_nonfinite_skip_storm(tmp_path):
    """A poisoned-batch storm burns the nonfinite-skip budget: the training
    SLO fires on the step clock at JAX's step, with JAX's alert stream."""
    specs = [(i, "nan") for i in range(8, 20)]
    streams = []
    for port, mod in ((True, tslo), (False, jslo)):
        slos = mod.SLOEvaluator(mod.default_training_objectives(
            skip_rate=0.5, windows=((8.0, 1.0), (4.0, 1.0))), clock=lambda: 0.0)
        est = _train(port, tmp_path / str(port), specs, slos=slos)
        assert est.nonfinite_skips >= 8
        fires = [a for a in slos.alerts if a["state"] == "fire"]
        assert [a["slo"] for a in fires] == ["train/nonfinite_skip_rate"]
        assert all(float(a["at"]).is_integer() for a in slos.alerts)  # the step clock
        streams.append(slos.alerts_bytes())
    assert streams[0] == streams[1]


def test_scale_storm_fires_at_jax_s_step(tmp_path):
    """An overflow storm halves the dynamic loss scale step after step: the
    sentinel fed from the loss-scale rows fires ``scale_storm`` at JAX's
    step, with JAX's anomaly log."""
    specs = [(i, "inf") for i in range(4, 20)]
    logs = []
    for port, mod in ((True, tsentinel), (False, jsentinel)):
        snt = mod.Sentinel(clock=lambda: 0.0, storm_halvings=3, storm_window=16.0)
        est = _train(port, tmp_path / str(port), specs, sentinel=snt, loss_scale=True)
        assert est.nonfinite_skips >= 16
        fires = [a for a in snt.anomalies if a.state == "fire"]
        assert [a.kind for a in fires] == ["scale_storm"]
        logs.append(snt.anomalies_bytes())
    assert logs[0] == logs[1]


def test_ops_plane_leaves_training_bitwise_unchanged(tmp_path):
    """A run with ``slos`` and ``sentinel`` attached trains bitwise as one
    without them: loss rows, loss-scale series and weights."""
    specs = [(i, "inf") for i in range(6, 9)]
    runs = []
    for attach in (False, True):
        kw = {}
        if attach:
            kw = dict(slos=tslo.SLOEvaluator(tslo.default_training_objectives()),
                      sentinel=tsentinel.Sentinel())
        d = tmp_path / str(attach)
        est = _train(True, d, specs, loss_scale=True, **kw)
        with open(os.path.join(d, "loss_vs_step.csv")) as f:
            losses = f.read()
        runs.append((losses, est.loss_scale_series,
                     {k: v.detach().numpy().tobytes() for k, v in est._state.params.items()}))
    assert runs[0] == runs[1] and runs[0][0]


# -- the examples -----------------------------------------------------------------------------


def test_slo_check_replays_trace_to_jax_s_report(lm, tmp_path):
    """A deterministic trace of a seeded run, replayed through the port's
    slo_check and JAX's: the same reports, the same gate."""
    sys.path.insert(0, os.path.join(_REPO, "tools"))
    import slo_check as jslo_check

    from gradaccum_tpu_torch.examples import slo_check

    jcfg, params, tcfg, tree = lm
    reports = {}
    for port in (True, False):
        trace_mod = ttrace if port else jtrace
        tracer = trace_mod.Tracer(deterministic=True, capacity=None)
        engine = (Engine(tree, tcfg, num_slots=4, max_len=32, tracer=tracer, device="cpu")
                  if port else jserving.Engine(params, jcfg, num_slots=4, max_len=32,
                                               tracer=tracer))
        driver = (SimulationDriver if port else jserving.SimulationDriver)(engine, seed=3)
        driver.run(driver.make_trace(8, arrival_rate=0.6))
        path = tracer.export(str(tmp_path / f"trace_{port}.json"))
        spec = tmp_path / "spec.json"
        spec.write_text(json.dumps({"objectives": [{
            "name": "queue_wait_p99", "metric": "serving/queue_wait", "threshold": 50.0,
            "target": 0.9, "windows": [[64.0, 1.0], [16.0, 1.0]], "event": "req/queue"}]}))
        out = tmp_path / f"report_{port}.json"
        main = slo_check.main if port else jslo_check.main
        assert main([path, "--spec", str(spec), "--json", str(out)]) == 0
        reports[port] = json.loads(out.read_text())["objectives"]
        strict = tmp_path / "strict.json"
        strict.write_text(json.dumps({"objectives": [{
            "name": "queue_wait_p99", "metric": "serving/queue_wait", "threshold": -1.0,
            "target": 0.9, "windows": [[64.0, 1.0], [16.0, 1.0]], "event": "req/queue"}]}))
        assert main([path, "--spec", str(strict)]) == 1
    assert reports[True] == reports[False]
    assert reports[True]["queue_wait_p99"]["samples"] == 8
    assert slo_check.main(["--selftest"]) == 0


def test_bench_slo_fast_measures_the_ratio(tmp_path):
    """``bench_slo --fast`` on the CPU: the baseline, the ops plane's cost
    and the ratio JAX gates at 1.02 (gated on the card by chip_smoke.py;
    a shared CPU's wall time is not gated here)."""
    from gradaccum_tpu_torch.examples import bench_slo

    out = tmp_path / "slo.json"
    result = bench_slo.main(["--fast", "--device", "cpu", "--out", str(out)])
    serve = result["serve"]
    assert serve["baseline_s_per_tick"] > 0 and serve["ops_plane_s_per_tick"] > 0
    assert serve["overhead_ratio"] == 1.0 + serve["ops_plane_s_per_tick"] / \
        serve["baseline_s_per_tick"]
    assert result["acceptance"]["passed"] == (serve["overhead_ratio"] <= bench_slo.GATE)
    assert json.loads(out.read_text())["overhead"]["serve"] == serve["overhead_ratio"]
