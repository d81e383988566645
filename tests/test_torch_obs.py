"""The port's observability layer held against JAX's.

- Trace determinism, byte for byte: two seeded training runs under a
  logical clock export identical trace JSON, and the port's trace of a run
  equals JAX's trace of the same run (spans, guard and loss-scale events,
  injected faults, the drain), in streaming mode with the first-step quirk
  (the ``apply``/``accumulate`` labels) and in scan mode (``scan-cycle``).
- The tracer's own contract: the kill switch, an installed tracer winning
  over it, the bounded ring, Chrome JSON equal to JAX's for the same calls.
- The registry: snapshot and Prometheus text byte-equal to JAX's for the
  same operations (labels, escaping, help, families), type conflicts.
- ``LatencySeries``: percentiles and summaries equal JAX's, windowed too.
- The flight recorder: numbering, rotation and readers as JAX's; a crash
  dump holds the fault, the steps leading in and the loss gauge.
"""

import importlib
import itertools

import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.estimator.config import RunConfig
from gradaccum_tpu_torch.estimator.estimator import Estimator, ModelBundle
from gradaccum_tpu_torch.obs import flight, metrics, trace
from gradaccum_tpu_torch.ops import accumulation as acc
from gradaccum_tpu_torch.ops.adamw import sgd
from gradaccum_tpu_torch.ops.loss_scale import LossScaleConfig
from gradaccum_tpu_torch.resilience import faults, preemption
from gradaccum_tpu_torch.utils import timing

jax = pytest.importorskip("jax")
jnp = importlib.import_module("jax.numpy")
jtrace = importlib.import_module("gradaccum_tpu.obs.trace")
jmetrics_reg = importlib.import_module("gradaccum_tpu.obs.metrics")
jflight = importlib.import_module("gradaccum_tpu.obs.flight")
jtiming = importlib.import_module("gradaccum_tpu.utils.timing")
jfaults = importlib.import_module("gradaccum_tpu.resilience.faults")
jpreemption = importlib.import_module("gradaccum_tpu.resilience.preemption")
jest = importlib.import_module("gradaccum_tpu.estimator.estimator")
jconfig = importlib.import_module("gradaccum_tpu.estimator.config")
jacc = importlib.import_module("gradaccum_tpu.ops.accumulation")
jopt = importlib.import_module("gradaccum_tpu.ops.adamw")
jls = importlib.import_module("gradaccum_tpu.ops.loss_scale")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

K = 4


class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(3, 1))


def _bundle():
    return ModelBundle(
        init=lambda seed, device: _Linear().to(device),
        loss=lambda m, b: torch.mean((b["x"] @ m.w - b["y"]) ** 2),
        predict=lambda m, b: {"predictions": b["x"] @ m.w}, eval_metrics={})


def _jax_bundle():
    return jest.ModelBundle(
        init=lambda rng, s: {"w": jnp.zeros((3, 1))},
        loss=lambda p, b: jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2),
        predict=lambda p, b: {"predictions": b["x"] @ p["w"]}, eval_metrics={})


def _batches(n, rows):
    rng = np.random.default_rng(0)
    return [{"x": rng.normal(size=(rows, 3)).astype(np.float32),
             "y": rng.normal(size=(rows, 1)).astype(np.float32)} for _ in range(n)]


# with the guard and a dynamic loss scale on, so that the flushes emit events
FAULTS = [("pre", 5, "nan"), ("pre", 9, "inf"), ("pre", 10, "inf"), ("pre", 11, "inf"),
          ("pre", 12, "inf")]


def _run(port: bool, tmp_path, mode="streaming", guarded=True, drain_at=None,
         crash_at=None, max_steps=24):
    """One seeded run under a deterministic tracer with a logical clock (one
    tick per clock read); returns the tracer and the Estimator."""
    tick = itertools.count()
    tr_mod, f_mod, p_mod = (trace, faults, preemption) if port else (jtrace, jfaults,
                                                                     jpreemption)
    tracer = tr_mod.Tracer(deterministic=True, clock=lambda: float(next(tick)),
                           capacity=None)
    accum = dict(num_micro_batches=K, first_step_quirk=True)
    if guarded:
        ls_cls = LossScaleConfig if port else jls.LossScaleConfig
        accum.update(skip_nonfinite=True, loss_scale=ls_cls(init_scale=16.0,
                                                            growth_interval=2))
    rows = 4 * (K if mode == "scan" else 1)
    data = _batches(max_steps // (K if mode == "scan" else 1), rows)
    run = dict(model_dir=str(tmp_path), save_checkpoints_steps=8, log_step_count_steps=6)
    if port:
        est = Estimator(_bundle(), sgd(0.1), acc.GradAccumConfig(**accum), RunConfig(**run),
                        mode=mode, device="cpu")
    else:
        est = jest.Estimator(_jax_bundle(), jopt.sgd(0.1), jacc.GradAccumConfig(**accum),
                             jconfig.RunConfig(**run), mode=mode)
    points = {"pre": f_mod.PRE_TRAIN_STEP, "post": f_mod.POST_TRAIN_STEP}
    specs = [f_mod.FaultSpec(points[p], at=at, kind=kind) for p, at, kind in FAULTS]
    if crash_at is not None:
        specs.append(f_mod.FaultSpec(f_mod.POST_TRAIN_STEP, at=crash_at))
    handler = p_mod.PreemptionHandler()

    def stream():
        for i, b in enumerate(data):
            if drain_at is not None and i == drain_at:
                handler.trigger()
            yield b

    with tr_mod.installed(tracer), f_mod.installed(f_mod.FaultInjector(
            f_mod.FaultSchedule(specs if guarded else specs[len(FAULTS):]))), handler:
        try:
            est.train(stream(), max_steps=max_steps)
        except f_mod.InjectedCrash:
            pass
    est.close()
    return tracer, est


@pytest.mark.parametrize("mode", ["streaming", "scan"])
def test_trace_is_byte_identical_across_seeded_runs_and_equal_to_jax(tmp_path, mode):
    one, est = _run(True, tmp_path / "a", mode)
    two, _ = _run(True, tmp_path / "b", mode)
    assert one.to_bytes() == two.to_bytes()
    want, jes = _run(False, tmp_path / "j", mode)
    assert one.to_bytes() == want.to_bytes()
    assert est.loss_scale_series == jes.loss_scale_series and est.nonfinite_skips > 0
    names = {e["name"] for e in one.snapshot()}
    assert {"train/step", "fault/injected", "train/nonfinite_skip",
            "train/loss_scale", "train/guard_verdict"} <= names


def test_train_step_span_labels_follow_the_streaming_quirk(tmp_path):
    tracer, _ = _run(True, tmp_path, guarded=False, max_steps=8)
    branches = [e["args"]["branch"] for e in tracer.snapshot() if e["name"] == "train/step"]
    # K=4 with the first-step quirk: the reference applies at step % 4 == 0
    assert branches == ["apply", "accumulate", "accumulate", "accumulate"] * 2
    scan, _ = _run(True, tmp_path / "s", mode="scan", guarded=False, max_steps=8)
    assert [e["args"]["branch"] for e in scan.snapshot()
            if e["name"] == "train/step"] == ["scan-cycle"] * 2


def test_drain_trace_equals_jax(tmp_path):
    got, est = _run(True, tmp_path / "t", guarded=False, drain_at=6)
    want, jes = _run(False, tmp_path / "j", guarded=False, drain_at=6)
    # the signal lands while batch 6 is fetched: the poll before step 7 sees it
    assert est.drained_at_step == jes.drained_at_step == 7
    assert got.to_bytes() == want.to_bytes()
    assert [e["args"] for e in got.snapshot() if e["name"] == "preemption/drain"] == \
        [{"step": 7, "target": 7, "seq": 7}]


def test_crash_dumps_flight_record_with_fault_steps_and_loss(tmp_path):
    _run(True, tmp_path, guarded=False, crash_at=7, max_steps=8)  # after the flush at 6
    dumps = flight.list_dumps(str(tmp_path))
    assert len(dumps) == 1
    payload = flight.load_dump(dumps[0])
    assert payload["reason"] == "crash"
    assert flight.fault_events(payload["events"]) == [("post_train_step", 7, "crash")]
    assert len([e for e in payload["events"] if e["name"] == "train/step"]) == 7
    assert payload["metrics"]["gauges"]["loss"]["value"] is not None


def test_estimator_registry_rebinds_writer_after_close(tmp_path):
    _, est = _run(True, tmp_path, guarded=False, max_steps=4)
    assert est.registry._writer is est.events
    est.close()  # detaches the writer; the next access recreates it
    assert est.registry._writer is est.events
    est.close()


# -- the tracer ---------------------------------------------------------------


def _emit(mod):
    tick = itertools.count()
    tr = mod.Tracer(deterministic=True, clock=lambda: float(next(tick)) / 7, capacity=5)
    with tr.span("a", cat="x", step=1) as sp:
        sp.set(extra="y")
    try:
        with tr.span("boom"):
            raise KeyError("k")
    except KeyError:
        pass
    for i in range(4):
        tr.event("e", cat="c", i=i, f=0.5 * i)
    tr.complete("late", 0.25, cat="q", n=3)
    return tr


def test_tracer_json_equals_jax_for_the_same_calls():
    got, want = _emit(trace), _emit(jtrace)
    assert got.to_bytes() == want.to_bytes()
    assert got.dropped == want.dropped == 2
    assert [e["name"] for e in got.snapshot()] == ["e", "e", "e", "e", "late"]


def test_kill_switch_and_installed_tracer(monkeypatch):
    monkeypatch.setenv("GRADACCUM_OBS", "0")
    assert trace.get_tracer() is trace.NULL and not trace.obs_enabled()
    assert trace.NULL.span("x").__enter__() is not None and trace.NULL.snapshot() == []
    mine = trace.Tracer()
    with trace.installed(mine):
        assert trace.get_tracer() is mine  # an explicit tracer wins
    assert trace.get_tracer() is trace.NULL
    monkeypatch.setenv("GRADACCUM_OBS", "1")
    assert trace.get_tracer().enabled


# -- the registry ---------------------------------------------------------------


def _fill(mod, timing_mod):
    reg = mod.MetricsRegistry()
    reg.counter("requests_total", help="total cache hits\nsecond line").inc()
    reg.counter("requests_total").inc(2)
    reg.gauge("depth", labels={"mesh": 'model="2",\\dp\n4'}).set(3, step=7)
    for rep in ("0", "1"):
        reg.counter("train/tokens_total", labels={"replica": rep}).inc(5)
        reg.gauge("train/queue-depth", labels={"replica": rep}).set(2.5)
        reg.histogram("train/lat", labels={"replica": rep}).observe(0.5)
    series = timing_mod.LatencySeries()
    series.extend([0.1, 0.4, 0.2, 0.9])
    reg.histogram("ttft", series=series)
    reg.publish({"loss": 1.25, "nonfinite_skips": 3}, step=4)
    reg.gauge("never_set")
    return reg


def test_registry_snapshot_and_prometheus_equal_jax():
    got, want = _fill(metrics, timing), _fill(jmetrics_reg, jtiming)
    assert got.to_prometheus() == want.to_prometheus()
    assert got.snapshot() == want.snapshot()
    assert metrics.MetricsRegistry().to_prometheus() == ""
    with pytest.raises(ValueError, match="different type"):
        got.counter("depth", labels={"replica": "0"})
    assert got.find("train/lat")[0] == "histogram"
    assert len(got.find_all("train/tokens_total")[1]) == 2


# -- LatencySeries ----------------------------------------------------------------


@pytest.mark.parametrize("window", [None, 7])
def test_latency_series_equals_jax(window):
    xs = np.random.default_rng(5).exponential(size=41)
    got, want = timing.LatencySeries(window), jtiming.LatencySeries(window)
    assert got.summary() == want.summary()  # empty
    got.extend(xs)
    want.extend(xs)
    assert got.summary() == want.summary()
    assert got.percentiles((10, 50, 95, 99.9)) == want.percentiles((10, 50, 95, 99.9))
    assert got.samples() == want.samples() and len(got) == len(want)
    s = timing.LatencySeries()
    s.extend(range(1, 101))
    assert s.summary()["p90"] == pytest.approx(90.1)


def test_time_device_steps_on_the_cpu():
    state = acc.streaming_init({"w": torch.zeros(3, 1, requires_grad=True)}, sgd(0.1))
    step = acc.streaming_step(lambda p, b: torch.mean((b["x"] @ p["w"] - b["y"]) ** 2),
                              sgd(0.1), acc.GradAccumConfig(K))
    batch = {k: torch.as_tensor(v) for k, v in _batches(1, 4)[0].items()}
    per_step, state = timing.time_device_steps(step, state, (batch,), iters=10)
    assert per_step > 0 and state.step == 12


# -- the flight recorder ------------------------------------------------------------


@pytest.mark.parametrize("mod", ["port", "jax"])
def test_flight_recorder_numbering_and_rotation(tmp_path, mod):
    fl, tr = (flight, trace) if mod == "port" else (jflight, jtrace)
    tracer = tr.Tracer(deterministic=True)
    rec = fl.FlightRecorder(str(tmp_path), tracer=tracer, max_dumps=2)
    tracer.event("fault/injected", point="p", index=3, kind="crash")
    paths = [rec.dump(reason) for reason in ("crash", "sig term!", "drain")]
    names = [p.rsplit("/", 1)[1] for p in paths]
    assert names == ["dump-0001-crash.json", "dump-0002-sig-term-.json",
                     "dump-0003-drain.json"]
    assert [p.rsplit("/", 1)[1] for p in fl.list_dumps(str(tmp_path))] == names[1:]
    assert fl.fault_events(fl.load_dump(paths[-1])["events"]) == [("p", 3, "crash")]
    assert fl.FlightRecorder(None).dump("x") is None
    assert fl.FlightRecorder(str(tmp_path), tracer=tr.NULL).dump("x") is None
