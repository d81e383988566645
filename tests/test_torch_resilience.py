"""The port's resilience layer held against JAX's on the same seeded inputs.

- Fault schedules from a seed, the overflow storm, the spec validation and
  ``corrupt_batch`` equal JAX's exactly.
- A crash at a seeded micro-step inside an accumulation window, resumed in
  a fresh Estimator from a checkpoint that is itself mid-window, ends bit
  for bit where the port's uninterrupted run ends (synchronous and async
  writer), and its loss trajectory is within 2e-6 of JAX's.
- Checkpoint repair (``tests/test_resilience.py``'s cases): quarantine and
  exact fallback, a bit flip caught by the manifest, all corrupt, a schema
  mismatch that never quarantines, an unverified undecodable file skipped,
  an explicit path that never falls back, stale tmps swept and IO errors
  retried. JAX's manifest reader verifies the port's files.
- The guard under injected NaN/Inf and an overflow storm: skip counts, the
  loss-scale and good-count series equal JAX's exactly, in both modes.
- Preemption: the drain bus, handler chaining, a simulated two-host drain,
  a dead peer, the c10d store transport on threads, SIGTERM with the async
  writer, ``train_and_evaluate`` preemption, and the crash path.
"""

import importlib
import os
import signal
import threading

import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.estimator import checkpoint as ckpt_lib
from gradaccum_tpu_torch.estimator.config import EvalSpec, RunConfig, TrainSpec
from gradaccum_tpu_torch.estimator.estimator import Estimator, ModelBundle
from gradaccum_tpu_torch.estimator.metrics import mean_absolute_error
from gradaccum_tpu_torch.obs import flight, trace
from gradaccum_tpu_torch.ops import accumulation as acc
from gradaccum_tpu_torch.ops.adamw import adam, sgd
from gradaccum_tpu_torch.ops.loss_scale import LossScaleConfig
from gradaccum_tpu_torch.resilience import faults, manifest, preemption
from gradaccum_tpu_torch.resilience.faults import (
    FaultInjector,
    FaultSchedule,
    FaultSpec,
    InjectedCrash,
)
from gradaccum_tpu_torch.resilience.retry import retry_io

jax = pytest.importorskip("jax")
jnp = importlib.import_module("jax.numpy")
jfaults = importlib.import_module("gradaccum_tpu.resilience.faults")
jmanifest = importlib.import_module("gradaccum_tpu.resilience.manifest")
jretry = importlib.import_module("gradaccum_tpu.resilience.retry")
jest = importlib.import_module("gradaccum_tpu.estimator.estimator")
jconfig = importlib.import_module("gradaccum_tpu.estimator.config")
jmetrics = importlib.import_module("gradaccum_tpu.estimator.metrics")
jacc = importlib.import_module("gradaccum_tpu.ops.accumulation")
jopt = importlib.import_module("gradaccum_tpu.ops.adamw")
jls = importlib.import_module("gradaccum_tpu.ops.loss_scale")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

K = 4
TRAJ_ATOL = 2e-6  # the port's float32 trajectory against JAX's


class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(3, 1))
        self.b = torch.nn.Parameter(torch.zeros(1))


def _bundle():
    def predict(m, batch):
        return {"predictions": batch["x"] @ m.w + m.b}

    def loss(m, batch):
        return torch.mean((predict(m, batch)["predictions"] - batch["y"]) ** 2)

    return ModelBundle(init=lambda seed, device: _Linear().to(device), loss=loss,
                       predict=torch.no_grad()(predict),
                       eval_metrics={"mae": mean_absolute_error(label_key="y")},
                       label_keys=("y",))


def _jax_bundle():
    def predict(p, batch):
        return {"predictions": batch["x"] @ p["w"] + p["b"]}

    return jest.ModelBundle(
        init=lambda rng, sample: {"w": jnp.zeros((3, 1)), "b": jnp.zeros((1,))},
        loss=lambda p, batch: jnp.mean((predict(p, batch)["predictions"] - batch["y"]) ** 2),
        predict=predict, eval_metrics={"mae": jmetrics.mean_absolute_error(label_key="y")})


def _batches(n, seed=0, batch=8):
    """Position i is the same batch on every call, so a resumed run can
    re-enter the stream at any offset."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.normal(size=(batch, 3)).astype(np.float32)
        out.append({"x": x, "y": x @ np.asarray([[1.0], [-2.0], [0.5]], np.float32)})
    return out


def _accum(**kw):
    return acc.GradAccumConfig(num_micro_batches=K, **kw)


def _estimator(model_dir, save_every=3, skip=False, async_ckpt=False,
               first_step_quirk=True, **run):
    return Estimator(_bundle(), sgd(0.05),
                     _accum(skip_nonfinite=skip, first_step_quirk=first_step_quirk),
                     RunConfig(model_dir=model_dir, save_checkpoints_steps=save_every,
                               async_checkpoint=async_ckpt, log_step_count_steps=1000,
                               **run),
                     mode="streaming", device="cpu")


def _jax_estimator(model_dir, accum, mode="streaming", opt=None, save_every=None):
    return jest.Estimator(_jax_bundle(), opt or jopt.sgd(0.05), accum,
                          jconfig.RunConfig(model_dir=model_dir,
                                            save_checkpoints_steps=save_every,
                                            log_step_count_steps=1000),
                          mode=mode)


def _assert_states_equal(a, b):
    fa, fb = ckpt_lib.flatten(a), ckpt_lib.flatten(b)
    assert fa.keys() == fb.keys()
    for key in fa:
        if isinstance(fa[key], torch.Tensor):
            assert torch.equal(fa[key], fb[key]), key
        else:
            assert fa[key] == fb[key], key


def _loss_by_step(model_dir):
    path = os.path.join(model_dir, "loss_vs_step.csv")
    with open(path) as f:
        next(f)
        return {int(s): loss for s, loss in (line.strip().split(",") for line in f)}


def _params(state):
    return {name.split("/")[-1]: t.detach().numpy() for name, t in state.params.items()}


# -- the fault harness ---------------------------------------------------------


def _specs(schedule):
    return [(s.point, s.at, s.kind, s.count, s.span, s.delay, s.target)
            for s in schedule.specs]


@pytest.mark.parametrize("seed", [0, 1234, 0xC0FFEE])
def test_fault_schedules_from_a_seed_equal_jax(seed):
    assert faults.POINTS == jfaults.POINTS and faults.KINDS == jfaults.KINDS
    assert faults.DATA_KINDS == jfaults.DATA_KINDS
    kw = dict(n_faults=12, kinds=faults.KINDS, index_range=(3, 70))
    assert _specs(FaultSchedule.seeded(seed, **kw)) == \
        _specs(jfaults.FaultSchedule.seeded(seed, **kw))
    storm = dict(start_range=(2, 30), length_range=(3, 11))
    assert _specs(FaultSchedule.overflow_storm(seed, **storm)) == \
        _specs(jfaults.FaultSchedule.overflow_storm(seed, **storm))


@pytest.mark.parametrize("spec", [
    dict(point="nowhere", at=1), dict(point=faults.PRE_TRAIN_STEP, at=1, kind="melt"),
    dict(point=faults.PRE_TRAIN_STEP, at=None, span=3),
    dict(point=faults.PRE_TRAIN_STEP, at=1, count=0),
    dict(point=faults.MID_DECODE_TICK, at=1, kind=faults.KIND_SLOW_TICK),
    dict(point=faults.PRE_TRAIN_STEP, at=1, kind=faults.KIND_REPLICA_KILL, target=0),
    dict(point=faults.PRE_TRAIN_STEP, at=1, target=2),
], ids=["point", "kind", "span", "count", "slow", "fleet-point", "target"])
def test_fault_spec_validation_equals_jax(spec):
    with pytest.raises(ValueError) as want:
        jfaults.FaultSpec(**spec)
    with pytest.raises(ValueError) as got:
        FaultSpec(**spec)
    assert str(got.value) == str(want.value)


def test_fault_spec_budget_wildcard_and_burst():
    inj = FaultInjector(FaultSchedule([
        FaultSpec(faults.PRE_TRAIN_STEP, at=None, kind=faults.KIND_NAN, count=2),
        FaultSpec(faults.POST_TRAIN_STEP, at=5, kind=faults.KIND_OVERFLOW_STORM, span=3)]))
    assert inj.fire(faults.PRE_TRAIN_STEP, 7) == faults.KIND_NAN
    assert inj.fire(faults.PRE_TRAIN_STEP, 9) == faults.KIND_NAN
    assert inj.fire(faults.PRE_TRAIN_STEP, 11) is None  # budget spent
    assert [inj.fire(faults.POST_TRAIN_STEP, i) for i in range(4, 10)] == \
        [None] + [faults.KIND_OVERFLOW_STORM] * 3 + [None, None]
    with pytest.raises(faults.InjectedIOError):
        FaultInjector(FaultSchedule([FaultSpec(faults.MID_CKPT_WRITE, at=2,
                                               kind=faults.KIND_IO_ERROR)])).fire(
            faults.MID_CKPT_WRITE, 2)
    assert faults.fire(faults.PRE_TRAIN_STEP, 0) is None  # nothing installed


@pytest.mark.parametrize("kind", faults.DATA_KINDS)
def test_corrupt_batch_equals_jax(kind):
    batch = {"x": np.ones((2, 3), np.float32), "ids": np.arange(4, dtype=np.int32)}
    got, want = faults.corrupt_batch(batch, kind), jfaults.corrupt_batch(batch, kind)
    for key in batch:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
        assert got[key].dtype == np.asarray(want[key]).dtype
    with pytest.raises(ValueError, match="data kinds"):
        faults.corrupt_batch(batch, faults.KIND_CRASH)


# -- crash mid-window, bitwise resume -----------------------------------------


@pytest.mark.parametrize("async_ckpt", [False, True], ids=["sync", "async"])
def test_crash_resume_bitwise_mid_window_and_trajectory_matches_jax(tmp_path, async_ckpt):
    """A crash at a seeded micro-step inside a window; a fresh Estimator
    resumes from the newest checkpoint (itself mid-window: saves every 3
    micro-steps, K=4) to the uninterrupted run's state, bit for bit, and the
    same losses; the trajectory is JAX's within 2e-6."""
    n_steps = 20
    crash_at = int(np.random.default_rng(0xC0FFEE).integers(7, 12))
    assert crash_at % K != 0
    state_a = _estimator(str(tmp_path / "a"), async_ckpt=async_ckpt).train(
        _batches(n_steps), max_steps=n_steps)

    est_b = _estimator(str(tmp_path / "b"), async_ckpt=async_ckpt)
    inj = FaultInjector(FaultSchedule([FaultSpec(faults.POST_TRAIN_STEP, at=crash_at)]))
    with faults.installed(inj), trace.installed(trace.Tracer(deterministic=True)):
        with pytest.raises(InjectedCrash):
            est_b.train(_batches(n_steps), max_steps=n_steps)
    assert inj.fired == [(faults.POST_TRAIN_STEP, crash_at, faults.KIND_CRASH)]
    assert est_b._res.async_ckpt is None  # the crash path closed the writer
    # the crash shipped its postmortem, holding the fault
    dumps = flight.list_dumps(str(tmp_path / "b"))
    assert dumps and dumps[-1].endswith("-crash.json")
    assert flight.fault_events(flight.load_dump(dumps[-1])["events"]) == inj.fired

    ckpt_step, _ = ckpt_lib.latest_checkpoint(str(tmp_path / "b"))
    assert 0 < ckpt_step < crash_at and ckpt_step % K != 0
    state_b = _estimator(str(tmp_path / "b"), async_ckpt=async_ckpt).train(
        _batches(n_steps)[ckpt_step:], max_steps=n_steps)
    assert state_b.step == n_steps
    _assert_states_equal(state_a, state_b)
    loss_a, loss_b = _loss_by_step(str(tmp_path / "a")), _loss_by_step(str(tmp_path / "b"))
    resumed = [s for s in loss_b if s > ckpt_step]
    assert resumed and all(loss_b[s] == loss_a[s] for s in resumed)

    # JAX's uninterrupted run on the same batches
    jstate = _jax_estimator(str(tmp_path / "j"), jacc.GradAccumConfig(num_micro_batches=K)
                            ).train(_batches(n_steps), max_steps=n_steps)
    for name, value in _params(state_a).items():
        np.testing.assert_allclose(value, np.asarray(jstate.params[name]), rtol=0,
                                   atol=TRAJ_ATOL, err_msg=name)
    loss_j = _loss_by_step(str(tmp_path / "j"))
    assert loss_j.keys() == loss_a.keys()
    np.testing.assert_allclose([float(loss_a[s]) for s in sorted(loss_a)],
                               [float(loss_j[s]) for s in sorted(loss_j)],
                               rtol=TRAJ_ATOL, atol=TRAJ_ATOL)


def test_async_save_copies_the_state_before_it_returns(tmp_path):
    """The optimizer writes in place: a tensor changed after save() returns
    must not reach the file."""
    state = {"w": torch.arange(6.0), "step": 3}
    writer = ckpt_lib.AsyncCheckpointer()
    writer.save(str(tmp_path), state, 3)
    state["w"].add_(100.0)  # the next step's in-place update
    writer.close()
    restored = ckpt_lib.restore(str(tmp_path), {"w": torch.zeros(6), "step": 0})
    assert torch.equal(restored["w"], torch.arange(6.0)) and restored["step"] == 3


def test_corrupt_newest_checkpoint_quarantined_with_exact_fallback(tmp_path):
    n_steps = 16
    state_a = _estimator(str(tmp_path / "a")).train(_batches(n_steps), max_steps=n_steps)
    _estimator(str(tmp_path / "b")).train(_batches(n_steps), max_steps=10)  # 3, 6, 9, 10
    ckpts = ckpt_lib.all_checkpoints(str(tmp_path / "b"))
    (previous, _), (newest, newest_path) = ckpts[-2], ckpts[-1]
    with open(newest_path, "r+b") as f:
        f.truncate(12)  # torn write
    state_b = _estimator(str(tmp_path / "b")).train(_batches(n_steps)[previous:],
                                                    max_steps=n_steps)
    assert os.path.exists(newest_path + ".corrupt") and not os.path.exists(newest_path)
    assert os.path.basename(newest_path) not in manifest.load(str(tmp_path / "b"))
    assert state_b.step == n_steps
    _assert_states_equal(state_a, state_b)


# -- checkpoint repair ---------------------------------------------------------


def test_restore_detects_bitflip_via_manifest(tmp_path):
    d = str(tmp_path)
    ckpt_lib.save(d, {"w": torch.arange(8.0)}, 5)
    path = ckpt_lib.save(d, {"w": torch.arange(8.0) * 2}, 10)
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF  # same length: only the checksum can tell
    with open(path, "wb") as f:
        f.write(bytes(data))
    restored = ckpt_lib.restore(d, {"w": torch.zeros(8)})
    assert torch.equal(restored["w"], torch.arange(8.0))
    assert os.path.exists(path + ".corrupt")


def test_all_checkpoints_corrupt_raises(tmp_path):
    d = str(tmp_path)
    for s in (2, 4):
        with open(ckpt_lib.save(d, {"w": torch.arange(4.0)}, s), "r+b") as f:
            f.truncate(3)
    with pytest.raises(ckpt_lib.CheckpointCorruptError):
        ckpt_lib.restore(d, {"w": torch.zeros(4)})


def test_schema_mismatch_never_quarantines_healthy_checkpoints(tmp_path):
    d = str(tmp_path)
    ckpt_lib.save(d, {"w": torch.arange(4.0)}, 2)
    ckpt_lib.save(d, {"w": torch.arange(4.0) * 2}, 4)
    with pytest.raises(ckpt_lib.CheckpointCorruptError, match="template"):
        ckpt_lib.restore(d, {"different_field": torch.zeros(2)})
    with pytest.raises(ValueError, match="template"):  # a wrong shape, too
        ckpt_lib.restore(d, {"w": torch.zeros(5)})
    assert not [n for n in os.listdir(d) if n.endswith(".corrupt")]
    restored = ckpt_lib.restore(d, {"w": torch.zeros(4)})
    assert torch.equal(restored["w"], torch.arange(4.0) * 2)


def test_undecodable_without_checksum_skipped_not_renamed(tmp_path):
    d = str(tmp_path)
    ckpt_lib.save(d, {"w": torch.arange(4.0)}, 2)
    bad = os.path.join(d, "ckpt-9.pt")  # newest, garbage, no manifest entry
    with open(bad, "wb") as f:
        f.write(b"not a checkpoint")
    restored = ckpt_lib.restore(d, {"w": torch.zeros(4)})
    assert torch.equal(restored["w"], torch.arange(4.0))
    assert os.path.exists(bad) and not os.path.exists(bad + ".corrupt")


def test_explicit_checkpoint_path_never_falls_back(tmp_path):
    d = str(tmp_path)
    ckpt_lib.save(d, {"w": torch.arange(4.0)}, 1)
    p = ckpt_lib.save(d, {"w": torch.arange(4.0)}, 2)
    with open(p, "r+b") as f:
        f.truncate(3)
    with pytest.raises(ckpt_lib.CheckpointCorruptError):
        ckpt_lib.restore(p, {"w": torch.zeros(4)})


def test_stale_tmp_swept_and_io_errors_retried(tmp_path):
    d = str(tmp_path)
    state = {"w": torch.arange(4.0)}
    with open(os.path.join(d, "ckpt-1.pt.tmp"), "wb") as f:
        f.write(b"dead")
    with faults.installed(FaultInjector(FaultSchedule([FaultSpec(faults.MID_CKPT_WRITE,
                                                                 at=2)]))):
        with pytest.raises(InjectedCrash):
            ckpt_lib.save(d, state, 2)
    assert any(n.endswith(".tmp") for n in os.listdir(d))
    inj = FaultInjector(FaultSchedule([FaultSpec(faults.MID_CKPT_WRITE, at=4,
                                                 kind=faults.KIND_IO_ERROR, count=2)]))
    with faults.installed(inj):
        path = ckpt_lib.save(d, state, 4)
    assert len(inj.fired) == 2
    assert not any(n.endswith(".tmp") for n in os.listdir(d))
    assert manifest.verify(d, path) is True
    # the manifest is JAX's file and schema: JAX's reader verifies it
    assert jmanifest.verify(d, path) is True
    assert manifest.load(d) == jmanifest.load(d) == {
        "ckpt-4.pt": {"sha256": manifest.sha256_bytes(open(path, "rb").read()),
                      "size": os.path.getsize(path)}}


def test_retry_io_backoff_equals_jax():
    def run(fn):
        calls, sleeps = [], []

        def always_fails():
            calls.append(1)
            raise OSError("disk on fire")

        with pytest.raises(OSError, match="disk on fire"):
            fn(always_fails, attempts=4, base_delay=0.01, sleep=sleeps.append)
        with pytest.raises(FileNotFoundError):
            fn(lambda: open("/nonexistent/ckpt"), give_up_on=(FileNotFoundError,),
               sleep=sleeps.append)
        return len(calls), sleeps

    assert run(retry_io) == run(jretry.retry_io) == (4, [0.01, 0.02, 0.04])
    with pytest.raises(ValueError):
        retry_io(lambda: None, attempts=0)


# -- the guard under injected faults, against JAX --------------------------------


def test_nan_injection_streaming_skip_count_equals_jax(tmp_path):
    data = _batches(12, seed=3)
    spec = dict(point=faults.PRE_TRAIN_STEP, at=5, kind=faults.KIND_NAN)
    est = _estimator(str(tmp_path / "t"), save_every=None, skip=True, first_step_quirk=False)
    with faults.installed(FaultInjector(FaultSchedule([FaultSpec(**spec)]))):
        state = est.train(data, max_steps=12)
    jcfg = jacc.GradAccumConfig(num_micro_batches=K, skip_nonfinite=True,
                                first_step_quirk=False)
    jes = _jax_estimator(str(tmp_path / "j"), jcfg)
    with jfaults.installed(jfaults.FaultInjector(jfaults.FaultSchedule(
            [jfaults.FaultSpec(**spec)]))):
        jstate = jes.train(data, max_steps=12)
    assert est.nonfinite_skips == jes.nonfinite_skips == 1
    assert est.good_count_series == jes.good_count_series
    for name, value in _params(state).items():
        assert np.all(np.isfinite(value))
        np.testing.assert_allclose(value, np.asarray(jstate.params[name]), rtol=0,
                                   atol=TRAJ_ATOL, err_msg=name)


def test_inf_injection_scan_skip_count_equals_jax(tmp_path):
    data = _batches(6, seed=4, batch=K * 8)
    spec = dict(point=faults.PRE_TRAIN_STEP, at=2 * K, kind=faults.KIND_INF)
    est = Estimator(_bundle(), adam(1e-2), _accum(skip_nonfinite=True),
                    RunConfig(model_dir=str(tmp_path / "t"), save_checkpoints_steps=None),
                    mode="scan", device="cpu")
    with faults.installed(FaultInjector(FaultSchedule([FaultSpec(**spec)]))):
        state = est.train(data, max_steps=6 * K)
    jes = _jax_estimator(str(tmp_path / "j"),
                         jacc.GradAccumConfig(num_micro_batches=K, skip_nonfinite=True),
                         mode="scan", opt=jopt.adam(1e-2))
    with jfaults.installed(jfaults.FaultInjector(jfaults.FaultSchedule(
            [jfaults.FaultSpec(**spec)]))):
        jstate = jes.train(data, max_steps=6 * K)
    assert est.nonfinite_skips == jes.nonfinite_skips == K
    assert state.step == int(jstate.step) == 6 * K
    for name, value in _params(state).items():
        np.testing.assert_allclose(value, np.asarray(jstate.params[name]), rtol=0,
                                   atol=TRAJ_ATOL, err_msg=name)


@pytest.mark.parametrize("mode", ["streaming", "scan"])
def test_overflow_storm_loss_scale_sequence_equals_jax(tmp_path, mode):
    """An overflow storm under dynamic loss scaling: the skip count, the
    loss-scale series (halving in the storm, regrowing after it) and the
    good-count series equal JAX's exactly."""
    batch = 8 * (K if mode == "scan" else 1)
    n_host = 40 if mode == "streaming" else 10
    data = _batches(n_host, seed=5, batch=batch)
    storm = dict(seed=0xBADF100D, start_range=(8, 9), length_range=(2 * K, 2 * K + 1))
    ls = dict(init_scale=16.0, growth_interval=2)
    cfg = dict(num_micro_batches=K, first_step_quirk=False, skip_nonfinite=True,
               normalize_by_good_count=True)
    est = Estimator(_bundle(), sgd(0.05),
                    acc.GradAccumConfig(**cfg, loss_scale=LossScaleConfig(**ls)),
                    RunConfig(model_dir=str(tmp_path / "t"), save_checkpoints_steps=None,
                              log_step_count_steps=1000), mode=mode, device="cpu")
    with faults.installed(FaultInjector(FaultSchedule.overflow_storm(**storm))):
        est.train(data, max_steps=40)
    jes = _jax_estimator(str(tmp_path / "j"), jacc.GradAccumConfig(
        **cfg, loss_scale=jls.LossScaleConfig(**ls)), mode=mode)
    with jfaults.installed(jfaults.FaultInjector(jfaults.FaultSchedule.overflow_storm(
            **storm))):
        jes.train(data, max_steps=40)
    assert est.nonfinite_skips == jes.nonfinite_skips > 0
    assert est.loss_scale_series == jes.loss_scale_series
    assert est.good_count_series == jes.good_count_series
    scales = [v for _, v in est.loss_scale_series]
    halves = [i for i in range(1, len(scales)) if scales[i] < scales[i - 1]]
    assert halves and any(scales[i] > scales[i - 1] for i in range(halves[0] + 1, len(scales)))


# -- preemption ---------------------------------------------------------------


def test_local_drain_bus_agrees_on_any_and_max():
    bus = preemption.LocalDrainBus(3)
    results = {}
    threads = [threading.Thread(target=lambda h, r, s: results.__setitem__(
        h, bus.exchange(h, r, s)), args=a) for a in ((0, False, 7), (1, True, 9),
                                                     (2, False, 8))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == {0: (True, 9), 1: (True, 9), 2: (True, 9)}


def test_drain_consensus_single_host_fallback():
    cons = preemption.DrainConsensus(multiprocess=False)
    assert cons.decide(False, 5) == (False, 5)
    cons.request()
    assert cons.decide(False, 6) == (True, 6)


def test_drain_bus_dead_peer_times_out_and_survivor_drains_locally():
    bus = preemption.LocalDrainBus(2, timeout=0.2)
    cons = preemption.DrainConsensus(multiprocess=False, bus=bus, host_id=0)
    cons.request()
    assert cons.decide(False, 9) == (True, 9)  # a local drain, not a hang


def test_simulated_two_host_drain_lands_identical_checkpoints(tmp_path):
    """Two simulated hosts train the same stream; host 0 alone is
    preempted. The consensus stops both at one agreed step with equal
    checkpoints, and both resume to the uninterrupted run's state."""
    n_steps = 30
    data = _batches(n_steps, seed=13)
    ref_state = _estimator(str(tmp_path / "ref"), save_every=None).train(data,
                                                                         max_steps=n_steps)
    bus = preemption.LocalDrainBus(2)
    results, errors = {}, []

    def host(hid):
        try:
            cons = preemption.DrainConsensus(multiprocess=False, bus=bus, host_id=hid)
            est = _estimator(str(tmp_path / f"host{hid}"), save_every=None,
                             drain_consensus=cons)

            def stream():
                for i, b in enumerate(data):
                    if hid == 0 and i == 11:
                        cons.request()
                    yield b

            state = est.train(stream(), max_steps=n_steps)
            results[hid] = (est.drained_at_step, state)
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append((hid, e))

    threads = [threading.Thread(target=host, args=(h,)) for h in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    (stop0, state0), (stop1, state1) = results[0], results[1]
    assert stop0 == stop1 and 0 < stop0 < n_steps
    _assert_states_equal(state0, state1)
    for hid in (0, 1):
        assert ckpt_lib.latest_checkpoint(str(tmp_path / f"host{hid}"))[0] == stop0
        final = _estimator(str(tmp_path / f"host{hid}"), save_every=None).train(
            data[stop0:], max_steps=n_steps)
        _assert_states_equal(final, ref_state)


def test_drain_consensus_over_a_c10d_store_on_threads():
    """The multi-process transport: one TCPStore, each of N threads a host
    with its own client. Every host gets the same decision each round (any
    requested, max step); the previous round's keys are deleted; leases
    read back; a host whose peers stop arriving drains locally."""
    from torch.distributed import TCPStore

    n = 3
    server = TCPStore("127.0.0.1", 0, n, True, wait_for_workers=False)
    results, errors = {}, []

    def host(i):
        try:
            client = TCPStore("127.0.0.1", server.port, n, False)
            cons = preemption.DrainConsensus(store=client, host_id=i, num_hosts=n,
                                             timeout_ms=20_000, lease_ttl=60.0)
            cons.renew_lease()
            out = [cons.decide(i == 1 and r == 2, 10 * r + i) for r in range(4)]
            results[i] = (out, cons.peer_liveness())
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append((i, e))

    threads = [threading.Thread(target=host, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    want = [(False, 2), (False, 12), (True, 22), (False, 32)]
    assert all(results[i][0] == want for i in range(n))
    assert all(results[i][1] == {0: "live", 1: "live", 2: "live"} for i in range(n))
    assert not server.check(["gradaccum/drain/2/0"])  # cleaned up by round 3
    assert server.check(["gradaccum/drain/3/0"])

    # host 1 of 2 never arrives: host 0's round times out, it drains locally
    lone = preemption.DrainConsensus(
        store=TCPStore("127.0.0.1", server.port, n, False), host_id=0, num_hosts=2,
        timeout_ms=200, key_prefix="gradaccum/dead")
    lone.request()
    assert lone.decide(False, 7) == (True, 7)


def test_preemption_handler_chains_and_uninstalls_out_of_order():
    base_calls = []
    original = signal.signal(signal.SIGTERM, lambda signum, frame: base_calls.append(signum))
    try:
        a = preemption.PreemptionHandler().install()
        b = preemption.PreemptionHandler().install()
        a.uninstall()  # out of order: b was installed after a
        assert signal.getsignal(signal.SIGTERM) is b._registered[signal.SIGTERM]
        os.kill(os.getpid(), signal.SIGTERM)
        assert b.triggered and not a.triggered
        assert base_calls == [signal.SIGTERM]  # the chain reached the base
        assert preemption.requested()
        b.uninstall()
        os.kill(os.getpid(), signal.SIGTERM)
        assert len(base_calls) == 2 and not preemption.requested()
        # a re-install on top of an orphaned registration forms no cycle
        a = preemption.PreemptionHandler().install()
        b = preemption.PreemptionHandler().install()
        a.uninstall()
        a.install()
        os.kill(os.getpid(), signal.SIGTERM)  # a cycle would RecursionError
        assert a.triggered and b.triggered and len(base_calls) == 3
        a.uninstall()
        b.uninstall()
    finally:
        signal.signal(signal.SIGTERM, original)


def test_sigterm_drains_async_writer_and_lands_final_checkpoint(tmp_path):
    est = _estimator(str(tmp_path), save_every=None, async_ckpt=True)
    handler = preemption.PreemptionHandler().install()
    with trace.installed(trace.Tracer(deterministic=True)):
        try:
            def stream():
                for i, b in enumerate(_batches(40, seed=7)):
                    if i == 9:
                        os.kill(os.getpid(), signal.SIGTERM)
                    yield b

            state = est.train(stream(), max_steps=40)
            stopped_at = state.step
            assert 0 < stopped_at < 40 and est.drained_at_step == stopped_at
            assert not preemption.requested()  # acknowledged
            # the newest file landed before train() returned
            assert ckpt_lib.latest_checkpoint(str(tmp_path))[0] == stopped_at
            drained = ckpt_lib.restore(str(tmp_path), _estimator(None)._init_state())
            _assert_states_equal(drained, state)
            dumps = flight.list_dumps(str(tmp_path))
            assert dumps[-1].endswith("-sigterm-drain.json")
            events = flight.load_dump(dumps[-1])["events"]
            assert [e["args"]["step"] for e in events
                    if e["name"] == "preemption/drain"] == [stopped_at]
            state = est.train(_batches(40, seed=7)[stopped_at:], max_steps=40)
            assert state.step == 40
        finally:
            handler.uninstall()
    # the resume is bitwise against an uninterrupted run
    _assert_states_equal(state, _estimator(None, save_every=None).train(
        _batches(40, seed=7), max_steps=40))


def test_train_and_evaluate_preemption_saves_final_checkpoint(tmp_path):
    est = _estimator(str(tmp_path), save_every=None, async_ckpt=True)
    handler = preemption.PreemptionHandler().install()
    try:
        data = _batches(200, seed=11)

        def input_fn():
            for i, batch in enumerate(data):
                if i == 25:
                    handler.trigger()  # cooperative preemption
                yield batch

        state, results = est.train_and_evaluate(
            TrainSpec(input_fn, max_steps=200),
            EvalSpec(lambda: iter(_batches(2, seed=12)), throttle_secs=3600))
    finally:
        handler.uninstall()
    assert 0 < state.step < 200 and results is None  # no grace-window eval
    assert state.step in [s for s, _ in ckpt_lib.all_checkpoints(str(tmp_path))]
    assert not preemption.requested()


def test_crash_mid_train_closes_async_writer_and_keeps_checkpoints(tmp_path):
    est = _estimator(str(tmp_path), save_every=3, async_ckpt=True)
    with faults.installed(FaultInjector(FaultSchedule([FaultSpec(faults.POST_TRAIN_STEP,
                                                                 at=8)]))):
        with pytest.raises(InjectedCrash):
            est.train(_batches(20), max_steps=20)
    assert est._res.async_ckpt is None
    assert 6 in [s for s, _ in ckpt_lib.all_checkpoints(str(tmp_path))]
    # the same Estimator stays usable: resources recreate lazily, and it
    # resumes from the newest checkpoint, not from its crashed memory
    state = est.train(_batches(20)[6:], max_steps=20)
    assert state.step == 20
    _assert_states_equal(state, _estimator(None, save_every=None).train(
        _batches(20), max_steps=20))


def test_slos_and_sentinel_wait_for_serving():
    for knob in ("slos", "sentinel"):
        with pytest.raises(NotImplementedError, match="serving"):
            RunConfig(**{knob: object()})
