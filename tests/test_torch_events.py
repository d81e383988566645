"""The port's event files and profiler windows (``estimator/events.py``,
``utils/profiling.py``), with JAX's contract:

- event files are observability, never a dependency: ``GRADACCUM_EVENTS=0``
  and a ``torch.utils.tensorboard`` that cannot import both give an
  inactive writer, zero files and zero errors through the whole API, and a
  training run still writes its checkpoints and loss CSV;
- the profiler traces exactly its window (held with a fake profiler, as
  JAX's tests hold ``jax.profiler``): a zero-width window never traces, a
  window past the end never traces, a window at step 0 traces exactly once,
  a failed start degrades to a no-op;
- with the real ``torch.profiler`` on the CPU, ``RunConfig(profile_dir=)``
  writes a Chrome trace JSON, scan mode with K past the window still traces
  one step, and an exception inside the window stops the profiler.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.estimator.config import RunConfig
from gradaccum_tpu_torch.estimator.estimator import Estimator, ModelBundle
from gradaccum_tpu_torch.ops.accumulation import GradAccumConfig
from gradaccum_tpu_torch.ops.adamw import sgd
from gradaccum_tpu_torch.utils import profiling

pytestmark = pytest.mark.torch
torch.set_num_threads(1)


def _exercise(writer):
    writer.scalar("loss", 1.0, step=0)
    writer.scalars({"a": 1.0, "b": 2.0}, step=1, subdir="eval")
    writer.flush()
    writer.close()


def _fresh_events_module():
    sys.modules.pop("gradaccum_tpu_torch.estimator.events", None)
    from gradaccum_tpu_torch.estimator import events

    return events


def test_events_opt_out_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("GRADACCUM_EVENTS", "0")
    writer = _fresh_events_module().EventWriter(str(tmp_path))
    assert not writer.active
    _exercise(writer)
    assert list(tmp_path.rglob("*")) == []


def test_events_without_tensorboard_write_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv("GRADACCUM_EVENTS", raising=False)
    # a None entry makes the import raise ImportError, as on a machine
    # without the tensorboard package
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    writer = _fresh_events_module().EventWriter(str(tmp_path))
    assert not writer.active
    _exercise(writer)
    assert list(tmp_path.rglob("*")) == []


def test_events_no_model_dir_is_inactive():
    writer = _fresh_events_module().EventWriter(None)
    assert not writer.active
    _exercise(writer)


class _FakeProfiler:
    """Counts start/stop calls; optionally fails the start."""

    def __init__(self, fail=False):
        self.starts = 0
        self.stops = 0
        self.fail = fail

    def start_trace(self, log_dir):
        if self.fail:
            raise RuntimeError("profiler unavailable")
        self.starts += 1

    def stop_trace(self):
        self.stops += 1
        return "trace.json"


@pytest.fixture
def fake_profiler(monkeypatch):
    fake = _FakeProfiler()
    monkeypatch.setattr(profiling, "start_trace", fake.start_trace)
    monkeypatch.setattr(profiling, "stop_trace", fake.stop_trace)
    return fake


@pytest.mark.parametrize("start,num,steps,traces", [
    (0, 0, 5, 0),  # a zero-width window never traces
    (100, 5, 10, 0),  # a window past the end of training never traces
    (0, 3, 10, 1),  # a window at step 0 traces exactly once
], ids=["zero-width", "past-end", "at-step-0"])
def test_profiler_window_edges(tmp_path, fake_profiler, start, num, steps, traces):
    prof = profiling.StepWindowProfiler(str(tmp_path), start_step=start, num_steps=num)
    for step in range(steps):
        prof.observe(step)
    prof.close()
    assert fake_profiler.starts == fake_profiler.stops == traces
    assert prof._done and not prof._active


def test_profiler_failed_start_degrades_to_noop(tmp_path, monkeypatch):
    fake = _FakeProfiler(fail=True)
    monkeypatch.setattr(profiling, "start_trace", fake.start_trace)
    monkeypatch.setattr(profiling, "stop_trace", fake.stop_trace)
    prof = profiling.StepWindowProfiler(str(tmp_path), start_step=2, num_steps=3)
    for step in range(8):
        prof.observe(step)  # must not raise
    prof.close()
    assert fake.stops == 0
    ran = []
    with profiling.trace("/nonexistent/dir"):
        ran.append(True)  # the region still runs
    assert ran and fake.stops == 0


def _linear_estimator(model_dir, k=1, mode="streaming", **run):
    class Linear(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(3, 1))

    bundle = ModelBundle(init=lambda seed, device: Linear(),
                         loss=lambda m, b: torch.mean((b["x"] @ m.w - b["y"]) ** 2),
                         predict=lambda m, b: {"predictions": b["x"] @ m.w},
                         eval_metrics={})
    return Estimator(bundle, sgd(0.1), GradAccumConfig(num_micro_batches=k),
                     RunConfig(model_dir=model_dir, log_step_count_steps=1000, **run),
                     mode=mode, device="cpu")


def _batches(n, rows=4):
    rng = np.random.default_rng(0)
    return [{"x": rng.normal(size=(rows, 3)).astype(np.float32),
             "y": rng.normal(size=(rows, 1)).astype(np.float32)} for _ in range(n)]


def _traces(d):
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def test_profile_window_writes_a_chrome_trace(tmp_path):
    prof_dir = str(tmp_path / "prof")
    _linear_estimator(None, profile_dir=prof_dir, profile_start_step=2,
                      profile_num_steps=3).train(_batches(10), max_steps=10)
    assert _traces(prof_dir) == ["trace-0001.json"]
    with open(os.path.join(prof_dir, "trace-0001.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_profile_window_smaller_than_k_still_traces(tmp_path):
    prof_dir = str(tmp_path / "prof_k")
    _linear_estimator(None, k=8, mode="scan", profile_dir=prof_dir, profile_start_step=10,
                      profile_num_steps=5).train(_batches(6, rows=32), max_steps=48)
    assert _traces(prof_dir) == ["trace-0001.json"]


def test_profiler_stopped_on_train_exception(tmp_path):
    class Boom(Exception):
        pass

    def exploding():
        yield from _batches(2)
        raise Boom()

    prof_dir = str(tmp_path / "prof_exc")
    est = _linear_estimator(None, profile_dir=prof_dir, profile_start_step=1,
                            profile_num_steps=100)
    with pytest.raises(Boom):
        est.train(exploding(), max_steps=10)
    assert profiling._active is None  # stopped: a retry can trace again
    assert _traces(prof_dir) == ["trace-0001.json"]
    with profiling.trace(prof_dir):
        torch.ones(2).sum()
    assert _traces(prof_dir) == ["trace-0001.json", "trace-0002.json"]


def test_estimator_without_events_trains_and_publishes(tmp_path, monkeypatch):
    """GRADACCUM_EVENTS=0: checkpoints and the loss CSV, zero event files;
    the registry still records every published scalar."""
    monkeypatch.setenv("GRADACCUM_EVENTS", "0")
    est = _linear_estimator(str(tmp_path), k=2, save_checkpoints_steps=4)
    est.train(_batches(8), max_steps=8)
    est.evaluate(_batches(1), name="eval")
    est.close()
    files = [p.name for p in tmp_path.rglob("*") if p.is_file()]
    assert "loss_vs_step.csv" in files and "ckpt-8.pt" in files
    assert not any(f.startswith("events.out.tfevents") for f in files)
    gauges = est.registry.snapshot()["gauges"]
    assert gauges["loss"]["step"] == 8
