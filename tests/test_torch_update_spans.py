"""The spans inside the port's update, its counter event and its clock.

- One scan update records one ``train/upload``, K each of
  ``train/forward``, ``train/backward`` and ``train/accumulate`` (plus the
  window's buffer), one ``train/clip`` and one ``train/optimizer``, all
  nested in their ``train/step`` with its ``step``; streaming mode records
  the same spans per micro-batch.
- ``Tracer.counter`` exports a Chrome ``"C"`` event; the Estimator emits a
  ``flash`` counter after each step, outside its span.
- ``GRADACCUM_OBS=0`` records nothing and trains bit for bit as a traced run.
- The tracer's default clock is the profiler's: a ``record_function`` range
  opened inside a span lies inside it.
- The flash wrapper's host time rises with its launches (on a card only).

No JAX here: the card test runs on the chip too.
"""

import collections
import itertools
import time

import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.estimator.config import RunConfig
from gradaccum_tpu_torch.estimator.estimator import Estimator
from gradaccum_tpu_torch.models import bert as tbert
from gradaccum_tpu_torch.obs import trace
from gradaccum_tpu_torch.ops import accumulation as tacc
from gradaccum_tpu_torch.ops import adamw as topt
from gradaccum_tpu_torch.ops import flash_attention as tfa

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

K = 4
ROUND_US = 1  # snapshot rounds ts and dur to whole µs each
INNER = ("train/upload", "train/forward", "train/backward", "train/accumulate",
         "train/clip", "train/optimizer")


def _batch(seed, n, s=16, vocab=128):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(4, s + 1, size=n)
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    return {"input_ids": (rng.integers(5, vocab, size=(n, s)) * mask).astype(np.int32),
            "input_mask": mask, "segment_ids": np.zeros((n, s), np.int32),
            "label": rng.integers(0, 2, size=n).astype(np.int32)}


def _estimator(mode="scan", bundle=None, optimizer=None):
    bundle = bundle or tbert.bert_classifier_bundle(tbert.BertConfig.tiny_for_tests())
    return Estimator(bundle, optimizer or topt.adamw(1e-3),
                     tacc.GradAccumConfig(K, clip_norm=1.0, first_step_quirk=False),
                     RunConfig(seed=3, save_checkpoints_steps=None,
                               log_step_count_steps=1000),
                     mode=mode, device="cpu")


def _batches(mode, updates):
    rows = 2 * K if mode == "scan" else 2
    return [_batch(i, rows) for i in range(updates * (1 if mode == "scan" else K))]


def _traced(mode="scan", updates=2):
    tracer = trace.Tracer(capacity=None)
    est = _estimator(mode)
    with trace.installed(tracer):
        state = est.train(_batches(mode, updates))
    return tracer.snapshot(), est, state


def test_one_scan_update_records_each_span_once_or_k_times():
    events, _, _ = _traced("scan", updates=2)
    for step in (0, K):
        got = collections.Counter(e["name"] for e in events if e["ph"] == "X"
                                  and e["args"]["step"] == step)
        assert got == {"train/step": 1, "train/upload": 1, "train/forward": K,
                       "train/backward": K, "train/accumulate": K + 1, "train/clip": 1,
                       "train/optimizer": 1}
        for name in ("train/forward", "train/backward"):
            assert sorted(e["args"]["micro"] for e in events
                          if e["name"] == name and e["args"]["step"] == step) == list(range(K))
    upload = [e for e in events if e["name"] == "train/upload"]
    # 2K rows of 16 int32 in each of 3 columns, and the labels
    assert [e["args"]["bytes"] for e in upload] == [2 * K * (3 * 16 + 1) * 4] * 2


@pytest.mark.parametrize("mode", ["scan", "streaming"])
def test_every_span_nests_in_its_step_and_shares_its_step(mode):
    events, _, _ = _traced(mode, updates=2)
    steps = {e["args"]["step"]: e for e in events if e["name"] == "train/step"}
    assert sorted(steps) == list(range(2 * K) if mode == "streaming" else [0, K])
    inner = [e for e in events if e["name"] in INNER]
    assert {e["name"] for e in inner} == set(INNER)
    for e in inner:
        parent = steps[e["args"]["step"]]
        assert e["tid"] == parent["tid"] and e["cat"] == "train"
        assert parent["ts"] - ROUND_US <= e["ts"]
        assert e["ts"] + e["dur"] <= parent["ts"] + parent["dur"] + 2 * ROUND_US
    if mode == "streaming":
        # one micro-batch a step, at its place in the window; the apply
        # step clips, updates and zeroes the accumulators
        for step, parent in steps.items():
            names = collections.Counter(e["name"] for e in inner
                                        if e["args"]["step"] == step)
            applies = step % K == K - 1
            assert names["train/forward"] == names["train/backward"] == 1
            assert names["train/accumulate"] == 1 + applies
            assert names["train/clip"] == names["train/optimizer"] == applies
            assert [e["args"]["micro"] for e in inner if e["args"]["step"] == step
                    and e["name"] == "train/forward"] == [step % K]


def test_flash_counter_follows_each_step_outside_its_span():
    events, _, _ = _traced("scan", updates=3)
    order = [e for e in events if e["name"] in ("train/step", "flash")]
    assert [e["name"] for e in order] == ["train/step", "flash"] * 3
    for step, counter in zip(order[::2], order[1::2]):
        assert counter["ph"] == "C" and counter["ts"] >= step["ts"] + step["dur"] - ROUND_US
        # the CPU runs the plain versions: no kernel launched
        assert counter["args"]["launches"] == counter["args"]["host_ns"] == 0


def test_counter_exports_a_chrome_counter_event_and_stays_deterministic():
    def emit():
        tick = itertools.count()
        tr = trace.Tracer(deterministic=True, clock=lambda: float(next(tick)) / 8)
        with tr.span("train/step", step=0):
            tr.counter("flash", cat="train", launches=3, host_ns=1500)
        tr.event("e", i=1)
        return tr

    one, two = emit(), emit()
    assert one.to_bytes() == two.to_bytes()
    counter = [e for e in one.to_chrome()["traceEvents"] if e.get("ph") == "C"]
    assert counter == [{"name": "flash", "cat": "train", "ph": "C", "ts": 125000, "pid": 0,
                        "tid": 0, "args": {"launches": 3, "host_ns": 1500, "seq": 0}}]
    assert trace.NULL.counter("flash", launches=1) is None
    # a deterministic tracer records no span inside an update
    assert not one.timed and trace.Tracer().timed and not trace.NULL.timed
    assert trace.UpdateSpans(one, 0)("train/forward") is trace.NO_SPANS("train/forward")
    # the default wall clock is CLOCK_REALTIME in seconds
    assert abs(trace.Tracer().now() - time.time()) < 1.0


def test_obs_off_records_nothing_and_trains_bitwise_as_a_traced_run(monkeypatch):
    traced_events, traced_est, traced = _traced("scan", updates=2)
    assert traced_events
    default = trace.Tracer(capacity=None)
    # the default tracer, as a user gets it: governed by the kill switch
    monkeypatch.setattr(trace, "_GLOBAL", default)
    monkeypatch.setattr(trace, "_EXPLICIT", False)
    monkeypatch.setenv("GRADACCUM_OBS", "0")
    est = _estimator("scan")
    state = est.train(_batches("scan", 2))
    assert default.snapshot() == []
    assert torch.equal(est.first_loss, traced_est.first_loss)
    assert torch.equal(est.last_loss, traced_est.last_loss)
    for name, p in state.params.items():
        assert torch.equal(p, traced.params[name]), name
    for name in state.opt_state.m:
        assert torch.equal(state.opt_state.m[name], traced.opt_state.m[name]), name
        assert torch.equal(state.opt_state.v[name], traced.opt_state.v[name]), name
    monkeypatch.setenv("GRADACCUM_OBS", "1")
    _estimator("scan").train(_batches("scan", 1))
    assert {e["name"] for e in default.snapshot()} >= set(INNER)


def test_spans_share_the_profilers_clock():
    """Under torch.profiler with CPU activity, every ``record_function``
    range opened inside a program span lies inside that span within
    200 µs, over a run of at least a second."""
    from torch.profiler import ProfilerActivity, profile, record_function

    bundle = tbert.bert_classifier_bundle(tbert.BertConfig.tiny_for_tests())
    loss = bundle.loss

    def probed_loss(model, batch):
        with record_function("probe/loss"):
            return loss(model, batch)

    opt = topt.adamw(1e-3)

    def probed_update(*args):
        with record_function("probe/update"):
            return opt.update(*args)

    est = _estimator("scan", bundle=bundle._replace(loss=probed_loss),
                     optimizer=opt._replace(update=probed_update))
    tracer = trace.Tracer(capacity=None)
    with trace.installed(tracer), profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 1.0:
            est.train(_batches("scan", 2))
    spans = [e for e in tracer.snapshot() if e["ph"] == "X"]
    probes = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
              for ev in prof.profiler.kineto_results.events()
              if ev.name() in ("probe/loss", "probe/update")]
    want = {"probe/loss": "train/forward", "probe/update": "train/optimizer"}
    assert len(probes) >= 2 * K
    slack = 200_000
    for name, start, end in probes:
        around = [s for s in spans if s["name"] == want[name]
                  and s["ts"] * 1000 - slack <= start <= (s["ts"] + s["dur"]) * 1000 + slack]
        assert len(around) == 1, (name, start)
        s = around[0]
        assert s["ts"] * 1000 - slack <= start and end <= (s["ts"] + s["dur"]) * 1000 + slack


def test_launch_host_ns_resets_beside_the_launch_counts():
    tfa.reset_launch_counts()
    assert tfa.launch_host_ns() == {name: 0 for name in tfa.KERNELS}
    assert tfa.launch_counts() == {name: 0 for name in tfa.KERNELS}


def test_flash_host_ns_rises_with_launches():
    if not torch.cuda.is_available():
        pytest.skip("the flash kernels need a CUDA card")
    tfa.reset_launch_counts()
    q, k, v = (torch.randn(2, 2, 64, 64, device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    seen = []
    for _ in range(3):
        tfa.flash_fwd_cuda(q, k, v, None, None, False, 0.0)
        seen.append((tfa.launch_counts()["flash_fwd"], tfa.launch_host_ns()["flash_fwd"]))
    torch.cuda.synchronize()
    assert [n for n, _ in seen] == [1, 2, 3]
    assert 0 < seen[0][1] < seen[1][1] < seen[2][1]
