"""The program's spans laid over a profiler window (``yardstick/spans.py``)
and the six readers of them, on a window and spans made by hand."""

from __future__ import annotations

import io
import threading
from types import SimpleNamespace

import pytest

from benchmark import spec
from benchmark.yardstick import profile, spans
from gradaccum_tpu_torch.obs import trace

SHARES = ("upload_idle_share", "micro_idle_share", "accum_idle_share",
          "optimizer_idle_share", "loop_idle_share")
US = 1000  # ns


def _span(name, start_us, end_us, step=0, tid=0):
    return {"name": name, "cat": "train", "ph": "X", "ts": start_us, "dur": end_us - start_us,
            "pid": 0, "tid": tid, "args": {"step": step}}


def _counter(t_us, launches, host_ns, tid=0):
    return {"name": "flash", "cat": "train", "ph": "C", "ts": t_us, "pid": 0, "tid": tid,
            "args": {"launches": launches, "host_ns": host_ns}}


def _window(host=()):
    """0-200 µs; the device busy 10-20, 60-70 and 150-160 µs."""
    kernels = [("k", 10 * US, 20 * US), ("k", 60 * US, 70 * US), ("k", 150 * US, 160 * US)]
    return profile.Window((0, 200 * US), kernels, [], list(host))


def _events():
    """One update, 5-120 µs, then the loop; 120-200 µs outside any step."""
    return [
        _span("train/step", 5, 120),
        _span("train/upload", 5, 15),
        _span("train/forward", 30, 50),
        _span("train/backward", 50, 65),
        _span("train/accumulate", 65, 80),
        _span("train/clip", 85, 90),
        _span("train/optimizer", 90, 110),
    ]


def _ctx(window, log=None):
    return SimpleNamespace(window=window, log=log or io.StringIO())


@pytest.fixture
def events(monkeypatch):
    made = _events()
    monkeypatch.setattr(spans, "program_events", lambda: made)
    return made


def test_a_gap_is_split_by_the_innermost_span_at_each_instant():
    w = _window()
    assert w.gaps() == [(0, 10 * US), (20 * US, 60 * US), (70 * US, 150 * US),
                        (160 * US, 200 * US)]
    found = spans.train_spans(w, _events())
    split = spans.idle_split(w, found)
    # 0-5 outside, 5-10 upload; 20-30 step, 30-50 forward, 50-60 backward;
    # 70-80 accumulate, 80-85 step, 85-90 clip, 90-110 optimizer, 110-120
    # step, 120-150 outside; 160-200 outside
    assert split == {spans.OUTSIDE: (5 + 30 + 40) * US, "train/upload": 5 * US,
                     "train/step": (10 + 5 + 10) * US, "train/forward": 20 * US,
                     "train/backward": 10 * US, "train/accumulate": 10 * US,
                     "train/clip": 5 * US, "train/optimizer": 20 * US}
    assert sum(split.values()) == w.window_ns - w.busy_ns()


def test_the_five_shares_sum_to_device_idle_share(events):
    ctx = _ctx(_window())
    got = {m: spec.reader(m)(ctx) for m in SHARES}
    assert got == pytest.approx({"upload_idle_share": 2.5, "micro_idle_share": 15.0,
                                 "accum_idle_share": 7.5, "optimizer_idle_share": 10.0,
                                 "loop_idle_share": 50.0})
    assert sum(got.values()) == pytest.approx(spec.reader("device_idle_share")(ctx))
    log = ctx.log.getvalue()
    assert "idle split (s): (outside train/step) 0.000075" in log
    assert "kernel launches inside train/step: 0 of 0" in log


def test_spans_outside_the_window_and_of_other_threads_are_ignored():
    w = _window()
    base = spans.shares(w, spans.train_spans(w, _events()))
    noise = [
        # the checked updates before the window, the next after it
        _span("train/step", -500, -100), _span("train/optimizer", -300, -200),
        _span("train/step", 300, 400), _span("train/forward", 310, 320),
        # not a train span, an instant event
        _span("ckpt/save", 0, 200),
        {"name": "train/loss_scale", "ph": "i", "ts": 40, "tid": 0, "args": {}},
    ]
    found = spans.train_spans(w, _events() + noise)
    assert found == spans.train_spans(w, _events())
    assert spans.shares(w, found) == base
    # a span that crosses the window's edge is clipped to it
    clipped = spans.train_spans(w, [_span("train/step", -50, 30)])
    assert clipped == [("train/step", 0, 30 * US)]
    # the program's tracer: another thread's spans over the whole window
    now = [0.0]
    tracer = trace.Tracer(clock=lambda: now[0], capacity=None)

    def emit(made):
        for e in made:
            now[0] = e["ts"] / 1e6
            span = tracer.span(e["name"], cat="train", step=0)
            span.__enter__()
            now[0] = (e["ts"] + e["dur"]) / 1e6
            span.__exit__(None, None, None)

    other = threading.Thread(target=emit, args=([_span("train/step", 0, 200),
                                                 _span("train/upload", 0, 200)],))
    other.start()
    other.join(timeout=60)
    assert not other.is_alive()
    emit(_events())
    with trace.installed(tracer):
        mine = spans.program_events()
    assert len(tracer.snapshot()) == 9 and len(mine) == 7
    assert spans.train_spans(w, mine) == spans.train_spans(w, _events())


def test_readers_read_nothing_without_spans_in_the_window(monkeypatch):
    w = _window()
    # the tracer is off, or stamps another clock (a monotonic one from 0 s)
    for made in ([], [_span("train/step", 10**9, 2 * 10**9)]):
        monkeypatch.setattr(spans, "program_events", lambda made=made: made)
        for m in SHARES + ("flash_host_us",):
            assert spec.reader(m)(_ctx(w)) is None
    monkeypatch.setattr(spans, "program_events", _events)
    for m in SHARES + ("flash_host_us",):
        assert spec.reader(m)(_ctx(None)) is None
    # no kernel ran in the window: no idle share, as device_idle_share
    idle = profile.Window((0, 200 * US), [], [], [])
    for m in SHARES + ("device_idle_share",):
        assert spec.reader(m)(_ctx(idle)) is None


def test_flash_host_us_reads_the_counters_deltas(monkeypatch):
    w = _window()
    made = [_counter(-50, 10, 1_000_000), _counter(0, 20, 2_000_000),  # the last before
            _counter(120, 80, 5_000_000), _counter(190, 120, 8_000_000),  # the last inside
            _counter(250, 200, 9_000_000), _counter(100, 1, 1, tid=1)]
    monkeypatch.setattr(spans, "program_events", lambda: made)
    assert spec.reader("flash_host_us")(_ctx(w)) == pytest.approx(
        (8_000_000 - 2_000_000) / (120 - 20) / 1e3)
    # no launch in the window, or no counter before it: nothing read
    assert spans.flash_host_us(w, [_counter(0, 20, 5), _counter(100, 20, 9)]) is None
    assert spans.flash_host_us(w, [_counter(100, 20, 5)]) is None


def test_kernel_launches_are_checked_against_the_steps():
    host = [("cudaLaunchKernel", 6 * US, 7 * US), ("cuLaunchKernelEx", 100 * US, 101 * US),
            ("cudaLaunchKernel", 130 * US, 131 * US), ("cudaMemcpyAsync", 8 * US, 9 * US)]
    w = _window(host)
    found = spans.train_spans(w, _events())
    assert spans.launches_inside_steps(w, found) == (2, 3)
    host = [("cudaStreamSynchronize", 86 * US, 87 * US), ("cudaMemcpyAsync", 85 * US, 86 * US),
            ("cudaMemcpyAsync", 91 * US, 92 * US), ("cudaMemcpyAsync", 2 * US, 3 * US),
            ("cudaLaunchKernel", 87 * US, 88 * US)]
    assert spans.calls_by_span(_window(host), found) == {
        "train/clip": {"cudaStreamSynchronize": 1, "cudaMemcpyAsync": 1},
        "train/optimizer": {"cudaMemcpyAsync": 1}, spans.OUTSIDE: {"cudaMemcpyAsync": 1}}
