"""The reduction of a profiler trace and the readers of the trace, on a
trace made by hand."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import spec
from benchmark.yardstick import flops, peaks, profile


class _Ev:
    def __init__(self, name, start, dur, device, kind):
        self._v = (name, start, dur, device, kind)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return "DeviceType." + self._v[3]

    def activity_type(self):
        return self._v[4]


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def _window():
    return profile.reduce(_prof(_window_events()))


def _window_events():
    return [
        _Ev(profile.WINDOW, 1000, 1000, "CPU", "user_annotation"),
        _Ev(profile.WINDOW, 1000, 1000, "CUDA", "gpu_user_annotation"),
        _Ev("aten::mm", 1000, 300, "CPU", "cpu_op"),
        _Ev("cudaMemcpyAsync", 1550, 100, "CPU", "cuda_runtime"),
        _Ev("aten::copy_", 1500, 200, "CPU", "cpu_op"),
        _Ev("nvjet_tst_128x256", 1100, 200, "CUDA", "kernel"),
        _Ev("void flash_fwd_tc_kernel<64>(Params, FwdArgs)", 1250, 150, "CUDA", "kernel"),
        _Ev("Memcpy HtoD (Pageable -> Device)", 1800, 100, "CUDA", "gpu_memcpy"),
        _Ev("void flash_dq_tc_kernel<64>(Params, BwdArgs)", 1950, 100, "CUDA", "kernel"),
        _Ev("before the window", 500, 100, "CUDA", "kernel"),
    ]


def test_busy_union_gaps_and_labels():
    w = _window()
    assert w.span == (1000, 2000)
    # kernels 1100-1400, the copy 1800-1900, the dq kernel clipped to 1950-2000
    assert w.busy_intervals() == [(1100, 1400), (1800, 1900), (1950, 2000)]
    assert w.busy_ns() == 450
    assert w.gaps() == [(1000, 1100), (1400, 1800), (1900, 1950)]
    # the middle of 1400-1800 is 1600, inside aten::copy_ and cudaMemcpyAsync:
    # the innermost is the runtime call
    assert w.gap_labels(w.gaps()) == ["aten::mm", "cudaMemcpyAsync",
                                      "(between host events)"]
    assert len(w.kernels) == 3
    assert w.flash_launches() == {("fwd", "bf16"): [150], ("dq", "bf16"): [50]}
    b = w.breakdown()
    assert b["device_ops"][0] == ["nvjet_tst_128x256", 200e-9]
    assert b["idle_gaps"][0] == ["cudaMemcpyAsync", 400e-9]


def _ctx(w, **kw):
    base = dict(window=w, updates=1, window_s=1e-6, spans=[], log=open("/dev/null", "w"),
                peaks=peaks.peaks_for("H100"), precision="bf16",
                rcfg={"layers": 1, "heads": 2, "hidden": 16}, micro_lengths=[[2, 3]],
                seq=4, causal=False, masked=True, model_flops=989e6,
                flash_launched={"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1})
    base.update(kw)
    return SimpleNamespace(**base)


def test_trace_readers():
    w = _window()
    ctx = _ctx(w)
    read = {m: spec.reader(m) for m in ("gemm_share", "flash_share", "device_idle_share",
                                        "launches_per_update", "step_mfu", "flash_roofline")}
    assert read["gemm_share"](ctx) == pytest.approx(100 * 200 / 450)
    assert read["flash_share"](ctx) == pytest.approx(100 * 200 / 450)
    assert read["device_idle_share"](ctx) == pytest.approx(100 * (1 - 450 / 1000))
    assert read["launches_per_update"](ctx) == 3
    assert read["step_mfu"](ctx) == pytest.approx(100 * 989e6 / 1e-6 / 989e12)
    # one fwd and one dq but no dkv launch: not one of each kind, not read
    assert read["flash_roofline"](ctx) is None


def test_flash_roofline_sums_least_times_over_device_times():
    ev = [_Ev(profile.WINDOW, 0, 10**6, "CPU", "user_annotation")]
    names = {"fwd": "flash_fwd_tc_kernel<64>", "dq": "flash_dq_tc_kernel<64>",
             "dkv": "flash_dkv_tc_kernel<64>"}
    for i, kind in enumerate(flops.PRODUCTS):
        ev.append(_Ev(names[kind], 1000 * (i + 1), 500, "CUDA", "kernel"))
    ctx = _ctx(profile.reduce(_prof(ev)), rcfg={"layers": 1, "heads": 2, "hidden": 16})
    p = ctx.peaks
    least = sum(flops.least_seconds(flops.flash_launch(k, [2, 3], 4, 2, 8, 2, False, True),
                                    p["bf16"], p["hbm"]) for k in flops.PRODUCTS)
    got = spec.reader("flash_roofline")(ctx)
    assert got == pytest.approx(100 * least / 1500e-9)
    # the port's counters saw a launch the trace lost: nothing read
    ctx.flash_launched = {"flash_fwd": 2, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    assert spec.reader("flash_roofline")(ctx) is None
    # a float32 launch in a bf16 window: the counts do not match, nothing read
    ev.append(_Ev("flash_fwd_kernel", 9000, 500, "CUDA", "kernel"))
    assert spec.reader("flash_roofline")(_ctx(profile.reduce(_prof(ev)))) is None


class _OldEv(_Ev):
    """An event of a PyTorch whose events name no activity type."""

    def __getattribute__(self, attr):
        if attr == "activity_type":
            raise AttributeError(attr)
        return object.__getattribute__(self, attr)


def test_without_activity_types_device_events_go_by_name():
    ev = [_OldEv(n, s, d, dev, "") for n, s, d, dev, _ in
          (e._v for e in _window_events())]
    w = profile.reduce(_prof(ev))
    assert not hasattr(ev[0], "activity_type")
    ref = _window()
    assert (w.kernels, w.other, w.span) == (ref.kernels, ref.other, ref.span)


def test_without_the_annotation_the_window_spans_every_event():
    ev = [e for e in _window_events() if e.name() != profile.WINDOW]
    w = profile.reduce(_prof(ev))
    # from the earliest event (a kernel at 500) to the latest end (2050)
    assert w.span == (500, 2050)
    assert w.busy_intervals()[0] == (500, 600)
    # a device copy of the annotation alone still marks the window
    ev.append(_OldEv(profile.WINDOW, 1000, 1000, "CUDA", ""))
    assert profile.reduce(_prof(ev)).span == (1000, 2000)


def test_no_device_events_reads_nothing():
    w = profile.reduce(_prof([_Ev(profile.WINDOW, 0, 100, "CPU", "user_annotation")]))
    ctx = _ctx(w, peaks=None)
    for m in ("gemm_share", "flash_share", "device_idle_share", "launches_per_update",
              "step_mfu", "flash_roofline"):
        assert spec.reader(m)(ctx) is None
    assert profile.reduce(_prof([])) is None
    only_host = profile.reduce(_prof([_Ev("aten::mm", 0, 10, "CPU", "cpu_op")]))
    assert only_host.span == (0, 10) and only_host.busy_ns() == 0
