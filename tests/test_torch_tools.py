"""The operator tools in the port, against JAX's ``tools/``.

``gradaccum_tpu_torch/examples/{obs_report,bench_obs,bench_trend,bench_mixed}.py``
beside ``tools/{obs_report,bench_obs,bench_trend,bench_mixed}.py``:

- the counterparts of JAX's tool tests (``test_obs.py``'s obs_report and
  bench_trend cases, ``test_slo.py``'s gapped flight directory and overhead
  column, ``test_serving_prefix.py``'s acceptance gate and the repo's
  artifacts), on the port's engine, tracer and flight recorder;
- the port's ``obs_report.report`` equal to JAX's on one file, for a trace
  the port's engine wrote and for one JAX's engine wrote;
- the port's ``bench_trend.collect`` equal to JAX's row for row, over the
  repo's committed artifacts and over a temporary directory;
- ``bench_mixed``'s bytes per parameter equal to JAX's ``run_config`` for
  every leg, the ``zero1`` leg on two spawned gloo ranks;
- ``bench_obs``'s serve leg emitting JAX's event stream per tick on the same
  seeded trace, and a well-formed acceptance block (the full budget run is
  ``slow``, as JAX's is).

    python -m pytest -m torch tests/test_torch_tools.py
"""

import importlib
import json
import os
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parent.parent


def _jax_tool(name):
    sys.path.insert(0, str(ROOT))
    return importlib.import_module(f"tools.{name}")


def _port_tool(name):
    return importlib.import_module(f"gradaccum_tpu_torch.examples.{name}")


@pytest.fixture(scope="module")
def tiny():
    """JAX's tiny LM and the same weights as the port's decode tree."""
    import jax

    from gradaccum_tpu.models import gpt as jgpt
    from gradaccum_tpu_torch.interop import params_from_jax, params_tree
    from gradaccum_tpu_torch.models import gpt as tgpt

    jcfg = jgpt.GPTConfig.tiny_for_tests(dropout=0.0)
    params = jgpt.gpt_lm_bundle(jcfg).init(jax.random.PRNGKey(0),
                                           {"input_ids": np.zeros((1, 8), np.int32)})
    cfg = tgpt.GPTConfig.tiny_for_tests(dropout=0.0)
    model = tgpt.GPTLM(cfg)
    model.load_state_dict(params_from_jax(jax.device_get(params["params"])))
    return jcfg, params, cfg, params_tree(model)


def _port_trace(tiny, path):
    """The port's engine under a seeded slow tick, traced to ``path``;
    returns the engine."""
    from gradaccum_tpu_torch.obs.trace import Tracer, installed
    from gradaccum_tpu_torch.resilience import faults
    from gradaccum_tpu_torch.serving import Engine, SimulationDriver

    _, _, cfg, tree = tiny
    tracer = Tracer(deterministic=True, capacity=None)
    engine = Engine(tree, cfg, num_slots=4, max_len=32, tracer=tracer, device="cpu")
    driver = SimulationDriver(engine, seed=11)
    schedule = faults.FaultSchedule([faults.FaultSpec(faults.MID_DECODE_TICK, at=2,
                                                      kind=faults.KIND_SLOW_TICK, delay=0.01)])
    with installed(tracer), faults.installed(faults.FaultInjector(schedule)):
        driver.run(driver.make_trace(6, arrival_rate=0.7))
    tracer.export(str(path))
    return engine


def _jax_trace(tiny, path):
    """JAX's engine on the same trace and schedule, traced to ``path``."""
    from gradaccum_tpu.obs.trace import Tracer, installed
    from gradaccum_tpu.resilience import faults
    from gradaccum_tpu.serving import Engine, SimulationDriver

    jcfg, params, _, _ = tiny
    tracer = Tracer(deterministic=True, capacity=None)
    engine = Engine(params, jcfg, num_slots=4, max_len=32, tracer=tracer)
    driver = SimulationDriver(engine, seed=11)
    schedule = faults.FaultSchedule([faults.FaultSpec(faults.MID_DECODE_TICK, at=2,
                                                      kind=faults.KIND_SLOW_TICK, delay=0.01)])
    with installed(tracer), faults.installed(faults.FaultInjector(schedule)):
        driver.run(driver.make_trace(6, arrival_rate=0.7))
    tracer.export(str(path))


# -- obs_report -------------------------------------------------------------------------


def test_obs_report_renders_trace_and_correlates_faults(tiny, tmp_path):
    """``test_obs.py :: test_obs_report_renders_trace_and_correlates_faults``
    on the port's engine and tracer."""
    obs_report = _port_tool("obs_report")
    path = tmp_path / "trace.json"
    engine = _port_trace(tiny, path)
    events, n_files = obs_report.collect(str(path))
    assert n_files == 1
    rep = obs_report.report(events)
    assert rep["serving"]["ticks"] == engine.tick_count
    assert rep["serving"]["queue_wait"]["count"] == 6
    assert rep["serving"]["service_time"]["p90"] is not None
    assert len(rep["faults"]) == 1
    assert rep["faults"][0]["fault"]["kind"] == "slow_tick"
    out = tmp_path / "report.json"
    assert obs_report.main([str(path), "--json", str(out)]) == 0
    assert json.loads(out.read_text())["events"] == len(events)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_obs_report_equals_jaxs_on_one_file(tiny, tmp_path, writer):
    """The port's ``report`` equals JAX's ``tools/obs_report.py`` on the same
    file, written by the port's engine or by JAX's; ``render`` prints the
    same lines."""
    path = tmp_path / "trace.json"
    (_port_trace if writer == "port" else _jax_trace)(tiny, path)
    port, jax_tool = _port_tool("obs_report"), _jax_tool("obs_report")
    got_events, got_n = port.collect(str(path))
    want_events, want_n = jax_tool.collect(str(path))
    assert got_n == want_n == 1 and got_events == want_events
    got, want = port.report(got_events), jax_tool.report(want_events)
    assert got == want
    assert got["serving"]["ticks"] > 0 and got["faults"]
    lines = ([], [])
    port.render(got, log=lines[0].append)
    jax_tool.render(want, log=lines[1].append)
    assert lines[0] == lines[1]


def test_obs_report_merges_overlapping_flight_dumps(tmp_path):
    from gradaccum_tpu_torch.obs import flight as obs_flight
    from gradaccum_tpu_torch.obs.trace import Tracer

    obs_report = _port_tool("obs_report")
    tracer = Tracer(deterministic=True, capacity=None)
    tracer.event("a", cat="x")
    recorder = obs_flight.FlightRecorder(str(tmp_path), tracer=tracer)
    recorder.dump("first")
    tracer.event("b", cat="x")
    recorder.dump("second")  # overlapping ring: event "a" appears twice
    events, n_files = obs_report.collect(str(tmp_path))
    assert n_files == 2
    assert [e["name"] for e in events] == ["a", "b"]


def test_obs_report_keeps_both_runs_despite_seq_collision(tmp_path):
    """Crash -> resume -> crash again: the second run's tracer restarts seq
    at 0, and fault -> effect never pairs across the runs."""
    from gradaccum_tpu_torch.obs import flight as obs_flight
    from gradaccum_tpu_torch.obs.trace import Tracer

    obs_report = _port_tool("obs_report")
    run_a = Tracer(deterministic=True, capacity=None)
    run_a.event("fault/injected", cat="resilience", point="post_train_step", index=3,
                kind="crash")
    run_a.event("serve/recover", cat="resilience", requeued=1)
    obs_flight.FlightRecorder(str(tmp_path), tracer=run_a).dump("crash")
    run_b = Tracer(deterministic=True, capacity=None)
    run_b.event("fault/injected", cat="resilience", point="post_train_step", index=9,
                kind="crash")
    obs_flight.FlightRecorder(str(tmp_path), tracer=run_b).dump("crash")
    events, n_files = obs_report.collect(str(tmp_path))
    assert n_files == 2
    seen = obs_flight.fault_events(events)
    assert ("post_train_step", 3, "crash") in seen and ("post_train_step", 9, "crash") in seen
    rep = obs_report.report(events)
    effects = {fx["fault"]["index"]: (fx["effect"] or {}).get("name") for fx in rep["faults"]}
    assert effects == {3: "serve/recover", 9: None}


def test_flight_rotation_caps_dumps_and_report_tolerates_gap(tmp_path):
    """``test_slo.py``'s rotation case: three dumps survive, numbering
    climbs over the gap, and obs_report merges the gapped directory."""
    from gradaccum_tpu_torch.obs import flight as obs_flight
    from gradaccum_tpu_torch.obs.trace import Tracer

    obs_report = _port_tool("obs_report")
    tracer = Tracer(deterministic=True, capacity=None)
    recorder = obs_flight.FlightRecorder(str(tmp_path), tracer=tracer, max_dumps=3)
    for i in range(7):
        tracer.event("e", cat="x", i=i)
        recorder.dump(f"r{i}")
    dumps = obs_flight.list_dumps(str(tmp_path))
    assert [os.path.basename(p)[:9] for p in dumps] == ["dump-0005", "dump-0006", "dump-0007"]
    again = obs_flight.FlightRecorder(str(tmp_path), tracer=tracer, max_dumps=3)
    assert os.path.basename(again.dump("later")).startswith("dump-0008")
    events, n_files = obs_report.collect(str(tmp_path))
    assert n_files == 3
    assert [e["args"]["i"] for e in events] == list(range(7))


# -- bench_trend ------------------------------------------------------------------------


def _write(path, data):
    path.write_text(data if isinstance(data, str) else json.dumps(data))


def test_bench_trend_aggregates_obs_artifact(tmp_path):
    bench_trend = _port_tool("bench_trend")
    _write(tmp_path / "BENCH_obs.json", {"bench": "observability overhead",
                                         "headline": "serve 1.01x",
                                         "acceptance": {"required": "<= 5%", "passed": True}})
    rows = bench_trend.collect(str(tmp_path))
    assert len(rows) == 1 and rows[0]["passed"] is True
    assert rows[0]["headline"] == "serve 1.01x"
    assert bench_trend.main(["--dir", str(tmp_path)]) == 0


def test_bench_trend_renders_overhead_block(tmp_path):
    bench_trend = _port_tool("bench_trend")
    _write(tmp_path / "BENCH_slo.json", {"bench": "ops plane overhead", "headline": "1.01x",
                                         "overhead": {"serve": 1.0123},
                                         "acceptance": {"required": "<= 1.02x", "passed": True}})
    rows = bench_trend.collect(str(tmp_path))
    assert rows[0]["overhead"] == "overhead serve 1.012x"
    assert bench_trend.main(["--dir", str(tmp_path)]) == 0


def test_bench_trend_gates_acceptance(tmp_path):
    """``test_serving_prefix.py:524``: a failed acceptance and an unreadable
    artifact both gate; a block-less artifact is listed only."""
    main = _port_tool("bench_trend").main
    _write(tmp_path / "BENCH_a.json", {"bench": "a", "acceptance": {"passed": True,
                                                                   "required": "x >= 2"}})
    _write(tmp_path / "BENCH_b.json", {"metric": "tokens/s", "value": 1.0})
    assert main(["--dir", str(tmp_path)]) == 0
    _write(tmp_path / "BENCH_c.json", {"bench": "c", "acceptance": {"passed": False,
                                                                   "required": "y"}})
    assert main(["--dir", str(tmp_path)]) == 1
    (tmp_path / "BENCH_c.json").unlink()
    _write(tmp_path / "BENCH_d.json", '{"bench": "d", "acce')
    assert main(["--dir", str(tmp_path)]) == 1


def test_bench_trend_repo_artifacts_all_pass():
    """``test_serving_prefix.py:553``: every acceptance block in the repo's
    committed artifacts still says passed (read only)."""
    assert _port_tool("bench_trend").main(["--dir", str(ROOT)]) == 0


def _artifact_dir(tmp_path):
    """Every column's shape, a dryrun each way, and an unreadable file."""
    arts = {
        "BENCH_mixed.json": json.loads((ROOT / "BENCH_mixed.json").read_text()),
        "BENCH_heal.json": json.loads((ROOT / "BENCH_heal.json").read_text()),
        "BENCH_x.json": {"bench": "x", "scaling": [{"replicas": 1, "tokens_per_s": 2.0},
                                                  {"replicas": 2, "tokens_per_s": 3.0}],
                         "acceptance": {"required_speedup": 1.4, "passed": False}},
        "BENCH_bad.json": '{"bench": ',
        "MULTICHIP_r01.json": {"ok": True, "n_devices": 8},
        "MULTICHIP_r02.json": {"skipped": True, "n_devices": 4},
        "MULTICHIP_r03.json": {"ok": False, "n_devices": 8},
    }
    for name, data in arts.items():
        _write(tmp_path / name, data)
    return tmp_path


@pytest.mark.parametrize("where", ["repo", "tmp"])
def test_bench_trend_collect_equals_jaxs_row_for_row(tmp_path, capsys, where):
    """The port's ``collect`` equals JAX's over the repo's committed
    artifacts and over a directory of every shape; ``main`` prints the same
    table and returns the same code."""
    d = str(ROOT) if where == "repo" else str(_artifact_dir(tmp_path))
    port, jax_tool = _port_tool("bench_trend"), _jax_tool("bench_trend")
    got, want = port.collect(d), jax_tool.collect(d)
    assert got == want and len(got) >= 7
    rc = port.main(["--dir", d])
    printed = capsys.readouterr().out
    assert (rc, printed) == (jax_tool.main(["--dir", d]), capsys.readouterr().out)


# -- bench_mixed ------------------------------------------------------------------------

BYTES = ("n_params", "param_bytes_per_param", "optimizer_bytes_per_param",
         "accumulator_bytes_per_param", "opt_plus_accum_bytes_per_param")


def test_bench_mixed_bytes_per_param_equal_jaxs_every_leg(tmp_path):
    """Every leg's bytes per parameter equal JAX's ``run_config`` exactly
    (the 12 -> 16 -> 12 -> 6 ladder), the ``zero1`` leg on two spawned gloo
    ranks, and the port's acceptance passes."""
    import jax.numpy as jnp

    jax_tool = _jax_tool("bench_mixed")
    bench_mixed = _port_tool("bench_mixed")
    result = bench_mixed.run(steps=1, device="cpu", log=lambda *_: None)
    rng = np.random.default_rng(bench_mixed.SEED)
    legs = [dict(), dict(compute_dtype=jnp.bfloat16),
            dict(compute_dtype=jnp.bfloat16, fused=True),
            dict(compute_dtype=jnp.bfloat16, fused=True, zero1=True)]
    for (name, _), kw, row in zip(bench_mixed.LEGS, legs, result["rows"]):
        want = jax_tool.run_config(name, rng, 1, **kw)
        assert row["config"] == name
        assert {k: row[k] for k in BYTES} == {k: want[k] for k in BYTES}, name
    assert [r["opt_plus_accum_bytes_per_param"] for r in result["rows"]] == [12.0, 16.0, 12.0,
                                                                            6.0]
    assert result["reduction_vs_f32"] == 2.0 and result["acceptance"]["passed"]
    assert set(result["acceptance"]) == {"required", "measured", "passed"}


# -- bench_obs --------------------------------------------------------------------------


def test_bench_obs_serve_leg_emits_jaxs_events_per_tick():
    """On the same seeded trace, the port's serve leg emits JAX's event
    stream: the same ticks, and per event name the same count."""
    from gradaccum_tpu.obs.trace import Tracer as JaxTracer
    from gradaccum_tpu_torch.obs.trace import Tracer

    jax_tool, bench_obs = _jax_tool("bench_obs"), _port_tool("bench_obs")
    n = 24
    engine, driver, trace = bench_obs._serve_setup(100, n, torch.device("cpu"))
    tracer = Tracer(capacity=None)
    _, ticks = bench_obs._serve_leg(engine, driver, trace, tracer)
    got = bench_obs._workload(tracer)
    jengine, jdriver, jtrace = jax_tool._serve_setup(seed=100, n_requests=n)
    jtracer = JaxTracer(capacity=None)
    _, jticks = jax_tool._serve_leg(jengine, jdriver, jtrace, jtracer)
    want = jax_tool._workload(jtracer)
    assert ticks == jticks > 0
    assert Counter(name for _, name, _, _ in got) == Counter(name for _, name, _, _ in want)
    assert [(ph, name, cat) for ph, name, cat, _ in got] == \
        [(ph, name, cat) for ph, name, cat, _ in want]


def test_bench_obs_small_run_has_a_well_formed_acceptance(tmp_path):
    """``bench_obs`` at small ``--repeats``: both hot paths measured, the
    artifact's acceptance block JAX's, written only where asked."""
    bench_obs = _port_tool("bench_obs")
    out = tmp_path / "obs.json"
    rc = bench_obs.main(["--device", "cpu", "--repeats", "1", "--requests", "12",
                         "--train-steps", "16", "--json", str(out)])
    art = json.loads(out.read_text())
    assert set(art["acceptance"]) == {"required", "passed"}
    assert isinstance(art["acceptance"]["passed"], bool) and rc == (0 if art["acceptance"][
        "passed"] else 1)
    assert art["acceptance"]["required"].startswith("obs enabled vs disabled: <= 5% overhead")
    for path, unit in (("serve", "tick"), ("train", "step")):
        leg = art[path]
        assert leg["events"] > 0 and leg[f"baseline_s_per_{unit}"] > 0
        assert leg["overhead_ratio"] >= 1.0
    assert art["headline"].startswith("obs overhead: serve ")
    assert os.listdir(tmp_path) == ["obs.json"]


@pytest.mark.slow
def test_bench_obs_overhead_within_budget(tmp_path):
    """The full budget run (``test_obs.py``'s slow lane): the acceptance
    passes on the CPU."""
    bench_obs = _port_tool("bench_obs")
    out = tmp_path / "BENCH_obs.json"
    rc = bench_obs.main(["--device", "cpu", "--json", str(out), "--repeats", "3",
                         "--requests", "24", "--train-steps", "80"])
    assert json.loads(out.read_text())["acceptance"]["passed"] is True and rc == 0
