"""BENCHMARK.json against the benchmark's contract, every cell resolved to
its files and readers, and the import rule: nothing under ``benchmark/``
imports JAX or the JAX package, and the reference imports nothing of the
program (top-level module names compared whole)."""

from __future__ import annotations

import ast
import json
import re

import pytest

from benchmark import families, spec, traffic
from benchmark.harness import forbidden_modules
from benchmark.yardstick import compare

BENCH = spec.benchmark_json()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits the budget
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"})):
        for e in BENCH[group]:
            assert set(e) == keys
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for cell in m.get("workloads", CELLS):
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
        if m["unit"] == "%" and m["name"].endswith("_roofline"):
            assert m["better"] == "higher"
    assert any("mfu" in m["name"] for m in BENCH["per_layer"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves(name):
    c = spec.cell(name)
    assert c["entry"]["chips"] == 1
    work = c["work"]
    assert work["precision"] in ("bf16", "f32")
    assert {"loss", "grad", "change"} <= set(work["limits"]) <= set(compare.NUMBERS)
    assert work["check_steps"] >= 3
    assert all(0 < v < 1 for v in work["limits"].values())
    assert traffic.rows_per_update(c["mix"]) % c["mix"]["num_micro_batches"] == 0
    assert families.load(c["config"]["family"]).reference.__name__.startswith(
        "benchmark.reference.")
    names = [m["name"] for m in c["end_to_end"] + c["per_layer"]]
    assert "setup_s" in names and len(c["end_to_end"]) >= 2 and c["per_layer"]
    for metric in names:
        assert callable(spec.reader(metric))


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    path = spec.ROOT / conf["file"]
    assert path.is_file() and conf["file"].startswith("benchmark/")
    data = json.loads(path.read_text())
    assert set(conf["reduced"]) <= set(data)
    assert conf["source"].startswith("https://")
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_anywhere_and_no_program_in_the_reference():
    files = sorted(spec.BENCH_DIR.rglob("*.py"))
    assert files
    for path in files:
        top = set(_imports(path))
        assert not top & {"jax", "jaxlib", "flax", "gradaccum_tpu"}, path
        if "reference" in path.relative_to(spec.BENCH_DIR).parts:
            assert not top & {"gradaccum_tpu_torch", "gradaccum_tpu"}, path
            assert top <= {"torch", "numpy", "math", "re", "importlib", "typing",
                           "__future__", "benchmark"}, path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "gradaccum_tpu_torchlike", types.ModuleType("x"))
    assert "gradaccum_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert "jax" in forbidden_modules()
