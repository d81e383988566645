"""What a cell is, read from data: ``BENCHMARK.json`` at the root of the
checkout, ``workloads/<cell>.json``, ``configs/<config>.json``,
``traffic/<mix>.json`` and one reader per metric, ``metrics/<metric>.py``.
Nothing here names a cell, a configuration or a metric: a later change
adds files and entries, and edits none of these."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

from benchmark import traffic

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def benchmark_json(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _entry(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} {name!r}")


def cell(name: str, root: Path = ROOT) -> dict:
    """Everything one run of cell ``name`` reads: its BENCHMARK.json entry,
    its workload file, its configuration and traffic, and the metrics it
    reports, end to end and per layer."""
    bench = benchmark_json(root)
    entry = _entry(bench["workloads"], name, "workload")
    work = json.loads((BENCH_DIR / "workloads" / f"{name}.json").read_text())
    conf_entry = _entry(bench["configs"], entry["config"], "config")
    config = json.loads((root / conf_entry["file"]).read_text())
    if work["config"] != entry["config"] or work["traffic"] != entry["traffic"]:
        raise ValueError(f"workloads/{name}.json disagrees with BENCHMARK.json on its "
                         f"config or traffic")

    def reports(metric):
        return "workloads" not in metric or name in metric["workloads"]

    return {"name": name, "entry": entry, "work": work, "config": config,
            "mix": traffic.load(entry["traffic"]),
            "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
            "per_layer": [m for m in bench["per_layer"] if reports(m)]}


def reader(metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {metric!r} ({path})")
    module_spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{metric}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read


def read_metrics(metrics: List[dict], ctx) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of every metric whose reader found
    something to read; a reader that returns None leaves its metric out."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
