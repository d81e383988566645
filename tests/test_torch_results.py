"""The port's ``examples/{plot_loss,reproduce_results}.py`` against JAX's.

The curve reader and ``curve_stats`` equal JAX's on the same CSV; the
overlay tool writes its PNG; and ``reproduce_results`` with its runs stood
in by fakes (the real runs are hours of training) builds the same
``summary.json`` as JAX's from the same curves and run metrics, copies the
curves into ``--out``, renders both figures and keeps the metrics of the
groups an ``--only`` call did not run.
"""

import importlib
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

from gradaccum_tpu_torch.examples import plot_loss as tplot
from gradaccum_tpu_torch.examples import reproduce_results as trr

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
jplot = importlib.import_module("examples.plot_loss")
jrr = importlib.import_module("examples.reproduce_results")

pytestmark = pytest.mark.torch


def _write_curve(model_dir, seed, n=60):
    os.makedirs(model_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    with open(os.path.join(model_dir, "loss_vs_step.csv"), "w") as f:
        f.write("step,loss\n")
        for s in range(1, n + 1):
            f.write(f"{s},{float(2.0 / s + 0.1 * rng.random())}\n")


def test_curve_reader_and_stats_equal_jax(tmp_path):
    _write_curve(tmp_path / "run", 1)
    got = tplot.read_curve(str(tmp_path / "run"))
    assert got == jplot.read_curve(str(tmp_path / "run"))
    assert trr.curve_stats(*got) == jrr.curve_stats(*got)
    assert trr._drop_flags(["--a", "1", "--b", "2", "--c"], ("--a",)) == \
        jrr._drop_flags(["--a", "1", "--b", "2", "--c"], ("--a",)) == ["--b", "2", "--c"]
    assert tplot.main([str(tmp_path / "o.png"), str(tmp_path / "run")]) == 0
    assert (tmp_path / "o.png").stat().st_size > 0
    assert tplot.main([]) == 1


def test_reproduce_results_summary_equals_jax(tmp_path, monkeypatch):
    metrics = {}

    def fake(name, model_dir):
        seed = sum(map(ord, name))
        _write_curve(model_dir, seed)
        metrics[name] = round(0.5 + (seed % 40) / 100, 4)
        return metrics[name]

    def port_run(module, name, extra, run_root, quick, device, run_timeout=1800):
        d = os.path.join(run_root, name)
        value = fake(name, d)
        return d, {"accuracy": value, "test_rmse": value}

    def jax_run(script, name, extra, run_root, quick, cpu_mesh=True, run_timeout=1800):
        d = os.path.join(run_root, name)
        return d, fake(name, d)

    monkeypatch.setattr(trr, "run_one", port_run)
    monkeypatch.setattr(jrr, "run_one", jax_run)
    got = trr.main(["--out", str(tmp_path / "t"), "--quick", "--device", "cpu"])
    jrr.main(["--out", str(tmp_path / "j"), "--quick"])
    with open(tmp_path / "j" / "summary.json") as f:
        want = json.load(f)
    assert got == want and len(got["runs"]) == 8
    for name in ("mnist_matrix.png", "bert_accumulation.png", "housing_b59_k3.csv"):
        assert (tmp_path / "t" / name).exists()
    # --only reruns one group and keeps the others' measured metrics
    again = trr.main(["--out", str(tmp_path / "t"), "--only", "housing", "--device", "cpu"])
    assert again["runs"]["mnist_01_1w_b200_k1"] == got["runs"]["mnist_01_1w_b200_k1"]
    assert "quick" not in again["runs"]["housing_b59_k3"]
