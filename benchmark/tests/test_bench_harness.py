"""The harness end to end at a tiny size on the CPU, with the port's plain
(CPU) kernels: the check passes on a sound run, and fails with the timed
path broken underneath (a state left unchanged, a working copy left
unwritten under moving masters, half of each micro-batch left out with the
mean over the rest, the loss altered where it is produced). The look for a card is the one step skipped."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness, spec
from benchmark.tests.tiny import CELLS, tiny_cell

SEED = 2**31 + 12345


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    # float32 on the CPU: the cells' limits are set for their own sizes and
    # precisions on the card, which a tiny bfloat16 run does not stand for
    r = harness.run(name, SEED, 0.3, False, device="cpu", cell=tiny_cell(name, "f32"))
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks" and r["failed"] == 0
    assert r["attempted"] > tiny_cell(name)["work"]["check_steps"]
    assert set(r["metrics"]) == {"train_tokens_per_s", "setup_s"}  # no peak on the CPU
    assert r["metrics"]["train_tokens_per_s"]["value"] > 0
    assert r["device"]["platform"] == "cpu"
    # the readings repeat from the seed
    again = harness.run(name, SEED, 0.0, False, device="cpu", cell=tiny_cell(name, "f32"))
    assert again["checks"] == r["checks"]


@pytest.mark.parametrize("fault", harness.FAULTS)
@pytest.mark.parametrize("name", CELLS[:2])
def test_broken_path_is_not_correct(name, fault):
    r = harness.run(name, SEED, 0.0, False, device="cpu", cell=tiny_cell(name, "f32"),
                    fault=fault)
    assert not r["correct"], (fault, r["checks"])
    if fault == "frozen":
        assert r["checks"]["change"]["value"] == 1.0
        assert r["checks"]["grad"]["value"] == 1.0


@pytest.mark.parametrize("name", CELLS[:2])
def test_bf16_program_on_the_cpu_follows_the_reference(name):
    # bfloat16 parameters with float32 masters, the plain kernels: within a
    # few bfloat16 ulps of the float32 reference at this size
    r = harness.run(name, SEED, 0.0, False, device="cpu", cell=tiny_cell(name, "bf16"))
    assert all(c["value"] < 0.02 for c in r["checks"].values()), r["checks"]


@pytest.mark.parametrize("name", CELLS[:2])
def test_stale_working_copy_is_not_correct(name):
    # bfloat16 parameters under float32 masters: the masters move, the copy
    # the model computes with is not written; its change reads 1
    r = harness.run(name, SEED, 0.0, False, device="cpu", cell=tiny_cell(name, "bf16"),
                    fault="stale_copy")
    assert not r["correct"], r["checks"]
    assert r["checks"]["change"]["value"] == 1.0


def test_traced_run_reports_per_layer_metrics():
    name = "bert-large.seq512"
    r = harness.run(name, SEED, 5.0, True, device="cpu", cell=tiny_cell(name, "f32"))
    assert r["correct"]
    assert r["attempted"] == tiny_cell(name)["work"]["check_steps"] + harness.TRACE_UPDATES
    # nothing ran on a device: no reader finds anything, none reads 0
    assert r["metrics"] == {}
    assert r["device"]["busy_s"] == 0.0 and r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert harness.check_lines(r).startswith("check loss:")


def _run_cli(cwd, *extra):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "bert-large.seq512", "--seed", "7", "--seconds", "1", "--trace",
                           "0", *extra], cwd=cwd, capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_without_a_card_the_command_fails_and_prints_no_result():
    p = _run_cli(spec.ROOT)
    assert p.returncode == 2 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_without_the_program_the_command_fails(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_cli(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
    json.loads((tmp_path / "BENCHMARK.json").read_text())
