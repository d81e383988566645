"""The port's data-parallel entry points held against JAX's examples.

- ``bert_finetune --dp/--zero1`` and ``gpt_lm --dp/--zero1``: every parser
  error JAX raises for these flags, with the same message on the same argv
  (``--dp 0``, ``--zero1`` at ``--dp 1``, and more ranks than devices, the
  port's device count set to the 8 virtual devices JAX sees here). JAX's
  ``--flash --dp`` refusal is the CPU's missing compiled kernel; the port's
  CPU route is the plain version, so it accepts the pair.
- MNIST variant 04 (two workers, batch 50 per worker, K=2) runs as two
  ranks spawned by the command itself, into a stale ``--model-dir`` that
  rank 0 alone empties, and variant 03 (two workers, batch
  100, K=1) under ``torchrun --standalone --nproc-per-node 2``, both with
  ``--device cpu --max-steps 20 --train-size 512``: one JSON line from rank
  0, two workers, a finite loss that falls.
- ``bert_finetune --dp 2 --zero1`` and ``gpt_lm --dp 2 --zero1 --flash``
  train a few steps on two CPU ranks and print their JSON line.

    python -m pytest -m torch tests/test_torch_dp_examples.py
"""

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gradaccum_tpu_torch.examples import bert_finetune as tbf
from gradaccum_tpu_torch.examples import gpt_lm as tlm
from gradaccum_tpu_torch.examples import mnist as tmnist

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
jbf = importlib.import_module("examples.bert_finetune")
jlm = importlib.import_module("examples.gpt_lm")

pytestmark = pytest.mark.torch
JAX_DEVICES = 8  # tests/conftest.py's virtual CPU devices


def _error_line(capsys):
    return capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1]


@pytest.mark.parametrize("example", ["bert_finetune", "gpt_lm"])
@pytest.mark.parametrize("argv", [["--dp", "0"], ["--zero1"], ["--zero1", "--dp", "1"],
                                  ["--dp", "16"], ["--dp", "16", "--zero1"]],
                         ids=["dp-0", "zero1-alone", "zero1-dp-1", "dp-past-devices",
                              "dp-past-devices-zero1"])
def test_dp_parser_errors_match_jax(example, argv, tmp_path, capsys, monkeypatch):
    jax_main = {"bert_finetune": jbf.main, "gpt_lm": jlm.main}[example]
    port = {"bert_finetune": tbf, "gpt_lm": tlm}[example]
    with pytest.raises(SystemExit):
        jax_main([*argv, "--model-dir", str(tmp_path / "jax")])
    want = _error_line(capsys)
    # as many cards as JAX has devices here, so "--device cuda" parses
    monkeypatch.setattr(port, "available_devices", lambda device: JAX_DEVICES)
    with pytest.raises(SystemExit):
        port.main([*argv, "--device", "cuda"])
    assert _error_line(capsys) == want


def test_flash_dp_is_refused_by_jax_on_the_cpu_only(tmp_path, capsys):
    with pytest.raises(SystemExit):
        jlm.main(["--flash", "--dp", "2", "--model-dir", str(tmp_path / "jax")])
    assert "needs the compiled TPU kernel" in _error_line(capsys)
    args = tlm.parse_args(["--flash", "--dp", "2", "--device", "cpu"])
    assert args.flash and args.dp == 2
    args = tbf.parse_args(["--dp", "2", "--zero1", "--device", "cpu"])
    assert args.dp == 2 and args.zero1


def _check_mnist(out, variant):
    assert out["variant"] == variant and out["workers"] == 2 and out["device"] == "cpu"
    assert out["steps"] == 20 and np.isfinite(out["first_loss"]) and np.isfinite(out["loss"])
    assert out["loss"] < out["first_loss"]
    assert 0.0 <= out["accuracy"] <= 1.0


def test_mnist_04_spawns_two_ranks_and_learns(tmp_path):
    # a stale model directory: rank 0 alone empties it, the others wait
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    (model_dir / "stale.txt").write_text("from an earlier run")
    out = tmnist.main(["--variant", "04", "--device", "cpu", "--max-steps", "20",
                       "--train-size", "512", "--model-dir", str(model_dir)])
    _check_mnist(out, "04")
    assert out["updates"] == 10 and out["accum_k"] == 2
    written = sorted(p.name for p in model_dir.iterdir())
    assert "stale.txt" not in written and "ckpt-20.pt" in written, written


def test_mnist_03_under_torchrun_learns():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(REPO), os.environ.get("PYTHONPATH")])), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "gradaccum_tpu_torch.examples.mnist", "--variant", "03", "--device", "cpu",
         "--max-steps", "20", "--train-size", "512", "--mode", "streaming"],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1  # rank 0 alone prints
    out = json.loads(lines[0])
    _check_mnist(out, "03")
    assert out["mode"] == "streaming" and out["accum_k"] == 1


def test_bert_and_gpt_entry_points_train_on_two_ranks():
    out = tbf.main(["--device", "cpu", "--dp", "2", "--zero1", "--max-steps", "4",
                    "--seq-len", "16", "--accum-k", "2", "--train-size", "64"])
    assert out["dp"] == 2 and out["zero1"] and out["updates"] == 2
    assert np.isfinite(out["loss"]) and 0.0 <= out["accuracy"] <= 1.0
    out = tlm.main(["--device", "cpu", "--dp", "2", "--zero1", "--flash", "--max-steps", "4",
                    "--seq-len", "32", "--sample", "0"])
    assert out["dp"] == 2 and out["zero1"] and out["updates"] == 2
    assert np.isfinite(out["loss"]) and 0.0 <= out["token_accuracy"] <= 1.0
