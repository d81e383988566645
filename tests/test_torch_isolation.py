"""The port stands alone and runs on the card unless told otherwise.

- Importing every module of ``gradaccum_tpu_torch`` (and ``chip_smoke.py``)
  loads neither ``jax`` nor ``gradaccum_tpu``; with ``jax``,
  ``gradaccum_tpu``, ``triton``, ``transformers`` and ``safetensors`` all
  blocked, every module still imports and a HuggingFace checkpoint
  directory still loads (the card's machine has neither of the last two).
- Without a card, the Estimator and the entry points (BERT, MNIST, housing)
  at their default device raise instead of running on the CPU (housing's
  ``--export-dir`` writes an artifact that loads), and
  ``chip_smoke.py`` exits non-zero without printing a result; each entry
  point runs on the CPU when asked.
- The kernel wrappers refuse CPU tensors, and ``flash_attention`` on CPU
  tensors reaches the plain versions: the launch counts stay 0.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.ops import flash_attention as tfa

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import gradaccum_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gradaccum_tpu_torch.__path__,
                                               "gradaccum_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(json.dumps({"modules": names, "loaded": sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "gradaccum_tpu"))}))
"""


# every top-level name in BLOCKED imports as if it were not installed
_BLOCKED_PROBE = """
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "gradaccum_tpu", "triton", "transformers", "safetensors")
for name in BLOCKED:
    sys.modules[name] = None
import gradaccum_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gradaccum_tpu_torch.__path__,
                                               "gradaccum_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from gradaccum_tpu_torch.models.bert_checkpoint import load_hf_checkpoint
cfg, params = load_hf_checkpoint(sys.argv[1])
print(len(names), len(params), cfg.vocab_size)
"""


# the observability, resilience, export, native-data, parallel and serving
# modules: each imports here and in the blocked probe below
NEW_MODULES = ("obs", "obs.trace", "obs.metrics", "obs.flight", "resilience",
               "resilience.retry", "resilience.manifest", "resilience.faults",
               "resilience.preemption", "estimator.events", "estimator.export",
               "utils.timing", "utils.profiling", "data.native",
               # sequence and pipeline parallelism
               "parallel.sp", "parallel.pp", "parallel.ulysses", "models.bert_pp",
               "examples.bench_longcontext",
               # the serving stack's core
               "utils.prng", "models.gpt_decode", "serving", "serving.scheduler",
               "serving.metrics", "serving.cache_pool", "serving.engine", "serving.server",
               "examples.bench_serving")


def _run(args, cwd=ROOT, timeout=120):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card refusals do not apply")


def test_importing_the_port_loads_no_jax():
    out = _run(["-c", _PROBE])
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert "gradaccum_tpu_torch.ops.flash_attention" in report["modules"]
    assert "gradaccum_tpu_torch.examples.bert_finetune" in report["modules"]
    for name in ("memory.quant", "models.gpt", "examples.gpt_lm") + NEW_MODULES:
        assert f"gradaccum_tpu_torch.{name}" in report["modules"]
    assert len(report["modules"]) >= 23 + len(NEW_MODULES)
    assert report["loaded"] == []


def test_the_port_imports_with_jax_triton_transformers_and_safetensors_blocked():
    fixture = os.path.join(ROOT, "tests", "fixtures", "bert_hf_tiny")
    out = _run(["-c", _BLOCKED_PROBE, fixture])
    assert out.returncode == 0, out.stderr
    n_modules, n_params, vocab = map(int, out.stdout.split())
    assert n_modules >= 23 + len(NEW_MODULES) and n_params > 0 and vocab == 24


def _tiny_estimator(**kw):
    from gradaccum_tpu_torch.estimator.estimator import Estimator
    from gradaccum_tpu_torch.models.bert import BertConfig, bert_classifier_bundle
    from gradaccum_tpu_torch.ops.accumulation import GradAccumConfig
    from gradaccum_tpu_torch.ops.adamw import adamw

    bundle = bert_classifier_bundle(BertConfig.tiny_for_tests(),
                                    attention_fn=tfa.flash_attention)
    return Estimator(bundle, adamw(1e-3), GradAccumConfig(2, clip_norm=1.0), **kw)


def test_estimator_defaults_to_the_card_and_raises_without_one():
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _tiny_estimator()
    assert _tiny_estimator(device="cpu").device.type == "cpu"


def test_entry_point_defaults_to_the_card_and_raises_without_one():
    _no_card()
    from gradaccum_tpu_torch.examples import bert_finetune

    with pytest.raises(RuntimeError, match="no CUDA device"):
        bert_finetune.main(["--max-steps", "4", "--seq-len", "16", "--accum-k", "2"])


def test_entry_point_script_runs_on_the_cpu_when_asked():
    out = _run([os.path.join("gradaccum_tpu_torch", "examples", "bert_finetune.py"),
                "--device", "cpu", "--max-steps", "4", "--seq-len", "16", "--accum-k", "2"])
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["device"] == "cpu" and result["updates"] == 2
    assert np.isfinite(result["loss"]) and result["mfu"] is None


SMALL_ENTRY_POINTS = {
    "mnist": ["--variant", "02", "--max-steps", "4", "--train-size", "256",
              "--eval-batch", "256"],
    "housing": ["--max-steps", "6"],
}


@pytest.mark.parametrize("name", sorted(SMALL_ENTRY_POINTS))
def test_small_entry_points_default_to_the_card_and_raise_without_one(name):
    _no_card()
    import importlib

    module = importlib.import_module(f"gradaccum_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(SMALL_ENTRY_POINTS[name])


@pytest.mark.parametrize("name", sorted(SMALL_ENTRY_POINTS))
def test_small_entry_point_scripts_run_on_the_cpu_when_asked(name):
    out = _run([os.path.join("gradaccum_tpu_torch", "examples", f"{name}.py"),
                "--device", "cpu", "--mode", "streaming", *SMALL_ENTRY_POINTS[name]])
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["device"] == "cpu" and result["mode"] == "streaming"
    assert np.isfinite(result["loss"]) and np.isfinite(result["first_loss"])
    if name == "housing":
        assert len(result["predictions"]) == 5 and np.isfinite(result["test_rmse"])
    else:
        assert result["updates"] == 2 and 0.0 <= result["accuracy"] <= 1.0


@pytest.mark.parametrize("name,argv", [
    ("mnist", ["--variant", "03", "--device", "cpu"]),
    ("mnist", ["--variant", "04", "--device", "cpu"]),
    ("housing", ["--export-dir", "EXPORT", "--device", "cpu", "--max-steps", "6"]),
])
def test_unported_entry_point_options_raise(name, argv, monkeypatch, tmp_path):
    import importlib

    module = importlib.import_module(f"gradaccum_tpu_torch.examples.{name}")
    if name == "housing":  # --export-dir is ported: it writes a loadable artifact
        from gradaccum_tpu_torch.estimator.export import load_exported

        export_dir = str(tmp_path / "export")
        out = module.main([export_dir if a == "EXPORT" else a for a in argv])
        assert out["export"] == os.path.join(export_dir, "model.pt2")
        got = load_exported(export_dir)({"x": np.ones((3, 14), np.float32),
                                         "y": np.zeros((3, 1), np.float32)})
        assert got["predictions"].shape == (3, 1)
        return
    # MNIST 03 and 04 are ported: the command hands its two workers to the
    # launcher as two CPU ranks (tests/test_torch_dp_examples.py trains them)
    launched = []
    monkeypatch.setattr(module, "spawn_ranks",
                        lambda *a, **kw: launched.append(a) or {"workers": 2})
    assert module.main(argv) == {"workers": 2}
    assert launched == [("gradaccum_tpu_torch.examples.mnist", argv, 2, "cpu")]


def test_chip_smoke_refuses_without_a_card(tmp_path):
    _no_card()
    out = _run(["chip_smoke.py"])
    assert out.returncode != 0 and '"ok"' not in out.stdout
    # alone in a directory, without the package beside it
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py"], cwd=tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_flash_on_cpu_tensors_launches_no_kernel():
    tfa.reset_launch_counts()
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.normal(size=(1, 2, 32, 16)).astype(np.float32),
                            requires_grad=True) for _ in range(3))
    mask = torch.zeros(1, 1, 1, 32, requires_grad=True)
    o = tfa.flash_attention(q, k, v, mask, dropout_rate=0.1, dropout_seed=7)
    o.sum().backward()
    assert q.grad is not None and mask.grad is not None
    assert tfa.launch_counts() == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


@pytest.mark.parametrize("name", sorted(tfa.KERNELS))
def test_kernel_wrappers_refuse_cpu_tensors(name):
    x = torch.zeros(1, 1, 16, 16)
    rows = torch.zeros(1, 1, 16, 1)
    args = {"flash_fwd": (x, x, x, None, None, False, 0.0),
            "flash_bwd_dq": (x, x, x, None, None, x, x, rows, False, 0.0),
            "flash_bwd_dkv": (x, x, x, None, None, x, rows, rows, False, 0.0)}[name]
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.KERNELS[name](*args)
    assert tfa.KERNELS[name].launches == 0
