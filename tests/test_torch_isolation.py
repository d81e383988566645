"""The port stands alone and runs on the card unless told otherwise.

- Importing every module of ``gradaccum_tpu_torch`` (and ``chip_smoke.py``)
  loads neither ``jax`` nor ``gradaccum_tpu``; with ``jax``,
  ``gradaccum_tpu``, ``triton``, ``transformers`` and ``safetensors`` all
  blocked, every module still imports and a HuggingFace checkpoint
  directory still loads (the card's machine has neither of the last two);
  with ``ml_dtypes`` blocked too (the card's numpy has no bfloat16), a
  bfloat16 pool's K/V goes through the swap store and the disk rung.
- Without a card, the Estimator and the entry points (BERT, MNIST, housing)
  at their default device raise instead of running on the CPU (housing's
  ``--export-dir`` writes an artifact that loads), as do ``bench_heal`` and
  ``chaos_smoke``, and ``chip_smoke.py`` exits non-zero without printing a
  result; each entry point runs on the CPU when asked.
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
               "examples.bench_serving",
               # admission control, swap, the tiered store and the int8 KV codec
               "serving.admission", "serving.swap", "memory.tiers",
               "examples.bench_admission", "examples.bench_mem",
               # the serving fault contract and the live ops plane
               "resilience.watchdog", "resilience.remediation", "obs.slo",
               "obs.sentinel", "obs.telemetry", "examples.bench_slo",
               "examples.slo_check", "examples.bench_cow", "examples.bench_spec",
               # live reconfiguration and the replica fleet
               "serving.reconfig", "serving.fleet", "serving.replicated",
               "examples.bench_reconfig", "examples.bench_fleet",
               # the self-healing ladder
               "resilience.healer", "examples.bench_heal", "examples.chaos_smoke",
               # the serving mesh
               "examples.serving_smoke",
               # the server over a multi-rank mesh, and the operator tools
               "serving.follower", "examples.obs_report", "examples.bench_obs",
               "examples.bench_trend", "examples.bench_mixed")


# a bfloat16 pool's K/V through the host store and the disk rung, with
# ml_dtypes blocked as well: the card's machine has numpy without it, so a
# record must hold the raw bits (an int16 view) and never a numpy bfloat16
_BF16_SWAP_PROBE = """
import sys, tempfile
for name in ("jax", "jaxlib", "flax", "gradaccum_tpu", "ml_dtypes"):
    sys.modules[name] = None
import numpy as np, torch
from gradaccum_tpu_torch.interop import params_tree
from gradaccum_tpu_torch.memory.tiers import TieredStore
from gradaccum_tpu_torch.models.gpt import GPTConfig, gpt_lm_bundle
from gradaccum_tpu_torch.serving import Engine
cfg = GPTConfig.tiny_for_tests(dropout=0.0)
params = params_tree(gpt_lm_bundle(cfg).init(0, "cpu"))
prompt = np.arange(1, 7, dtype=np.int32)
streams = []
for swap in ("host", "tiered", None):
    kw = dict(swap=swap, admission="quantile") if swap else {}
    eng = Engine(params, cfg, num_slots=2, max_len=32, page_size=4, device="cpu",
                 cache_dtype=torch.bfloat16, **kw)
    if swap == "tiered":
        eng._swap_store = TieredStore(host_max_bytes=64, disk_dir=tempfile.mkdtemp())
    rid = eng.submit(prompt, 10)
    if swap:
        for _ in range(3):
            eng.step()
        assert eng.preempt(rid)
    eng.run_until_idle()
    assert eng.metrics.swap_ins == (1 if swap else 0), swap
    streams.append(list(eng.results[rid]))
assert streams[0] == streams[1] == streams[2], streams
print("ok", "ml_dtypes" in sys.modules and sys.modules["ml_dtypes"] is None)
"""


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


def test_bf16_swap_records_need_no_numpy_bfloat16():
    out = _run(["-c", _BF16_SWAP_PROBE])
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", "True"]


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


@pytest.mark.parametrize("name", ["bench_heal", "chaos_smoke"])
def test_healer_benches_default_to_the_card_and_raise_without_one(name):
    _no_card()
    import importlib

    module = importlib.import_module(f"gradaccum_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--fast"] if name == "bench_heal" else [])


@pytest.mark.parametrize("name,argv", [
    ("bench_heal", ["--fast", "--delay", "0.12"]),
    ("chaos_smoke", ["--seed", "2"]),
])
def test_healer_bench_scripts_run_on_the_cpu_when_asked(name, argv, tmp_path):
    """Each script runs tiny on the CPU, passes JAX's acceptance and writes
    only the artifact it was given."""
    out_file = tmp_path / f"{name}.json"
    out = _run([os.path.join("gradaccum_tpu_torch", "examples", f"{name}.py"), *argv,
                "--device", "cpu", "--json", str(out_file)], timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    with open(out_file) as f:
        artifact = json.load(f)
    assert artifact["acceptance"]["passed"] is True and artifact["device"] == "cpu"
    assert os.listdir(tmp_path) == [out_file.name]


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
