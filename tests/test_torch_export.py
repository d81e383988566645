"""Export on ``torch.export`` held against JAX's ``jax.export``.

From the same weights (carried from JAX with ``interop.params_from_jax``)
each model is exported by both packages from a one-row sample and called
through each package's ``load_exported`` at a batch size the trace never
saw: the housing MLP, the tiny BERT classifier (the port through the flash
forward operator's CPU implementation, JAX through its dense core) and the
tiny GPT (causal). Outputs agree within 1e-6, classes exactly (GPT's
logits within 1e-5: its forward alone, unexported, differs from JAX's by up
to 2e-6, and ``tests/test_torch_gpt.py`` holds it at 1e-5); each port
artifact equals the port's own forward bit for bit; the manifests agree. The BestExporter writes JAX's ``best_metric.json``. The
port's artifact holds the operator ``gradaccum::flash_fwd`` and loads
without the model code; the entry points' ``--export-dir`` and
``--export-best-dir`` write artifacts that load and serve unseen batch
sizes.
"""

import ast
import importlib
import json
import os

import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.estimator import export as texport
from gradaccum_tpu_torch.estimator.config import EvalSpec, RunConfig, TrainSpec
from gradaccum_tpu_torch.estimator.estimator import Estimator
from gradaccum_tpu_torch.interop import params_from_jax
from gradaccum_tpu_torch.models import bert as tbert
from gradaccum_tpu_torch.models import gpt as tgpt
from gradaccum_tpu_torch.models import housing_mlp as thousing
from gradaccum_tpu_torch.ops import flash_attention as tfa
from gradaccum_tpu_torch.ops.accumulation import GradAccumConfig
from gradaccum_tpu_torch.ops.adamw import adam
from gradaccum_tpu_torch.utils.tree import named_parameters

jax = pytest.importorskip("jax")
jexport = importlib.import_module("gradaccum_tpu.estimator.export")
jbert = importlib.import_module("gradaccum_tpu.models.bert")
jgpt = importlib.import_module("gradaccum_tpu.models.gpt")
jhousing = importlib.import_module("gradaccum_tpu.models.housing_mlp")
jest = importlib.import_module("gradaccum_tpu.estimator.estimator")
jconfig = importlib.import_module("gradaccum_tpu.estimator.config")
jacc = importlib.import_module("gradaccum_tpu.ops.accumulation")
jopt = importlib.import_module("gradaccum_tpu.ops.adamw")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

OUT_TOL = dict(rtol=1e-6, atol=1e-6)  # exported outputs against JAX's
# GPT's forward itself (no export) is 2e-6 from JAX's at these weights
GPT_TOL = dict(rtol=1e-5, atol=1e-5)
S = 16


def _housing(n, seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.uniform(0, 10, size=(n, 14)).astype(np.float32),
            "y": rng.normal(20, 5, size=(n, 1)).astype(np.float32)}


def _bert(n, seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((n, S), np.int32)
    mask[0, S - 5:] = 0
    return {"input_ids": (rng.integers(5, 128, size=(n, S)) * mask).astype(np.int32),
            "input_mask": mask, "segment_ids": np.zeros((n, S), np.int32)}


def _gpt(n, seed):
    return {"input_ids": np.random.default_rng(seed).integers(
        0, 64, size=(n, S)).astype(np.int32)}


CASES = {
    "mlp": (jhousing.housing_mlp_bundle, thousing.housing_mlp_bundle, _housing),
    "bert": (lambda: jbert.bert_classifier_bundle(jbert.BertConfig.tiny_for_tests()),
             lambda: tbert.bert_classifier_bundle(tbert.BertConfig.tiny_for_tests(),
                                                  attention_fn=tfa.flash_attention),
             _bert),
    "gpt": (lambda: jgpt.gpt_lm_bundle(jgpt.GPTConfig.tiny_for_tests(dropout=0.0)),
            lambda: tgpt.gpt_lm_bundle(tgpt.GPTConfig.tiny_for_tests(dropout=0.0),
                                       attention_fn=tfa.causal_flash_attention),
            _gpt),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_export_roundtrip_matches_jax_at_an_unseen_batch(tmp_path, case):
    j_make, t_make, make = CASES[case]
    jb, tb = j_make(), t_make()
    sample = make(1, 0)  # one row, as JAX's callers export
    params = jax.device_get(jb.init(jax.random.PRNGKey(0), sample))
    model = tb.init(1, "cpu")
    model.load_state_dict(params_from_jax(params))

    jexport.export_predict(jb.predict, params, sample, str(tmp_path / "j"))
    path = texport.export_predict(tb.predict, model, sample, str(tmp_path / "t"))
    assert path == str(tmp_path / "t" / "model.pt2")
    batch = make(5, 1)  # a batch size the trace never saw
    want = jexport.load_exported(str(tmp_path / "j"))(batch)
    got = texport.load_exported(str(tmp_path / "t"))(batch)
    assert got.keys() == want.keys()
    for key in want:
        w, g = np.asarray(want[key]), got[key].numpy()
        assert g.shape == w.shape, key
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, err_msg=key,
                                       **(GPT_TOL if case == "gpt" else OUT_TOL))
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)
    # the same outputs as the model itself, and a one-row call works too
    direct = tb.predict(model, {k: torch.as_tensor(v) for k, v in batch.items()})
    for key in direct:
        assert torch.equal(got[key], direct[key]), key
    one = texport.load_exported(str(tmp_path / "t"))(make(1, 2))
    assert all(v.shape[0] == 1 for v in one.values())

    jm, tm = jexport.load_manifest(str(tmp_path / "j")), texport.load_manifest(
        str(tmp_path / "t"))
    assert tm["inputs"] == jm["inputs"] and tm["batch_polymorphic"] is True
    assert tm["outputs"].keys() == jm["outputs"].keys()
    for key, spec in jm["outputs"].items():
        assert tm["outputs"][key]["shape"] == spec["shape"], key
        if spec["dtype"].startswith("float"):
            assert tm["outputs"][key]["dtype"] == spec["dtype"], key
        else:  # argmax: int64 in torch, int32 in JAX
            assert tm["outputs"][key]["dtype"] in ("int64", spec["dtype"]), key


def test_the_artifact_holds_the_flash_operator_and_no_model_code(tmp_path):
    tb = CASES["bert"][1]()
    model = tb.init(1, "cpu")
    texport.export_predict(tb.predict, model, _bert(1, 0), str(tmp_path))
    program = torch.export.load(str(tmp_path / "model.pt2"))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("gradaccum.flash_fwd.default") == 2  # one per layer
    # load_exported needs the operator library, and no model module
    tree = ast.parse(open(texport.__file__).read())
    imported = {a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
                for a in node.names}
    imported |= {node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)}
    ours = {m for m in imported if m and m.startswith("gradaccum_tpu_torch")}
    assert ours == {"gradaccum_tpu_torch.ops.flash_attention"}


def test_flash_operator_fake_and_devices():
    q = torch.randn(2, 2, 8, 16)
    o, lse = tfa.flash_fwd_op(q, q, q, None, None, False, 0.0)
    want_o, want_lse = tfa.flash_forward_reference(q, q, q, None, None, False, 0.0)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    with torch._subclasses.fake_tensor.FakeTensorMode():
        fo, flse = tfa.flash_fwd_op(torch.empty(2, 2, 8, 16, device="cuda"),
                                    torch.empty(2, 2, 8, 16, device="cuda"),
                                    torch.empty(2, 2, 8, 16, device="cuda"),
                                    None, None, True, 0.0)
        assert fo.shape == (2, 2, 8, 16) and fo.device.type == "cuda"
        assert flse.shape == (2, 2, 8, 1) and flse.dtype == torch.float32
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))


def _linear_pair(tmp_path, best_dir):
    jb = jhousing.housing_mlp_bundle()
    tb = thousing.housing_mlp_bundle()
    params = jax.device_get(jb.init(jax.random.PRNGKey(0), _housing(1, 0)))
    train = [_housing(8, i) for i in range(12)]
    evald = [_housing(16, 99)]
    run = dict(save_checkpoints_steps=None, log_step_count_steps=4)
    spec = dict(throttle_secs=0, export_best_dir=None, best_metric="rmse", best_mode="min")
    jes = jest.Estimator(jb, jopt.adam(1e-2), jacc.GradAccumConfig(num_micro_batches=2),
                         jconfig.RunConfig(model_dir=str(tmp_path / "jm"), **run),
                         mode="streaming", warm_start=params)
    carried = tb.init(1, "cpu")
    carried.load_state_dict(params_from_jax(params))
    tes = Estimator(tb, adam(1e-2), GradAccumConfig(num_micro_batches=2),
                    RunConfig(model_dir=str(tmp_path / "tm"), **run), mode="streaming",
                    device="cpu", warm_start={k: v.detach().clone() for k, v in
                                              named_parameters(carried).items()})
    jes.train_and_evaluate(jconfig.TrainSpec(lambda: iter(train), max_steps=12),
                           jconfig.EvalSpec(lambda: iter(evald), **dict(
                               spec, export_best_dir=str(tmp_path / "jb"))))
    tes.train_and_evaluate(TrainSpec(lambda: iter(train), max_steps=12),
                           EvalSpec(lambda: iter(evald), **dict(spec, export_best_dir=best_dir)))
    return tes


def test_best_exporter_writes_jax_best_metric_json(tmp_path):
    best = str(tmp_path / "tb")
    tes = _linear_pair(tmp_path, best)
    with open(os.path.join(best, "best_metric.json")) as f:
        got = json.load(f)
    with open(tmp_path / "jb" / "best_metric.json") as f:
        want = json.load(f)
    assert got.keys() == want.keys() == {"metric", "value", "step"}
    assert (got["metric"], got["step"]) == (want["metric"], want["step"]) == ("rmse", 12)
    np.testing.assert_allclose(got["value"], want["value"], rtol=2e-6)
    # the label key is stripped from the default signature, as in JAX
    assert texport.load_manifest(best)["inputs"].keys() == {"x"}
    out = texport.load_exported(best)({"x": _housing(3, 5)["x"]})
    assert out["predictions"].shape == (3, 1)
    # a worse value never replaces the best one
    tes._maybe_export_best(EvalSpec(None, export_best_dir=best, best_metric="rmse",
                                    best_mode="min"), {"rmse": got["value"] + 1.0},
                           tes._state)
    with open(os.path.join(best, "best_metric.json")) as f:
        assert json.load(f) == got
    with pytest.raises(ValueError, match="best_mode"):
        tes._maybe_export_best(EvalSpec(None, export_best_dir=best, best_mode="up"),
                               {"accuracy": 1.0}, tes._state)


def test_entry_points_export_artifacts_that_load_without_the_model(tmp_path):
    from gradaccum_tpu_torch.examples import bert_finetune, gpt_lm

    out = bert_finetune.main(["--device", "cpu", "--max-steps", "4", "--seq-len", "16",
                              "--accum-k", "2", "--model-dir", str(tmp_path / "m"),
                              "--export-dir", str(tmp_path / "e"),
                              "--export-best-dir", str(tmp_path / "b")])
    assert out["export"] == str(tmp_path / "e" / "model.pt2")
    for d in ("e", "b"):
        m = texport.load_manifest(str(tmp_path / d))
        assert m["inputs"].keys() == {"input_ids", "input_mask", "segment_ids"}
        assert m["inputs"]["input_ids"]["shape"] == [1, 16]
    with open(tmp_path / "b" / "best_metric.json") as f:
        best = json.load(f)
    assert best["metric"] == "accuracy" and best["step"] in (2, 4)
    rng = np.random.default_rng(3)
    batch = {"input_ids": rng.integers(0, out["vocab_size"], size=(3, 16)).astype(np.int32),
             "input_mask": np.ones((3, 16), np.int32),
             "segment_ids": np.zeros((3, 16), np.int32)}
    got = texport.load_exported(str(tmp_path / "e"))(batch)
    assert got["logits"].shape == (3, 2) and torch.isfinite(got["logits"]).all()

    lm = gpt_lm.main(["--device", "cpu", "--max-steps", "4", "--flash", "--sample", "0",
                      "--export-dir", str(tmp_path / "g")])
    assert lm["export"] == str(tmp_path / "g" / "model.pt2")
    ids = np.random.default_rng(4).integers(0, 256, size=(2, 64)).astype(np.int32)
    g = texport.load_exported(str(tmp_path / "g"))({"input_ids": ids})
    assert g["logits"].shape == (2, 64, 256) and g["next_token"].shape == (2,)
