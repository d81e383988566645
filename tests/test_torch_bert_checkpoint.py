"""Loading a pretrained HuggingFace BERT into the port, and warm-starting from it.

- On the committed fixture ``tests/fixtures/bert_hf_tiny`` (written by
  ``transformers.save_pretrained``) the port's ``load_hf_checkpoint``, which
  reads the directory itself, equals JAX's ``load_hf_checkpoint`` (through
  ``transformers``) carried over with ``interop.params_from_jax``, bit for
  bit, and the same config.
- The port's safetensors reader equals the ``safetensors`` package (present
  here, not on the card) on the fixture and on BF16 and F16 files; the
  sharded and ``pytorch_model.bin`` forms read the same tensors.
- Config defaults, the ``bert.`` prefix, the head rules, the ``hidden_act``
  refusal and missing-tensor errors.
- The loaded encoder's outputs equal ``transformers.BertModel``'s to 1e-5.
- ``Estimator(warm_start=)`` is strict, and a checkpoint in ``model_dir``
  wins over it.
- The reference's chain in-process on the fixture (``--hf-checkpoint``,
  ``--data-dir``, seq 32, K=2, 8 micro-steps, ``--device cpu``), and a short
  warm-started trajectory held against JAX's warm-started Estimator with
  dropout off: parameters within 2e-6 after 4 updates at lr 1e-4. At lr
  1e-3 the AdamW amplification ``tests/test_torch_accumulation.py``
  explains (about 100·g per update for a gradient far below eps) carries
  float32 summation-order differences to ~7e-6 over 4 constant-rate
  updates; at 1e-4 it is ten times smaller (~4e-7) while the weights still
  move by ~1e-3.
"""

import dataclasses
import importlib
import json
import os
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.data.tokenization import load_vocab
from gradaccum_tpu_torch.estimator import checkpoint as tckpt
from gradaccum_tpu_torch.estimator.config import RunConfig
from gradaccum_tpu_torch.estimator.estimator import Estimator
from gradaccum_tpu_torch.examples import bert_finetune
from gradaccum_tpu_torch.interop import params_from_jax, params_to_jax, state_dict_key
from gradaccum_tpu_torch.models import bert as tbert
from gradaccum_tpu_torch.models import bert_checkpoint as tbc
from gradaccum_tpu_torch.ops import accumulation as tacc
from gradaccum_tpu_torch.ops import adamw as tadamw
from gradaccum_tpu_torch.ops import flash_attention as tfa
from gradaccum_tpu_torch.utils.tree import named_parameters

safetensors_torch = pytest.importorskip("safetensors.torch")
transformers = pytest.importorskip("transformers")

jbc = importlib.import_module("gradaccum_tpu.models.bert_checkpoint")
jbert = importlib.import_module("gradaccum_tpu.models.bert")
jacc = importlib.import_module("gradaccum_tpu.ops.accumulation")
jadamw = importlib.import_module("gradaccum_tpu.ops.adamw")
jest_mod = importlib.import_module("gradaccum_tpu.estimator.estimator")
jconfig = importlib.import_module("gradaccum_tpu.estimator.config")
jtree = importlib.import_module("gradaccum_tpu.utils.tree")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "bert_hf_tiny"
PARAM_ATOL = 2e-6
TRAJ_LR = 1e-4
CONFIG_FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads", "intermediate_size",
                 "max_position_embeddings", "type_vocab_size", "hidden_dropout",
                 "attention_dropout", "layer_norm_eps")


def _same_config(port_cfg, jax_cfg):
    for field in CONFIG_FIELDS:
        assert getattr(port_cfg, field) == getattr(jax_cfg, field), field


def _assert_equal_to_jax(port_params, jax_params):
    want = params_from_jax(jax_params)
    got = {state_dict_key(name): t for name, t in port_params.items()}
    assert got.keys() == want.keys()
    for key, t in want.items():
        assert got[key].dtype == torch.float32
        assert torch.equal(got[key], t), key


def test_fixture_loads_bitwise_like_jax():
    cfg, params = tbc.load_hf_checkpoint(str(FIXTURE), num_classes=2)
    jcfg, jparams = jbc.load_hf_checkpoint(str(FIXTURE), num_classes=2)
    _same_config(cfg, jcfg)
    _assert_equal_to_jax(params, jparams)
    assert not params["params/classifier/kernel"].any()  # BertModel: zero head
    model = tbert.bert_classifier_bundle(cfg).init(0, "cpu")
    assert set(named_parameters(model)) == set(params)


def _hf_dir(tmp_path, cls="BertForSequenceClassification", num_labels=3, **cfg_kw):
    cfg = transformers.BertConfig(vocab_size=40, hidden_size=16, num_hidden_layers=2,
                                  num_attention_heads=2, intermediate_size=32,
                                  max_position_embeddings=32, num_labels=num_labels, **cfg_kw)
    torch.manual_seed(0)
    model = getattr(transformers, cls)(cfg)
    path = tmp_path / cls
    model.save_pretrained(str(path))
    return path


def test_sequence_classification_head_loads_like_jax(tmp_path):
    path = _hf_dir(tmp_path)
    assert any(k.startswith("bert.") for k in tbc.read_hf_state_dict(str(path)))
    cfg, params = tbc.load_hf_checkpoint(str(path), num_classes=3)
    jcfg, jparams = jbc.load_hf_checkpoint(str(path), num_classes=3)
    _same_config(cfg, jcfg)
    _assert_equal_to_jax(params, jparams)
    assert params["params/classifier/kernel"].shape == (3, 16) and \
        params["params/classifier/kernel"].any()
    with pytest.raises(ValueError, match="classifier head has 3 classes"):
        tbc.load_hf_checkpoint(str(path), num_classes=2)


def test_a_base_model_ignores_a_head_in_its_files(tmp_path):
    path = _hf_dir(tmp_path)
    with open(path / "config.json") as f:
        config = json.load(f)
    config["architectures"] = ["BertModel"]
    with open(path / "config.json", "w") as f:
        json.dump(config, f)
    _, params = tbc.load_hf_checkpoint(str(path), num_classes=2)
    assert params["params/classifier/kernel"].shape == (2, 16)
    assert not params["params/classifier/kernel"].any()


def test_safetensors_reader_equals_the_package(tmp_path):
    want = safetensors_torch.load_file(str(FIXTURE / "model.safetensors"))
    got = tbc.read_safetensors(str(FIXTURE / "model.safetensors"))
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) and got[k].dtype == want[k].dtype for k in want)
    rng = np.random.default_rng(0)
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        tensors = {"a.weight": torch.tensor(rng.normal(size=(5, 3))).to(dtype),
                   "b": torch.tensor(rng.normal(size=(7,))).to(dtype),
                   "scalar": torch.tensor(1.5).to(dtype),
                   "empty": torch.zeros(0, 4, dtype=dtype)}
        path = tmp_path / f"{dtype}.safetensors"
        safetensors_torch.save_file(tensors, str(path), metadata={"format": "pt"})
        got = tbc.read_safetensors(str(path))
        assert got.keys() == tensors.keys()
        for k, t in tensors.items():
            assert got[k].dtype == dtype and got[k].shape == t.shape and torch.equal(got[k], t), k
    with pytest.raises(ValueError, match="dtype I64"):
        path = tmp_path / "ints.safetensors"
        safetensors_torch.save_file({"ids": torch.arange(3)}, str(path))
        tbc.read_safetensors(str(path))


def test_bf16_checkpoint_converts_to_float32(tmp_path):
    path = tmp_path / "bf16"
    shutil.copytree(FIXTURE, path)
    sd = safetensors_torch.load_file(str(path / "model.safetensors"))
    safetensors_torch.save_file({k: v.to(torch.bfloat16) for k, v in sd.items()},
                                str(path / "model.safetensors"), metadata={"format": "pt"})
    _, params = tbc.load_hf_checkpoint(str(path))
    table = params["params/bert/word_embeddings/embedding"]
    assert table.dtype == torch.float32
    assert torch.equal(table, sd["embeddings.word_embeddings.weight"].to(torch.bfloat16).float())


def test_sharded_and_pickled_forms_read_the_same_tensors(tmp_path):
    want = tbc.read_hf_state_dict(str(FIXTURE))
    names = sorted(want)
    sharded = tmp_path / "sharded"
    sharded.mkdir()
    shutil.copy(FIXTURE / "config.json", sharded)
    weight_map = {}
    for i, part in enumerate((names[::2], names[1::2])):
        shard = f"model-{i + 1:05d}-of-00002.safetensors"
        safetensors_torch.save_file({n: want[n] for n in part}, str(sharded / shard))
        weight_map.update({n: shard for n in part})
    with open(sharded / "model.safetensors.index.json", "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    pickled = tmp_path / "pickled"
    pickled.mkdir()
    shutil.copy(FIXTURE / "config.json", pickled)
    torch.save(want, str(pickled / "pytorch_model.bin"))
    for path in (sharded, pickled):
        got = tbc.read_hf_state_dict(str(path))
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want), path
    with pytest.raises(FileNotFoundError):
        tbc.read_hf_state_dict(str(tmp_path))


def test_config_defaults_prefix_and_refusals():
    cfg = tbc.config_from_hf({"vocab_size": 50, "hidden_size": 32, "num_hidden_layers": 1,
                              "num_attention_heads": 2, "intermediate_size": 64})
    assert (cfg.max_position_embeddings, cfg.type_vocab_size, cfg.layer_norm_eps,
            cfg.hidden_dropout, cfg.attention_dropout) == (512, 2, 1e-12, 0.1, 0.1)
    jcfg = jbc.config_from_hf(transformers.BertConfig(vocab_size=50, hidden_size=32,
                                                      num_hidden_layers=1,
                                                      num_attention_heads=2,
                                                      intermediate_size=64))
    _same_config(cfg, jcfg)
    assert tbc.config_from_hf({}).hidden_size == transformers.BertConfig().hidden_size
    with pytest.raises(ValueError, match="hidden_act='relu'"):
        tbc.config_from_hf({"hidden_act": "relu"})
    with pytest.raises(ValueError, match="erf-gelu"):
        jbc.config_from_hf(transformers.BertConfig(hidden_act="relu"))
    assert tbc.config_from_hf({}, dtype=torch.bfloat16).dtype == torch.bfloat16

    cfg, _ = tbc.load_hf_checkpoint(str(FIXTURE))
    sd = tbc.read_hf_state_dict(str(FIXTURE))
    plain = tbc.convert_hf_state_dict(sd, cfg, num_classes=2)
    prefixed = tbc.convert_hf_state_dict({f"bert.{k}": v for k, v in sd.items()}, cfg,
                                         num_classes=2)
    assert all(torch.equal(plain[n], prefixed[n]) for n in plain)
    with pytest.raises(ValueError, match="no classifier head"):
        tbc.convert_hf_state_dict(sd, cfg)
    lacking = {k: v for k, v in sd.items() if not k.startswith("pooler.")}
    with pytest.raises(ValueError, match=r"pooler\.dense\.bias.*pooler\.dense\.weight"):
        tbc.convert_hf_state_dict(lacking, cfg, num_classes=2)


def test_loaded_encoder_matches_transformers():
    cfg, params = tbc.load_hf_checkpoint(str(FIXTURE))
    model = tbert.bert_classifier_bundle(cfg, attention_fn=tfa.flash_attention).init(0, "cpu")
    with torch.no_grad():
        for name, p in named_parameters(model).items():
            p.copy_(params[name])
    hf = transformers.BertModel.from_pretrained(str(FIXTURE)).eval()
    rng = np.random.default_rng(0)
    mask = (np.arange(12)[None, :] < np.array([[12], [7]])).astype(np.int64)
    ids = torch.tensor(rng.integers(1, cfg.vocab_size, size=(2, 12)) * mask)
    with torch.no_grad():
        want = hf(input_ids=ids, attention_mask=torch.tensor(mask))
        seq, _ = model.bert(ids, torch.tensor(mask), None, True)
        pooled = torch.tanh(model.pooler(seq[:, 0]))
    np.testing.assert_allclose(seq.numpy(), want.last_hidden_state.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pooled.numpy(), want.pooler_output.numpy(), rtol=1e-5, atol=1e-5)


# -- warm start in the Estimator -------------------------------------------------


def _estimator(model_dir=None, warm_start=None, cfg=None, attention_fn=tfa.flash_attention,
               lr=1e-3, k=2):
    cfg = cfg or tbc.load_hf_checkpoint(str(FIXTURE))[0]
    return Estimator(tbert.bert_classifier_bundle(cfg, attention_fn=attention_fn),
                     tadamw.adamw(lr), tacc.GradAccumConfig(k, clip_norm=1.0),
                     RunConfig(model_dir=model_dir, log_step_count_steps=1000,
                               save_checkpoints_steps=None),
                     mode="scan", device="cpu", warm_start=warm_start)


def _fixture_batches(n_batches, k=2, micro=8, seq=32):
    texts, labels = bert_finetune.load_tsv(str(FIXTURE / "train.tsv"))
    tok = load_vocab(str(FIXTURE / "vocab.txt"))
    rows = n_batches * k * micro
    data = dict(tok.encode_batch(texts[:rows], max_seq_length=seq), label=labels[:rows])
    return [{key: v[i * k * micro:(i + 1) * k * micro] for key, v in data.items()}
            for i in range(n_batches)]


def test_warm_start_is_strict_and_a_checkpoint_wins(tmp_path):
    _, params = tbc.load_hf_checkpoint(str(FIXTURE))
    est = _estimator(warm_start=params)
    start = est.train([], final_save=False).params
    assert all(torch.equal(start[n].detach(), params[n]) for n in params)
    for bad, match in ((dict(list(params.items())[1:]), "missing"),
                       (dict(params, extra=torch.zeros(1)), "unexpected"),
                       (dict(params, **{"params/pooler/bias": torch.zeros(3)}), "shapes")):
        with pytest.raises(ValueError, match=match):
            _estimator(warm_start=bad).train([], final_save=False)
    # a run saves a checkpoint; a new warm-started Estimator on that model_dir
    # resumes from the checkpoint, not from the warm-start weights
    trained = _estimator(str(tmp_path), warm_start=params).train(_fixture_batches(2))
    assert tckpt.latest_checkpoint(str(tmp_path))[0] == trained.step == 4
    resumed = _estimator(str(tmp_path), warm_start=params).train([], final_save=False)
    assert resumed.step == 4
    assert all(torch.equal(resumed.params[n], trained.params[n]) for n in params)
    assert not torch.equal(resumed.params["params/classifier/kernel"],
                           params["params/classifier/kernel"])


def test_warm_started_trajectory_matches_jax():
    overrides = dict(hidden_dropout=0.0, attention_dropout=0.0)
    jcfg, jparams = jbc.load_hf_checkpoint(str(FIXTURE), num_classes=2, **overrides)
    jest = jest_mod.Estimator(
        jbert.bert_classifier_bundle(jcfg), jadamw.adamw(TRAJ_LR),
        jacc.GradAccumConfig(2, clip_norm=1.0, first_step_quirk=False),
        jconfig.RunConfig(log_step_count_steps=1000, save_checkpoints_steps=None),
        mode="scan", warm_start=jparams)
    batches = _fixture_batches(4)
    jstate = jest.train(batches)
    cfg, params = tbc.load_hf_checkpoint(str(FIXTURE), num_classes=2, **overrides)
    state = _estimator(warm_start=params, cfg=cfg, lr=TRAJ_LR).train(batches)
    assert state.step == int(jstate.step) == 8
    got = dict(jtree.named_leaves(params_to_jax(state.params)))
    want = dict(jtree.named_leaves(jax.device_get(jstate.params)))
    start = dict(jtree.named_leaves(params_to_jax(params)))
    moved = 0.0
    for name in want:
        np.testing.assert_allclose(got[name], np.asarray(want[name]), rtol=0, atol=PARAM_ATOL,
                                   err_msg=name)
        moved = max(moved, float(np.abs(np.asarray(want[name]) - start[name]).max()))
    assert moved > 100 * PARAM_ATOL


def test_the_fixture_chain_runs_in_process(tmp_path):
    model_dir = tmp_path / "chain"
    out = bert_finetune.main(["--hf-checkpoint", str(FIXTURE), "--data-dir", str(FIXTURE),
                              "--seq-len", "32", "--accum-k", "2", "--max-steps", "8",
                              "--model-dir", str(model_dir), "--device", "cpu"])
    assert out["warm_start"] == str(FIXTURE) and out["vocab_size"] == 24
    assert out["updates"] == 4 and np.isfinite(out["loss"])
    assert out["first_loss"] == pytest.approx(np.log(2.0), abs=1e-6)  # zero head: uniform
    assert 0.0 <= out["accuracy"] <= 1.0 and out["evaluations"] == 2
    assert (model_dir / "loss_vs_step.csv").exists()


def test_model_dir_starts_fresh_unless_resume(tmp_path):
    """As JAX's entry point (``examples/common.py :: prepare_model_dir``): a
    second run in the same ``--model-dir`` starts from the same state as
    the first, not from the first's checkpoint; with ``--resume`` it
    continues from that checkpoint."""
    model_dir = tmp_path / "run"
    argv = ["--hf-checkpoint", str(FIXTURE), "--data-dir", str(FIXTURE), "--seq-len", "32",
            "--accum-k", "2", "--model-dir", str(model_dir), "--device", "cpu"]
    first = bert_finetune.main([*argv, "--max-steps", "4"])
    again = bert_finetune.main([*argv, "--max-steps", "4"])
    assert first["steps"] == again["steps"] == 4
    assert first["timed_host_steps"] == again["timed_host_steps"] == 1  # 2 host steps each
    assert (again["first_loss"], again["loss"]) == (first["first_loss"], first["loss"])
    assert tckpt.latest_checkpoint(str(model_dir))[0] == 4
    resumed = bert_finetune.main([*argv, "--max-steps", "8", "--resume"])
    assert resumed["steps"] == 8 and resumed["timed_host_steps"] == 1  # 2 more host steps
    assert resumed["first_loss"] != first["first_loss"]  # a trained head, not the zero one
    assert tckpt.latest_checkpoint(str(model_dir))[0] == 8


@pytest.mark.parametrize("argv,match", [
    (["--seq-len", "65"], "position table"),
    (["--vocab", "VOCAB"], "does not match"),
    (["--num-experts", "2"], "cannot combine"),
    (["--vocab-size", "30522"], "fixes the vocab size"),
])
def test_warm_start_parser_errors(tmp_path, capsys, argv, match):
    vocab = tmp_path / "vocab.txt"
    # the special tokens and 26 words: a valid vocab, 30 entries against the
    # checkpoint's 24
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + [f"w{i}" for i in range(26)]
    vocab.write_text("\n".join(words) + "\n")
    argv = [a.replace("VOCAB", str(vocab)) for a in argv]
    with pytest.raises(SystemExit):
        bert_finetune.main(["--hf-checkpoint", str(FIXTURE), "--data-dir", str(FIXTURE),
                            "--device", "cpu", "--max-steps", "2", *argv])
    assert match in capsys.readouterr().err


def test_a_checkpoint_without_vocab_needs_vocab(tmp_path, capsys):
    path = tmp_path / "novocab"
    shutil.copytree(FIXTURE, path)
    os.remove(path / "vocab.txt")
    with pytest.raises(SystemExit):
        bert_finetune.main(["--hf-checkpoint", str(path), "--device", "cpu"])
    assert "no vocab.txt" in capsys.readouterr().err
    assert dataclasses.is_dataclass(tbc.config_from_hf({}))
