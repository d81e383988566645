"""The port's BERT entry point held against JAX's ``examples/bert_finetune.py``.

- Every parser error JAX raises for the flags the port carries, under the
  same conditions and with the same message (both on the same argv; the
  port also gets ``--device cpu``).
- The task table, the synthetic corpus, the TSV reader (with its
  malformed-row warning) and the ``--label-noise`` flips equal JAX's.
- ``--full --quick`` sizes the schedule to 3 epochs of the corpus, trains
  40 micro-steps of it and writes ``preset.json`` with JAX's keys (``dp``
  among them; the ``--dp/--zero1`` parser errors are held against JAX's in
  ``tests/test_torch_dp_examples.py``).
- ``--tp/--ep``: JAX's parser errors word for word (JAX's ``--flash``
  refusal excepted: the port's attention core is the flash kernels on each
  rank's heads), and tiny CPU runs at ``--tp 2`` and ``--tp 2 --ep 2
  --num-experts 4`` (spawned gloo ranks) whose losses equal the one-rank
  runs' within 1e-5.
"""

import importlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.examples import bert_finetune as tbf

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
jbf = importlib.import_module("examples.bert_finetune")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

FIXTURE = str(REPO / "tests" / "fixtures" / "bert_hf_tiny")


def _error_line(capsys):
    err = capsys.readouterr().err.strip().splitlines()
    return err[-1].split("error: ", 1)[1]


@pytest.mark.parametrize("argv", [
    ["--quick"],
    ["--moe-top-k", "2"],
    ["--moe-top-k", "0"],
    ["--num-experts", "2", "--moe-top-k", "3"],
    ["--sparse-embed-grad", "--mode", "streaming"],
    ["--hf-checkpoint", FIXTURE, "--num-experts", "2"],
    # raised after the checkpoint is read
    ["--hf-checkpoint", FIXTURE, "--data-dir", FIXTURE, "--seq-len", "65"],
    ["--hf-checkpoint", FIXTURE, "--data-dir", FIXTURE, "--vocab", "VOCAB"],
], ids=["quick-without-full", "top-k-without-experts", "top-k-0", "top-k-above-experts",
        "sparse-streaming", "hf-with-experts", "seq-past-positions", "vocab-mismatch"])
def test_parser_errors_match_jax(argv, tmp_path, capsys):
    # a valid vocab of 30 entries against the checkpoint's 24
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]"]
                               + [f"w{i}" for i in range(26)]) + "\n")
    argv = [str(vocab) if a == "VOCAB" else a for a in argv]
    with pytest.raises(SystemExit):
        jbf.main([*argv, "--model-dir", str(tmp_path / "jax")])
    want = _error_line(capsys)
    with pytest.raises(SystemExit):
        tbf.main([*argv, "--device", "cpu"])
    assert _error_line(capsys) == want


def test_task_table_corpus_and_tsv_reader_match_jax(tmp_path, capsys):
    assert tbf.TASKS == jbf.TASKS
    for n, seed in ((50, 1), (20, 2)):
        texts, labels = tbf.synthetic_text_task(n, seed)
        jtexts, jlabels = jbf.synthetic_text_task(n, seed)
        assert texts == jtexts and np.array_equal(labels, jlabels)
        assert labels.dtype == jlabels.dtype
    path = tmp_path / "train.tsv"
    path.write_text("1\tid0\ta dog runs fast\nnot-a-label\tx\n0\tfast runs dog a\nalone\n")
    got, want = tbf.load_tsv(str(path)), jbf.load_tsv(str(path))
    warnings = capsys.readouterr().err.strip().splitlines()
    assert got[0] == want[0] == ["a dog runs fast", "fast runs dog a"]
    assert np.array_equal(got[1], want[1]) and got[1].dtype == want[1].dtype
    assert len(warnings) == 2 and warnings[0] == warnings[1]
    assert "skipped 2 malformed row(s) (2 kept)" in warnings[0]
    empty = tmp_path / "empty.tsv"
    empty.write_text("x\n")
    with pytest.raises(ValueError, match="no parseable"):
        tbf.load_tsv(str(empty))


def test_label_noise_flips_like_jax():
    args = tbf.parse_args(["--label-noise", "0.25", "--train-size", "400", "--device", "cpu"])
    texts, labels, _, _ = tbf._load_data(args, tbf.TASKS["cola"])
    clean_texts, clean = jbf.synthetic_text_task(400, seed=1)
    # JAX's flip, as examples/bert_finetune.py draws it
    flip = np.random.default_rng(19830610).random(400) < 0.25
    assert texts == clean_texts
    assert np.array_equal(labels, np.where(flip, 1 - clean, clean))
    assert labels.dtype == np.int32 and 60 < int(flip.sum()) < 140


def test_full_quick_preset(tmp_path):
    model_dir = tmp_path / "preset"
    out = tbf.main(["--full", "--quick", "--train-size", "160", "--seq-len", "16",
                    "--accum-k", "2", "--model-dir", str(model_dir), "--device", "cpu"])
    # 160 rows x 3 epochs / micro 8 = 60 micro-steps; --quick trains 40 of them
    assert out["steps"] == 40 and out["updates"] == 20
    with open(model_dir / "preset.json") as f:
        preset = json.load(f)
    assert preset == out["preset"]
    assert {key: preset[key] for key in ("task", "corpus", "micro_batch", "accum_k", "dp",
                                         "epochs", "full_max_steps", "ran_steps", "quick")} == {
        "task": "cola", "corpus": 160, "micro_batch": 8, "accum_k": 2, "dp": 1, "epochs": 3,
        "full_max_steps": 60, "ran_steps": 40, "quick": True}
    assert 0.0 <= preset["final_eval_accuracy"] <= 1.0


JAX_DEVICES = 8  # tests/conftest.py's virtual CPU devices


@pytest.mark.parametrize("argv", [
    ["--tp", "0"],
    ["--ep", "0"],
    ["--ep", "2"],
    ["--ep", "3", "--num-experts", "4"],
    ["--tp", "4", "--ep", "4", "--num-experts", "4"],
    ["--dp", "2", "--tp", "2", "--ep", "4", "--num-experts", "4"],
], ids=["tp-0", "ep-0", "ep-without-experts", "ep-not-dividing", "mesh-past-devices",
        "dp-tp-ep-past-devices"])
def test_tp_ep_parser_errors_match_jax(argv, tmp_path, capsys, monkeypatch):
    with pytest.raises(SystemExit):
        jbf.main([*argv, "--model-dir", str(tmp_path / "jax")])
    want = _error_line(capsys)
    # as many cards as JAX has devices here, so "--device cuda" parses
    monkeypatch.setattr(tbf, "available_devices", lambda device: JAX_DEVICES)
    with pytest.raises(SystemExit):
        tbf.main([*argv, "--device", "cuda"])
    assert _error_line(capsys) == want


def test_tp_ep_mesh_and_rules_follow_jax():
    from gradaccum_tpu_torch.models.moe import moe_ep_rules
    from gradaccum_tpu_torch.parallel.tp import bert_tp_ep_rules, bert_tp_rules

    def pick(*argv):
        return tbf.mesh_axes(tbf.parse_args([*argv, "--device", "cpu"]))

    assert pick() == (None, None)
    assert pick("--dp", "2") == (None, None)
    assert pick("--dp", "2", "--tp", "2") == ([("data", 2), ("model", 2)], bert_tp_rules())
    assert pick("--ep", "2", "--num-experts", "4") == ([("data", 1), ("expert", 2)],
                                                        moe_ep_rules())
    assert pick("--tp", "2", "--ep", "2", "--num-experts", "4") == (
        [("data", 1), ("model", 2), ("expert", 2)], bert_tp_ep_rules())


@pytest.mark.parametrize("extra", [[], ["--num-experts", "4", "--moe-top-k", "2"]],
                         ids=["tp2", "tp2-ep2"])
def test_tp_ep_runs_equal_the_one_rank_run(extra):
    base = ["--device", "cpu", "--max-steps", "4", "--seq-len", "16", "--accum-k", "2",
            "--vocab-size", "128", "--train-size", "64", *extra]
    one = tbf.main(base)
    wide = ["--tp", "2"] + (["--ep", "2"] if extra else [])
    got = tbf.main(base + wide)
    assert got["tp"] == 2 and got["ep"] == (2 if extra else 1) and got["updates"] == 2
    for key in ("first_loss", "loss"):
        np.testing.assert_allclose(got[key], one[key], rtol=1e-5, err_msg=key)
    if extra:
        assert got["moe_dropped_fraction"] == one["moe_dropped_fraction"]
