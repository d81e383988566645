"""The sequence- and pipeline-parallel entry points on the CPU.

- ``bert_finetune --sp 2`` (ring and Ulysses) and ``--pp 2``: each spawns
  its two gloo ranks and trains the same deterministic model (dropout 0
  under both) on the same data, so their losses agree within float32
  reassociation;
- ``bench_longcontext --device cpu`` writes one row for each of its four
  cores (the sharded ones from one spawn of two seq ranks) and its CSV.

Both train BERT-Small's width on the CPU: about two minutes together.

    python -m pytest -m torch tests/test_torch_longcontext.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch
torch.set_num_threads(1)


def test_bert_finetune_sp_ring_ulysses_and_pp_runs_agree(tmp_path):
    """The entry point spawns its ranks: ``--sp 2`` (ring and Ulysses) and
    ``--pp 2`` train the same deterministic model (dropout 0 under both) on
    the same data, so their losses agree within float32 reassociation."""
    from gradaccum_tpu_torch.examples import bert_finetune as tbf

    base = ["--device", "cpu", "--max-steps", "4", "--seq-len", "16", "--accum-k", "2",
            "--vocab-size", "128", "--train-size", "64"]
    runs = {name: tbf.main(base + extra + ["--model-dir", str(tmp_path / name)]) for name, extra in
            (("ring", ["--sp", "2"]), ("ulysses", ["--sp", "2", "--sp-core", "ulysses"]),
             ("pp", ["--pp", "2"]))}
    assert runs["ring"]["sp"] == 2 and runs["ulysses"]["sp_core"] == "ulysses"
    assert runs["pp"]["pp"] == 2 and all(r["updates"] == 2 for r in runs.values())
    for name in ("ulysses", "pp"):
        for key in ("first_loss", "loss"):
            np.testing.assert_allclose(runs[name][key], runs["ring"][key], rtol=1e-5,
                                       err_msg=f"{name} {key}")
        assert runs[name]["accuracy"] == runs["ring"]["accuracy"]


def test_bench_longcontext_writes_a_row_per_core(tmp_path):
    """``bench_longcontext --device cpu``: one row for each of the four
    cores (the sharded ones from one spawn of two seq ranks), and the CSV."""
    import csv

    from gradaccum_tpu_torch.examples import bench_longcontext as bench

    out = tmp_path / "longcontext.csv"
    assert bench.main(["--device", "cpu", "--seqs", "32", "--tokens", "64", "--iters", "2",
                       "--remat-legs", "none", "--out", str(out)]) == 0
    with open(out, newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["core"] for r in rows] == ["dense", "flash", "ring", "ulysses"]
    for r in rows:
        assert r["seq"] == "32" and r["micro_batch"] == "2" and not r["error"]
        assert float(r["ms_per_step"]) > 0 and float(r["tokens_per_sec"]) > 0
    assert rows[2]["device"].endswith("x2 ranks")
