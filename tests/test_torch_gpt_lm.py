"""The port's GPT entry point held against JAX's ``examples/gpt_lm.py``.

- The flags the port carries take JAX's defaults, and a bad value gets
  JAX's parser error; ``--dp/--zero1`` are carried (their parser errors
  against JAX's: ``tests/test_torch_dp_examples.py``), and so are ``--tp``
  and ``--export-dir``.
- ``--tp``: JAX's parser errors (its ``--flash --tp`` refusal excepted),
  and a tiny CPU run at ``--tp 2 --flash`` (two spawned gloo ranks) whose
  losses equal the one-rank run's within 1e-5.
- The synthetic corpus and its byte windows (90/10 split) equal JAX's.
- A 4-step CPU run with ``--flash`` prints one JSON line: finite losses,
  token accuracy in [0, 1], the decode rate line says "KV-cache".
- ``--sample`` decodes with ``generate_cached``: from the same trained
  weights, its bytes equal JAX's ``generate_cached`` output.
- Without ``--device cpu`` it raises here, where there is no card.
"""

import argparse
import importlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gradaccum_tpu_torch.examples import gpt_lm as tlm

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
jlm = importlib.import_module("examples.gpt_lm")

pytestmark = pytest.mark.torch
torch.set_num_threads(1)


class _Parsed(Exception):
    pass


def _jax_args(argv, monkeypatch):
    """The namespace JAX's example parses from ``argv`` (it stops there)."""
    parse = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        raise _Parsed(parse(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed) as got:
        jlm.main(argv)
    monkeypatch.undo()
    return vars(got.value.args[0])


def test_defaults_match_jax(monkeypatch):
    want = _jax_args([], monkeypatch)
    got = vars(tlm.build_parser().parse_args([]))
    assert set(got) == set(want) | {"device"}
    for key in set(got) - {"device", "model_dir"}:
        assert got[key] == want[key], key
    assert got["device"] == "cuda"


@pytest.mark.parametrize("argv", [["--mode", "bogus"], ["--seq-len", "x"],
                                  ["--sample", "1.5"], ["--lr", "fast"]],
                         ids=["mode", "seq-len", "sample", "lr"])
def test_bad_values_get_jax_errors(argv, capsys):
    with pytest.raises(SystemExit):
        jlm.main(argv)
    want = capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1]
    with pytest.raises(SystemExit):
        tlm.main([*argv, "--device", "cpu"])
    got = capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1]
    assert got == want


def test_mesh_and_export_flags_are_not_carried(capsys):
    # every mesh flag of JAX's example is carried now: --tp (tensor
    # parallelism), --dp and --zero1, so --zero1 alone meets JAX's own
    # parser error; --export-dir is carried too (the artifact is held in
    # tests/test_torch_export.py)
    assert tlm.parse_args(["--tp", "2", "--device", "cpu"]).tp == 2
    assert tlm.build_parser().parse_args(["--export-dir", "x"]).export_dir == "x"
    with pytest.raises(SystemExit):
        tlm.main(["--zero1", "--device", "cpu"])
    assert "--zero1 needs --dp >= 2 (moments shard over 'data')" in capsys.readouterr().err


def test_corpus_and_windows_match_jax():
    text = tlm.synthetic_corpus(5000, seed=19830610)
    assert text == jlm.synthetic_corpus(5000, seed=19830610)
    train, evald = tlm.windows_of(text, 64)
    data = np.frombuffer(text.encode("utf-8"), np.uint8).astype(np.int32)
    n = len(data) // 64
    assert train.shape == (int(0.9 * n), 64) and evald.shape == (n - int(0.9 * n), 64)
    np.testing.assert_array_equal(np.concatenate([train, evald]).reshape(-1), data[:n * 64])


def test_a_short_cpu_run_prints_its_json_line(capsys):
    out = tlm.main(["--device", "cpu", "--flash", "--max-steps", "4", "--seq-len", "32",
                    "--batch", "4", "--sample", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == out
    assert any("tokens/sec (KV-cache" in line for line in lines)
    assert out["device"] == "cpu" and out["flash"] and out["updates"] == 2
    assert np.isfinite(out["loss"]) and np.isfinite(out["first_loss"])
    assert 0.0 <= out["token_accuracy"] <= 1.0 and out["evaluations"] >= 1
    assert len(out["sample"]) == 32 // 2 + 4


def test_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card refusal does not apply")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.main(["--max-steps", "2"])


JAX_DEVICES = 8  # tests/conftest.py's virtual CPU devices


@pytest.mark.parametrize("argv", [["--tp", "0"], ["--tp", "16"], ["--dp", "4", "--tp", "4"]],
                         ids=["tp-0", "tp-past-devices", "dp-tp-past-devices"])
def test_tp_parser_errors_match_jax(argv, tmp_path, capsys, monkeypatch):
    with pytest.raises(SystemExit):
        jlm.main([*argv, "--model-dir", str(tmp_path / "jax")])
    want = capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1]
    # as many cards as JAX has devices here, so "--device cuda" parses
    monkeypatch.setattr(tlm, "available_devices", lambda device: JAX_DEVICES)
    with pytest.raises(SystemExit):
        tlm.main([*argv, "--device", "cuda"])
    got = capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1]
    assert got == want


def test_tp_flash_run_equals_the_one_rank_run():
    base = ["--device", "cpu", "--flash", "--max-steps", "4", "--seq-len", "32",
            "--batch", "4", "--sample", "0"]
    one = tlm.main(base)
    got = tlm.main(base + ["--tp", "2"])
    assert got["tp"] == 2 and got["updates"] == 2
    for key in ("first_loss", "loss"):
        np.testing.assert_allclose(got[key], one[key], rtol=1e-5, err_msg=key)


def test_sample_decodes_with_the_kv_cache_as_jax_does(monkeypatch):
    """``--sample``'s bytes equal JAX's ``generate_cached`` on the same trained
    weights (the tree the port's decode was handed, carried to JAX)."""
    from gradaccum_tpu_torch.models import gpt_decode as tdec

    jdec = importlib.import_module("gradaccum_tpu.models.gpt_decode")
    jgpt = importlib.import_module("gradaccum_tpu.models.gpt")
    seen = []
    real = tdec.generate_cached

    def spy(params, cfg, prompt, num_steps, **kw):
        seen.append((params, cfg, np.asarray(prompt)))
        return real(params, cfg, prompt, num_steps, **kw)

    monkeypatch.setattr(tdec, "generate_cached", spy)
    out = tlm.main(["--device", "cpu", "--max-steps", "4", "--seq-len", "32",
                    "--batch", "4", "--sample", "12"])
    params, cfg, prompt = seen[-1]

    def to_numpy(node):
        if isinstance(node, dict):
            return {k: to_numpy(v) for k, v in node.items()}
        return node.detach().numpy().copy()

    jcfg = jgpt.GPTConfig(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
                          num_layers=cfg.num_layers, num_heads=cfg.num_heads,
                          intermediate_size=cfg.intermediate_size,
                          max_position_embeddings=cfg.max_position_embeddings, dropout=0.0)
    want = np.asarray(jdec.generate_cached(to_numpy(params), jcfg, prompt, 12))[0]
    assert out["sample"] == bytes(int(t) for t in want).decode("utf-8", "replace")
    assert len(want) == 32 // 2 + 12
