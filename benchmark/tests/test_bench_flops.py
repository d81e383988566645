"""The analytic work against hand counts, at a padded and a causal shape."""

from __future__ import annotations

import pytest

from benchmark.yardstick import flops, peaks

BERT = {"hidden": 4, "layers": 1, "heads": 2, "intermediate": 8,
        "head_flops_per_row": 2 * 4 * 4 + 2 * 4 * 5, "head_flops_per_token": 0,
        "causal": False}
GPT = {"hidden": 4, "layers": 1, "heads": 2, "intermediate": 8, "head_flops_per_row": 0,
       "head_flops_per_token": 2 * 4 * 10, "causal": True}


def test_padded_model_flops_count_real_tokens_only():
    # per token: Q K V O 4·(2·4·4) = 128, FFN 2·(2·4·8) = 128; 5 real tokens
    # scores and context 4·H·n² over rows of 2 and 3; pooler and head per row
    fwd = 256 * 5 + 4 * 4 * (2 * 2 + 3 * 3) + 72 * 2
    assert flops.train_flops(BERT, [2, 3]) == 3 * fwd
    # padding a row adds nothing: only the lengths count
    assert flops.train_flops(BERT, [2, 3]) == flops.train_flops(BERT, [3, 2])


def test_causal_model_flops_halve_attention_and_count_the_tied_head():
    fwd = 256 * 4 + 4 * 4 * 16 / 2 + 80 * 4
    assert flops.train_flops(GPT, [4]) == 3 * fwd


@pytest.mark.parametrize("causal", [False, True])
def test_flash_launch_work(causal):
    # [B=2, A=2, S=4, D=8] bf16, rows of 2 and 3 real tokens, a key mask
    half = 0.5 if causal else 1.0
    sq = (2 * 2 + 3 * 3) * half
    t, r, m = 2 * 2 * 4 * 8 * 2, 2 * 2 * 4 * 4, 2 * 4 * 2
    want = {"fwd": (2 * 2 * 8 * 2 * sq, 3 * t + m + t + r),
            "dq": (3 * 2 * 8 * 2 * sq, 5 * t + m + r + t + r),
            "dkv": (4 * 2 * 8 * 2 * sq, 4 * t + m + 2 * r + 2 * t)}
    for kind, (fl, moved) in want.items():
        work = flops.flash_launch(kind, [2, 3], 4, 2, 8, 2, causal, True)
        assert work == {"flops": fl, "bytes": moved}
    assert flops.flash_launch("fwd", [4], 4, 2, 8, 2, causal, False)["bytes"] == \
        3 * 128 + 128 + 32  # one row: q k v, o, lse


def test_least_time_is_the_larger_bound():
    p = peaks.peaks_for("NVIDIA H100 80GB HBM3")
    assert p["f32x3"] == pytest.approx(165e12)
    by_bytes = {"flops": 1e9, "bytes": 1e9}
    assert flops.least_seconds(by_bytes, p["bf16"], p["hbm"]) == 1e9 / 3.35e12
    by_ops = {"flops": 1e15, "bytes": 1e6}
    assert flops.least_seconds(by_ops, p["bf16"], p["hbm"]) == 1e15 / 989e12
    assert peaks.peaks_for("cpu") is None
