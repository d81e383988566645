"""The port's ``bench_serving`` entry point on the CPU at ``--fast`` shapes.

Its default legs (serial, engine closed-load, the offered-load sweep) and
``--paged`` finish, print one JSON line per leg, and their results carry
every key of JAX's committed ``BENCH_serving.json`` and ``BENCH_paged.json``
(the structure JAX's slow-lane ``test_bench_serving_fast_sweep`` and
``test_bench_paged_fast`` check), plus the port's TTFT on the tick clock
and KV bytes per token in flight. ``--prefix`` and ``--mesh`` raise; without
``--device cpu`` it raises here, where there is no card.
"""

import json
from pathlib import Path

import pytest
import torch

from gradaccum_tpu_torch.examples import bench_serving

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _keys_cover(got, want, where="result"):
    """Every key of JAX's artifact ``want`` is in ``got``, recursively."""
    missing = set(want) - set(got)
    assert not missing, f"{where}: {sorted(missing)}"
    for key, value in want.items():
        if isinstance(value, dict) and key not in ("admission_stalls", "acceptance"):
            _keys_cover(got[key], value, f"{where}.{key}")
        if isinstance(value, list) and value and isinstance(value[0], dict):
            for i, item in enumerate(got[key]):
                _keys_cover(item, value[0], f"{where}.{key}[{i}]")


def _legs(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_default_legs_at_fast_shapes(tmp_path, capsys):
    out = tmp_path / "serving.json"
    result = bench_serving.main(["--fast", "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(result))
    _keys_cover(result, json.loads((REPO / "BENCH_serving.json").read_text()))
    assert [leg["leg"] for leg in _legs(capsys)] == ["serial", "engine"] + ["sweep"] * 3
    assert result["engine"]["decode_programs"] == 1
    assert result["serial_tokens_per_s"] > 0 and result["engine"]["tokens_per_s"] > 0
    assert result["engine"]["kv_bytes_per_token_in_flight"] > 0
    assert len(result["sweep"]) == 3
    for leg in result["sweep"]:
        assert leg["tokens_per_s"] > 0 and 0 < leg["occupancy_mean"] <= 1
        assert leg["ttft_s"]["count"] == leg["ttft_ticks"]["count"] == 8
        assert leg["ttft_ticks"]["p99"] >= 0
    assert result["platform"]["backend"] == "cpu"


def test_paged_legs_at_fast_shapes(capsys):
    result = bench_serving.main(["--paged", "--fast", "--device", "cpu"])
    _keys_cover(result, json.loads((REPO / "BENCH_paged.json").read_text()))
    assert [leg["leg"] for leg in _legs(capsys)] == ["fixed", "paged"]
    for leg in (result["fixed"], result["paged"]):
        assert leg["tokens_per_s"] > 0 and leg["peak_concurrent_requests"] >= 1
        assert leg["kv_bytes_per_token_in_flight"] > 0 and leg["decode_programs"] == 1
    assert result["fixed"]["kv_pool_bytes"] == result["paged"]["kv_pool_bytes"]
    assert result["paged"]["block_pool_waterline"] is not None
    assert result["acceptance"]["passed"]


@pytest.mark.parametrize("flag", ["--prefix", "--mesh"])
def test_later_comparisons_raise(flag):
    with pytest.raises(NotImplementedError, match="item 5i"):
        bench_serving.main([flag, "--fast", "--device", "cpu"])


def test_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card refusal does not apply")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_serving.main(["--fast"])
