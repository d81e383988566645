"""The comparison that decides ``correct``, on readings made by hand."""

from __future__ import annotations

import math

import pytest

from benchmark.yardstick import compare

REF = {"losses": [2.0, 4.0, 1.0, 3.0],
       "grad": {"a": 1.0, "b": 2.0, "c": 4.0, "key_bias": 1e-6},
       "change": {"a": 0.5, "b": 1.0, "c": 2.0, "key_bias": 3.0}}


def _prog(**kw):
    prog = {"losses": list(REF["losses"]), "grad": dict(REF["grad"]),
            "change": dict(REF["change"])}
    for key, value in kw.items():
        prog[key] = value
    return prog


def test_equal_readings_read_nothing():
    assert compare.gaps(_prog(), REF, 2) == {"loss": 0.0, "loss_first": 0.0, "grad": 0.0,
                                                "change": 0.0}


def test_each_number_by_hand():
    prog = _prog(losses=[2.02, 4.0, 1.5, 3.0],
                 grad={"a": 1.1, "b": 2.0, "c": 4.4, "key_bias": 0.3},
                 change={"a": 0.6, "b": 1.0, "c": 2.0, "key_bias": 9.0})
    got = compare.gaps(prog, REF, 2)
    assert got["loss"] == pytest.approx(0.5)  # the third micro-batch
    assert got["loss_first"] == pytest.approx(0.01)  # the first update's two
    # median leaf norm 1.5: a over 1.5, c over its own 4, key_bias over 1.5
    assert got["grad"] == pytest.approx((0.3 - 1e-6) / 1.5)
    # key_bias's reference gradient is under a thousandth of the median's:
    # left out of the change; a's gap over the moved leaves' median, 1.0
    assert got["change"] == pytest.approx(0.1)


def test_verdict_and_non_finite_readings():
    limits = {"loss": 0.1, "grad": 0.1, "change": 0.1}
    assert compare.verdict({"loss": 0.05, "grad": 0.1, "change": 0.0, "loss_first": 9.0},
                           limits)
    assert not compare.verdict({"loss": 0.2, "grad": 0.0, "change": 0.0}, limits)
    got = compare.gaps(_prog(losses=[math.nan, 4.0, 1.0, 3.0]), REF, 2)
    assert got["loss"] == math.inf
    assert not compare.verdict(got, limits)
    with pytest.raises(ValueError):
        compare.gaps(_prog(grad={"a": 1.0}), REF, 2)
