"""The traffic generator: repeatable from the seed, the same work for every
seed, lengths on the mix's quantiles, LM rows packed with no padding."""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np
import pytest

from benchmark import traffic

MIXES = ("yelp5.seq512.b64x4", "yelp5.seq512.b32x4", "packed.seq1024.b16x4")


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_batches(name):
    mix = traffic.load(name)
    a, b = traffic.updates(mix, 2**31 + 7, 2), traffic.updates(mix, 2**31 + 7, 2)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for key in x:
            np.testing.assert_array_equal(x[key], y[key])
    c = traffic.updates(mix, 2**31 + 8, 1)[0]
    assert not np.array_equal(a[0]["input_ids"], c["input_ids"])


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_gives_the_same_work(name):
    mix = traffic.load(name)
    lengths = [np.sort(traffic.row_lengths(b)) for s in (1, 99, 2**33)
               for b in traffic.updates(mix, s, 2)]
    for x in lengths[1:]:
        np.testing.assert_array_equal(x, lengths[0])
    rows = traffic.rows_per_update(mix)
    assert len(lengths[0]) == rows


@pytest.mark.parametrize("name", MIXES[:2])
def test_padded_rows_hold_their_lengths(name):
    mix = traffic.load(name)
    batch = traffic.updates(mix, 5, 1)[0]
    lens = traffic.row_lengths(batch)
    assert lens.min() >= mix["min"] and lens.max() <= mix["max"]
    # the grid's median is the mix's median
    assert np.median(lens) == pytest.approx(mix["median"], rel=0.02)
    q90 = mix["median"] * math.exp(mix["sigma"] * NormalDist().inv_cdf(0.9))
    assert np.quantile(lens, 0.9) == pytest.approx(q90, rel=0.05)
    ids, mask = batch["input_ids"], batch["input_mask"]
    rows = np.arange(len(lens))
    assert (ids[:, 0] == mix["cls_id"]).all()
    assert (ids[rows, lens - 1] == mix["sep_id"]).all()
    assert (ids[mask == 0] == mix["pad_id"]).all()
    assert (batch["segment_ids"] == 0).all()
    assert set(np.unique(batch["label"])) <= set(range(mix["num_classes"]))
    assert traffic.real_tokens(mix, batch) == int(lens.sum())


def test_packed_rows_have_no_padding_and_eos_between_documents():
    mix = traffic.load("packed.seq1024.b16x4")
    batch = traffic.updates(mix, 5, 1)[0]
    ids = batch["input_ids"]
    assert ids.shape == (traffic.rows_per_update(mix), mix["seq_len"])
    assert set(batch) == {"input_ids"}
    assert traffic.real_tokens(mix, batch) == ids.size
    assert ids.min() >= 0 and ids.max() < mix["vocab_size"]
    flat = ids.reshape(-1)
    eos = np.flatnonzero(flat == mix["eos_id"])
    # documents between EOS marks: their median near the mix's (ids drawn
    # uniform over the vocabulary may also hit the EOS id: rarely)
    docs = np.diff(eos) - 1
    assert np.median(docs) == pytest.approx(mix["median"], rel=0.25)
    assert len(eos) > ids.size / (mix["median"] * math.exp(mix["sigma"] ** 2 / 2)) * 0.7


def test_length_grid_is_the_lognormal_quantiles():
    grid = traffic.length_grid(1000, 160, 0.8, 16, 512)
    assert grid[0] == 16 and grid[-1] == 512
    assert np.median(grid) == pytest.approx(160, abs=1)
    assert (np.diff(grid) >= 0).all()
