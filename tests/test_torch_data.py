"""The port's data layer held against the JAX package's, array for array.

- MNIST idx files: the reader round-trips (gzip and plain) and refuses a
  bad magic number; the fixture directory loads to the same arrays as JAX.
- ``synthetic`` and ``flip_labels``: equal to JAX's arrays bit for bit.
- The housing CSV (``tests/fixtures/housing_tiny.csv``) and the synthetic
  stand-in: the same 14 features and labels as JAX.
- ``Dataset``: ``shard``, ``map``, ``take`` and their orderings with
  ``shuffle``, ``batch`` and ``repeat`` yield what JAX's ``Dataset``
  yields (the chains of ``tests/test_data.py``).
"""

import gzip
import importlib
import os
import struct

import numpy as np
import pytest

from gradaccum_tpu_torch.data import csv as tcsv
from gradaccum_tpu_torch.data import mnist as tmnist
from gradaccum_tpu_torch.data.pipeline import Dataset as TDataset

jcsv = importlib.import_module("gradaccum_tpu.data.csv")
jmnist = importlib.import_module("gradaccum_tpu.data.mnist")
JDataset = importlib.import_module("gradaccum_tpu.data.pipeline").Dataset

pytestmark = pytest.mark.torch

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _write_idx(tmp_path, gz):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(5, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, size=5, dtype=np.uint8)
    opener, suffix = (gzip.open, ".gz") if gz else (open, "")
    ipath = str(tmp_path / f"train-images-idx3-ubyte{suffix}")
    lpath = str(tmp_path / f"train-labels-idx1-ubyte{suffix}")
    with opener(ipath, "wb") as f:
        f.write(struct.pack(">iiii", 2051, 5, 28, 28) + images.tobytes())
    with opener(lpath, "wb") as f:
        f.write(struct.pack(">ii", 2049, 5) + labels.tobytes())
    return ipath, lpath, images, labels


@pytest.mark.parametrize("gz", [True, False])
def test_read_idx_roundtrip(tmp_path, gz):
    ipath, lpath, images, labels = _write_idx(tmp_path, gz)
    imgs, lbls = tmnist.read_images(ipath), tmnist.read_labels(lpath)
    assert imgs.shape == (5, 28, 28, 1) and imgs.dtype == np.float32
    assert lbls.dtype == np.int32
    np.testing.assert_array_equal(imgs[..., 0], images.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(lbls, labels.astype(np.int32))
    np.testing.assert_array_equal(imgs, jmnist.read_images(ipath))
    np.testing.assert_array_equal(lbls, jmnist.read_labels(lpath))


@pytest.mark.parametrize("kind", ["images", "labels"])
def test_read_idx_bad_magic(tmp_path, kind):
    path = str(tmp_path / "bad.gz")
    header = struct.pack(">iiii", 1234, 1, 28, 28) if kind == "images" else \
        struct.pack(">ii", 1234, 1)
    with gzip.open(path, "wb") as f:
        f.write(header + b"\0" * 784)
    reader = tmnist.read_images if kind == "images" else tmnist.read_labels
    with pytest.raises(ValueError, match="magic"):
        reader(path)


def test_load_fixture_directory_equals_jax():
    got = tmnist.load(os.path.join(FIXTURES, "mnist"), synthetic_fallback=False)
    want = jmnist.load(os.path.join(FIXTURES, "mnist"), synthetic_fallback=False)
    for split in ("train", "test"):
        for a, b in zip(got[split], want[split]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        tmnist.load(str(FIXTURES), synthetic_fallback=False)


def test_synthetic_and_flip_labels_equal_jax_bit_for_bit():
    got = tmnist.synthetic(num_train=64, num_test=16)
    want = jmnist.synthetic(num_train=64, num_test=16)
    for split in ("train", "test"):
        for a, b in zip(got[split], want[split]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    labels = got["train"][1]
    flipped = tmnist.flip_labels(labels, 0.25)
    np.testing.assert_array_equal(flipped, jmnist.flip_labels(labels, 0.25))
    assert flipped.dtype == labels.dtype and (flipped != labels).any()
    assert tmnist.flip_labels(labels, 0.0) is labels
    np.testing.assert_array_equal(tmnist.load(None, num_train=32)["train"][0],
                                  jmnist.load(None, num_train=32)["train"][0])


@pytest.mark.parametrize("source", ["fixture", "synthetic"])
def test_housing_features_equal_jax(source):
    path = os.path.join(FIXTURES, "housing_tiny.csv") if source == "fixture" else None
    X, y = tcsv.load_housing(path)
    jX, jy = jcsv.load_housing(path)
    assert X.shape[1] == 14 == tcsv.housing_feature_columns().width
    assert X.dtype == jX.dtype and y.dtype == jy.dtype
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(y, jy)
    if source == "fixture":
        cols = tcsv.read_csv(path)
        assert list(cols["CHAS"]) == list(jcsv.read_csv(path)["CHAS"])
        engineered = tcsv.process_features(cols)
        np.testing.assert_array_equal(engineered["CRIM"], np.log(cols["CRIM"]))
        assert engineered["B"].min() >= 300 and engineered["B"].max() <= 500


def _data(n=10):
    return {"x": np.arange(n, dtype=np.float32), "y": np.arange(n) * 10}


def _double(batch):
    return {"x": batch["x"] * 2, "y": batch["y"]}


CHAINS = {
    "batch-remainder": lambda D: D.from_arrays(_data(10)).batch(4),
    "batch-drop": lambda D: D.from_arrays(_data(10)).batch(4, drop_remainder=True),
    "shard-every-nth": lambda D: D.from_arrays(_data(10)).shard(2, 1).batch(10),
    "shuffle-seeded": lambda D: D.from_arrays(_data(20)).shuffle(7, seed=3).batch(20),
    "repeat-reshuffles": lambda D: D.from_arrays(_data(8)).shuffle(8, seed=1).repeat(2).batch(8),
    "batch-map-repeat": lambda D: D.from_arrays(_data(6)).batch(3).map(_double).repeat(2),
    "repeat-batch-take": lambda D: D.from_arrays(_data(4)).repeat().batch(4).take(5),
    "prefetch": lambda D: D.from_arrays(_data(10)).batch(3).prefetch(2),
    "mnist-chain": lambda D: D.from_arrays(
        {"image": np.arange(40 * 4, dtype=np.float32).reshape(40, 4),
         "label": np.arange(40, dtype=np.int32)})
    .shard(2, 0).shuffle(17, seed=19830610).batch(8).repeat(2),
    "map-before-batch": lambda D: D.from_arrays(_data(6)).map(
        lambda e: {"x": e["x"] + 100}).batch(3),
    "map-alone": lambda D: D.from_arrays(_data(3)).map(lambda e: e),
    "map-repeat-batch": lambda D: D.from_arrays(_data(4)).map(lambda e: e).repeat(2).batch(4),
    "shuffle-shard-0": lambda D: D.from_arrays(_data(10)).shuffle(10, seed=2).shard(2, 0).batch(10),
    "shuffle-shard-1": lambda D: D.from_arrays(_data(10)).shuffle(10, seed=2).shard(2, 1).batch(10),
    "take-then-map": lambda D: D.from_arrays(_data(10)).take(7).map(
        lambda e: {"x": e["x"] - 1}).batch(3),
    "repeat-map": lambda D: D.from_arrays(_data(5)).batch(2).repeat(2).map(_double),
    "repeat-take": lambda D: D.from_arrays(_data(5)).batch(2).repeat().take(4),
}


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_dataset_chain_equals_jax(chain):
    got, want = list(CHAINS[chain](TDataset)), list(CHAINS[chain](JDataset))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for key in a:
            assert np.shape(a[key]) == np.shape(b[key])
            np.testing.assert_array_equal(a[key], b[key])


def test_dataset_orderings():
    """The placement rules tf.data has: batch -> map -> repeat maps whole
    batches; map before batch maps elements; shard after shuffle takes
    positions, so two shards cover the dataset."""
    seen = []
    out = list(TDataset.from_arrays(_data(6)).batch(3)
               .map(lambda b: seen.append(b["x"].shape) or b).repeat(2))
    assert len(out) == 4 and seen == [(3,)] * 4
    shards = [list(TDataset.from_arrays(_data(10)).shuffle(10, seed=2).shard(2, i).batch(10))[0]
              for i in range(2)]
    assert sorted(shards[0]["x"].tolist() + shards[1]["x"].tolist()) == list(range(10))
    assert len(list(TDataset.from_arrays(_data(4)).repeat().batch(4).take(5))) == 5
    with pytest.raises(ValueError, match="shard index"):
        TDataset.from_arrays(_data(4)).shard(2, 2)


def test_two_ops_after_repeat():
    """map then take after repeat: each op keeps its own argument. (JAX's
    ``Dataset`` binds the ops after ``repeat`` late, so there the map would
    call the take's count; the port binds each as it is built.)"""
    out = list(TDataset.from_arrays(_data(5)).batch(2).repeat().map(_double).take(4))
    assert [b["x"].tolist() for b in out] == [[0, 2], [4, 6], [8], [0, 2]]
