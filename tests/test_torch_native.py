"""The port's native data reader (``data/native.py``) against the numpy
readers and JAX's native reader.

On generated idx files (raw and gzipped) and numeric CSVs, the native
reader's arrays are byte-identical to the port's numpy paths and to JAX's
native reader; the library is built into ``build/native/`` and never into
``native/``; ``GRADACCUM_NATIVE=0`` disables it; a file the native parser
declines (ragged rows, quoting, a bad magic) takes the numpy path with the
numpy path's own error.
"""

import gzip
import importlib
import os
import struct

import numpy as np
import pytest

from gradaccum_tpu_torch.data import csv as tcsv
from gradaccum_tpu_torch.data import mnist as tmnist
from gradaccum_tpu_torch.data import native

jnative = importlib.import_module("gradaccum_tpu.data.native")
jcsv = importlib.import_module("gradaccum_tpu.data.csv")

pytestmark = pytest.mark.torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _idx_files(tmp_path, gz):
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, size=(13, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, size=13, dtype=np.uint8)
    opener = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    img = str(tmp_path / f"images-idx3-ubyte{suffix}")
    lab = str(tmp_path / f"labels-idx1-ubyte{suffix}")
    with opener(img, "wb") as f:
        f.write(struct.pack(">iiii", tmnist.IMAGE_MAGIC, 13, 28, 28) + images.tobytes())
    with opener(lab, "wb") as f:
        f.write(struct.pack(">ii", tmnist.LABEL_MAGIC, 13) + labels.tobytes())
    return img, lab


def _numpy_path(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)


def _same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_the_library_builds_into_build_native():
    assert native.available(), native.build_error
    so = native._so_path()
    assert os.path.dirname(so) == os.path.join(ROOT, "build", "native")
    assert os.path.exists(so)
    assert native.get_lib().ga_version() == 1


@pytest.mark.parametrize("gz", [False, True], ids=["raw", "gz"])
def test_idx_readers_are_byte_identical(tmp_path, monkeypatch, gz):
    img, lab = _idx_files(tmp_path, gz)
    got_i, got_l = native.read_idx_images(img), native.read_idx_labels(lab)
    _same_bytes(got_i, jnative.read_idx_images(img))
    _same_bytes(got_l, jnative.read_idx_labels(lab))
    _same_bytes(tmnist.read_images(img), got_i)  # the reader takes the native path
    _numpy_path(monkeypatch)
    _same_bytes(tmnist.read_images(img), got_i)
    _same_bytes(tmnist.read_labels(lab), got_l)
    assert got_i.shape == (13, 28, 28, 1) and got_l.dtype == np.int32


def _numeric_csv(path, ragged=False):
    rng = np.random.default_rng(3)
    values = rng.normal(0, 50, size=(17, 4))
    with open(path, "w") as f:
        f.write("a,b,c,d\n")
        for i, row in enumerate(values):
            cells = [repr(float(v)) for v in row]
            if i == 3:
                cells[1] = ""  # record_defaults 0.0
            if i == 5:
                cells[2] = "  7.25 "  # trimmed
            if ragged and i == 8:
                cells = cells[:2]
            f.write(",".join(cells) + "\n")


def test_numeric_csv_is_byte_identical(tmp_path, monkeypatch):
    path = str(tmp_path / "t.csv")
    _numeric_csv(path)
    cols = ["a", "b", "c", "d"]
    matrix, n_cols = native.read_csv_numeric(path)
    assert n_cols == 4 and matrix.shape == (17, 4)
    jm, _ = jnative.read_csv_numeric(path)
    _same_bytes(matrix, jm)
    via_native = tcsv.read_csv(path, columns=cols)
    _numpy_path(monkeypatch)
    via_numpy = tcsv.read_csv(path, columns=cols)
    want = jcsv.read_csv(path, columns=cols)
    for c in cols:
        _same_bytes(via_native[c], via_numpy[c])
        _same_bytes(via_native[c], want[c])
        _same_bytes(via_native[c], matrix[:, cols.index(c)])


def test_declined_files_take_the_numpy_path(tmp_path):
    path = str(tmp_path / "ragged.csv")
    _numeric_csv(path, ragged=True)
    with pytest.raises(ValueError, match="native csv"):
        native.read_csv_numeric(path)
    got = tcsv.read_csv(path, columns=["a", "b", "c", "d"])  # the csv module's parse
    assert got["c"][8] == 0.0 and got["d"][8] == 0.0
    bad = str(tmp_path / "bad-idx3-ubyte")
    with open(bad, "wb") as f:
        f.write(struct.pack(">iiii", 1234, 1, 28, 28) + bytes(784))
    with pytest.raises(ValueError, match="bad idx3 magic 1234"):
        tmnist.read_images(bad)
    # the housing table has a categorical column: never the native parser
    housing = os.path.join(ROOT, "tests", "fixtures", "housing_tiny.csv")
    _same_bytes(tcsv.read_csv(housing)["CRIM"], jcsv.read_csv(housing)["CRIM"])


def test_switch_off_disables_the_library(monkeypatch):
    monkeypatch.setenv("GRADACCUM_NATIVE", "0")
    assert native.get_lib() is None and not native.available()
    assert native.read_idx_labels("/nonexistent") is None
