"""The port's native data reader (``data/native.py``) against the numpy
readers and JAX's readers.

On generated idx files (raw and gzipped) and numeric CSVs, the native
reader's arrays are byte-identical to the port's numpy paths and to JAX's
readers on their numpy path. JAX's native library is kept out of these
tests (its ``get_lib`` patched to None): JAX's loader runs ``make`` in
place when the library is missing, with a lock of one process only, so
test workers that start together can load a half-written library and keep
``None`` for good. JAX's own ``tests/test_native.py`` holds its native
reader to that same numpy path. The port's library is built into
``build/native/`` and never into
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
jmnist = importlib.import_module("gradaccum_tpu.data.mnist")

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


@pytest.fixture(autouse=True)
def _jax_readers_on_numpy(monkeypatch):
    """JAX's readers take their numpy path: nothing here builds JAX's
    library (its in-place ``make`` is not safe across processes)."""
    monkeypatch.setattr(jnative, "get_lib", lambda: None)


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
    _same_bytes(got_i, jmnist.read_images(img))
    _same_bytes(got_l, jmnist.read_labels(lab))
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
    want = jcsv.read_csv(path, columns=cols)
    _same_bytes(matrix, np.stack([want[c] for c in cols], axis=1))
    via_native = tcsv.read_csv(path, columns=cols)
    _numpy_path(monkeypatch)
    via_numpy = tcsv.read_csv(path, columns=cols)
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


# --------------------------------------------------------------------------
# the WordPiece encoder's native fast path (tests/test_native.py:199-264)
# --------------------------------------------------------------------------


def _vocab_pair(corpus, size):
    """The port's tokenizer (native fast path), its pure-Python twin, and
    JAX's tokenizer on its Python path, over one corpus."""
    from gradaccum_tpu.data import tokenization as jtok
    from gradaccum_tpu_torch.data import tokenization as ttok

    tok = ttok.build_vocab(corpus, size=size)
    assert tok._native_encoder() is not None, "native wordpiece not built"
    tok_py = ttok.build_vocab(corpus, size=size)
    tok_py._native_tried = True  # skip native: the pure-Python reference
    tok_jax = jtok.build_vocab(corpus, size=size)
    tok_jax._native_tried = True
    assert tok.vocab == tok_jax.vocab
    return tok, tok_py, tok_jax


@pytest.mark.parametrize("text_a,text_b", [
    ("the cat sat", None),
    ("a dog runs fast!", None),
    ("unbelievable running", "the mat."),
    ("THE CAT", None),  # the lowercase path
    ("totally-unseen zqxj", None),  # UNK and a punctuation split
    ("word " * 200, "pad " * 150),  # the pair truncation loop
    ("", None),  # empty text
], ids=["plain", "punct", "pair", "upper", "unk", "truncate", "empty"])
def test_wordpiece_native_matches_python_and_jax(text_a, text_b):
    corpus = ["the cat sat on the mat", "a dog runs fast!", "unbelievable",
              "it's a fine day, isn't it?", "running runner ran"]
    tok, tok_py, tok_jax = _vocab_pair(corpus, 64)
    got = tok._native_encoder().encode(text_a, text_b, 32)
    assert got is not None
    for want in (tok_py.encode(text_a, text_b, max_seq_length=32),
                 tok_jax.encode(text_a, text_b, max_seq_length=32)):
        for g, w, name in zip(got, want, ["ids", "mask", "segments"]):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_wordpiece_native_declines_non_ascii():
    tok, tok_py, _ = _vocab_pair(["plain ascii corpus"], 64)
    assert tok._native_encoder().encode("café au lait", None, 16) is None  # Python does it
    got, want = tok.encode("café au lait", max_seq_length=16), \
        tok_py.encode("café au lait", max_seq_length=16)
    assert got[1].sum() > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("paired", [False, True], ids=["single", "pairs"])
def test_wordpiece_native_batch_matches_python_with_mixed_unicode(paired):
    tok, tok_py, tok_jax = _vocab_pair(
        ["plain ascii text", "with punctuation, too!", "more words here"], 128)
    texts = ["plain text", "café au lait", "naïve approach!", "ascii again", ""]
    pairs = [None, "more words", "plain", None, "touché"] if paired else None
    got = tok.encode_batch(texts, pairs, max_seq_length=16)
    for ref in (tok_py, tok_jax):
        want = ref.encode_batch(texts, pairs, max_seq_length=16)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_wordpiece_native_control_bytes_fall_back():
    """Interior NULs truncate at the C boundary and 0x1C-0x1F are whitespace
    to Python but not to std::isspace: both take the Python path."""
    tok, tok_py, tok_jax = _vocab_pair(["cat dog fish", "short rest of sentence"], 128)
    tricky = ["cat\x1cdog", "short\x00 rest", "cat\x1ddog fish", "plain cat"]
    assert tok._native_encoder().encode(tricky[0], None, 16) is None
    assert tok._native_encoder().encode(tricky[1], None, 16) is None
    got = tok.encode_batch(tricky, max_seq_length=16)
    for ref in (tok_py, tok_jax):
        want = ref.encode_batch(tricky, max_seq_length=16)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
