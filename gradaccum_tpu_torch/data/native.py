"""ctypes bindings to the repo's native data-loading runtime
(``native/dataloader.cc``), the port's copy of ``gradaccum_tpu/data/native.py``.

The idx (MNIST) and numeric-CSV readers of :mod:`.mnist` and :mod:`.csv`
call into it when it is available and take their numpy paths when it is
not (no compiler, ``GRADACCUM_NATIVE=0``, a failed build or load) or when
it declines a file (a parse problem it reports). Both paths give the same
bytes. :class:`NativeWordPiece` is the WordPiece encoder's ASCII fast
path, which ``tokenization.Tokenizer`` takes when the library is there; it
declines non-ASCII text (and text with a NUL), which the Python path
encodes.

The library is built at first use with ``g++`` from the source into
``build/native/libgradaccum_data-<hash of the source>.so`` (``build/`` is
ignored by git), never into ``native/``; a changed source builds anew. The
signatures below are this package's own copy of the C interface.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SOURCE = os.path.join(_ROOT, "native", "dataloader.cc")
_BUILD_DIR = os.path.join(_ROOT, "build", "native")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
build_error: Optional[str] = None  # why the last build failed, if it did


def _so_path() -> str:
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libgradaccum_data-{digest}.so")


def _build(so: str) -> bool:
    """Compile the source into ``so`` (written to a temporary name, then
    renamed, so a concurrent reader never loads half a file)."""
    global build_error
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), "-O3", "-std=c++17", "-fPIC", "-shared",
           "-o", tmp, _SOURCE, "-lz"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (subprocess.SubprocessError, OSError) as e:
        build_error = str(e)
        return False
    if out.returncode != 0:
        build_error = out.stderr.strip()[-2000:]
        return False
    os.replace(tmp, so)
    return True


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.ga_version.restype = ctypes.c_int
    lib.ga_idx_images_size.argtypes = [ctypes.c_char_p, i32p, i32p, i32p]
    lib.ga_idx_images_size.restype = ctypes.c_int
    lib.ga_idx_read_images.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
    ]
    lib.ga_idx_read_images.restype = ctypes.c_int
    lib.ga_idx_labels_size.argtypes = [ctypes.c_char_p, i32p]
    lib.ga_idx_labels_size.restype = ctypes.c_int
    lib.ga_idx_read_labels.argtypes = [ctypes.c_char_p, i32p, ctypes.c_int64]
    lib.ga_idx_read_labels.restype = ctypes.c_int
    lib.ga_csv_size.argtypes = [ctypes.c_char_p, ctypes.c_int, i32p, i32p]
    lib.ga_csv_size.restype = ctypes.c_int
    lib.ga_csv_read.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
    ]
    lib.ga_csv_read.restype = ctypes.c_int
    lib.ga_wp_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.ga_wp_create.restype = ctypes.c_void_p
    lib.ga_wp_destroy.argtypes = [ctypes.c_void_p]
    lib.ga_wp_destroy.restype = None
    lib.ga_wp_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32,
        i32p, i32p, i32p,
    ]
    lib.ga_wp_encode.restype = ctypes.c_int
    lib.ga_wp_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p, i32p,
    ]
    lib.ga_wp_encode_batch.restype = ctypes.c_int
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, built on first use; None if unavailable
    or disabled (``GRADACCUM_NATIVE=0``)."""
    global _lib, _load_attempted
    if os.environ.get("GRADACCUM_NATIVE", "1") == "0":
        return None
    with _lock:
        if _load_attempted:
            return _lib
        _load_attempted = True
        try:
            so = _so_path()
        except OSError:
            return None  # the source is not beside the package
        if not os.path.exists(so) and not _build(so):
            return None
        try:
            _lib = _declare(ctypes.CDLL(so))
        except OSError:
            _lib = None
        return _lib


def available() -> bool:
    return get_lib() is not None


def _check(rc: int, what: str, path: str):
    if rc != 0:
        raise ValueError(f"native {what} failed with code {rc} for {path}")


def read_idx_images(path: str) -> Optional[np.ndarray]:
    """float32 [N, rows, cols, 1] in [0, 1], or None if native is off."""
    lib = get_lib()
    if lib is None:
        return None
    n, rows, cols = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    _check(lib.ga_idx_images_size(path.encode(), ctypes.byref(n), ctypes.byref(rows),
                                  ctypes.byref(cols)), "idx_images_size", path)
    out = np.empty(n.value * rows.value * cols.value, np.float32)
    _check(lib.ga_idx_read_images(path.encode(),
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                  out.size), "idx_read_images", path)
    return out.reshape(n.value, rows.value, cols.value, 1)


def read_idx_labels(path: str) -> Optional[np.ndarray]:
    """int32 [N], or None if native is off."""
    lib = get_lib()
    if lib is None:
        return None
    n = ctypes.c_int32()
    _check(lib.ga_idx_labels_size(path.encode(), ctypes.byref(n)), "idx_labels_size", path)
    out = np.empty(n.value, np.int32)
    _check(lib.ga_idx_read_labels(path.encode(),
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                  out.size), "idx_read_labels", path)
    return out


def read_csv_numeric(path: str, skip_header: bool = True) -> Optional[Tuple[np.ndarray, int]]:
    """(float32 [rows, cols] with record_defaults 0.0, cols), or None."""
    lib = get_lib()
    if lib is None:
        return None
    n_rows, n_cols = ctypes.c_int32(), ctypes.c_int32()
    _check(lib.ga_csv_size(path.encode(), int(skip_header), ctypes.byref(n_rows),
                           ctypes.byref(n_cols)), "csv_size", path)
    out = np.empty(n_rows.value * n_cols.value, np.float32)
    _check(lib.ga_csv_read(path.encode(), int(skip_header),
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size),
           "csv_read", path)
    return out.reshape(n_rows.value, n_cols.value), n_cols.value


NONASCII = -6  # ga_wp_encode's code for text the Python path must encode


def _native_safe(text: Optional[str]) -> bool:
    """Can the C string interface see this text faithfully? Interior NULs
    truncate at the C boundary with no error, so they take the Python path,
    as non-ASCII text does (the C side rejects control bytes itself)."""
    return text is None or (text.isascii() and "\x00" not in text)


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeWordPiece:
    """Handle to the C++ WordPiece encoder (the ASCII fast path).

    ``encode`` returns ``(ids, mask, segments)`` int32 arrays, or None when
    the text needs the full-Unicode Python path; ``encode_batch`` encodes a
    whole batch in one call and flags the rows the Python path must redo.
    The handle's vocab is read-only after construction, so encoding is
    reentrant."""

    def __init__(self, vocab_tokens, pad_id, unk_id, cls_id, sep_id, lower=True):
        self._lib = get_lib()
        self._handle = None
        if self._lib is None:
            return
        # a non-ASCII (or NUL-bearing) entry could only match text the
        # native path declines anyway: a lone space stands in for it, which
        # basic tokenization (it splits on whitespace) can never produce
        tokens = [t if _native_safe(t) else " " for t in vocab_tokens]
        arr = (ctypes.c_char_p * len(tokens))(*[t.encode() for t in tokens])
        self._handle = self._lib.ga_wp_create(arr, len(tokens), pad_id, unk_id, cls_id,
                                              sep_id, int(lower))

    @property
    def available(self) -> bool:
        return self._handle is not None

    def encode(self, text_a: str, text_b: Optional[str], max_seq_length: int):
        if self._handle is None or not _native_safe(text_a) or not _native_safe(text_b):
            return None
        ids, mask, seg = (np.empty(max_seq_length, np.int32) for _ in range(3))
        rc = self._lib.ga_wp_encode(self._handle, text_a.encode(),
                                    text_b.encode() if text_b else None, max_seq_length,
                                    _i32(ids), _i32(mask), _i32(seg))
        if rc == NONASCII:
            return None
        if rc != 0:
            raise ValueError(f"native wordpiece encode failed with code {rc}")
        return ids, mask, seg

    def encode_batch(self, texts, text_pairs, max_seq_length: int):
        """``(ids, mask, seg, needs_python)``: ``[n, max_seq_length]`` arrays
        and the bool rows the Python path must encode (non-ASCII); None when
        the library is unavailable."""
        if self._handle is None:
            return None
        n = len(texts)
        pairs = text_pairs if text_pairs is not None else [None] * n
        safe_a = [_native_safe(t) for t in texts]
        safe_b = [_native_safe(p) for p in pairs]
        # a declined row is encoded from "" (cheaply) and replaced
        arr_a = (ctypes.c_char_p * n)(*[t.encode() if ok else b""
                                        for t, ok in zip(texts, safe_a)])
        arr_b = None
        if any(p for p in pairs):
            arr_b = (ctypes.c_char_p * n)(*[p.encode() if (p and ok) else None
                                            for p, ok in zip(pairs, safe_b)])
        ids, mask, seg = (np.empty((n, max_seq_length), np.int32) for _ in range(3))
        status = np.empty(n, np.int32)
        rc = self._lib.ga_wp_encode_batch(self._handle, arr_a, arr_b, n, max_seq_length,
                                          _i32(ids), _i32(mask), _i32(seg), _i32(status))
        if rc != 0:
            raise ValueError(f"native wordpiece batch failed with code {rc}")
        needs_python = np.zeros(n, bool)
        for i in range(n):
            if not safe_a[i] or not safe_b[i] or status[i] == NONASCII:
                needs_python[i] = True
            elif status[i] != 0:
                raise ValueError(f"native wordpiece encode failed with code {int(status[i])}")
        return ids, mask, seg, needs_python

    def __del__(self):
        try:
            if self._handle is not None and self._lib is not None:
                self._lib.ga_wp_destroy(self._handle)
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass
