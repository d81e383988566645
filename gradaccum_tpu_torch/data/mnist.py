"""MNIST idx-format reader, the port's copy of ``gradaccum_tpu/data/mnist.py``.

The reference's ``mnist_dataset.py`` (distributedExample/mnist_dataset.py:
4-26) parses the raw idx gz files with ``FixedLengthRecordDataset`` — images as 784-byte records after a
16-byte header, labels as 1-byte records after an 8-byte header — then
``decode_raw`` → float/255 → reshape 28×28×1.

Here the files are parsed directly into NumPy arrays (the whole dataset is
~55 MB — device feeding happens at batch granularity via the pipeline layer,
not per-record). Semantics preserved: float32 images scaled by 1/255 with
shape ``[N, 28, 28, 1]``, int labels.

When the idx files are absent, a deterministic synthetic stand-in with the
same shapes/dtypes and a learnable class structure is generated so every
entrypoint stays runnable end-to-end.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Dict, Optional, Tuple

import numpy as np

IMAGE_MAGIC = 2051
LABEL_MAGIC = 2049

FILES = {
    "train": ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz"),
    "test": ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz"),
}


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_images(path: str) -> np.ndarray:
    """Parse an idx3 image file → float32 [N, 28, 28, 1] in [0, 1].

    The /255 normalization and 28×28×1 reshape mirror
    mnist_dataset.py:10-12.
    """
    with _open(path) as f:
        magic, n, rows, cols = struct.unpack(">iiii", f.read(16))
        if magic != IMAGE_MAGIC:
            raise ValueError(f"{path}: bad idx3 magic {magic}")
        data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
    return (data.astype(np.float32) / 255.0).reshape(n, rows, cols, 1)


def read_labels(path: str) -> np.ndarray:
    """Parse an idx1 label file → int32 [N] (mnist_dataset.py:14-16)."""
    with _open(path) as f:
        magic, n = struct.unpack(">ii", f.read(8))
        if magic != LABEL_MAGIC:
            raise ValueError(f"{path}: bad idx1 magic {magic}")
        data = np.frombuffer(f.read(n), dtype=np.uint8)
    return data.astype(np.int32)


def synthetic(
    num_train: int = 8192, num_test: int = 1024, seed: int = 19830610
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Deterministic MNIST-shaped synthetic data with learnable structure.

    Each class is a fixed random 28×28 template; samples are the template
    plus pixel noise, clipped to [0, 1]. A small CNN reaches >95% accuracy
    on this in a few hundred steps, which is what the example/bench flows
    need from it.
    """
    rng = np.random.default_rng(seed)
    templates = rng.uniform(0.0, 1.0, size=(10, 28, 28, 1)).astype(np.float32)

    def make(n, split_seed):
        r = np.random.default_rng(split_seed)
        labels = r.integers(0, 10, size=n).astype(np.int32)
        noise = r.normal(0.0, 0.35, size=(n, 28, 28, 1)).astype(np.float32)
        images = np.clip(templates[labels] + noise, 0.0, 1.0)
        return images, labels

    return {"train": make(num_train, seed + 1), "test": make(num_test, seed + 2)}


def flip_labels(
    labels: np.ndarray, frac: float, num_classes: int = 10,
    seed: int = 19830610,
) -> np.ndarray:
    """Symmetric label noise: flip ``frac`` of labels to a uniform OTHER class.

    Gives a fresh single-epoch stream a nonzero entropy floor: with 10%
    flips the optimal loss is ``H(0.9, 0.1/9 x 9) ~ 0.545``."""
    if frac <= 0:
        return labels
    rng = np.random.default_rng(seed + 7)
    flip = rng.random(labels.shape[0]) < frac
    offset = rng.integers(1, num_classes, size=labels.shape[0])
    return np.where(flip, (labels + offset) % num_classes, labels).astype(
        labels.dtype)


def load(
    data_dir: Optional[str] = None,
    synthetic_fallback: bool = True,
    num_train: Optional[int] = None,
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Load MNIST as ``{"train": (images, labels), "test": ...}``.

    Mirrors ``mnist_dataset.load()`` (mnist_dataset.py:4-26) including the
    image/label zip; falls back to :func:`synthetic` when files are missing.
    ``num_train`` sizes the synthetic fallback (e.g. a fresh single-epoch
    stream covering a whole run's sample budget); ignored for real files.
    """
    if data_dir is not None:
        found = {}
        for split, (img_name, lbl_name) in FILES.items():
            img = _find(data_dir, img_name)
            lbl = _find(data_dir, lbl_name)
            if img and lbl:
                found[split] = (read_images(img), read_labels(lbl))
        if len(found) == len(FILES):
            return found
        if found or not synthetic_fallback:
            missing = set(FILES) - set(found)
            raise FileNotFoundError(f"MNIST files for splits {missing} not in {data_dir}")
    if not synthetic_fallback:
        raise FileNotFoundError("no data_dir given and synthetic_fallback=False")
    if num_train is not None:
        return synthetic(num_train=num_train)
    return synthetic()


def _find(data_dir: str, name: str) -> Optional[str]:
    for candidate in (name, name[:-3] if name.endswith(".gz") else name + ".gz"):
        path = os.path.join(data_dir, candidate)
        if os.path.exists(path):
            return path
    return None
