"""The one traffic generator: host batches for a cell, from a seed.

A traffic mix is a JSON file beside this module (``<name>.json``) that
holds only parameters. Two kinds of rows are known:

- ``"rows": "padded"``: sequence classification. Each row holds
  ``[CLS] tokens [SEP]`` at its own length, padded to ``seq_len`` with
  ``input_mask`` 0; segment ids are 0; labels are uniform over
  ``num_classes``.
- ``"rows": "packed"``: causal language modelling. Documents are joined
  with ``eos_id`` after each and cut into rows of exactly ``seq_len``
  tokens, so no row holds padding.

Lengths are log-normal (``median``, ``sigma``, clipped to ``[min, max]``),
but drawn on a fixed grid of quantiles: every update holds the same
multiset of lengths, and the seed only orders them and draws the token
ids and labels. Every seed thus gives every update the same work, so a
rate read in one run does not depend on which lengths the seed drew.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from statistics import NormalDist
from typing import Dict, List

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent


def load(name: str) -> dict:
    """The parameters of traffic mix ``name``."""
    path = TRAFFIC_DIR / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    return json.loads(path.read_text())


def length_grid(n: int, median: float, sigma: float, lo: int, hi: int) -> np.ndarray:
    """``n`` log-normal lengths at the quantiles ``(i + 0.5) / n``, rounded
    and clipped to ``[lo, hi]``: the same multiset for every seed."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(np.rint(median * np.exp(sigma * z)), lo, hi).astype(np.int64)


def rows_per_update(mix: dict) -> int:
    return int(mix["micro_batch"]) * int(mix["num_micro_batches"])


def _padded_update(mix: dict, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    rows, seq = rows_per_update(mix), int(mix["seq_len"])
    lens = rng.permutation(length_grid(rows, mix["median"], mix["sigma"], mix["min"],
                                       mix["max"]))
    ids = rng.integers(mix["token_lo"], mix["vocab_size"], size=(rows, seq), dtype=np.int64)
    pos = np.arange(seq)[None, :]
    mask = pos < lens[:, None]
    ids[:, 0] = mix["cls_id"]
    ids[np.arange(rows), lens - 1] = mix["sep_id"]
    ids = np.where(mask, ids, mix["pad_id"])
    return {
        "input_ids": ids.astype(np.int32),
        "input_mask": mask.astype(np.int32),
        "segment_ids": np.zeros((rows, seq), dtype=np.int32),
        "label": rng.integers(0, mix["num_classes"], size=rows, dtype=np.int64).astype(np.int32),
    }


def _packed_update(mix: dict, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    rows, seq = rows_per_update(mix), int(mix["seq_len"])
    total = rows * seq
    mean = mix["median"] * math.exp(mix["sigma"] ** 2 / 2)
    n_docs = int(math.ceil(2 * total / mean)) + 1  # more than fills the rows
    lens = rng.permutation(length_grid(n_docs, mix["median"], mix["sigma"], mix["min"],
                                       mix["max"]))
    ids = rng.integers(0, mix["vocab_size"], size=total, dtype=np.int64)
    # an EOS after each document, until the update's tokens are filled
    ends = np.cumsum(lens + 1) - 1
    ids[ends[ends < total]] = mix["eos_id"]
    if ends[-1] < total - 1:
        raise ValueError("the documents drawn do not fill the update")
    return {"input_ids": ids.reshape(rows, seq).astype(np.int32)}


_KINDS = {"padded": _padded_update, "packed": _packed_update}


def updates(mix: dict, seed: int, count: int) -> List[Dict[str, np.ndarray]]:
    """``count`` host batches of ``rows_per_update`` rows each, every value
    a numpy array with the rows first (as ``Estimator.train`` reads them)."""
    make = _KINDS[mix["rows"]]
    rng = np.random.default_rng([int(seed) % 2**63, 0x7AFF1C])
    return [make(mix, rng) for _ in range(count)]


def real_tokens(mix: dict, batch: Dict[str, np.ndarray]) -> int:
    """The tokens of ``batch`` that are not padding."""
    if "input_mask" in batch:
        return int(batch["input_mask"].sum())
    return int(batch["input_ids"].size)


def row_lengths(batch: Dict[str, np.ndarray]) -> np.ndarray:
    """Each row's real length (every row whole in packed rows)."""
    if "input_mask" in batch:
        return batch["input_mask"].sum(axis=1).astype(np.int64)
    rows, seq = batch["input_ids"].shape
    return np.full(rows, seq, dtype=np.int64)
