"""CSV input pipeline + feature columns (housing regression).

The port's copy of ``gradaccum_tpu/data/csv.py``: the reference's
``csv_input_fn`` stack (another-example.py:19-95). TextLine parse with
per-column defaults (``parse_csv_row``, 62-72), optional feature engineering
(``process_features``, 75-80: log-transform ``CRIM``, clip ``B`` to
[300, 500]), and the feature-column → ``input_layer`` dense assembly
(``get_feature_columns``, 83-95: 12 numeric columns + one indicator
(one-hot) column over the categorical ``CHAS`` vocabulary).
"""

from __future__ import annotations

import csv as _csv
from typing import Dict, List, Optional, Sequence

import numpy as np

# Boston-housing schema from another-example.py:62-68 (column order of the
# generated CSVs; MEDV is the label).
HOUSING_COLUMNS = [
    "CRIM", "ZN", "INDUS", "CHAS", "NOX", "RM", "AGE",
    "DIS", "RAD", "TAX", "PTRATIO", "B", "LSTAT", "MEDV",
]
HOUSING_LABEL = "MEDV"
HOUSING_CATEGORICAL = {"CHAS": ["0", "1"]}  # another-example.py:88-90


def read_csv(
    path: str,
    columns: Sequence[str] = HOUSING_COLUMNS,
    skip_header: bool = True,
) -> Dict[str, np.ndarray]:
    """Read a CSV into a dict of column arrays (TextLineDataset + decode_csv
    semantics, another-example.py:40-47) with the csv module. Numeric
    columns parse to float32 with default 0.0 for empty fields (the
    reference's record_defaults); categorical columns stay strings.
    """
    rows: List[List[str]] = []
    with open(path, newline="") as f:
        reader = _csv.reader(f)
        if skip_header:
            next(reader, None)
        for row in reader:
            if row:
                rows.append(row)
    out: Dict[str, np.ndarray] = {}
    for i, name in enumerate(columns):
        raw = [r[i] if i < len(r) else "" for r in rows]
        if name in HOUSING_CATEGORICAL:
            out[name] = np.asarray(raw, dtype=object)
        else:
            # whitespace-only counts as empty -> record_defaults 0.0, and
            # non-empty fields must parse in full
            stripped = [("" if v is None else str(v).strip()) for v in raw]
            out[name] = np.asarray(
                [float(v) if v else 0.0 for v in stripped],
                dtype=np.float32,
            )
    return out


def process_features(features: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Feature engineering per another-example.py:75-80: log1p-style
    transform of CRIM (log(x) there; data is strictly positive) and clip of
    B to [300, 500]."""
    out = dict(features)
    if "CRIM" in out:
        out["CRIM"] = np.log(out["CRIM"].astype(np.float32))
    if "B" in out:
        out["B"] = np.clip(out["B"].astype(np.float32), 300.0, 500.0)
    return out


class FeatureColumns:
    """Dense assembly of numeric + one-hot categorical columns.

    The ``tf.feature_column`` → ``input_layer`` equivalent
    (another-example.py:83-95, 99-102): numeric columns pass through,
    categorical-with-vocabulary columns become indicator (one-hot) blocks;
    unknown vocab values get an all-zero row (TF's default num_oov_buckets=0).
    Column order follows the constructor lists, so the dense layout is stable.
    """

    def __init__(
        self,
        numeric: Sequence[str],
        categorical: Optional[Dict[str, Sequence[str]]] = None,
    ):
        self.numeric = list(numeric)
        self.categorical = {k: list(v) for k, v in (categorical or {}).items()}

    @property
    def width(self) -> int:
        return len(self.numeric) + sum(len(v) for v in self.categorical.values())

    def __call__(self, features: Dict[str, np.ndarray]) -> np.ndarray:
        n = len(next(iter(features.values())))
        blocks = []
        for name in self.numeric:
            blocks.append(features[name].astype(np.float32).reshape(n, 1))
        for name, vocab in self.categorical.items():
            idx = {v: i for i, v in enumerate(vocab)}
            onehot = np.zeros((n, len(vocab)), dtype=np.float32)
            for row, val in enumerate(features[name]):
                j = idx.get(str(val))
                if j is not None:
                    onehot[row, j] = 1.0
            blocks.append(onehot)
        return np.concatenate(blocks, axis=1)


def housing_feature_columns() -> FeatureColumns:
    """The exact column set of another-example.py:83-95."""
    numeric = [c for c in HOUSING_COLUMNS if c not in (HOUSING_LABEL, "CHAS")]
    return FeatureColumns(numeric, HOUSING_CATEGORICAL)


def load_housing(
    path: Optional[str] = None,
    engineer: bool = True,
    seed: int = 19830610,
    num_rows: int = 506,
):
    """Load (features_dense, labels) for the housing task.

    With no file, generates a deterministic synthetic dataset with the same
    schema (the real data came from pandas+sklearn in the reference,
    another-example.py:233-244). Returns
    ``(X [N, 14], y [N, 1])`` after feature engineering + one-hot CHAS.
    """
    if path is not None:
        cols = read_csv(path)
    else:
        rng = np.random.default_rng(seed)
        cols = {}
        for name in HOUSING_COLUMNS:
            if name == "CHAS":
                cols[name] = np.asarray(
                    [str(v) for v in rng.integers(0, 2, size=num_rows)], dtype=object
                )
            elif name == "CRIM":
                cols[name] = rng.uniform(0.01, 90.0, size=num_rows).astype(np.float32)
            elif name == "B":
                cols[name] = rng.uniform(0.0, 600.0, size=num_rows).astype(np.float32)
            else:
                cols[name] = rng.uniform(0.0, 100.0, size=num_rows).astype(np.float32)
        # synthetic label: a fixed linear map + noise so the MLP has signal
        w = rng.normal(size=(len(HOUSING_COLUMNS) - 1,)).astype(np.float32) * 0.05
        feats = np.stack(
            [cols[c].astype(np.float32) if c != "CHAS" else
             np.asarray([float(v) for v in cols[c]], np.float32)
             for c in HOUSING_COLUMNS if c != HOUSING_LABEL],
            axis=1,
        )
        cols[HOUSING_LABEL] = (feats @ w + rng.normal(0, 1, size=num_rows)).astype(
            np.float32
        )
    labels = cols.pop(HOUSING_LABEL).astype(np.float32).reshape(-1, 1)
    if engineer:
        cols = process_features(cols)
    dense = housing_feature_columns()(cols)
    return dense, labels
