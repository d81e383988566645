"""Analytic work: the model's training FLOPs, and each flash kernel's
operations and bytes, from the shapes and the rows' real lengths.

Model FLOPs are three times the forward's matrix products over the real
tokens (padding is not counted): per token and layer the four attention
projections and the FFN, ``2·H·(4H + 2I)``; per row and layer the scores
and the context over the row's own length, ``4·n²·H``, halved when
causal; the head per row (BERT's pooler and classifier) or per token
(GPT's tied head, ``2·H·V``).

A flash launch covers one layer of one micro-batch, [B, A, S, D]. Its
operations count what these inputs need: real query rows against real
keys, ``n²`` per row and head, halved when causal, times ``2·D`` per
product: the forward two products (S, P·V), the dq kernel three (S again,
dP, dQ), the dk/dv kernel four (S, dP, dV, dK). Its bytes count each input
read once and each output written once, whole tensors as passed.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np

PRODUCTS = {"fwd": 2, "dq": 3, "dkv": 4}


def _sq(lengths, causal: bool) -> float:
    n = np.asarray(lengths, dtype=np.float64)
    return float(np.sum(n * n)) * (0.5 if causal else 1.0)


def train_flops(fl: dict, lengths: Iterable[int]) -> float:
    """Training FLOPs of one micro-batch (or any rows) with these lengths;
    ``fl`` from the reference model's ``flop_layers``."""
    lengths = np.asarray(list(lengths), dtype=np.float64)
    h, layers, inter = fl["hidden"], fl["layers"], fl["intermediate"]
    tokens = float(lengths.sum())
    fwd = (layers * 2.0 * h * (4 * h + 2 * inter) * tokens
           + layers * 4.0 * h * _sq(lengths, fl["causal"])
           + fl["head_flops_per_row"] * len(lengths) + fl["head_flops_per_token"] * tokens)
    return 3.0 * fwd


def flash_launch(kind: str, lengths, seq: int, heads: int, head_dim: int, elem_bytes: int,
                 causal: bool, masked: bool) -> Dict[str, float]:
    """``{"flops", "bytes"}`` of one launch of ``kind`` (fwd, dq, dkv)."""
    rows = len(lengths)
    flops = PRODUCTS[kind] * 2.0 * head_dim * heads * _sq(lengths, causal)
    t = float(rows * heads * seq * head_dim * elem_bytes)  # one [B, A, S, D] tensor
    r = float(rows * heads * seq * 4)  # one float32 [B, A, S, 1] row tensor
    mask = float(rows * seq * elem_bytes) if masked else 0.0
    moved = {"fwd": 3 * t + mask + t + r,  # q k v mask -> o lse
             "dq": 5 * t + mask + r + t + r,  # q k v dO o mask lse -> dq delta
             "dkv": 4 * t + mask + 2 * r + 2 * t}[kind]  # q k v dO mask lse delta -> dk dv
    return {"flops": flops, "bytes": moved}


def least_seconds(work: Dict[str, float], peak_flops: float, peak_bytes: float) -> float:
    """The least time the card could take: the larger of operations over
    the peak and bytes over the memory's bandwidth."""
    return max(work["flops"] / peak_flops, work["bytes"] / peak_bytes)
