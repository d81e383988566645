"""Streaming evaluation metrics (the port of
``gradaccum_tpu/estimator/metrics.py``): a metric maps one batch to a
``(total, count)`` pair of partial sums, summed on the host across batches
and finalized at the end, as ``tf.metrics`` does."""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class Metric(NamedTuple):
    update: Callable[[Any, Any], tuple]
    finalize: Callable[[float, float], float]


def accuracy(pred_key: str = "classes", label_key: str = "label") -> Metric:
    """``tf.metrics.accuracy``: running correct / total."""

    def update(outputs, batch):
        pred = outputs[pred_key].reshape(-1)
        label = torch.as_tensor(batch[label_key], device=pred.device).reshape(-1)
        return float((pred == label).sum()), float(label.numel())

    return Metric(update, lambda total, count: total / count)
