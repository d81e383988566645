"""Streaming evaluation metrics (the port of
``gradaccum_tpu/estimator/metrics.py``): a metric maps one batch to a
``(total, count)`` pair of partial sums, summed on the host across batches
and finalized at the end, as ``tf.metrics`` does. ``accuracy`` is the
classifiers' metric; ``mean_absolute_error`` and ``root_mean_squared_error``
are the housing regression's."""

from __future__ import annotations

import math
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


def _errors(outputs, batch, pred_key, label_key):
    pred = outputs[pred_key].reshape(-1)
    label = torch.as_tensor(batch[label_key], device=pred.device).reshape(-1)
    return pred - label, float(label.numel())


def mean_absolute_error(pred_key: str = "predictions", label_key: str = "label") -> Metric:
    """``tf.metrics.mean_absolute_error``: running sum |pred - label| / count."""

    def update(outputs, batch):
        err, count = _errors(outputs, batch, pred_key, label_key)
        return float(err.abs().sum()), count

    return Metric(update, lambda total, count: total / count)


def root_mean_squared_error(pred_key: str = "predictions",
                            label_key: str = "label") -> Metric:
    """``tf.metrics.root_mean_squared_error``: sqrt(running sum of squared
    errors / count)."""

    def update(outputs, batch):
        err, count = _errors(outputs, batch, pred_key, label_key)
        return float(err.square().sum()), count

    return Metric(update, lambda total, count: math.sqrt(total / count))
