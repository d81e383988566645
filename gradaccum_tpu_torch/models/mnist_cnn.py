"""MNIST CNN, the reference's Keras Sequential model, for the port.

The port of ``gradaccum_tpu/models/mnist_cnn.py`` (distributedExample/
01:22-28, the same in 02/03/04): Conv 3×3 → 32, VALID, relu → MaxPool
2×2/2 → Flatten (13·13·32 = 5408) → Dense 64, relu → Dense 10 logits.

Images arrive NHWC ``[B, 28, 28, 1]`` as in JAX; the convolution runs NCHW
and the pooled map is flattened in (h, w, c) order, as flax flattens NHWC,
so the first Dense's 5408 input rows line up with the JAX kernel's rows
and weights carry across with a transpose only (``interop.py``).

Loss: sparse softmax cross-entropy summed, times 1/B (01:43-45). Predict:
logits, argmax classes and softmax probabilities (02:31-33). The layers are
torch ops (``F.conv2d``, ``F.max_pool2d``, ``F.linear``): in JAX they were
XLA code, not a Pallas kernel.

``compute_dtype`` stores the parameters in that dtype and runs the model in
it (pair it with ``adam(..., master_dtype=torch.float32)``); the logits and
the loss stay float32. JAX's compute-only ``dtype`` knob is not carried: no
caller of the port sets it.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from gradaccum_tpu_torch.estimator.estimator import ModelBundle
from gradaccum_tpu_torch.estimator.metrics import accuracy
from gradaccum_tpu_torch.models.init import init_weights, store_in


class MnistCNN(nn.Module):
    def __init__(self, num_classes: int = 10, dtype: Any = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(1, 32, 3)  # no padding: VALID, 28 -> 26
        self.dense = nn.Linear(13 * 13 * 32, 64)
        self.logits = nn.Linear(64, num_classes)

    def _w(self, layer):
        return layer.weight.to(self.dtype), layer.bias.to(self.dtype)

    def forward(self, images):
        x = images.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.max_pool2d(F.relu(F.conv2d(x, *self._w(self.conv))), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten (h, w, c)
        x = F.relu(F.linear(x, *self._w(self.dense)))
        return F.linear(x, *self._w(self.logits)).float()


def sparse_softmax_loss(logits, labels):
    """Σ sparse CE · (1/B): a multiply by the reciprocal, as JAX does."""
    # scatter, not F.one_hot: one_hot range-checks on the host, a sync
    onehot = torch.zeros_like(logits).scatter_(-1, labels.long()[:, None], 1.0)
    per_example = -torch.sum(onehot * F.log_softmax(logits, dim=-1), dim=-1)
    return torch.sum(per_example) * (1.0 / labels.shape[0])


def mnist_cnn_bundle(compute_dtype: Any = None) -> ModelBundle:
    """Batches: ``{"image": [B, 28, 28, 1] float32, "label": [B] int}``."""

    def init(seed: int, device) -> MnistCNN:
        model = MnistCNN(dtype=torch.float32 if compute_dtype is None else compute_dtype)
        init_weights(model, torch.Generator().manual_seed(seed))
        return store_in(model, compute_dtype).to(device)

    def loss(model, batch):
        return sparse_softmax_loss(model(batch["image"]), batch["label"])

    @torch.no_grad()
    def predict(model, batch):
        logits = model(batch["image"])
        return {"logits": logits, "classes": torch.argmax(logits, dim=-1),
                "probabilities": torch.softmax(logits, dim=-1)}

    return ModelBundle(init=init, loss=loss, predict=predict,
                       eval_metrics={"accuracy": accuracy()})
