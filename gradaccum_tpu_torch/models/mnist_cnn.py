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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gradaccum_tpu_torch.estimator.estimator import ModelBundle
from gradaccum_tpu_torch.estimator.metrics import accuracy
from gradaccum_tpu_torch.models.init import init_weights


class MnistCNN(nn.Module):
    def __init__(self, num_classes: int = 10):
        super().__init__()
        self.conv = nn.Conv2d(1, 32, 3)  # no padding: VALID, 28 -> 26
        self.dense = nn.Linear(13 * 13 * 32, 64)
        self.logits = nn.Linear(64, num_classes)

    def forward(self, images):
        x = images.float().permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.max_pool2d(F.relu(self.conv(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten (h, w, c)
        return self.logits(F.relu(self.dense(x)))


def sparse_softmax_loss(logits, labels):
    """Σ sparse CE · (1/B): a multiply by the reciprocal, as JAX does."""
    # scatter, not F.one_hot: one_hot range-checks on the host, a sync
    onehot = torch.zeros_like(logits).scatter_(-1, labels.long()[:, None], 1.0)
    per_example = -torch.sum(onehot * F.log_softmax(logits, dim=-1), dim=-1)
    return torch.sum(per_example) * (1.0 / labels.shape[0])


def mnist_cnn_bundle() -> ModelBundle:
    """Batches: ``{"image": [B, 28, 28, 1] float32, "label": [B] int}``."""

    def init(seed: int, device) -> MnistCNN:
        model = MnistCNN()
        init_weights(model, torch.Generator().manual_seed(seed))
        return model.to(device)

    def loss(model, batch):
        return sparse_softmax_loss(model(batch["image"]), batch["label"])

    @torch.no_grad()
    def predict(model, batch):
        logits = model(batch["image"])
        return {"logits": logits, "classes": torch.argmax(logits, dim=-1),
                "probabilities": torch.softmax(logits, dim=-1)}

    return ModelBundle(init=init, loss=loss, predict=predict,
                       eval_metrics={"accuracy": accuracy()})
