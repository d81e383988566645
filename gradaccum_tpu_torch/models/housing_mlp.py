"""Housing-price regression MLP, for the port.

The port of ``gradaccum_tpu/models/housing_mlp.py`` (another-example.py:
109-118): Dense [16, 8, 4] with relu, then Dense 1, on the 14 dense
features of ``data/csv.py`` (12 numeric columns and a one-hot CHAS); MSE
loss, and MAE and RMSE on ``y`` as evaluation metrics. ``compute_dtype``
stores the parameters in that dtype and runs the stack in it; the output is
cast back to float32, so the loss stays float32.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gradaccum_tpu_torch.estimator.estimator import ModelBundle
from gradaccum_tpu_torch.estimator.metrics import mean_absolute_error, root_mean_squared_error
from gradaccum_tpu_torch.models.init import init_weights, store_in

HOUSING_FEATURES = 14  # data.csv.housing_feature_columns().width


class HousingMLP(nn.Module):
    def __init__(self, in_features: int = HOUSING_FEATURES,
                 hidden: Sequence[int] = (16, 8, 4), dtype: Any = torch.float32):
        super().__init__()
        self.depth = len(hidden)
        self.dtype = dtype
        for i, (fan_in, width) in enumerate(zip((in_features,) + tuple(hidden), hidden)):
            self.add_module(f"hidden_{i}", nn.Linear(fan_in, width))  # flax names
        self.output = nn.Linear(hidden[-1], 1)

    def _dense(self, layer, x):
        return F.linear(x, layer.weight.to(self.dtype), layer.bias.to(self.dtype))

    def forward(self, features):
        x = features.to(self.dtype)
        for i in range(self.depth):
            x = F.relu(self._dense(getattr(self, f"hidden_{i}"), x))
        return self._dense(self.output, x).float()


def housing_mlp_bundle(hidden: Sequence[int] = (16, 8, 4),
                       in_features: int = HOUSING_FEATURES,
                       compute_dtype: Any = None) -> ModelBundle:
    """Batches: ``{"x": [B, 14] float32, "y": [B, 1] float32}``.
    ``compute_dtype``: pair it with ``adam(..., master_dtype=torch.float32)``."""

    def init(seed: int, device) -> HousingMLP:
        model = HousingMLP(in_features, hidden,
                           torch.float32 if compute_dtype is None else compute_dtype)
        init_weights(model, torch.Generator().manual_seed(seed))
        return store_in(model, compute_dtype).to(device)

    def loss(model, batch):
        return torch.mean((model(batch["x"]) - batch["y"]) ** 2)  # regression_head MSE

    @torch.no_grad()
    def predict(model, batch):
        return {"predictions": model(batch["x"])}

    return ModelBundle(init=init, loss=loss, predict=predict,
                       eval_metrics={"mae": mean_absolute_error(label_key="y"),
                                     "rmse": root_mean_squared_error(label_key="y")})
