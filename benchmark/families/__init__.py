"""How the benchmark builds the program under test for each model family.

A configuration file names its ``family``; ``families/<family>.py``
turns the file into the port's bundle (with the weights the benchmark
made handed in through the bundle's ``init``) and names the reference
model that follows it (``reference/``). A new family is a new file here.
"""

from __future__ import annotations

import importlib


def load(family: str):
    return importlib.import_module(f"benchmark.families.{family}")


def copy_weights(module, weights) -> None:
    """Copy ``weights`` (``{torch parameter name: tensor}``) into ``module``;
    a missing or extra name, or another shape, raises."""
    import torch

    params = dict(module.named_parameters())
    if params.keys() != weights.keys():
        raise ValueError(f"weights do not match the program's parameters: missing "
                         f"{sorted(params.keys() - weights.keys())}, extra "
                         f"{sorted(weights.keys() - params.keys())}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: shape {tuple(weights[name].shape)} for "
                                 f"{tuple(p.shape)}")
            p.copy_(weights[name])


def state_names(module) -> dict:
    """``{name in the program's state: torch parameter name}``."""
    from gradaccum_tpu_torch.utils.tree import named_parameters

    by_id = {id(p): name for name, p in module.named_parameters()}
    return {name: by_id[id(p)] for name, p in named_parameters(module).items()}
