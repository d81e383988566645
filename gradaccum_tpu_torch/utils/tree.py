"""Parameter naming and tree math.

The JAX package names every parameter by its pytree key path joined with
"/" (``params/bert/layer_0/attention/query/kernel``), and the optimizer's
weight-decay exclusion regex-searches those names. The port keeps them: a
model's trainables are handed around as an ordered ``{jax_name: Parameter}``
dictionary, built from the ``nn.Module`` tree by :func:`named_parameters`.
The module tree mirrors the flax one (same submodule names), so only the
leaf name changes: ``Linear.weight`` and ``Conv2d.weight`` are ``kernel``,
``LayerNorm.weight`` is ``scale``, ``Embedding.weight`` is ``embedding``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

import torch
from torch import nn

# leaf renames by module type; a type not listed keeps torch's leaf names
_LEAF_NAMES = (
    (nn.Linear, {"weight": "kernel", "bias": "bias"}),
    (nn.Conv2d, {"weight": "kernel", "bias": "bias"}),
    (nn.LayerNorm, {"weight": "scale", "bias": "bias"}),
    (nn.Embedding, {"weight": "embedding"}),
)


def _leaf_name(module: nn.Module, leaf: str) -> str:
    for cls, names in _LEAF_NAMES:
        if isinstance(module, cls):
            return names.get(leaf, leaf)
    return leaf


def _path_key(name: str):
    return name.split("/")


def named_parameters(module: nn.Module, prefix: str = "params") -> Dict[str, nn.Parameter]:
    """``{jax_name: parameter}`` for every trainable of ``module``, ordered as
    ``jax.tree.leaves`` orders the flax tree (dict keys sorted per level)."""
    out = {}
    for mod_name, mod in module.named_modules():
        for leaf, param in mod.named_parameters(recurse=False):
            parts = [prefix] + (mod_name.split(".") if mod_name else [])
            out["/".join(parts + [_leaf_name(mod, leaf)])] = param
    return {name: out[name] for name in sorted(out, key=_path_key)}


def map_state(fn: Callable, node, path: str = "", leaf_types=(torch.Tensor,)):
    """``node`` (a state: NamedTuples, dicts, tuples and lists of tensors)
    rebuilt with every leaf of ``leaf_types`` replaced by ``fn(path,
    leaf)``; paths join field names and keys with "/" as checkpoints do
    (``opt_state/m/params/bert/...``). Anything else (an int step, None)
    is kept."""
    if isinstance(node, leaf_types):
        return fn(path, node)
    join = (lambda key: f"{path}/{key}") if path else str
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(map_state(fn, child, join(key), leaf_types)
                            for key, child in zip(node._fields, node)))
    if isinstance(node, dict):
        return {key: map_state(fn, child, join(key), leaf_types) for key, child in node.items()}
    if isinstance(node, (tuple, list)):
        return type(node)(map_state(fn, child, join(i), leaf_types)
                          for i, child in enumerate(node))
    return node


def tree_map_with_names(fn: Callable, named: Dict[str, torch.Tensor], *rest):
    """``{name: fn(name, leaf, *rest_leaves)}`` over a named dictionary."""
    return {name: fn(name, leaf, *(r[name] for r in rest)) for name, leaf in named.items()}


def tree_cast_floating(named: Dict[str, torch.Tensor], dtype) -> Dict[str, torch.Tensor]:
    """Every floating tensor cast to ``dtype``, integer and bool tensors
    untouched: how a bundle's ``compute_dtype`` turns float32-initialized
    parameters into low-precision storage (the float32 masters then live in
    the optimizer state, ``ops/adamw.py :: adamw(master_dtype=...)``).
    ``dtype=None`` is the identity."""
    if dtype is None:
        return named
    return {name: t.to(dtype) if t.is_floating_point() else t for name, t in named.items()}


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """L2 norm over all tensors in float32, matching ``tf.linalg.global_norm``
    (the sum of squares of each tensor, summed in order, then the root)."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))
