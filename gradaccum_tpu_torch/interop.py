"""Carry weights between the JAX package's flax trees and the port's modules.

``params_from_jax`` turns a flax parameter tree (nested dicts of numpy
arrays, e.g. ``jax.device_get(params)``) into a torch ``state_dict`` for
the port's mirrored module tree; ``params_to_jax`` is the inverse, from a
``{jax_name: tensor}`` dictionary (:func:`..utils.tree.named_parameters`,
or gradients keyed the same way) or from a module. The mapping:

- Dense ``kernel`` [in, out]  <->  ``Linear.weight`` [out, in]
- Conv ``kernel`` HWIO [kh, kw, in, out]  <->  ``Conv2d.weight`` OIHW
  [out, in, kh, kw]
- ``bias``                    <->  ``bias``
- LayerNorm ``scale``         <->  ``LayerNorm.weight``
- Embed ``embedding``         <->  ``Embedding.weight``
- MoE ``router``, ``w_in``, ``b_in``, ``w_out``, ``b_out`` (raw arrays, not
  Dense kernels) keep their names and layouts

The mapping goes by leaf name, so every model whose module tree mirrors the
flax one carries across: BERT, the MNIST CNN, the housing MLP and GPT
(BERT's names plus ``attention_LayerNorm``, ``mlp_LayerNorm``,
``final_LayerNorm`` and ``position_embeddings``). Names stay the JAX
package's, since the optimizer's weight-decay exclusion regex-searches them:
a renamed leaf would silently change which weights decay.

:func:`params_tree` is the same tree the other way: the port's own tensors
arranged as JAX's nested ``params["params"]["layer_0"]...`` tree, kernels
as ``[in, out]`` views (no copy), which ``models/gpt_decode.py`` reads as
JAX's decode reads the flax tree.

:func:`pipeline_params_from_jax` and :func:`pipeline_params_to_jax` carry
the pipeline's parameters (``parallel/pp.py``): a JAX ``PipelineParams``
(``pre``/``stages``/``post`` flax trees, the stages stacked ``[P, ...]``)
or a bare stage-stacked tree, as ``(pre, stages, post)`` of numpy trees or
from ``jax.device_get``, to and from the port's ``{jax_name: tensor}``
dictionaries in the port's layouts (a stacked Dense kernel ``[P, in, out]``
is ``[P, out, in]`` here).
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

from gradaccum_tpu_torch.utils.tree import named_parameters

_TO_TORCH_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
                  "bias": "bias"}
_TO_TORCH_LEAF.update({name: name for name in ("router", "w_in", "b_in", "w_out", "b_out")})


def _flatten(tree, prefix=()):
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            yield from _flatten(tree[key], prefix + (str(key),))
    else:
        yield prefix, tree


def state_dict_key(jax_name: str) -> str:
    """``params/bert/pooler/kernel`` -> ``bert.pooler.weight``."""
    parts = jax_name.split("/")
    if parts[0] == "params":
        parts = parts[1:]
    leaf = _TO_TORCH_LEAF.get(parts[-1])
    if leaf is None:
        raise KeyError(f"no torch counterpart for leaf {parts[-1]!r} of {jax_name}")
    return ".".join(parts[:-1] + [leaf])


def _kernel_to_torch(arr, name, stacked=False):
    if stacked:  # stage-stacked Dense [P, in, out] -> [P, out, in]
        return np.swapaxes(arr, -1, -2)
    if arr.ndim == 2:  # Dense [in, out] -> Linear [out, in]
        return arr.T
    if arr.ndim == 4:  # Conv HWIO -> Conv2d OIHW
        return arr.transpose(3, 2, 0, 1)
    raise ValueError(f"{name}: only 2-D Dense and 4-D Conv kernels map to torch")


def _kernel_to_jax(arr, stacked=False):
    if stacked:
        return np.swapaxes(arr, -1, -2)
    return arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)


def _named_from_jax(tree, stacked=False):
    """A flax tree -> ``(jax_name, tensor)`` pairs in the port's layouts;
    with ``stacked`` the leaves carry a leading stage dimension."""
    for path, leaf in _flatten(tree):
        arr = np.asarray(leaf)
        if path[-1] == "kernel":
            arr = _kernel_to_torch(arr, "/".join(path), stacked)
        yield "/".join(path), torch.tensor(arr)  # a copy: jax arrays are read-only


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """A flax parameter tree -> a torch ``state_dict`` (float tensors on the
    CPU; ``module.load_state_dict`` moves them to the module's device)."""
    return {state_dict_key(name): t for name, t in _named_from_jax(tree)}


def params_to_jax(named: Union[nn.Module, Dict[str, torch.Tensor]], stacked: bool = False):
    """``{jax_name: tensor}`` (or a module) -> a nested flax-shaped dict of
    float32 numpy arrays, kernels back in flax's layouts; with ``stacked``
    the leaves carry a leading stage dimension."""
    if isinstance(named, nn.Module):
        named = named_parameters(named)
    tree: dict = {}
    for name, t in named.items():
        arr = t.detach().to("cpu", torch.float32).numpy()
        if name.endswith("/kernel"):
            arr = _kernel_to_jax(arr, stacked)
        node = tree
        *parents, leaf = name.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


def params_tree(named: Union[nn.Module, Dict[str, torch.Tensor]]):
    """``{jax_name: tensor}`` (or a module) -> the nested flax-shaped tree of
    the same tensors, detached: a Dense ``kernel`` is the transposed view of
    ``Linear.weight`` (``[in, out]``, flax's layout), every other leaf the
    tensor itself. Nothing is copied, so the tree follows the module's
    weights and its device."""
    if isinstance(named, nn.Module):
        named = named_parameters(named)
    tree: dict = {}
    for name, t in named.items():
        t = t.detach()
        if name.endswith("/kernel"):
            if t.dim() != 2:
                raise ValueError(f"{name}: only 2-D Dense kernels map to a decode tree")
            t = t.t()
        node = tree
        *parents, leaf = name.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = t
    return tree


def pipeline_params_from_jax(params):
    """JAX pipeline parameters -> the port's: a ``PipelineParams`` (any
    object with ``pre``, ``stages`` and ``post``) gives the port's
    ``PipelineParams`` of ``{jax_name: tensor}`` dictionaries, a bare
    stage-stacked tree gives one dictionary."""
    from gradaccum_tpu_torch.parallel.pp import PipelineParams

    if not hasattr(params, "stages"):
        return dict(_named_from_jax(params, stacked=True))
    return PipelineParams(
        pre=None if params.pre is None else dict(_named_from_jax(params.pre)),
        stages=dict(_named_from_jax(params.stages, stacked=True)),
        post=None if params.post is None else dict(_named_from_jax(params.post)))


def pipeline_params_to_jax(params):
    """The port's pipeline parameters -> ``(pre, stages, post)`` flax-shaped
    numpy trees (``pre`` and ``post`` None for a bare stage dictionary), to
    build JAX's ``PipelineParams`` from."""
    if not hasattr(params, "stages"):
        return None, params_to_jax(params, stacked=True), None
    return (None if params.pre is None else params_to_jax(params.pre),
            params_to_jax(params.stages, stacked=True),
            None if params.post is None else params_to_jax(params.post))
