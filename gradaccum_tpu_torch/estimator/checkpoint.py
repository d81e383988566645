"""Checkpoint save/restore of the whole train state.

The port of ``gradaccum_tpu/estimator/checkpoint.py``: one file per step,
``<dir>/ckpt-<step>.pt``, holding every leaf of the state (a ``ScanState``
or ``StreamingState``: the parameters, the optimizer state — AdamW's moments,
Adam's ``t`` and moments, the float32 masters under bfloat16 parameters, or
SGD's momentum buffers — the step, and in
streaming mode the gradient accumulators and the window's good count, plus
the ``DynamicLossScale`` when scaling is on). The accumulators and the
moments checkpoint with the weights, so a resume in the middle of an
accumulation window continues the same trajectory bit for bit.

Leaves are keyed by their "/"-joined path through the state's named tuples
and dictionaries (``params/params/bert/pooler/kernel``, ``opt_state/t``,
``step``); a blockwise-int8 moment (``QuantTensor``) saves its codes, its
scales and its shape, and restores only into the same shape. Each file is
written to ``.tmp``, flushed to disk and renamed
into place, so a crash never leaves a torn checkpoint under the final name;
only the newest ``keep`` files are kept.

Not ported yet (ROADMAP.md): the sha256 manifest, quarantine of corrupt
files, IO retries and the asynchronous writer.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from gradaccum_tpu_torch.memory.quant import QuantTensor

_CKPT_RE = re.compile(r"ckpt-(\d+)\.pt$")


def _children(node) -> List[Tuple[str, Any]]:
    if isinstance(node, tuple) and hasattr(node, "_fields"):  # a NamedTuple
        return list(zip(node._fields, node))
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, (tuple, list)):
        return [(str(i), child) for i, child in enumerate(node)]
    raise TypeError(f"cannot checkpoint a {type(node).__name__}")


def flatten(state, prefix: str = "") -> Dict[str, Any]:
    """``{path: leaf}`` for every tensor and int leaf of ``state``, in order.
    A ``QuantTensor`` gives its ``q``, its ``scale`` and its ``shape`` (a
    tuple of ints)."""
    if isinstance(state, (torch.Tensor, int)) or state is None:
        return {prefix: state}
    if isinstance(state, QuantTensor):
        return {f"{prefix}/q": state.q, f"{prefix}/scale": state.scale,
                f"{prefix}/shape": state.shape}
    out = {}
    for key, child in _children(state):
        out.update(flatten(child, f"{prefix}/{key}" if prefix else str(key)))
    return out


def _rebuild(template, saved: Dict[str, Any], path: str, where: str):
    """``template`` with every leaf taken from ``saved``: tensors copied in
    place (so a model holding them sees the restored values), ints and None
    replaced."""
    if isinstance(template, torch.Tensor):
        got = saved[path]
        if not isinstance(got, torch.Tensor) or got.shape != template.shape \
                or got.dtype != template.dtype:
            desc = (f"{got.dtype} {tuple(got.shape)}" if isinstance(got, torch.Tensor)
                    else type(got).__name__)
            raise ValueError(f"{where}: {path} is {desc}, template {template.dtype} "
                             f"{tuple(template.shape)}")
        with torch.no_grad():
            template.copy_(got)
        return template
    if isinstance(template, int) or template is None:
        return saved[path]
    if isinstance(template, QuantTensor):
        shape = tuple(saved[f"{path}/shape"])
        if shape != template.shape:
            raise ValueError(f"{where}: {path} is a QuantTensor of shape {shape}, "
                             f"template {template.shape}")
        _rebuild(template.q, saved, f"{path}/q", where)
        _rebuild(template.scale, saved, f"{path}/scale", where)
        return template
    children = [(key, _rebuild(child, saved, f"{path}/{key}" if path else str(key), where))
                for key, child in _children(template)]
    if hasattr(template, "_fields"):
        return type(template)(*(child for _, child in children))
    if isinstance(template, dict):
        return dict(children)
    return type(template)(child for _, child in children)


def save(directory: str, state, step: int, keep: int = 5) -> str:
    """Atomically write ``state`` as ``ckpt-<step>.pt``; prune to ``keep``."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt-{step}.pt")
    tmp = path + ".tmp"
    payload = {key: leaf.detach().to("cpu", copy=True) if isinstance(leaf, torch.Tensor)
               else leaf for key, leaf in flatten(state).items()}
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    if keep:
        for _, old in all_checkpoints(directory)[:-keep]:
            os.remove(old)
    return path


def all_checkpoints(directory: str) -> List[Tuple[int, str]]:
    """``(step, path)`` pairs, oldest first."""
    if not os.path.isdir(directory):
        return []
    found = []
    for name in os.listdir(directory):
        m = _CKPT_RE.match(name)
        if m:
            found.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(found)


def latest_checkpoint(directory: str) -> Optional[Tuple[int, str]]:
    ckpts = all_checkpoints(directory)
    return ckpts[-1] if ckpts else None


def _load(directory_or_path: str) -> Tuple[str, Dict[str, Any]]:
    path = directory_or_path
    if not os.path.isfile(path):
        latest = latest_checkpoint(directory_or_path)
        if latest is None:
            raise FileNotFoundError(f"no checkpoints under {directory_or_path}")
        path = latest[1]
    return path, torch.load(path, map_location="cpu", weights_only=True)


def restore(directory_or_path: str, template):
    """Load the newest checkpoint of a directory (or an explicit file) INTO
    the template state: tensors are copied in place, the rest rebuilt.
    Raises FileNotFoundError when there is none and ValueError when its
    leaves differ from the template's in name, shape or dtype."""
    path, payload = _load(directory_or_path)
    want = flatten(template)
    if payload.keys() != want.keys():
        missing = sorted(want.keys() - payload.keys())[:3]
        extra = sorted(payload.keys() - want.keys())[:3]
        raise ValueError(f"{path}: leaves differ from the template's "
                         f"(missing {missing}, unexpected {extra})")
    return _rebuild(template, payload, "", path)


def restore_params(directory_or_path: str, params: Dict[str, torch.Tensor]) -> int:
    """Copy only the checkpoint's parameters into ``params`` (in place), for
    inference; returns the checkpoint's step."""
    path, payload = _load(directory_or_path)
    saved = {key[len("params/"):]: leaf for key, leaf in payload.items()
             if key.startswith("params/")}
    if saved.keys() != params.keys():
        raise ValueError(f"{path}: parameter names differ from the model's")
    _rebuild(params, saved, "", path)
    return int(payload["step"])
