"""Model export for serving on ``torch.export`` (the port of
``gradaccum_tpu/estimator/export.py``, the ``export_savedmodel`` slot).

``export_predict`` traces ``predict_fn(module, batch)`` with the trained
weights into one ``torch.export`` program and saves it as ``model.pt2``,
beside JAX's ``manifest.json`` (the input and output shapes and dtypes of
the caller's sample, ``batch_polymorphic``, and under ``"extra"`` any
JSON-serializable metadata the caller passes: the serving tier records its
engine's knobs there, ``serving/engine.py :: Engine.manifest``). Any later
process loads it with :func:`load_exported`, which imports the port's
operator libraries (``ops/flash_attention.py``, where the flash forward is
the operator ``gradaccum::flash_fwd``, and ``ops/matmul.py``, whose
``gradaccum::mm_f32`` is a float32 product on the card) and nothing of the
model code.

The batch dimension is exported as a dynamic ``Dim`` by default, so one
artifact serves any batch size. torch specializes a dimension of size 1,
so a one-row sample (what JAX's callers pass) is traced repeated to two
rows; the manifest still records the caller's own sample. The program runs
on the device its weights were exported from: an export on the card
launches the flash forward kernel inside the artifact.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict

import numpy as np
import torch

_BLOB = "model.pt2"
_MANIFEST = "manifest.json"


class _Serve(torch.nn.Module):
    """``batch -> predict_fn(module, batch)`` as a module to trace."""

    def __init__(self, predict_fn, module: torch.nn.Module):
        super().__init__()
        self.module = module
        self._predict = predict_fn

    def forward(self, batch):
        return self._predict(self.module, batch)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _module_device(module: torch.nn.Module) -> torch.device:
    for t in list(module.parameters()) + list(module.buffers()):
        return t.device
    return torch.device("cpu")


def export_predict(
    predict_fn: Callable[[torch.nn.Module, Dict[str, Any]], Dict[str, torch.Tensor]],
    module: torch.nn.Module,
    sample_batch: Dict[str, Any],
    export_dir: str,
    batch_polymorphic: bool = True,
    extra: Dict[str, Any] = None,
) -> str:
    """Serialize ``lambda batch: predict_fn(module, batch)`` to
    ``export_dir`` (weights included). Returns the program's path.

    ``sample_batch``: a dict batch of arrays fixing every input's shape and
    dtype; with ``batch_polymorphic`` the leading dim is exported as a
    dynamic dimension, so the artifact serves any batch size. ``extra``:
    JSON-serializable metadata stored under the manifest's ``"extra"``
    key."""
    if not isinstance(sample_batch, dict):
        raise TypeError("export expects dict batches (the ModelBundle contract)")
    device = _module_device(module)
    sample = {key: torch.as_tensor(np.asarray(v)).to(device) for key, v in sample_batch.items()}
    traced = sample
    dynamic = None
    if batch_polymorphic:
        rows = {t.shape[0] for t in sample.values()}
        if len(rows) != 1:
            raise ValueError(f"a batch-polymorphic export needs one leading size, got {rows}")
        if rows == {1}:  # a size-1 dimension would be specialized
            traced = {key: t.repeat(2, *([1] * (t.dim() - 1))) for key, t in sample.items()}
        batch = torch.export.Dim("batch", min=1)
        dynamic = ({key: {0: batch} for key in traced},)
    serve = _Serve(predict_fn, module).eval()
    with torch.no_grad():
        # traced with grad off, so the model's own no_grad adds no wrapper
        program = torch.export.export(serve, (traced,), dynamic_shapes=dynamic, strict=False)
        outputs = serve(sample)

    os.makedirs(export_dir, exist_ok=True)
    blob_path = os.path.join(export_dir, _BLOB)
    tmp = os.path.join(export_dir, "model.tmp.pt2")  # torch.export wants the suffix
    torch.export.save(program, tmp)
    os.replace(tmp, blob_path)  # atomic like the checkpoint writer

    manifest = {
        "inputs": {key: {"shape": list(np.shape(leaf)), "dtype": _dtype_name(t.dtype)}
                   for (key, leaf), t in zip(sample_batch.items(), sample.values())},
        "outputs": {key: {"shape": list(v.shape), "dtype": _dtype_name(v.dtype)}
                    for key, v in outputs.items()},
        "batch_polymorphic": batch_polymorphic,
    }
    if extra is not None:
        manifest["extra"] = extra
    with open(os.path.join(export_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return blob_path


def load_exported(export_dir: str) -> Callable[[Dict[str, Any]], Dict[str, torch.Tensor]]:
    """Load an export and return ``fn(batch) -> outputs`` (tensors on the
    artifact's device). Needs no model code: only the program, the manifest
    and the operator library. ``batch`` takes arrays or tensors; each input
    is cast to the manifest's dtype and moved to the artifact's device."""
    import gradaccum_tpu_torch.ops.flash_attention  # noqa: F401 (gradaccum::flash_fwd)
    import gradaccum_tpu_torch.ops.matmul  # noqa: F401 (gradaccum::mm_f32)

    program = torch.export.load(os.path.join(export_dir, _BLOB))
    inputs = load_manifest(export_dir)["inputs"]
    tensors = list(program.state_dict.values()) + list(program.constants.values())
    device = next((t.device for t in tensors if isinstance(t, torch.Tensor)),
                  torch.device("cpu"))
    run = program.module()

    def fn(batch):
        ordered = {key: torch.as_tensor(np.asarray(batch[key]) if not isinstance(
            batch[key], torch.Tensor) else batch[key]).to(
                device=device, dtype=getattr(torch, spec["dtype"]))
            for key, spec in inputs.items()}
        with torch.no_grad():
            return run(ordered)

    return fn


def load_manifest(export_dir: str) -> Dict[str, Any]:
    with open(os.path.join(export_dir, _MANIFEST)) as f:
        return json.load(f)
