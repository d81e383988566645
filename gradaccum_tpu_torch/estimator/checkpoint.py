"""Checkpoint save/restore of the scan-mode train state.

The port of ``gradaccum_tpu/estimator/checkpoint.py``: one file per step,
``<dir>/ckpt-<step>.pt``, holding ``{params, m, v, step}`` (the optimizer
moments checkpoint with the weights, so a resume continues the same
trajectory bit for bit). Each file is written to ``.tmp``, flushed to disk
and renamed into place, so a crash never leaves a torn checkpoint under the
final name; only the newest ``keep`` files are kept.

Not ported yet (ROADMAP.md): the sha256 manifest, quarantine of corrupt
files, IO retries and the asynchronous writer.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import torch

from gradaccum_tpu_torch.ops.accumulation import ScanState

_CKPT_RE = re.compile(r"ckpt-(\d+)\.pt$")


def _cpu(named):
    return {name: t.detach().to("cpu", copy=True) for name, t in named.items()}


def save(directory: str, state: ScanState, step: int, keep: int = 5) -> str:
    """Atomically write ``state`` as ``ckpt-<step>.pt``; prune to ``keep``."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt-{step}.pt")
    tmp = path + ".tmp"
    payload = {"params": _cpu(state.params), "m": _cpu(state.opt_state.m),
               "v": _cpu(state.opt_state.v), "step": int(state.step)}
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


def restore(directory_or_path: str, template: ScanState) -> ScanState:
    """Load the newest checkpoint of a directory (or an explicit file) INTO
    the template's tensors, in place, so a model holding those parameters
    sees the restored values. Raises FileNotFoundError when there is none
    and ValueError when its names or shapes differ from the template's."""
    path = directory_or_path
    if not os.path.isfile(path):
        latest = latest_checkpoint(directory_or_path)
        if latest is None:
            raise FileNotFoundError(f"no checkpoints under {directory_or_path}")
        path = latest[1]
    payload = torch.load(path, map_location="cpu", weights_only=True)
    targets = {"params": template.params, "m": template.opt_state.m,
               "v": template.opt_state.v}
    for key, named in targets.items():
        saved = payload[key]
        if saved.keys() != named.keys():
            raise ValueError(f"{path}: {key} names differ from the template's")
        for name, t in named.items():
            if saved[name].shape != t.shape or saved[name].dtype != t.dtype:
                raise ValueError(f"{path}: {key}/{name} is {saved[name].dtype} "
                                 f"{tuple(saved[name].shape)}, template {t.dtype} "
                                 f"{tuple(t.shape)}")
            with torch.no_grad():
                t.copy_(saved[name])
    return template._replace(step=int(payload["step"]))
