"""TensorBoard event files for model_dir — the reference's implicit summaries.

The port of ``gradaccum_tpu/estimator/events.py``: train-loss scalars land
in ``model_dir`` and eval metrics in ``model_dir/<eval_name>``, so
``tensorboard --logdir model_dir`` shows the train/eval split the
reference's users expect.

The writer backend is ``torch.utils.tensorboard`` when it imports (it needs
the ``tensorboard`` package, which a machine may lack) and a silent no-op
otherwise — event files are observability, never a hard dependency of
training. ``GRADACCUM_EVENTS=0`` skips the import.
"""

from __future__ import annotations

import os
from typing import Dict, Optional


def _writer_cls():
    if os.environ.get("GRADACCUM_EVENTS", "1") == "0":
        return None  # opt-out: skips the tensorboard import entirely
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter
    except Exception:
        return None


class EventWriter:
    """Scalar event writer rooted at ``model_dir``; no-op without a backend.

    One lazily-created sub-writer per tag directory ("" for train scalars,
    the eval name for each evaluate() stream).
    """

    def __init__(self, model_dir: Optional[str]):
        self._root = model_dir
        self._writers: Dict[str, object] = {}
        self._cls = _writer_cls() if model_dir else None

    @property
    def active(self) -> bool:
        return self._cls is not None

    def _writer(self, subdir: str):
        if self._cls is None:
            return None
        if subdir not in self._writers:
            path = os.path.join(self._root, subdir) if subdir else self._root
            self._writers[subdir] = self._cls(log_dir=path)
        return self._writers[subdir]

    def scalar(self, tag: str, value: float, step: int, subdir: str = ""):
        w = self._writer(subdir)
        if w is not None:
            w.add_scalar(tag, value, global_step=step)

    def scalars(self, values: Dict[str, float], step: int, subdir: str = ""):
        for tag, value in values.items():
            self.scalar(tag, float(value), step, subdir)

    def flush(self):
        for w in self._writers.values():
            w.flush()

    def close(self):
        for w in self._writers.values():
            w.close()
        self._writers.clear()
