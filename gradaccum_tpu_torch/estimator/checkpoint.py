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
written to ``.tmp``, flushed to disk and renamed into place, so a crash
never leaves a torn checkpoint under the final name; only the newest
``keep`` files are kept.

Integrity, as in JAX: every landed file gets a sha256 entry in
``ckpt-manifest.json`` (``resilience/manifest.py``, JAX's schema); writes
retry transient OSErrors with backoff and sweep stale ``.tmp`` files a
crashed writer left behind; ``restore`` walks newest to oldest,
QUARANTINES a file whose checksum fails or that cannot be read back
(renamed to ``*.corrupt``, its manifest entry dropped) and falls back to
the next-oldest, so a torn write costs one checkpoint interval, never the
run. A file that verifies but does not fit the template is a schema
mismatch, not corruption: it is left alone and ``CheckpointCorruptError``
says so. The seeded fault harness (``resilience/faults.py``) can kill or
fail the write between its two halves (``MID_CKPT_WRITE``).

:class:`AsyncCheckpointer` overlaps serialization and the disk write with
training. The optimizer updates its tensors in place, so ``save`` copies
the whole state into pinned host buffers before it returns: the copies are
queued on the card's current stream behind the step that produced the
state (so the next step, queued after them, cannot overwrite a tensor
before it is copied), an event is recorded after them, and the writer
thread waits on that event before it serializes. The training thread
never waits for the card here.
"""

from __future__ import annotations

import io
import os
import re
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from gradaccum_tpu_torch.memory.quant import QuantTensor
from gradaccum_tpu_torch.resilience import faults, manifest
from gradaccum_tpu_torch.resilience.retry import retry_io

_CKPT_RE = re.compile(r"ckpt-(\d+)\.pt$")
_TMP_RE = re.compile(r"ckpt-\d+\.pt\.tmp$")


class CheckpointCorruptError(RuntimeError):
    """Every checkpoint in the directory failed checksum or decode."""


class CheckpointSchemaError(CheckpointCorruptError, ValueError):
    """A checkpoint that verifies against the manifest does not fit the
    template: a schema mismatch, not corruption (also a ValueError, as a
    template mismatch of an unverified file is)."""


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


def sweep_stale_tmps(directory: str) -> List[str]:
    """Remove ``ckpt-*.pt.tmp`` left by a crashed writer. Safe because
    writes are single-threaded per directory (AsyncCheckpointer keeps one
    in flight): any tmp present when a new write starts is dead."""
    removed = []
    try:
        names = os.listdir(directory)
    except OSError:
        return removed
    for name in names:
        if _TMP_RE.match(name):
            path = os.path.join(directory, name)
            try:
                os.remove(path)
                removed.append(path)
            except OSError:
                pass  # best-effort: a vanished tmp is the goal anyway
    return removed


def _quarantine(directory: str, path: str, reason: str) -> None:
    """Move a bad checkpoint aside (``*.corrupt``) so the newest-first scan
    never trips on it again, and drop its manifest entry."""
    target = path + ".corrupt"
    try:
        os.replace(path, target)
    except OSError:
        try:
            os.remove(path)
        except OSError:
            return  # cannot touch it; restore will keep skipping it by name
    manifest.forget(directory, os.path.basename(path))
    print(f"[ckpt] quarantined {os.path.basename(path)}: {reason}")


def _host_payload(state, buffers: Optional[Dict[str, torch.Tensor]] = None):
    """``flatten(state)`` with every tensor copied to the host. With
    ``buffers`` (a dict reused across calls) the copies go into pinned
    buffers without waiting for the card; the caller records an event."""
    payload = {}
    for key, leaf in flatten(state).items():
        if not isinstance(leaf, torch.Tensor):
            payload[key] = leaf
        elif buffers is None or leaf.device.type != "cuda":
            payload[key] = leaf.detach().to("cpu", copy=True)
        else:
            buf = buffers.get(key)
            if buf is None or buf.shape != leaf.shape or buf.dtype != leaf.dtype:
                buf = buffers[key] = torch.empty(leaf.shape, dtype=leaf.dtype,
                                                 pin_memory=True)
            payload[key] = buf.copy_(leaf.detach(), non_blocking=True)
    return payload


def _encode_and_write(directory: str, payload: Dict[str, Any], step: int,
                      keep: int, ready=None) -> str:
    path = os.path.join(directory, f"ckpt-{step}.pt")
    tmp = path + ".tmp"
    sweep_stale_tmps(directory)
    if ready is not None:
        ready.synchronize()  # the host copies have landed
    buf = io.BytesIO()
    torch.save(payload, buf)
    data = buf.getvalue()

    def write():
        with open(tmp, "wb") as f:
            mid = len(data) // 2
            f.write(data[:mid])
            # a "crash" here leaves a truncated tmp (the sweep's job); an
            # "io_error" exercises the retry loop around this closure
            faults.fire(faults.MID_CKPT_WRITE, step)
            f.write(data[mid:])
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    retry_io(write)
    pruned = []
    if keep:
        for _, old in all_checkpoints(directory)[:-keep]:
            try:
                os.remove(old)
            except OSError:
                continue  # still on disk: keep its checksum entry too
            pruned.append(os.path.basename(old))
    # one manifest load+rewrite per save: record the new file and forget
    # every pruned one together
    manifest.apply(directory, record_entry=(os.path.basename(path), data),
                   forget_names=pruned)
    return path


def save(directory: str, state, step: int, keep: int = 5) -> str:
    """Atomically write ``state`` as ``ckpt-<step>.pt``; prune to ``keep``."""
    os.makedirs(directory, exist_ok=True)
    return _encode_and_write(directory, _host_payload(state), step, keep)


class AsyncCheckpointer:
    """Overlap serialization and the disk write with training.

    ``save`` copies the state into pinned host buffers (queued on the
    card's stream, see the module docstring) and hands serialization and
    IO to a single worker thread. At most one save is in flight — a new
    save waits for the previous one first, preserving the checkpoint order,
    the atomic tmp+rename per file, and the reuse of the pinned buffers.
    Call ``wait()`` before relying on the newest file (restore, exit).
    """

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-writer")
        self._pending: Optional[Future] = None
        self._lock = threading.Lock()
        self._buffers: Dict[str, torch.Tensor] = {}

    def save(self, directory: str, state, step: int, keep: int = 5) -> None:
        os.makedirs(directory, exist_ok=True)
        with self._lock:
            if self._pending is not None:
                try:
                    # surface errors; keep one in flight. The failed future
                    # must clear even when this raises, or one bad write
                    # would re-raise the same stale error on every save
                    self._pending.result()
                finally:
                    self._pending = None
            payload = _host_payload(state, self._buffers)
            cards = {leaf.device for leaf in flatten(state).values()
                     if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"}
            ready = None
            if cards:  # after the copies, on the stream they were queued on
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(next(iter(cards))))
            self._pending = self._pool.submit(_encode_and_write, directory, payload,
                                              step, keep, ready)

    def wait(self) -> None:
        """Block until the in-flight write (if any) has landed on disk."""
        with self._lock:
            if self._pending is not None:
                try:
                    self._pending.result()
                finally:
                    self._pending = None  # a failed write is done failing

    def close(self) -> None:
        try:
            self.wait()  # surfaces a failed in-flight write exactly once
        finally:
            self._pool.shutdown(wait=True)


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


def _check_template(template, payload: Dict[str, Any], where: str) -> None:
    """Raise ValueError unless ``payload`` holds every leaf of ``template``
    with its shape and dtype (checked whole, before anything is copied)."""
    want = flatten(template)
    if payload.keys() != want.keys():
        missing = sorted(want.keys() - payload.keys())[:3]
        extra = sorted(payload.keys() - want.keys())[:3]
        raise ValueError(f"{where}: leaves differ from the template's "
                         f"(missing {missing}, unexpected {extra})")
    for key, leaf in want.items():
        got = payload[key]
        if isinstance(leaf, torch.Tensor):
            if not isinstance(got, torch.Tensor) or got.shape != leaf.shape \
                    or got.dtype != leaf.dtype:
                desc = (f"{got.dtype} {tuple(got.shape)}" if isinstance(got, torch.Tensor)
                        else type(got).__name__)
                raise ValueError(f"{where}: {key} is {desc}, template {leaf.dtype} "
                                 f"{tuple(leaf.shape)}")
        elif isinstance(leaf, tuple) and tuple(got) != leaf:  # a QuantTensor's shape
            raise ValueError(f"{where}: {key.rsplit('/', 1)[0]} is a QuantTensor of shape "
                             f"{tuple(got)}, template {leaf}")


def _decode(data: bytes) -> Dict[str, Any]:
    return torch.load(io.BytesIO(data), map_location="cpu", weights_only=True)


def _try_load(directory: str, path: str, check: Callable[[Dict[str, Any], str], None]):
    """Read, verify and decode one candidate; the payload, or None to fall
    back to an older one.

    Quarantine (a destructive rename) is reserved for PROVEN corruption — a
    checksum mismatch against the manifest. A file whose checksum verifies
    but that still fails to decode or to fit the template is intact on
    disk: that is a schema mismatch, and renaming healthy checkpoints over
    a software bug would destroy optimizer state, so it raises instead. A
    file with no manifest entry that fails is skipped WITHOUT renaming:
    corruption cannot be proven, so nothing is destroyed."""
    def read():
        with open(path, "rb") as f:
            return f.read()

    try:
        # a vanished file (pruned or quarantined meanwhile) is permanent:
        # no backoff sleeps on it
        data = retry_io(read, give_up_on=(FileNotFoundError,))
    except OSError as e:
        # an unreadable file is not PROVEN corrupt: skip, destroy nothing
        print(f"[ckpt] skipping {os.path.basename(path)} (unreadable after retries: {e})")
        return None
    verdict = manifest.verify_bytes(directory, os.path.basename(path), data)
    if verdict is False:
        _quarantine(directory, path, "checksum mismatch")
        return None
    try:
        payload = _decode(data)
        check(payload, path)
        return payload
    except Exception as e:  # truncated or garbled file, another schema
        if verdict is True:
            raise CheckpointSchemaError(
                f"{path} verifies against the manifest but does not fit the "
                f"given template — a state-schema mismatch, not disk corruption "
                f"(file left untouched): {e}") from e
        print(f"[ckpt] skipping {os.path.basename(path)} "
              f"(no checksum on record, unreadable into the template: {e})")
        return None


def _load(directory_or_path: str, check: Callable[[Dict[str, Any], str], None]):
    """``(path, payload)`` of an explicit file (never a fallback: the caller
    named it) or of the newest healthy checkpoint of a directory."""
    if os.path.isfile(directory_or_path):
        path = directory_or_path
        with open(path, "rb") as f:
            data = f.read()
        if manifest.verify_bytes(os.path.dirname(path) or ".", os.path.basename(path),
                                 data) is False:
            raise CheckpointCorruptError(f"checksum mismatch for {path}")
        payload = _decode(data)
        check(payload, path)
        return path, payload
    candidates = all_checkpoints(directory_or_path)
    if not candidates:
        raise FileNotFoundError(f"no checkpoints under {directory_or_path}")
    for _, path in reversed(candidates):
        payload = _try_load(directory_or_path, path, check)
        if payload is not None:
            return path, payload
    raise CheckpointCorruptError(
        f"all {len(candidates)} checkpoints under {directory_or_path} failed to "
        f"restore (corrupt files quarantined as *.corrupt; unproven ones left in place)")


def restore(directory_or_path: str, template):
    """Load the newest healthy checkpoint of a directory (or an explicit
    file) INTO the template state: tensors are copied in place, the rest
    rebuilt. Raises FileNotFoundError when there is none, ValueError when
    an explicit file's leaves differ from the template's in name, shape or
    dtype, and CheckpointCorruptError when no candidate restores."""
    def check(payload, path):
        _check_template(template, payload, path)

    path, payload = _load(directory_or_path, check)
    return _rebuild(template, payload, "", path)


def restore_params(directory_or_path: str, params: Dict[str, torch.Tensor]) -> int:
    """Copy only the checkpoint's parameters into ``params`` (in place), for
    inference; returns the checkpoint's step."""
    def saved_params(payload):
        return {key[len("params/"):]: leaf for key, leaf in payload.items()
                if key.startswith("params/")}

    def check(payload, path):
        _check_template(params, saved_params(payload), path)

    path, payload = _load(directory_or_path, check)
    _rebuild(params, saved_params(payload), "", path)
    return int(payload["step"])
