"""Per-file checksum manifest for checkpoint directories (the port of
``gradaccum_tpu/resilience/manifest.py``, same file and schema).

``ckpt-manifest.json`` sits next to the checkpoints and maps each file name
to ``{"sha256": ..., "size": ...}``. The writer records an entry right
after the atomic rename lands; restore verifies before deserializing, so a
bit-flipped or truncated checkpoint is detected and quarantined instead of
crashing or resuming from garbage.

Files without an entry (pre-manifest checkpoints, foreign files) verify as
``None`` = unknown: restore still attempts them, relying on deserialization
errors alone, so old checkpoint directories keep working.

The manifest itself is written atomically (tmp + rename, with IO retry) and
read defensively — a corrupt manifest degrades to "no entries", never to a
failed restore.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional

from gradaccum_tpu_torch.resilience.retry import retry_io

MANIFEST_NAME = "ckpt-manifest.json"


def manifest_path(directory: str) -> str:
    return os.path.join(directory, MANIFEST_NAME)


def load(directory: str) -> Dict[str, dict]:
    """All entries, or {} when the manifest is missing or unreadable."""
    try:
        with open(manifest_path(directory)) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else {}
    except (OSError, ValueError):
        return {}


def _write(directory: str, entries: Dict[str, dict]) -> None:
    path = manifest_path(directory)
    tmp = path + ".tmp"

    def write():
        with open(tmp, "w") as f:
            json.dump(entries, f, indent=0, sort_keys=True)
        os.replace(tmp, path)

    retry_io(write)


def sha256_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def apply(directory: str, record_entry=None, forget_names=()) -> None:
    """One load + one atomic rewrite for a batch of changes —
    ``record_entry=(filename, data)`` adds/overwrites a checksum entry,
    ``forget_names`` drops entries (pruned/quarantined files). The
    checkpoint writer records the new file and forgets every pruned one in
    a single call instead of O(keep) manifest round-trips per save."""
    entries = load(directory)
    changed = False
    if record_entry is not None:
        filename, data = record_entry
        entries[filename] = {"sha256": sha256_bytes(data), "size": len(data)}
        changed = True
    for name in forget_names:
        if name in entries:
            del entries[name]
            changed = True
    if changed:
        _write(directory, entries)


def record(directory: str, filename: str, data: bytes) -> None:
    """Add/overwrite ``filename``'s entry (checksum of ``data`` as written)."""
    apply(directory, record_entry=(filename, data))


def forget(directory: str, filename: str) -> None:
    apply(directory, forget_names=(filename,))


def verify_bytes(directory: str, filename: str, data: bytes) -> Optional[bool]:
    """Checksum already-read file contents against the manifest entry:
    True = match, False = corrupt, None = no entry (unknown). The bytes
    variant lets restore read each candidate exactly once."""
    entry = load(directory).get(filename)
    if not isinstance(entry, dict) or "sha256" not in entry:
        return None
    if "size" in entry and entry["size"] != len(data):
        return False
    return sha256_bytes(data) == entry["sha256"]


def verify(directory: str, path: str) -> Optional[bool]:
    """True = checksum matches, False = corrupt, None = no entry (unknown)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return False
    return verify_bytes(directory, os.path.basename(path), data)
