"""TieredStore: the host and disk rungs below the card's KV pool.

The port of ``gradaccum_tpu/memory/tiers.py``. The engine demotes preempted
requests into host memory (``serving/swap.py :: HostSwapStore``) and
re-prefills when a record is gone; this ladder adds the rung below it. When
the host rung is full, its least recently used records spill to disk (one
``.npz`` per record), and a ``get`` of a spilled record re-checks its sha
digest and promotes it back to host. Capacity is an error only when both
rungs are full, and only disk overflow drops a record, which the engine
survives (a missing record re-prefills).

The store has ``HostSwapStore``'s surface (``put``/``get``/``discard`` and
the byte counters), so ``Engine(swap="tiered")`` is the only switch. Every
move appends a :class:`TierEvent`. A bfloat16 pool's records hold raw
``int16`` bits with their dtype names beside them (``swap.py :: to_host``);
the ``.npz`` stores the same bits and the names, so the disk rung needs no
bfloat16 in numpy either.
"""

from __future__ import annotations

import json
import os
import tempfile
import zipfile
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from gradaccum_tpu_torch.serving.swap import (
    HostSwapStore,
    SwapCapacityError,
    SwapError,
    SwapRecord,
)

_META = ("__meta__", "__digest__", "__dtypes__")


class TierEvent(NamedTuple):
    """One move on the ladder, for tests and the obs export."""

    kind: str   # "demote" | "promote" | "evict" | "corrupt"
    rid: int
    tier: str   # where the record landed: "disk", "host" or "gone"
    nbytes: int


class TieredStore:
    """A host rung (LRU, its capacity managed here) over a disk rung.

    The inner :class:`HostSwapStore` is uncapped: its own FIFO eviction would
    drop records, where this ladder demotes them. ``held_bytes`` and
    ``max_bytes`` report the host rung, so the engine's swap gauges keep
    their meaning. ``disk_dir`` defaults to a fresh temporary directory."""

    def __init__(self, host_max_bytes: int = 64 * 1024 * 1024,
                 disk_max_bytes: int = 1024 * 1024 * 1024, disk_dir: Optional[str] = None):
        self.max_bytes = int(host_max_bytes)
        self.disk_max_bytes = int(disk_max_bytes)
        self._dir = disk_dir or tempfile.mkdtemp(prefix="gradaccum_tier_")
        os.makedirs(self._dir, exist_ok=True)
        self._host = HostSwapStore(max_bytes=None)
        self._lru: List[int] = []            # host rids, oldest first
        self._disk: Dict[int, int] = {}      # rid -> nbytes, insertion = LRU
        self._disk_held = 0
        self.events: List[TierEvent] = []
        self.demotions = 0
        self.promotions = 0
        self.evictions = 0    # records lost off the disk rung
        self.corruptions = 0  # disk records failing their sha re-check

    # -- HostSwapStore's surface ------------------------------------------

    @property
    def held_bytes(self) -> int:
        return self._host.held_bytes

    @property
    def bytes_out(self) -> int:
        return self._host.bytes_out

    @property
    def bytes_in(self) -> int:
        return self._host.bytes_in

    @property
    def disk_held_bytes(self) -> int:
        return self._disk_held

    def __len__(self) -> int:
        return len(self._host) + len(self._disk)

    def __contains__(self, rid: int) -> bool:
        return rid in self._host or rid in self._disk

    def put(self, rid: int, arrays: Dict[str, np.ndarray], page_start: int, length: int,
            dtypes: Optional[Dict[str, str]] = None) -> SwapRecord:
        """Host if it fits (demoting LRU records to make room), straight to
        disk if it is larger than the host rung, an error only if it exceeds
        both."""
        nbytes = sum(int(a.nbytes) for a in arrays.values())
        if nbytes > self.max_bytes and nbytes > self.disk_max_bytes:
            raise SwapCapacityError(
                f"swap record for request {rid} is {nbytes} bytes but the ladder holds "
                f"{self.held_bytes}/{self.max_bytes} host and {self._disk_held}/"
                f"{self.disk_max_bytes} disk bytes — resuming by re-prefill instead")
        self.discard(rid)
        rec = self._host.put(rid, arrays, page_start, length, dtypes)
        self._lru.append(rid)
        if nbytes > self.max_bytes:
            self._demote(rid)  # oversized for host: disk only
        else:
            self._fit_host()
        return rec

    def get(self, rid: int) -> SwapRecord:
        """Fetch a record, promoting it to host if it had spilled. KeyError if
        absent, SwapError if a disk record fails its sha re-check (the record
        is dropped)."""
        if rid in self._host:
            rec = self._host.get(rid)
            self._lru.remove(rid)
            self._lru.append(rid)
            return rec
        if rid not in self._disk:
            raise KeyError(f"no swap record for request {rid}")
        rec = self._load_disk(rid)
        nbytes = self._disk.pop(rid)
        self._disk_held -= nbytes
        self._unlink(rid)
        if rec.compute_digest() != rec.digest:
            self.corruptions += 1
            self.events.append(TierEvent("corrupt", rid, "gone", nbytes))
            raise SwapError(f"disk tier record for request {rid} failed digest "
                            "re-verification — dropping it")
        self.promotions += 1
        self.events.append(TierEvent("promote", rid, "host", nbytes))
        if nbytes <= self.max_bytes:
            self._host.put(rid, rec.arrays, rec.page_start, rec.length, rec.dtypes)
            self._lru.append(rid)
            self._fit_host()
        return rec

    def discard(self, rid: int) -> None:
        if rid in self._host:
            self._host.discard(rid)
            self._lru.remove(rid)
        if rid in self._disk:
            self._disk_held -= self._disk.pop(rid)
            self._unlink(rid)

    def clear(self) -> None:
        self._host.clear()
        self._lru.clear()
        for rid in list(self._disk):
            self._unlink(rid)
        self._disk.clear()
        self._disk_held = 0

    # -- the ladder -------------------------------------------------------

    def _fit_host(self) -> None:
        while self._host.held_bytes > self.max_bytes and len(self._lru) > 1:
            self._demote(self._lru[0])

    def _path(self, rid: int) -> str:
        return os.path.join(self._dir, f"swap_{rid}.npz")

    def _unlink(self, rid: int) -> None:
        try:
            os.unlink(self._path(rid))
        except OSError:
            pass

    def _demote(self, rid: int) -> None:
        """Move one host record to disk, evicting the oldest disk records if
        the rung overflows (a real loss, counted)."""
        rec = self._host.peek(rid)
        self._host.discard(rid)
        self._lru.remove(rid)
        payload = dict(rec.arrays)
        payload["__meta__"] = np.asarray([rec.page_start, rec.length], dtype=np.int64)
        payload["__digest__"] = np.frombuffer(rec.digest.encode("ascii"), dtype=np.uint8).copy()
        payload["__dtypes__"] = np.frombuffer(json.dumps(rec.dtypes).encode("ascii"),
                                              dtype=np.uint8).copy()
        np.savez(self._path(rid), **payload)
        self._disk[rid] = rec.nbytes
        self._disk_held += rec.nbytes
        self.demotions += 1
        self.events.append(TierEvent("demote", rid, "disk", rec.nbytes))
        while self._disk_held > self.disk_max_bytes and len(self._disk) > 1:
            old = next(iter(self._disk))
            self._disk_held -= self._disk.pop(old)
            self._unlink(old)
            self.evictions += 1
            self.events.append(TierEvent("evict", old, "gone", 0))

    def _load_disk(self, rid: int) -> SwapRecord:
        try:
            with np.load(self._path(rid)) as z:
                meta = z["__meta__"]
                digest = bytes(z["__digest__"]).decode("ascii")
                dtypes = json.loads(bytes(z["__dtypes__"]).decode("ascii"))
                arrays = {k: z[k] for k in z.files if k not in _META}
        except (OSError, KeyError, ValueError, zipfile.BadZipFile) as e:
            # BadZipFile is not an OSError: a truncated container lands here
            self.corruptions += 1
            self._disk_held -= self._disk.pop(rid)
            self._unlink(rid)
            self.events.append(TierEvent("corrupt", rid, "gone", 0))
            raise SwapError(f"disk tier record for request {rid} is unreadable: {e}")
        return SwapRecord(arrays=arrays, page_start=int(meta[0]), length=int(meta[1]),
                          digest=digest, nbytes=sum(int(a.nbytes) for a in arrays.values()),
                          dtypes=dtypes)

    def stats(self) -> Dict[str, int]:
        """Rung occupancy and ladder traffic (the obs export's block)."""
        return {
            "host_records": len(self._host),
            "host_bytes": self._host.held_bytes,
            "host_max_bytes": self.max_bytes,
            "disk_records": len(self._disk),
            "disk_bytes": self._disk_held,
            "disk_max_bytes": self.disk_max_bytes,
            "demotions": self.demotions,
            "promotions": self.promotions,
            "evictions": self.evictions,
            "corruptions": self.corruptions,
        }
