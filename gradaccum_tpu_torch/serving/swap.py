"""Host-memory block store for preempted requests (swap-out and swap-in).

The port of ``gradaccum_tpu/serving/swap.py``. On the paged pool the swap
unit is a block: a victim's live private blocks are gathered off the card
(``models/gpt_decode.py :: gather_blocks``), freed back to the pool, and at
re-admission either scattered back into fresh blocks (``scatter_blocks``) or
dropped in favour of re-prefilling prompt + generated-so-far:
``Engine(swap="host"|"recompute")``.

Every record carries a sha256 over its arrays and metadata, checked at
swap-in: a bit that rots in host memory, or a ``MID_SWAP_IO`` fault
(``resilience/faults.py``), surfaces as :class:`SwapError` or ``OSError``
and the engine re-prefills instead of decoding against bad K/V. Records hold
host numpy only.

**bfloat16 pools.** numpy has no bfloat16 without ``ml_dtypes``, which the
card's machine lacks, so :func:`to_host` keeps such a tensor's raw bits as
``int16`` and names its dtype in the record's ``dtypes``; the digest covers
those bytes and those names, and :func:`to_device` reinterprets the bits.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gradaccum_tpu_torch.resilience import faults

# torch dtypes numpy cannot hold, kept as raw bits of the same width
_RAW_BITS = {torch.bfloat16: torch.int16}
_BY_NAME = {str(dtype).replace("torch.", ""): dtype for dtype in _RAW_BITS}


def to_host(t: torch.Tensor) -> Tuple[np.ndarray, Optional[str]]:
    """Copy ``t`` off the card into host numpy: ``(array, dtype name)``, the
    name set only where the array holds raw bits. The copy is synchronous:
    the blocks it reads may be handed to the next request as soon as it
    returns."""
    bits = _RAW_BITS.get(t.dtype)
    if bits is None:
        return t.detach().cpu().numpy(), None
    return t.detach().view(bits).cpu().numpy(), str(t.dtype).replace("torch.", "")


def to_device(a: np.ndarray, dtype_name: Optional[str], device) -> torch.Tensor:
    """Invert :func:`to_host` onto ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype_name is not None:
        t = t.view(_BY_NAME[dtype_name])
    return t.to(device)


class SwapError(RuntimeError):
    """A swap record failed its sha256 check: the host copy is not the bytes
    that left the card, so it must not re-enter the pool (the engine
    re-prefills)."""


class SwapCapacityError(OSError):
    """One record is larger than the store's ``max_bytes``. An OSError on
    purpose: the engine's put-side fallback (drop the swap, resume by
    re-prefill) already catches OSError."""


@dataclasses.dataclass
class SwapRecord:
    """One preempted request's host K/V. ``arrays`` maps names ("k"/"v",
    "k_q"/"k_scale"/"v_q"/"v_scale" for an int8 pool, plus
    "draft_k"/"draft_v" for a speculative engine) to host numpy;
    ``page_start`` counts the leading shared pages left alive in the pool
    for their other users; ``dtypes`` names the dtype of each array held as
    raw bits (:func:`to_host`)."""

    arrays: Dict[str, np.ndarray]
    page_start: int
    length: int
    digest: str
    nbytes: int
    dtypes: Dict[str, str] = dataclasses.field(default_factory=dict)

    def compute_digest(self) -> str:
        h = hashlib.sha256()
        h.update(np.int64([self.page_start, self.length]).tobytes())
        for name in sorted(self.arrays):
            h.update(name.encode())
            h.update(np.ascontiguousarray(self.arrays[name]).tobytes())
        for name in sorted(self.dtypes):
            h.update(f"{name}:{self.dtypes[name]}".encode())
        return h.hexdigest()


class HostSwapStore:
    """Request-id-keyed host block store with sha-checked round trips.

    ``put`` and ``get`` fire the ``MID_SWAP_IO`` fault point (index = the
    request id); both directions raise ``OSError`` to the engine, whose
    fallback is re-prefill. ``max_bytes`` bounds the store: a ``put`` past
    the cap evicts the OLDEST records first (FIFO; an evicted request
    re-prefills through the engine's KeyError path), and a single record
    larger than the cap raises :class:`SwapCapacityError`."""

    def __init__(self, max_bytes: Optional[int] = None):
        if max_bytes is not None and int(max_bytes) < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self.max_bytes = None if max_bytes is None else int(max_bytes)
        self._recs: Dict[int, SwapRecord] = {}  # insertion order = eviction order
        self.bytes_out = 0  # cumulative card -> host
        self.bytes_in = 0   # cumulative host -> card (successful gets)
        self.evictions = 0  # records dropped to honour max_bytes
        self._held = 0

    def __len__(self) -> int:
        return len(self._recs)

    def __contains__(self, rid: int) -> bool:
        return int(rid) in self._recs

    @property
    def held_bytes(self) -> int:
        return self._held

    def put(self, rid: int, arrays: Dict[str, np.ndarray], page_start: int, length: int,
            dtypes: Optional[Dict[str, str]] = None) -> SwapRecord:
        faults.fire(faults.MID_SWAP_IO, int(rid))
        # the store owns its bytes: a record outlives the buffer it came from
        arrays = {k: np.array(v, copy=True) for k, v in arrays.items()}
        rec = SwapRecord(arrays=arrays, page_start=int(page_start), length=int(length),
                         digest="", nbytes=sum(a.nbytes for a in arrays.values()),
                         dtypes=dict(dtypes or {}))
        if self.max_bytes is not None:
            if rec.nbytes > self.max_bytes:
                raise SwapCapacityError(
                    f"swap record for request {rid} is {rec.nbytes} bytes but the store "
                    f"holds {self._held} of {self.max_bytes} allowed — resuming by "
                    "re-prefill instead")
            self.discard(rid)  # a replaced record's bytes do not count twice
            while self._recs and self._held + rec.nbytes > self.max_bytes:
                self.discard(next(iter(self._recs)))
                self.evictions += 1
        rec.digest = rec.compute_digest()
        self._recs[int(rid)] = rec
        self._held += rec.nbytes
        self.bytes_out += rec.nbytes
        return rec

    def get(self, rid: int) -> SwapRecord:
        """Verified fetch (the record stays until :meth:`discard`): KeyError
        for an unknown id, OSError under an injected fault, SwapError on a
        digest mismatch."""
        rec = self._recs[int(rid)]
        faults.fire(faults.MID_SWAP_IO, int(rid))
        if rec.compute_digest() != rec.digest:
            raise SwapError(f"swap record for request {rid} failed its sha256 check")
        self.bytes_in += rec.nbytes
        return rec

    def peek(self, rid: int) -> SwapRecord:
        """Unverified fetch for moves between the rungs of ``memory/tiers.py``:
        no fault point, no digest check, no ``bytes_in``."""
        return self._recs[int(rid)]

    def discard(self, rid: int) -> bool:
        rec = self._recs.pop(int(rid), None)
        if rec is not None:
            self._held -= rec.nbytes
        return rec is not None

    def clear(self) -> None:
        self._recs.clear()
        self._held = 0
