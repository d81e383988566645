"""KV-cache pools: the engine's device memory, fixed-slot or paged.

The port of ``gradaccum_tpu/serving/cache_pool.py`` without its
``PrefixCache`` (prefix sharing, ROADMAP.md item 5b).

A ``CachePool`` owns one ``[num_layers, num_slots, heads, max_len,
head_dim]`` K/V pair (``models/gpt_decode.py``'s fixed layout, the batch
axis read as SLOTS) and a ``[num_slots]`` length vector, allocated once:
requests come and go by claiming and releasing slot indices on the host,
and every device tensor keeps its shape. A released slot needs no device
work: its stale tail is masked by the slot's length, and the next
admission's prefill overwrites ``[0, max_len)``.

A ``PagedCachePool`` pages the length axis: K/V live in a block pool
``[num_layers, num_blocks + 1, heads, page_size, head_dim]`` (the last
block is the trash block that page-table sentinels address, see
``gpt_decode.py``) and each slot owns a page-table row of block ids, so the
pool is charged per token in flight, rounded up to a page. Two levels of
accounting:

- **reservations** gate admission: an admitted request reserves its worst
  case ``ceil((prompt + max_new_tokens) / page_size)`` blocks, so
  allocation never fails mid-stream, and the engine's write ``limit`` keeps
  a slot inside its reservation;
- **allocations** happen on demand as a slot's length crosses page
  boundaries, and are what ``kv_bytes_in_use`` reports.

Blocks are refcounted (``adopt_shared`` maps a slot's leading pages onto
live blocks): a block is freed when its last user releases, and a live
shared block whose allocating slot released is an ORPHAN, counted so that
``unreserved_blocks`` never promises memory a survivor still holds.
Every size reported to users is JAX's: ``num_blocks`` blocks, the trash
block apart.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from gradaccum_tpu_torch.models.gpt import GPTConfig
from gradaccum_tpu_torch.models.gpt_decode import (
    PREFIX_ITEM,
    DecodeCache,
    init_cache,
    init_paged_pool,
)


class PoolPressure(RuntimeError):
    """Structured mid-stream allocation failure: a slot needed blocks the
    free list could not supply. Impossible under the worst-case reservation
    gate; an overcommitting admission policy (ROADMAP.md item 5d) raises it
    to preempt a victim."""

    def __init__(self, slot: int, need_blocks: int, free_blocks: int,
                 reserved_blocks: int):
        super().__init__(
            f"slot {slot} needs {need_blocks} more block(s) but the pool has "
            f"{free_blocks} free ({reserved_blocks} reserved to the slot) — preempt a "
            "victim or shrink admission optimism")
        self.slot = int(slot)
        self.need_blocks = int(need_blocks)
        self.free_blocks = int(free_blocks)
        self.reserved_blocks = int(reserved_blocks)


class BlockTableCorruption(RuntimeError):
    """A page-table row holds an id outside ``[0, num_blocks]``: raised at
    upload, so a bad table never reaches a device gather."""


class _SlotLedger:
    """Slot claim/release bookkeeping shared by both pools: lowest slot
    first, and claim/release validation. The device programs write the pool
    tensors in place, so JAX's ``set_arrays`` has nothing to store."""

    def _init_slots(self, num_slots: int) -> None:
        if num_slots < 1:
            raise ValueError(f"need at least one slot, got {num_slots}")
        self.num_slots = num_slots
        self._free: List[int] = list(range(num_slots - 1, -1, -1))
        self._claimed = [False] * num_slots

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def active_count(self) -> int:
        return self.num_slots - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.active_count / self.num_slots

    def claim(self) -> Optional[int]:
        """Lowest free slot index, or None when the pool is full."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._claimed[slot] = True
        return slot

    def claim_many(self, n: int) -> List[int]:
        slots = []
        for _ in range(n):
            slot = self.claim()
            if slot is None:
                break
            slots.append(slot)
        return slots

    def _release_slot(self, slot: int) -> None:
        if not self._claimed[slot]:
            raise ValueError(f"slot {slot} is not claimed")
        self._claimed[slot] = False
        self._free.append(slot)
        self._free.sort(reverse=True)  # deterministic: lowest slot next


class CachePool(_SlotLedger):
    """Slot bookkeeping (host) and the pooled cache tensors (device).
    ``cache_dtype`` narrows K/V storage; compute stays at ``cfg.dtype``."""

    def __init__(self, cfg: GPTConfig, num_slots: int, max_len: int, cache_dtype=None,
                 device=None):
        self._init_slots(num_slots)
        cache = init_cache(cfg, num_slots, max_len, cache_dtype=cache_dtype, device=device)
        self.k = cache.k
        self.v = cache.v
        self.cache_dtype = cache_dtype
        self.lengths = torch.zeros(num_slots, dtype=torch.int64, device=device)
        self.max_len = max_len

    def release(self, slot: int) -> None:
        self._release_slot(slot)

    def as_cache(self) -> DecodeCache:
        """The pool as a DecodeCache (per-slot lengths) for the tick."""
        return DecodeCache(k=self.k, v=self.v, length=self.lengths)


class PagedCachePool(_SlotLedger):
    """Slot and block bookkeeping (host) and the paged pool (device).

    ``num_blocks`` sets the token capacity (``num_blocks * page_size``
    positions shared by all slots); ``max_len`` bounds one request
    (``max_pages = max_len / page_size`` page-table columns). Unassigned
    page-table entries hold the sentinel ``num_blocks``."""

    def __init__(self, cfg: GPTConfig, num_slots: int, max_len: int, page_size: int,
                 num_blocks: int, prefix_cache=None, cache_dtype=None, device=None):
        self._init_slots(num_slots)
        if prefix_cache is not None:
            raise NotImplementedError(f"a prefix cache waits for {PREFIX_ITEM}")
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} must be a multiple of page_size {page_size}")
        if max_len > cfg.max_position_embeddings:
            raise ValueError(f"max_len {max_len} exceeds max_position_embeddings "
                             f"{cfg.max_position_embeddings}")
        self.k, self.v = init_paged_pool(cfg, num_blocks, page_size, cache_dtype=cache_dtype,
                                         device=device)
        self._cfg = cfg
        self.cache_dtype = cache_dtype
        self.device = self.k.device
        self.segments: List[int] = [int(num_blocks)]  # grow order, as JAX's
        self.lengths = torch.zeros(num_slots, dtype=torch.int64, device=device)
        self.max_len = max_len
        self.page_size = page_size
        self.num_blocks = num_blocks
        self.max_pages = max_len // page_size
        self.page_table = np.full((num_slots, self.max_pages), num_blocks, np.int32)
        self._table_device: Optional[torch.Tensor] = None
        self._free_blocks: List[int] = list(range(num_blocks - 1, -1, -1))
        self._slot_blocks: List[List[int]] = [[] for _ in range(num_slots)]
        self._slot_reserved = [0] * num_slots
        self._slot_shared = [0] * num_slots
        self._reserved_total = 0
        self._block_refs = [0] * num_blocks
        self._shared_count = 0  # blocks at refcount > 1
        self._block_owner: List[Optional[int]] = [None] * num_blocks
        self._orphans = 0  # live blocks covered by no reservation

    def _decref(self, block: int, slot: int) -> bool:
        """Drop one reference ``slot`` holds on ``block``; True when the
        block hit zero and must be freed."""
        if self._block_refs[block] == 2:
            self._shared_count -= 1
        self._block_refs[block] -= 1
        if self._block_refs[block] == 0:
            if self._block_owner[block] is None:
                self._orphans -= 1
            self._block_owner[block] = None
            return True
        if self._block_owner[block] == slot:
            # sharers outlive the allocator: no reservation covers it now
            self._block_owner[block] = None
            self._orphans += 1
        return False

    def _reclaim(self, blocks: List[int]) -> None:
        if blocks:
            self._free_blocks.extend(blocks)
            self._free_blocks.sort(reverse=True)  # deterministic: lowest block next

    def release(self, slot: int) -> None:
        """Free the slot, decref its blocks (freeing those that hit zero) and
        return its reservation."""
        self._release_slot(slot)
        self._reclaim([block for block in self._slot_blocks[slot]
                       if self._decref(block, slot)])
        self._slot_blocks[slot] = []
        self._slot_shared[slot] = 0
        self.page_table[slot, :] = self.num_blocks
        self._table_device = None
        self._reserved_total -= self._slot_reserved[slot]
        self._slot_reserved[slot] = 0

    # -- block accounting -------------------------------------------------

    @property
    def allocated_blocks(self) -> int:
        return self.num_blocks - len(self._free_blocks)

    @property
    def free_blocks(self) -> int:
        return len(self._free_blocks)

    @property
    def unreserved_blocks(self) -> int:
        """Blocks no reservation or live orphan holds: what admission may
        promise."""
        return self.num_blocks - self._reserved_total - self._orphans

    @property
    def shared_blocks(self) -> int:
        return self._shared_count

    @property
    def admittable_blocks(self) -> int:
        return min(self.unreserved_blocks, self.free_blocks)

    def blocks_of(self, slot: int) -> List[int]:
        return list(self._slot_blocks[slot])

    def refcount(self, block: int) -> int:
        return self._block_refs[int(block)]

    def owner_of(self, block: int) -> Optional[int]:
        return self._block_owner[int(block)]

    @property
    def token_capacity(self) -> int:
        return self.num_blocks * self.page_size

    def blocks_for(self, tokens: int) -> int:
        return -(-int(tokens) // self.page_size)

    def can_reserve(self, tokens: int, shared_blocks: int = 0) -> bool:
        """Would a request of ``tokens`` positions fit, ``shared_blocks`` of
        its leading pages already live? Checked against reservations."""
        total = self.blocks_for(tokens)
        need = total - int(shared_blocks)
        return need <= self.unreserved_blocks and total <= self.max_pages

    def reserve(self, slot: int, tokens: int, shared_blocks: int = 0) -> None:
        if not self._claimed[slot]:
            raise ValueError(f"slot {slot} is not claimed")
        if not self.can_reserve(tokens, shared_blocks):
            raise ValueError(
                f"cannot reserve {self.blocks_for(tokens) - shared_blocks} blocks "
                f"({self.unreserved_blocks} unreserved of {self.num_blocks})")
        self._slot_reserved[slot] = self.blocks_for(tokens) - int(shared_blocks)
        self._reserved_total += self._slot_reserved[slot]

    def adopt_shared(self, slot: int, blocks: List[int]) -> None:
        """Map the slot's leading page-table entries onto live blocks: incref
        each, no device work. Must precede any ``alloc_to`` for the slot."""
        if not self._claimed[slot]:
            raise ValueError(f"slot {slot} is not claimed")
        if self._slot_blocks[slot]:
            raise ValueError(f"slot {slot} already has pages; adopt_shared must precede "
                             "allocation")
        for page, block in enumerate(blocks):
            block = int(block)
            if not 0 <= block < self.num_blocks or self._block_refs[block] < 1:
                raise ValueError(f"cannot adopt dead block {block}")
            if self._block_refs[block] == 1:
                self._shared_count += 1
            self._block_refs[block] += 1
            self._slot_blocks[slot].append(block)
            self.page_table[slot, page] = block
        self._slot_shared[slot] = len(blocks)
        if blocks:
            self._table_device = None

    def alloc_to(self, slot: int, tokens: int) -> None:
        """Ensure the slot's pages cover ``tokens`` positions; fresh blocks
        start at refcount 1, owned by this slot."""
        need = min(self.blocks_for(tokens), self.max_pages)
        have = len(self._slot_blocks[slot])
        if need - self._slot_shared[slot] > self._slot_reserved[slot]:
            raise ValueError(
                f"slot {slot} needs {need - self._slot_shared[slot]} private blocks but "
                f"reserved only {self._slot_reserved[slot]} — the write limit should "
                "have made this unreachable")
        for page in range(have, need):
            if not self._free_blocks:
                raise PoolPressure(slot, need - page, 0, self._slot_reserved[slot])
            block = self._free_blocks.pop()
            self._block_refs[block] = 1
            self._block_owner[block] = slot
            self._slot_blocks[slot].append(block)
            self.page_table[slot, page] = block
        if need > have:
            self._table_device = None

    def fork_cow(self, slot: int, page: int) -> Optional[int]:
        raise NotImplementedError(f"copy-on-write forks wait for {PREFIX_ITEM}")

    def grow(self, extra_blocks: int) -> int:
        """Append ``extra_blocks`` blocks: ids ``num_blocks..num_blocks +
        extra - 1`` address them through the same page table, live slots keep
        their state, and the sentinel (and the trash block behind it) moves to
        the new total. Returns the new block count."""
        extra = int(extra_blocks)
        if extra < 1:
            raise ValueError(f"grow needs at least one block, got {extra}")
        old = self.num_blocks
        extra_k, extra_v = init_paged_pool(self._cfg, extra, self.page_size,
                                           cache_dtype=self.cache_dtype, device=self.device)
        # [real blocks, new blocks, trash]: the new trash is a fresh block
        self.k = torch.cat([self.k[:, :old], extra_k], dim=1)
        self.v = torch.cat([self.v[:, :old], extra_v], dim=1)
        total = old + extra
        self.page_table[self.page_table == old] = total
        self.num_blocks = total
        self.segments.append(extra)
        self._free_blocks.extend(range(total - 1, old - 1, -1))
        self._free_blocks.sort(reverse=True)
        self._block_refs.extend([0] * extra)
        self._block_owner.extend([None] * extra)
        self._table_device = None
        return total

    def page_table_device(self) -> torch.Tensor:
        """The page table on the device, re-uploaded only after a change
        (``alloc_to``, ``adopt_shared``, ``release``, ``grow``); an upload
        bounds-checks the host table first."""
        if self._table_device is None:
            bad_mask = (self.page_table < 0) | (self.page_table > self.num_blocks)
            if bad_mask.any():
                bad = np.argwhere(bad_mask)[0]
                raise BlockTableCorruption(
                    f"page table holds out-of-range block id "
                    f"{int(self.page_table[tuple(bad)])} at slot {int(bad[0])} page "
                    f"{int(bad[1])} (valid ids are 0..{self.num_blocks})")
            self._table_device = torch.as_tensor(self.page_table.astype(np.int64)).to(
                self.device)
        return self._table_device
