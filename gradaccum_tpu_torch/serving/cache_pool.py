"""KV-cache pools: the engine's device memory, fixed-slot or paged.

The port of ``gradaccum_tpu/serving/cache_pool.py``.

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

:class:`PrefixCache` is the host index that finds shareable blocks: full
prompt pages by a cumulative sha1 of their token bytes, and with ``cow``
the prompt's final partial page at every sub-page length (a radix tree,
``memory/radix.py``). A sharer adopts a partial tail block read-only up to
its matched length, and its first write into that page forks the block
(:meth:`PagedCachePool.fork_cow`: a fresh private block, a one-block device
copy by the engine, the page-table entry rewritten), or takes it over when
it is the last reference.

Under a serving mesh (``tp > 1``, one process per rank) each rank's pool
holds its own ``num_heads / tp`` heads of every slot or block; the page
tables, refcounts, reservations and the prefix index stay host
bookkeeping, the same on every rank.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gradaccum_tpu_torch.memory.quant import kv_map
from gradaccum_tpu_torch.memory.radix import RadixIndex
from gradaccum_tpu_torch.models.gpt import GPTConfig
from gradaccum_tpu_torch.models.gpt_decode import (
    DecodeCache,
    init_cache,
    init_paged_pool,
)
from gradaccum_tpu_torch.utils.platform import upload


class PoolPressure(RuntimeError):
    """Structured mid-stream allocation failure: a slot needed blocks the
    free list could not supply. Impossible under the worst-case reservation
    gate; under an overcommitting admission policy (``allow_overcommit``) it
    is the engine's signal to preempt a victim and retry."""

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
    ``cache_dtype`` narrows K/V storage; compute stays at ``cfg.dtype``.
    ``tp``: this rank's heads of a model axis that wide."""

    def __init__(self, cfg: GPTConfig, num_slots: int, max_len: int, cache_dtype=None,
                 device=None, tp: int = 1):
        self._init_slots(num_slots)
        cache = init_cache(cfg, num_slots, max_len, cache_dtype=cache_dtype, device=device,
                           tp=tp)
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


def _tokens(prompt) -> np.ndarray:
    """A prompt as flat contiguous ``np.int32``, whatever it came as (a
    list, a numpy array of any integer width, a torch tensor on any
    device): the keys hash these bytes, so one prompt keys the same from
    every caller, and as JAX keys it."""
    if torch.is_tensor(prompt):
        prompt = prompt.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(prompt).reshape(-1), np.int32)


class PrefixCache:
    """Host index from page-aligned prompt chunks to live pool blocks.

    Chunk ``i`` covers tokens ``[i*page_size, (i+1)*page_size)`` and is keyed
    by a CUMULATIVE sha1 of tokens ``[0, (i+1)*page_size)``, so a match of
    chunk ``i`` implies a match of every earlier one and a lookup walks
    chunks to the first miss. The pool forgets a block's entries the moment
    its refcount reaches zero (``forget_block``): the index never hands out
    a recycled page, and an idle pool implies an empty index.

    With ``cow=True`` the index also marks the prompt's final PARTIAL chunk
    at every token length in a radix tree (:meth:`insert_tail`): a later
    prompt matching one of those sub-page prefixes adopts the block
    read-only up to the matched count (:meth:`match_cow`), and the engine
    forks it before the sharer's first write into that page. The same
    sub-page content may live in many private blocks (every fork copies
    it), so each position keeps every live backing block, first registered
    first. :meth:`trim_tail` drops what a sole surviving sharer will
    overwrite when it takes a block over."""

    def __init__(self, page_size: int, cow: bool = True):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = int(page_size)
        self.cow = bool(cow)
        self._by_hash: Dict[str, int] = {}   # chunk hash -> block id
        self._by_block: Dict[int, str] = {}  # block id -> its chunk hash
        self._tails = RadixIndex()

    def __len__(self) -> int:
        """Full-chunk entries: the operator's "indexed chunks" gauge."""
        return len(self._by_hash)

    @property
    def tail_count(self) -> int:
        """Live sub-page (copy-on-write) tail entries: distinct marked
        positions in the radix tree."""
        return self._tails.mark_points

    def _chunk(self, data: np.ndarray, chunk: int) -> bytes:
        return data[chunk * self.page_size:(chunk + 1) * self.page_size].tobytes()

    def match(self, prompt) -> List[int]:
        """Block ids of the longest indexed prefix of ``prompt``, STRICTLY
        shorter than the prompt: at least one trailing token is left to
        prefill (the request needs its last token's logits)."""
        data = _tokens(prompt)
        blocks: List[int] = []
        h = hashlib.sha1()
        for chunk in range((data.size - 1) // self.page_size):
            h.update(self._chunk(data, chunk))
            block = self._by_hash.get(h.copy().hexdigest())
            if block is None:
                break
            blocks.append(block)
        return blocks

    def insert(self, prompt, blocks: List[int]) -> None:
        """Register ``prompt``'s leading full-page chunks as backed by
        ``blocks`` (one per chunk, in order). An indexed chunk is skipped:
        the first writer's block stays canonical. With ``cow`` every
        sub-page prefix of each newly indexed chunk is marked in the tree
        too (a chunk already indexed was marked when it was first
        inserted, so it is only walked)."""
        data = _tokens(prompt)
        h = hashlib.sha1()
        w = self._tails.writer() if self.cow else None
        for chunk, block in enumerate(blocks):
            block = int(block)
            base = chunk * self.page_size
            if self.cow:
                probe = h.copy()
                probe.update(self._chunk(data, chunk))
                if probe.hexdigest() in self._by_hash:
                    h = probe
                    w.advance(data[base:base + self.page_size])
                    continue
                for t in range(1, self.page_size):
                    w.advance(data[base + t - 1])
                    w.mark(block, t)
                w.advance(data[base + self.page_size - 1])
            h.update(self._chunk(data, chunk))
            key = h.copy().hexdigest()
            if key in self._by_hash:
                continue
            self._by_hash[key] = block
            self._by_block[block] = key

    def insert_tail(self, prompt, block: int) -> None:
        """Register the prompt's FINAL partial chunk as backed by ``block``:
        one mark per tail length in ``[1, len % page_size]``. A no-op when
        ``cow`` is off or the prompt is page-aligned."""
        if not self.cow:
            return
        data = _tokens(prompt)
        rem = data.size % self.page_size
        if rem == 0:
            return
        full = data.size - rem
        w = self._tails.writer(data[:full])
        for t in range(1, rem + 1):
            w.advance(data[full + t - 1])
            w.mark(int(block), t)

    def match_cow(self, prompt) -> Tuple[List[int], Optional[int], int]:
        """``(full_blocks, tail_block, tail_tokens)``: the page-aligned
        chunks matched (UNCLAMPED: an identical page-aligned prompt may
        share every page; the engine recomputes its last token with the
        write dropped) and the longest indexed sub-page continuation
        (``None, 0`` when the walk ends on a page boundary). The shared
        total never exceeds the prompt. Without ``cow`` this is
        :meth:`match` with no tail."""
        if not self.cow:
            return self.match(prompt), None, 0
        data = _tokens(prompt)
        blocks: List[int] = []
        h = hashlib.sha1()
        for chunk in range(data.size // self.page_size):
            h.update(self._chunk(data, chunk))
            block = self._by_hash.get(h.copy().hexdigest())
            if block is None:
                break
            blocks.append(block)
        start = len(blocks) * self.page_size
        tail_block: Optional[int] = None
        tail_tokens = 0
        # marks along an insert's chunk cover the contiguous lengths 1..k,
        # so the first divergence ends the longest match
        r = self._tails.reader(data[:start])
        if r is not None:
            for t in range(1, min(self.page_size - 1, data.size - start) + 1):
                if not r.advance(data[start + t - 1]):
                    break
                pairs = r.marks()
                if pairs:
                    tail_block, tail_tokens = pairs[0][0], t
        return blocks, tail_block, tail_tokens

    def is_live(self, block: int) -> bool:
        """Whether ``block`` backs an indexed FULL chunk (sub-page entries
        are ignored: every prompt page carries them under COW)."""
        return int(block) in self._by_block

    def forget_block(self, block: int) -> None:
        """Drop every entry ``block`` backs: the pool calls this when the
        block's refcount reaches zero."""
        key = self._by_block.pop(int(block), None)
        if key is not None:
            self._by_hash.pop(key, None)
        self._tails.forget(int(block))

    def trim_tail(self, block: int, max_tokens: int) -> None:
        """Drop every entry of ``block`` covering more than ``max_tokens``
        of it, its full-chunk entry included when ``max_tokens`` is under a
        page: the sole surviving sharer that takes the block over will
        overwrite what lies past its own matched extent."""
        if int(max_tokens) < self.page_size:
            key = self._by_block.pop(int(block), None)
            if key is not None:
                self._by_hash.pop(key, None)
        self._tails.trim(int(block), int(max_tokens))

    def clear(self) -> None:
        self._by_hash.clear()
        self._by_block.clear()
        self._tails.clear()


class PagedCachePool(_SlotLedger):
    """Slot and block bookkeeping (host) and the paged pool (device).

    ``num_blocks`` sets the token capacity (``num_blocks * page_size``
    positions shared by all slots); ``max_len`` bounds one request
    (``max_pages = max_len / page_size`` page-table columns). Unassigned
    page-table entries hold the sentinel ``num_blocks``. ``tp``: this
    rank's heads of a model axis that wide."""

    def __init__(self, cfg: GPTConfig, num_slots: int, max_len: int, page_size: int,
                 num_blocks: int, prefix_cache: Optional[PrefixCache] = None,
                 cache_dtype=None, device=None, tp: int = 1):
        self._init_slots(num_slots)
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} must be a multiple of page_size {page_size}")
        if max_len > cfg.max_position_embeddings:
            raise ValueError(f"max_len {max_len} exceeds max_position_embeddings "
                             f"{cfg.max_position_embeddings}")
        if prefix_cache is not None and prefix_cache.page_size != page_size:
            raise ValueError(f"prefix cache page_size {prefix_cache.page_size} != pool "
                             f"page_size {page_size}")
        self.k, self.v = init_paged_pool(cfg, num_blocks, page_size, cache_dtype=cache_dtype,
                                         device=device, tp=tp)
        self._cfg = cfg
        self._tp = tp
        self.cache_dtype = cache_dtype
        self.device = self.k.device
        self.segments: List[int] = [int(num_blocks)]  # grow order, as JAX's
        self.lengths = torch.zeros(num_slots, dtype=torch.int64, device=device)
        self.max_len = max_len
        self.page_size = page_size
        self.num_blocks = num_blocks
        self.max_pages = max_len // page_size
        self.prefix_cache = prefix_cache
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
        # an overcommitting admission policy sets this: alloc_to may then
        # grow a slot past its reservation, and an empty free list raises
        # PoolPressure for the engine to preempt a victim
        self.allow_overcommit = False

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
        """Free blocks that reached zero and forget their index entries."""
        if not blocks:
            return
        self._free_blocks.extend(blocks)
        self._free_blocks.sort(reverse=True)  # deterministic: lowest block next
        if self.prefix_cache is not None:
            for block in blocks:
                self.prefix_cache.forget_block(block)

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
        if (not self.allow_overcommit
                and need - self._slot_shared[slot] > self._slot_reserved[slot]):
            raise ValueError(
                f"slot {slot} needs {need - self._slot_shared[slot]} private blocks but "
                f"reserved only {self._slot_reserved[slot]} — the write limit should "
                "have made this unreachable")
        for page in range(have, need):
            if not self._free_blocks:
                # only under overcommit; the blocks granted so far stay mapped
                raise PoolPressure(slot, need - page, 0, self._slot_reserved[slot])
            block = self._free_blocks.pop()
            self._block_refs[block] = 1
            self._block_owner[block] = slot
            self._slot_blocks[slot].append(block)
            self.page_table[slot, page] = block
        if need > have:
            self._table_device = None

    def fork_cow(self, slot: int, page: int) -> Optional[int]:
        """Copy-on-write fork of the slot's ADOPTED block at ``page``: a
        fresh private block (refcount 1, covered by the slot's reservation,
        which never counted the adopted tail as shared) takes its
        page-table entry and the shared block loses a reference. Returns
        the OLD block id, for the engine's one-block device copy, or None
        when the fork is ELIDED: the slot held the last reference, so it
        takes the block over in place."""
        if not self._claimed[slot]:
            raise ValueError(f"slot {slot} is not claimed")
        old = int(self.page_table[slot, page])
        if not 0 <= old < self.num_blocks or self._block_refs[old] < 1:
            raise ValueError(f"slot {slot} page {page} maps no live block")
        if self._slot_blocks[slot][page] != old:
            raise ValueError("page-table/slot-blocks mirror out of sync")
        if self._block_refs[old] == 1 and self._block_owner[old] != slot:
            if self._block_owner[old] is None:
                self._orphans -= 1  # now covered by this slot's reservation
            self._block_owner[old] = slot
            self._slot_shared[slot] -= 1
            return None
        if not self._free_blocks:
            raise PoolPressure(slot, 1, 0, self._slot_reserved[slot])
        new = self._free_blocks.pop()
        self._block_refs[new] = 1
        self._block_owner[new] = slot
        self._slot_blocks[slot][page] = new
        self.page_table[slot, page] = new
        self._table_device = None
        self._slot_shared[slot] -= 1
        if self._decref(old, slot):
            self._reclaim([old])
        return old

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
                                           cache_dtype=self.cache_dtype, device=self.device,
                                           tp=self._tp)
        # [real blocks, new blocks, trash]: the new trash is a fresh block
        def cat(a, b):
            return torch.cat([a[:, :old], b], dim=1)

        self.k = kv_map(cat, self.k, extra_k)
        self.v = kv_map(cat, self.v, extra_v)
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
        (``alloc_to``, ``adopt_shared``, ``fork_cow``, ``release``,
        ``grow``); an upload
        bounds-checks the host table first."""
        if self._table_device is None:
            bad_mask = (self.page_table < 0) | (self.page_table > self.num_blocks)
            if bad_mask.any():
                bad = np.argwhere(bad_mask)[0]
                raise BlockTableCorruption(
                    f"page table holds out-of-range block id "
                    f"{int(self.page_table[tuple(bad)])} at slot {int(bad[0])} page "
                    f"{int(bad[1])} (valid ids are 0..{self.num_blocks})")
            self._table_device = upload(self.page_table.astype(np.int64), self.device)
        return self._table_device
