"""A compressed radix tree over token sequences with marked positions.

The port of ``gradaccum_tpu/memory/radix.py``, host-only and unchanged in
its semantics: ``serving/cache_pool.py :: PrefixCache`` keeps its sub-page
(copy-on-write) tail entries here. The tree is keyed by token CONTENT, not
by hash: edges carry runs of token ids (``np.int32``), and a path from the
root spells a token prefix. Positions along edges can be *marked* with
``(value, t)`` pairs: the serving layer marks position ``k`` of a partially
filled KV block with ``(block_id, tokens_valid)``, so a later prompt that
shares the first ``t`` tokens of that block's page can adopt it copy-on-write.

Traversal is via cursors (:meth:`RadixIndex.writer` /
:meth:`RadixIndex.reader`): a writer materializes missing structure as it
advances (splitting edges at divergence points), a reader stops at the first
divergence. Both advance one token at a time or ``n`` tokens at once; marks
are read and written at the cursor's position. ``forget``, ``trim`` and the
pruning of unmarked leaf chains are value-indexed, so eviction is
O(marks removed), not O(tree).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class _Slot:
    """The set of ``(value, t)`` pairs marked at one tree position.

    Shared by reference between ``node.marks[off]`` and the per-value
    registry ``RadixIndex._by_value``, so an edge split can relocate the
    slot (rewriting ``node``/``off``) without touching the registry."""

    __slots__ = ("node", "off", "pairs")

    def __init__(self, node: "_Node", off: int):
        self.node = node
        self.off = off
        self.pairs: List[Tuple[int, int]] = []  # (value, t), append order


class _Node:
    """One radix node: an edge of tokens leading INTO it from its
    parent, children keyed by their edge's first token, and marks keyed
    by offset along this node's edge (offset k = state after consuming
    edge[:k]; k ranges 1..len(edge))."""

    __slots__ = ("edge", "children", "marks", "parent")

    def __init__(self, edge: np.ndarray, parent: Optional["_Node"]):
        self.edge = edge                       # np.int32 [n], n >= 1 unless root
        self.children: Dict[int, "_Node"] = {}
        self.marks: Dict[int, _Slot] = {}
        self.parent = parent


class _Cursor:
    """A position in the tree: ``node`` + ``off`` tokens consumed along
    its edge (off == len(edge) means 'at the node', ready to descend).
    The root is (root, 0)."""

    __slots__ = ("_idx", "node", "off", "_write")

    def __init__(self, idx: "RadixIndex", write: bool):
        self._idx = idx
        self.node = idx._root
        self.off = 0
        self._write = write

    def advance(self, tokens) -> bool:
        """Consume ``tokens`` (scalar int or 1-D array) from the current
        position. Returns True if the full run was consumed. A reader
        returns False at the first divergence (cursor stays where it
        stopped); a writer creates the missing structure and always
        returns True."""
        toks = np.atleast_1d(np.asarray(tokens, dtype=np.int32))
        pos = 0
        while pos < toks.size:
            if self.off < len(self.node.edge):
                # inside an edge: match token-by-token (vectorized run)
                n = min(toks.size - pos, len(self.node.edge) - self.off)
                seg = self.node.edge[self.off:self.off + n]
                eq = toks[pos:pos + n] == seg
                run = int(np.argmin(eq)) if not eq.all() else n
                self.off += run
                pos += run
                if run < n:  # divergence mid-edge
                    if not self._write:
                        return False
                    self._idx._split(self.node, self.off)
                    # fall through: off == len(edge), descend/create below
                continue
            # at a node boundary: descend by next token
            nxt = int(toks[pos])
            child = self.node.children.get(nxt)
            if child is None:
                if not self._write:
                    return False
                child = _Node(toks[pos:].copy(), self.node)
                self.node.children[nxt] = child
                self.node = child
                self.off = toks.size - pos
                return True
            self.node = child
            self.off = 0
        return True

    def mark(self, value: int, t: int) -> None:
        """Annotate the current position with ``(value, t)``. Pairs for
        the same value at the same position are deduplicated (first
        registration wins)."""
        assert self._write and self.off > 0
        slot = self.node.marks.get(self.off)
        if slot is None:
            slot = _Slot(self.node, self.off)
            self.node.marks[self.off] = slot
            self._idx._points += 1
        elif any(v == value for v, _ in slot.pairs):
            return
        slot.pairs.append((value, t))
        self._idx._by_value.setdefault(value, []).append(slot)

    def marks(self) -> List[Tuple[int, int]]:
        """The ``(value, t)`` pairs at the current position, in
        registration order; [] if unmarked."""
        slot = self.node.marks.get(self.off)
        return list(slot.pairs) if slot is not None else []


class RadixIndex:
    """The tree plus value-indexed bookkeeping for eviction."""

    def __init__(self):
        self._root = _Node(np.empty(0, dtype=np.int32), None)
        self._by_value: Dict[int, List[_Slot]] = {}
        self._points = 0

    @property
    def mark_points(self) -> int:
        """Number of distinct tree positions carrying at least one
        mark: the prefix cache's ``tail_count``."""
        return self._points

    def writer(self, tokens=None) -> _Cursor:
        c = _Cursor(self, write=True)
        if tokens is not None:
            c.advance(tokens)
        return c

    def reader(self, tokens=None) -> Optional[_Cursor]:
        """A read-only cursor, pre-advanced through ``tokens`` if given;
        None if that prefix is not in the tree."""
        c = _Cursor(self, write=False)
        if tokens is not None and not c.advance(tokens):
            return None
        return c

    def _split(self, node: _Node, off: int) -> None:
        """Split ``node``'s edge at ``off`` (0 < off < len(edge)): a new
        child keeps the suffix, the children, and the marks past the cut
        (slots relocated in place — the by-value registry holds the same
        objects)."""
        child = _Node(node.edge[off:].copy(), node)
        child.children = node.children
        for c in child.children.values():
            c.parent = child
        child.marks = {}
        keep: Dict[int, _Slot] = {}
        for o, slot in node.marks.items():
            if o > off:
                slot.node = child
                slot.off = o - off
                child.marks[slot.off] = slot
            else:
                keep[o] = slot
        node.marks = keep
        node.edge = node.edge[:off].copy()
        node.children = {int(child.edge[0]): child}

    def forget(self, value: int) -> None:
        """Drop every mark carrying ``value``; prune any structure left
        unmarked and childless."""
        slots = self._by_value.pop(value, None)
        if not slots:
            return
        dirty = []
        for slot in slots:
            slot.pairs = [p for p in slot.pairs if p[0] != value]
            if not slot.pairs and slot.node.marks.get(slot.off) is slot:
                del slot.node.marks[slot.off]
                self._points -= 1
                dirty.append(slot.node)
        for node in dirty:
            self._prune(node)

    def trim(self, value: int, max_t: int) -> None:
        """Remove ``value``'s marks with ``t > max_t`` (the serving
        layer's tail truncation after a partial block is cut back)."""
        slots = self._by_value.get(value)
        if not slots:
            return
        keep_slots = []
        dirty = []
        for slot in slots:
            mine = [p for p in slot.pairs if p[0] == value]
            if mine and mine[0][1] > max_t:
                slot.pairs = [p for p in slot.pairs if p[0] != value]
                if not slot.pairs and slot.node.marks.get(slot.off) is slot:
                    del slot.node.marks[slot.off]
                    self._points -= 1
                    dirty.append(slot.node)
            else:
                keep_slots.append(slot)
        if keep_slots:
            self._by_value[value] = keep_slots
        else:
            del self._by_value[value]
        for node in dirty:
            self._prune(node)

    def clear(self) -> None:
        self._root = _Node(np.empty(0, dtype=np.int32), None)
        self._by_value.clear()
        self._points = 0

    def _prune(self, node: _Node) -> None:
        """Walk up from ``node`` removing childless, markless nodes —
        keeps the tree proportional to LIVE marks, not history."""
        while (node.parent is not None and not node.children
               and not node.marks):
            parent = node.parent
            del parent.children[int(node.edge[0])]
            node.parent = None
            node = parent
