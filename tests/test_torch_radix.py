"""The port's radix index (``memory/radix.py``) against JAX's.

Seeded random sequences of operations on both packages' ``RadixIndex``:
writer inserts with marks (token runs from a small alphabet, so prompts
share prefixes and split edges), ``forget``, ``trim``, ``clear``, and
reader walks. After every operation the two trees give the same marks at
every probed position, the same reader outcomes and the same count of
marked positions, and the trees have the same shape (edges, marks,
children), also once ``forget`` has removed every mark.
"""

import importlib

import numpy as np
import pytest

from gradaccum_tpu_torch.memory.radix import RadixIndex

jradix = importlib.import_module("gradaccum_tpu.memory.radix")

pytestmark = pytest.mark.torch


def _probe(index, seqs):
    """Every prefix of every sequence: the reader's outcome and marks."""
    out = []
    for seq in seqs:
        r = index.reader()
        for tok in seq:
            if not r.advance(tok):
                out.append(None)
                break
            out.append(r.marks())
        whole = index.reader(seq)
        out.append(None if whole is None else whole.marks())
    return out


def _shape(node):
    """The tree's structure: edges, marks and children, recursively."""
    return (node.edge.tolist(), sorted((o, s.pairs) for o, s in node.marks.items()),
            sorted((k, _shape(c)) for k, c in node.children.items()))


@pytest.mark.parametrize("seed", range(6))
def test_random_operations_equal_jax(seed):
    rng = np.random.default_rng(seed)
    port, ref = RadixIndex(), jradix.RadixIndex()
    seqs, values = [], []
    for step in range(150):
        op = rng.choice(["insert", "forget", "trim", "clear", "advance_run"],
                        p=[0.5, 0.2, 0.2, 0.02, 0.08])
        if op == "insert" or not values:
            base = seqs[int(rng.integers(len(seqs)))] if seqs and rng.random() < 0.6 else []
            keep = int(rng.integers(0, len(base) + 1))
            seq = list(base[:keep]) + rng.integers(0, 4, int(rng.integers(1, 9))).tolist()
            value = int(rng.integers(0, 12))
            marks = sorted(rng.choice(len(seq), size=int(rng.integers(1, len(seq) + 1)),
                                      replace=False).tolist())
            for index in (port, ref):
                w = index.writer()
                for pos, tok in enumerate(seq):
                    w.advance(tok)
                    if pos in marks:
                        w.mark(value, pos + 1)
            seqs.append(seq)
            values.append(value)
        elif op == "forget":
            value = values[int(rng.integers(len(values)))]
            port.forget(value)
            ref.forget(value)
        elif op == "trim":
            value, max_t = values[int(rng.integers(len(values)))], int(rng.integers(0, 8))
            port.trim(value, max_t)
            ref.trim(value, max_t)
        elif op == "clear":
            port.clear()
            ref.clear()
        else:  # a writer skipping a whole run at once, then one mark
            seq = rng.integers(0, 4, int(rng.integers(2, 7))).tolist()
            value = int(rng.integers(0, 12))
            for index in (port, ref):
                w = index.writer(np.asarray(seq, np.int32))
                w.mark(value, len(seq))
            seqs.append(seq)
            values.append(value)
        probes = seqs[-12:] + [rng.integers(0, 4, 6).tolist()]
        assert _probe(port, probes) == _probe(ref, probes), (step, op)
        assert port.mark_points == ref.mark_points, (step, op)
        assert _shape(port._root) == _shape(ref._root), (step, op)
    for value in set(values):
        port.forget(value)
        ref.forget(value)
    assert port.mark_points == ref.mark_points == 0
    assert _shape(port._root) == _shape(ref._root)


def test_marks_dedupe_and_split_keep_slots():
    """A second mark of one value at a position is dropped (first wins);
    splitting an edge carries the marks past the cut to the new child."""
    for make in (RadixIndex, jradix.RadixIndex):
        index = make()
        w = index.writer([1, 2, 3, 4])
        w.mark(7, 4)
        w.mark(7, 9)
        w.mark(8, 4)
        assert index.reader([1, 2, 3, 4]).marks() == [(7, 4), (8, 4)]
        index.writer([1, 2, 9]).mark(5, 3)  # splits [1, 2, 3, 4] after 2
        assert index.reader([1, 2, 3, 4]).marks() == [(7, 4), (8, 4)]
        assert index.reader([1, 2, 9]).marks() == [(5, 3)]
        assert index.reader([1, 2, 7]) is None
        index.trim(7, 3)
        assert index.reader([1, 2, 3, 4]).marks() == [(8, 4)] and index.mark_points == 2
