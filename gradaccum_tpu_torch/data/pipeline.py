"""Array-backed input pipeline with tf.data semantics (numpy only).

The port's copy of ``gradaccum_tpu/data/pipeline.py``. Operators compose
in call order, as tf.data does:

- ``shard(num, index)``: every ``num``-th element by POSITION (so it also
  holds after a shuffle or a map), as ``tf.data.Dataset.shard``;
- ``shuffle(buffer_size, seed)``: buffered (reservoir) shuffle, reseeded
  per epoch;
- ``batch(n, drop_remainder)``: gather-based, vectorized;
- ``map(fn)``: applied wherever it sits in the chain (the CSV pipeline
  batches before it maps);
- ``repeat(count)``: re-runs the upstream chain, advancing shuffle seeds;
- ``take(n)``: the first ``n`` elements;
- ``prefetch(n)``: a background thread keeps ``n`` elements ready.

Elements are dicts (or tuples) of numpy arrays sharing the leading
dimension; iterating yields the same structure, batched.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np


def _leaves(data):
    if isinstance(data, dict):
        return [data[k] for k in sorted(data)]
    if isinstance(data, (tuple, list)):
        return list(data)
    return [data]


def _gather(data, idx):
    if isinstance(data, dict):
        return {k: v[idx] for k, v in data.items()}
    if isinstance(data, (tuple, list)):
        return type(data)(v[idx] for v in data)
    return data[idx]


def _num_examples(data) -> int:
    leaves = _leaves(data)
    if not leaves:
        raise ValueError("empty dataset")
    n = len(leaves[0])
    if any(len(leaf) != n for leaf in leaves[1:]):
        raise ValueError("dataset leaves disagree on leading dim")
    return n


class Dataset:
    """A lazily-evaluated op chain over an in-memory structure of arrays."""

    def __init__(self, data, ops=None):
        self._data = data
        self._n = _num_examples(data)
        self._ops = list(ops or [])

    @classmethod
    def from_arrays(cls, data) -> "Dataset":
        return cls(data)

    def _with(self, op) -> "Dataset":
        return Dataset(self._data, self._ops + [op])

    def shard(self, num_shards: int, index: int) -> "Dataset":
        if not 0 <= index < num_shards:
            raise ValueError(f"shard index {index} not in [0, {num_shards})")
        return self._with(("shard", num_shards, index))

    def shuffle(self, buffer_size: int, seed: Optional[int] = None) -> "Dataset":
        return self._with(("shuffle", buffer_size, seed))

    def batch(self, batch_size: int, drop_remainder: bool = False) -> "Dataset":
        return self._with(("batch", batch_size, drop_remainder))

    def map(self, fn: Callable[[Any], Any]) -> "Dataset":
        return self._with(("map", fn))

    def repeat(self, count: Optional[int] = None) -> "Dataset":
        return self._with(("repeat", count))

    def prefetch(self, n: int = 2) -> "Dataset":
        return self._with(("prefetch", n))

    def take(self, n: int) -> "Dataset":
        return self._with(("take", n))

    def _build(self, ops, epoch: int) -> Iterator[Any]:
        """The iterator for ``ops``; ``epoch`` advances shuffle seeds. The
        stream starts as example indices; the first ``map`` or ``batch``
        materializes elements, and later ops work on them."""
        stream: Iterator[Any] = iter(range(self._n))
        is_index_stream = True
        for i, op in enumerate(ops):
            kind = op[0]
            if kind == "shard":
                num, index = op[1], op[2]
                stream = (x for pos, x in enumerate(stream) if pos % num == index)
            elif kind == "shuffle":
                stream = _buffered_shuffle(stream, op[1], op[2], epoch)
            elif kind == "batch":
                stream = self._batch_stream(stream, op[1], op[2], is_index_stream)
                is_index_stream = False
            elif kind == "map":
                fn = op[1]
                if is_index_stream:
                    stream = (fn(_gather(self._data, j)) for j in stream)
                    is_index_stream = False
                else:
                    stream = (fn(x) for x in stream)
            elif kind == "repeat":
                return self._repeat_stream(ops[:i], ops[i + 1:], op[1], epoch)
            elif kind == "take":
                stream = itertools.islice(stream, op[1])
            elif kind == "prefetch":
                stream = _prefetch(stream, op[1])
            else:  # pragma: no cover
                raise AssertionError(kind)
        if is_index_stream:
            stream = (_gather(self._data, j) for j in stream)
        return stream

    def _batch_stream(self, stream, batch_size, drop_remainder, is_index_stream):
        def emit(buf):
            if is_index_stream:
                return _gather(self._data, np.asarray(buf))
            first = buf[0]
            if isinstance(first, dict):
                return {k: np.stack([b[k] for b in buf]) for k in first}
            return type(first)(np.stack(xs) for xs in zip(*buf))

        buf = []
        for item in stream:
            buf.append(item)
            if len(buf) == batch_size:
                yield emit(buf)
                buf = []
        if buf and not drop_remainder:
            yield emit(buf)

    def _repeat_stream(self, upstream_ops, downstream, count, epoch):
        def epochs():
            e = epoch
            while count is None or e < epoch + count:
                yield from self._build(upstream_ops, e)
                e += 1

        # downstream ops apply to the concatenated epochs of materialized
        # elements or batches
        stream = epochs()
        for op in downstream:
            if op[0] == "map":
                stream = map(op[1], stream)
            elif op[0] == "take":
                stream = itertools.islice(stream, op[1])
            elif op[0] == "prefetch":
                stream = _prefetch(stream, op[1])
            elif op[0] == "batch":
                stream = self._batch_stream(stream, op[1], op[2], is_index_stream=False)
            else:
                raise ValueError(f"{op[0]}() after repeat() is not supported")
        return stream

    def __iter__(self):
        return iter(self._build(self._ops, epoch=0))


def _buffered_shuffle(stream, buffer_size, seed, epoch):
    """tf.data reservoir shuffle: keep a buffer, emit a random element as
    each new one arrives; the seed advances per epoch."""
    rng = np.random.default_rng(
        None if seed is None else np.random.SeedSequence([seed, epoch])
    )
    buf = []
    for x in stream:
        buf.append(x)
        if len(buf) > buffer_size:
            k = int(rng.integers(len(buf)))
            buf[k], buf[-1] = buf[-1], buf[k]
            yield buf.pop()
    for k in rng.permutation(len(buf)):
        yield buf[k]


def _prefetch(stream, n):
    q: "queue.Queue" = queue.Queue(maxsize=max(1, n))
    sentinel = object()
    error = []

    def worker():
        try:
            for x in stream:
                q.put(x)
        except BaseException as e:  # handed to the consumer, which re-raises
            error.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        x = q.get()
        if x is sentinel:
            if error:
                raise error[0]
            return
        yield x
