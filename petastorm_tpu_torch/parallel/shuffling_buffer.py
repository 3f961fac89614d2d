"""Columnar shuffling buffers: dicts of ``(n, ...)`` numpy arrays or torch
tensors on any device (or lists for ragged and raw-payload fields).

A copy of ``petastorm_tpu.parallel.shuffling_buffer``: the random buffer draws
from the same ``numpy.random.default_rng(seed)`` stream in the same calls, so
both packages emit rows in the same order for the same seed and input. A
tensor column is gathered and concatenated on its own device, so
``BatchedDataLoader`` shuffles tensors that its ``transform_fn`` put on the
card there. Chunks are kept as separate parts and only the rows a retrieve
touches are copied. Not thread safe. The module imports no torch: the process
pool's workers load it.
"""

import sys
from collections import deque

import numpy as np


def _is_torch_tensor(value):
    torch = sys.modules.get('torch')
    return torch is not None and isinstance(value, torch.Tensor)


def _gather(columns, indices):
    out = {}
    for name, col in columns.items():
        if isinstance(col, np.ndarray):
            out[name] = col[indices]
        elif _is_torch_tensor(col):
            out[name] = col[np.asarray(indices)]
        else:
            out[name] = [col[i] for i in indices]
    return out


def _concat_parts(parts):
    out = {}
    for name in parts[0]:
        values = [p[name] for p in parts]
        if isinstance(values[0], np.ndarray) and values[0].ndim >= 1:
            out[name] = np.concatenate(values) if len(values) > 1 else values[0]
        elif _is_torch_tensor(values[0]):
            import torch
            out[name] = torch.cat(values) if len(values) > 1 else values[0]
        else:
            merged = []
            for v in values:
                merged.extend(list(v))
            out[name] = merged
    return out


def _num_rows(columns):
    for col in columns.values():
        return len(col)
    return 0


class ShufflingBufferBase(object):
    """The columnar shuffling-buffer interface: ``add_many`` columns in,
    ``retrieve`` rows out."""

    def add_many(self, columns):
        raise NotImplementedError()

    def retrieve(self, n):
        """A dict of columns with ``n`` rows (fewer only after ``finish``)."""
        raise NotImplementedError()

    @property
    def size(self):
        raise NotImplementedError()

    def can_retrieve(self, n):
        raise NotImplementedError()

    def finish(self):
        """No more adds; drain whatever remains."""
        raise NotImplementedError()


class NoopShufflingBuffer(ShufflingBufferBase):
    """FIFO pass-through: a deque of parts and a read cursor into the head part."""

    def __init__(self):
        self._parts = deque()
        self._head_offset = 0
        self._size = 0
        self._finished = False

    def add_many(self, columns):
        if self._finished:
            raise RuntimeError('Cannot add to a finished shuffling buffer')
        n = _num_rows(columns)
        if n:
            self._parts.append(columns)
            self._size += n

    def retrieve(self, n):
        """A dict of columns with ``n`` rows (fewer only after ``finish``)."""
        take = min(n, self._size) if self._finished else n
        if take > self._size:
            raise RuntimeError('Not enough rows buffered: asked {}, have {}'
                               .format(n, self._size))
        pieces = []
        needed = take
        while needed > 0:
            head = self._parts[0]
            use = min(_num_rows(head) - self._head_offset, needed)
            pieces.append({name: col[self._head_offset:self._head_offset + use]
                           for name, col in head.items()})
            needed -= use
            self._head_offset += use
            if self._head_offset >= _num_rows(head):
                self._parts.popleft()
                self._head_offset = 0
        self._size -= take
        return _concat_parts(pieces) if pieces else {}

    @property
    def size(self):
        return self._size

    def can_retrieve(self, n):
        return self._size >= n or (self._finished and self._size > 0)

    def finish(self):
        """No more adds; drain whatever remains."""
        self._finished = True


class RandomShufflingBuffer(ShufflingBufferBase):
    """Random-order buffer with a decorrelation floor: holds up to
    ``shuffling_buffer_capacity`` rows; a retrieve must leave at least
    ``min_after_retrieve`` rows behind (until ``finish``). Each retrieve samples
    uniformly without replacement over every row still buffered."""

    def __init__(self, shuffling_buffer_capacity, min_after_retrieve, seed=None):
        if min_after_retrieve > shuffling_buffer_capacity:
            raise ValueError('min_after_retrieve must be <= capacity')
        self._capacity = shuffling_buffer_capacity
        self._min_after = min_after_retrieve
        self._random = np.random.default_rng(seed)
        self._parts = []        # list of column dicts
        self._alive = []        # list of int arrays: still-alive row positions per part
        self._size = 0
        self._finished = False

    def add_many(self, columns):
        if self._finished:
            raise RuntimeError('Cannot add to a finished shuffling buffer')
        n = _num_rows(columns)
        if not n:
            return
        self._parts.append(columns)
        self._alive.append(np.arange(n))
        self._size += n

    def can_add(self):
        """True while the buffer holds fewer rows than its capacity and is
        not finished."""
        return self._size < self._capacity and not self._finished

    def retrieve(self, n):
        """A dict of columns with ``n`` rows (fewer only after ``finish``)."""
        if self._finished:
            take = min(n, self._size)
        else:
            take = n
            if self._size - n < self._min_after:
                raise RuntimeError('Retrieval would drop below min_after_retrieve; '
                                   'buffer more rows first (size={}, min={})'
                                   .format(self._size, self._min_after))
        counts = np.array([len(a) for a in self._alive])
        cum = np.concatenate([[0], np.cumsum(counts)])
        ranks = self._random.choice(self._size, size=take, replace=False)
        part_ids = np.searchsorted(cum, ranks, side='right') - 1
        pieces = []
        for part_id in np.unique(part_ids):
            local_ranks = ranks[part_ids == part_id] - cum[part_id]
            positions = self._alive[part_id][local_ranks]
            pieces.append(_gather(self._parts[part_id], positions))
            self._alive[part_id] = np.delete(self._alive[part_id], local_ranks)
        self._parts = [p for p, a in zip(self._parts, self._alive) if len(a)]
        self._alive = [a for a in self._alive if len(a)]
        self._size -= take
        return _concat_parts(pieces) if pieces else {}

    @property
    def size(self):
        return self._size

    def can_retrieve(self, n):
        if self._finished:
            return self._size > 0
        return self._size - n >= self._min_after

    @property
    def min_after_retrieve(self):
        """The current decorrelation floor."""
        return self._min_after

    def set_min_after_retrieve(self, value):
        """Set the decorrelation floor, clamped to ``[0, capacity]`` (the
        loader's ``loader_min_after_retrieve`` knob). Returns the applied
        value. Like the rest of the buffer, not thread-safe: the loader calls
        it on its producer thread, between retrieves."""
        value = max(0, min(int(value), self._capacity))
        self._min_after = value
        return value

    def finish(self):
        """No more adds; drain whatever remains."""
        self._finished = True
