"""The reference petastorm's torch adapters over the port's readers: a copy of
``petastorm_tpu.pytorch`` with a ``device``.

``DataLoader`` — row-based, with an optional shuffling queue and a
decimal-friendly collate. ``BatchedDataLoader`` — columnar, over a
``make_batch_reader`` reader. ``InMemBatchedDataLoader`` — loads once, then
serves epochs of in-memory random batches. All yield dicts of torch tensors,
in the order, with the values and with the dtype sanitizing of the JAX
package's adapters (bool -> uint8, uint16 -> int32, uint32 -> int64, datetime
-> int64 ns, Decimal -> float64; None and strings are refused with the field
named).

The defined difference: each loader takes ``device=None``, resolved by
:func:`~petastorm_tpu_torch.parallel.loader.resolve_device`, so the batches
land on the card (a pinned host copy, then a ``non_blocking`` copy on the
current stream) unless the caller passes ``device='cpu'``, which keeps them on
the host as the JAX package's adapters do. ``InMemBatchedDataLoader`` holds
its rows on ``device`` and gathers each batch there.
"""

import decimal
from collections.abc import Mapping

import numpy as np

from petastorm_tpu_torch.parallel.shuffling_buffer import (NoopShufflingBuffer,
                                                           RandomShufflingBuffer)


def _sanitize_value(name, value):
    """A value as a numpy array torch can hold: bool -> uint8, uint16 ->
    int32, uint32 -> int64, datetime -> int64 ns, Decimal -> float64; None,
    strings and object arrays raise with the field named."""
    if value is None:
        raise TypeError('Field {!r} is None; use a TransformSpec or schema_fields to '
                        'drop nullable fields before the torch loader'.format(name))
    if isinstance(value, decimal.Decimal):
        return np.float64(value)
    if isinstance(value, (str, bytes)):
        raise TypeError('Field {!r} is a string; torch tensors cannot hold strings — '
                        'drop it via schema_fields'.format(name))
    arr = np.asarray(value)
    if arr.dtype == np.bool_:
        return arr.astype(np.uint8)
    if arr.dtype == np.uint16:
        return arr.astype(np.int32)
    if arr.dtype == np.uint32:
        return arr.astype(np.int64)
    if arr.dtype.kind == 'M':
        return arr.astype('datetime64[ns]').astype(np.int64)
    if arr.dtype == object:
        raise TypeError('Field {!r} has object dtype (strings/None?); drop it via '
                        'schema_fields'.format(name))
    return arr


def _writable_contiguous(arr):
    """A contiguous, writable array: Arrow-backed columns are read-only views
    that ``torch.as_tensor`` cannot safely alias."""
    arr = np.ascontiguousarray(arr)
    return arr if arr.flags.writeable else arr.copy()


def _to_device(value, device):
    """``value`` (a tensor, or a dict, tuple or namedtuple of them) on
    ``device``: a pinned host copy, then a ``non_blocking`` copy, for CUDA."""
    if isinstance(value, Mapping):
        return {name: _to_device(v, device) for name, v in value.items()}
    if isinstance(value, tuple):
        moved = [_to_device(v, device) for v in value]
        return type(value)(*moved) if hasattr(value, '_fields') else type(value)(moved)
    if device.type == 'cuda' and value.device.type == 'cpu':
        return value.pin_memory().to(device, non_blocking=True)
    return value.to(device)


def decimal_friendly_collate(rows):
    """Collate a list of rows (dicts, tuples or namedtuples, or leaves) into
    stacked torch tensors with the same nesting; Decimals become float64."""
    import torch
    first = rows[0]
    if isinstance(first, Mapping):
        return {name: decimal_friendly_collate([row[name] for row in rows])
                for name in first}
    if isinstance(first, tuple):
        collated = [decimal_friendly_collate(list(col)) for col in zip(*rows)]
        if hasattr(first, '_fields'):   # a namedtuple: rebuild the same row type
            return type(first)(*collated)
        return type(first)(collated)
    sanitized = [_sanitize_value('<collate>', v) for v in rows]
    return torch.as_tensor(np.stack(sanitized))


class LoaderBase(object):
    """Iteration guards of every loader: no concurrent iteration, the reader
    reset when a consumed loader is iterated again, and an error latched."""

    def __init__(self, reader, device=None):
        from petastorm_tpu_torch.parallel.loader import resolve_device
        self.reader = reader
        self.device = resolve_device(device)
        self._in_iter = False
        self._error = None
        self._started = False

    def __iter__(self):
        if self._in_iter:
            raise RuntimeError('Concurrent iteration of a loader is not allowed')
        if self._error is not None:
            raise RuntimeError('Loader previously failed') from self._error
        if self._started and getattr(self.reader, 'last_row_consumed', False):
            self.reader.reset()
        self._started = True
        self._in_iter = True
        try:
            for batch in self._iter_impl():
                yield _to_device(batch, self.device)
        except Exception as exc:
            self._error = exc
            raise
        finally:
            self._in_iter = False

    def _iter_impl(self):
        raise NotImplementedError()

    def stop(self):
        self.reader.stop()

    def join(self):
        self.reader.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        self.join()


class DataLoader(LoaderBase):
    """Row-based loader: reader rows -> optional shuffling queue ->
    ``collate_fn`` batches of ``batch_size`` rows (the last one may be
    smaller)."""

    def __init__(self, reader, batch_size=1, collate_fn=decimal_friendly_collate,
                 shuffling_queue_capacity=0, seed=None, device=None):
        super().__init__(reader, device)
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffling_queue_capacity = shuffling_queue_capacity
        self._seed = seed

    def _iter_impl(self):
        batch = []
        for row in self._row_stream():
            batch.append(row)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch:
            yield self.collate_fn(batch)

    def _row_stream(self):
        rows = ({k: _sanitize_value(k, v) for k, v in row._asdict().items()}
                for row in self.reader)
        if self.shuffling_queue_capacity <= 0:
            yield from rows
            return
        rng = np.random.default_rng(self._seed)
        buffer = []
        for row in rows:
            if len(buffer) < self.shuffling_queue_capacity:
                buffer.append(row)
                continue
            index = rng.integers(len(buffer))
            yield buffer[index]
            buffer[index] = row
        rng.shuffle(buffer)
        yield from buffer


class BatchedDataLoader(LoaderBase):
    """Columnar loader over a ``make_batch_reader`` reader: each rowgroup's
    columns go through ``transform_fn`` (default ``torch.as_tensor``), then
    through a shuffling buffer (random with ``shuffling_queue_capacity``);
    the last batch may be smaller. A ``transform_fn`` that puts the columns
    on the card makes the buffer gather and concatenate them there."""

    def __init__(self, reader, batch_size=1, transform_fn=None,
                 shuffling_queue_capacity=0, seed=None, device=None):
        super().__init__(reader, device)
        if not getattr(reader, 'is_batched_reader', False):
            raise ValueError('BatchedDataLoader requires a make_batch_reader reader')
        self.batch_size = batch_size
        self.shuffling_queue_capacity = shuffling_queue_capacity
        self._seed = seed
        if transform_fn is None:
            import torch
            transform_fn = torch.as_tensor
        self.transform_fn = transform_fn

    def _iter_impl(self):
        if self.shuffling_queue_capacity > 0:
            buffer = RandomShufflingBuffer(self.shuffling_queue_capacity,
                                           self.shuffling_queue_capacity // 2,
                                           seed=self._seed)
        else:
            buffer = NoopShufflingBuffer()
        for batch in self.reader:
            buffer.add_many({name: self.transform_fn(_writable_contiguous(
                _sanitize_value(name, col))) for name, col in batch._asdict().items()})
            while buffer.can_retrieve(self.batch_size):
                yield buffer.retrieve(self.batch_size)
        buffer.finish()
        while buffer.can_retrieve(1):
            yield buffer.retrieve(self.batch_size)


class InMemBatchedDataLoader(LoaderBase):
    """Loads up to ``rows_capacity`` rows once (the reader is then stopped),
    then serves ``num_epochs`` epochs of batches from memory on ``device``:
    a ``torch.randperm`` seeded with ``seed + epoch`` each epoch (or the
    rows in order without ``shuffle``), full batches only."""

    def __init__(self, reader, batch_size=1, rows_capacity=None, num_epochs=1,
                 shuffle=True, seed=0, device=None):
        super().__init__(reader, device)
        self.batch_size = batch_size
        self._num_epochs = num_epochs
        self._shuffle = shuffle
        self._seed = seed
        self._columns = None
        self._rows = 0
        self._capacity = rows_capacity

    def _fill(self):
        import torch
        parts = []
        count = 0
        if getattr(self.reader, 'is_batched_reader', False):
            for batch in self.reader:
                columns = {k: _sanitize_value(k, v) for k, v in batch._asdict().items()}
                parts.append(columns)
                count += len(next(iter(columns.values())))
                if self._capacity is not None and count >= self._capacity:
                    break
        else:
            rows = []
            for row in self.reader:
                rows.append({k: _sanitize_value(k, v) for k, v in row._asdict().items()})
                count += 1
                if self._capacity is not None and count >= self._capacity:
                    break
            if rows:
                parts.append({name: np.stack([r[name] for r in rows]) for name in rows[0]})
        # stopped at once, so an infinite-epoch reader cannot block on a full queue
        self.reader.stop()
        self.reader.join()
        if not parts:
            raise ValueError('Reader produced no rows to preload')
        merged = {name: np.concatenate([p[name] for p in parts])[:self._capacity]
                  for name in parts[0]}
        self._columns = _to_device({name: torch.as_tensor(_writable_contiguous(col))
                                    for name, col in merged.items()}, self.device)
        self._rows = len(next(iter(merged.values())))

    def _iter_impl(self):
        import torch
        if self._columns is None:
            self._fill()
        for epoch in range(self._num_epochs):
            if self._shuffle:
                generator = torch.Generator()
                generator.manual_seed(self._seed + epoch)
                order = torch.randperm(self._rows, generator=generator)
            else:
                order = torch.arange(self._rows)
            order = order.to(self.device)
            for start in range(0, self._rows - self.batch_size + 1, self.batch_size):
                indices = order[start:start + self.batch_size]
                yield {name: col[indices] for name, col in self._columns.items()}

    def __iter__(self):
        # re-iteration is always allowed (the rows are in memory and the
        # reader already stopped), and the batches are already on the device
        if self._in_iter:
            raise RuntimeError('Concurrent iteration of a loader is not allowed')
        self._in_iter = True
        try:
            yield from self._iter_impl()
        finally:
            self._in_iter = False
