"""Arrow-table batching queue: a FIFO of tables re-chunked into tables of a
fixed row count; a copy of ``petastorm_tpu.arrow_helpers``."""

from collections import deque

import pyarrow as pa


class BatchingTableQueue(object):
    """``put`` arbitrary-size tables, ``get`` tables of exactly ``batch_size`` rows."""

    def __init__(self, batch_size):
        if batch_size < 1:
            raise ValueError('batch_size must be >= 1')
        self._batch_size = batch_size
        self._batches = deque()
        self._head_offset = 0
        self._buffered_rows = 0

    def put(self, table):
        for batch in table.to_batches():
            if batch.num_rows:
                self._batches.append(batch)
                self._buffered_rows += batch.num_rows

    def empty(self):
        return self._buffered_rows < self._batch_size

    def get(self):
        if self.empty():
            raise ValueError('Not enough rows buffered: {} < {}'
                             .format(self._buffered_rows, self._batch_size))
        needed = self._batch_size
        parts = []
        while needed > 0:
            head = self._batches[0]
            available = head.num_rows - self._head_offset
            take = min(available, needed)
            parts.append(head.slice(self._head_offset, take))
            needed -= take
            self._head_offset += take
            if self._head_offset >= head.num_rows:
                self._batches.popleft()
                self._head_offset = 0
        self._buffered_rows -= self._batch_size
        return pa.Table.from_batches(parts)
