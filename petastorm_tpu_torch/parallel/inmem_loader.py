"""InMemTorchLoader: load a dataset once, then serve seeded epochs of batches
with no further host IO. The counterpart of
``petastorm_tpu.parallel.inmem_loader.InMemJaxLoader`` for one device.

- The fill reads the reader to its end (or ``rows_capacity`` rows) through
  the streaming path's columnar chunks and sanitizer, then stops the reader.
- At the first epoch the whole dataset goes to ``device`` in one pinned copy
  (the streaming loader's ``upload_columns``), as contiguous tensors, and the
  host copy is dropped.
- Each epoch's index vector comes from J4
  (:func:`~petastorm_tpu_torch.ops.index_shuffle.random_index_shuffle`, keys
  from :func:`~petastorm_tpu_torch.ops.index_shuffle.epoch_round_keys` of
  ``(seed, epoch)``), or ``arange`` without shuffle; each batch is an
  ``index_select`` of a slice of it.
- :meth:`InMemTorchLoader.scan_epochs` runs whole epochs as programs
  (:mod:`~petastorm_tpu_torch.parallel.graphs`): on the card one CUDA graph
  replay per epoch, its steps gathering their batches by static slices of an
  index buffer that the epoch's J4 refills before the replay.

Left for later slices, and absent from the signature: the mesh path
(``mesh``/``partition_spec``, shard-blocked residency and shard-local
shuffles) and the host-only ``device_put=False`` mode.
"""

import warnings

import numpy as np
import torch

from petastorm_tpu_torch.ops.index_shuffle import epoch_round_keys, random_index_shuffle
from petastorm_tpu_torch.parallel.graphs import ProgramCache, StepProgram, program_state
from petastorm_tpu_torch.parallel.loader import (iter_reader_chunks, reader_may_be_infinite,
                                                 resolve_device, sanitize_columns,
                                                 upload_columns)

_FILL_SAFETY_CAP = 100_000_000
#: scan_epochs keeps this many (step_fn, shuffle) programs before evicting
_SCAN_CACHE_MAX = 8


class InMemTorchLoader(object):
    """Fill once from ``reader``, then iterate seeded shuffled batches on
    ``device`` for ``num_epochs`` (None = infinite).

    :param reader: a reader from :func:`petastorm_tpu_torch.make_reader` or
        :func:`~petastorm_tpu_torch.make_batch_reader`, or one without
        ``iter_columnar`` (read through its batches or rows). An NGram reader
        fills window-major: one window is one row in memory, each field
        ``(length, *shape)`` (overlapping windows are materialized: budget
        ``rows x length``).
    :param batch_size: rows per batch.
    :param num_epochs: epochs to serve from memory (None = infinite);
        independent of the reader's own ``num_epochs``, which only governs the
        fill (use reader ``num_epochs=1``).
    :param rows_capacity: stop filling after this many rows (required if the
        reader may be infinite). The reader is stopped after the fill.
    :param shuffle: seeded reshuffle every epoch.
    :param seed: base seed; epoch ``e`` draws its round keys from ``(seed, e)``.
    :param pad_ragged: as in :class:`~petastorm_tpu_torch.parallel.loader.TorchDataLoader`.
    :param drop_last: drop the final partial batch.
    :param device: ``'cuda'`` (default) or ``'cpu'``; CUDA without a card raises.
    """

    def __init__(self, reader, batch_size, num_epochs=1, rows_capacity=None, shuffle=True,
                 seed=0, pad_ragged=None, drop_last=True, device=None):
        if batch_size < 1:
            raise ValueError('batch_size must be >= 1')
        if num_epochs is not None and num_epochs < 1:
            raise ValueError('num_epochs must be >= 1 or None')
        if getattr(reader, 'device_decode_fields', None):
            raise ValueError(
                'InMemTorchLoader does not support device_decode_fields (the fill '
                'materializes DECODED host columns); use TorchDataLoader for the '
                'device decode tail, or drop the knob')
        self.batch_size = batch_size
        self.num_epochs = num_epochs
        self.device = resolve_device(device)
        self._shuffle = shuffle
        self._seed = seed
        self._pad_ragged = dict(pad_ragged or {})
        self._drop_last = drop_last
        self._columns = self._fill(reader, rows_capacity)
        self._num_rows = next(iter(self._columns.values())).shape[0] if self._columns else 0
        if self._num_rows < batch_size and drop_last:
            raise ValueError('Loaded {} rows < batch_size {} with drop_last=True — '
                             'every epoch would be empty'.format(self._num_rows, batch_size))
        self._data = None  # the dataset on the device, uploaded at first use
        # scan_epochs: programs keyed by (step_fn, shuffle), so train and eval
        # variants of one step stay side by side, one index buffer all of them
        # read, and an epoch cursor that repeated calls keep advancing
        self._scan_cache = ProgramCache(
            _SCAN_CACHE_MAX,
            'scan_epochs built {built} distinct (step_fn, shuffle) programs; pass a '
            'stable step_fn object to reuse them')
        self._index = None
        self._scan_epoch = 0

    # ------------------------------------------------------------------ fill

    def _fill(self, reader, rows_capacity):
        if rows_capacity is None and reader_may_be_infinite(reader):
            raise ValueError(
                'rows_capacity is required with a (possibly) infinite reader: '
                'num_epochs=None, a wrapper over one, or a custom reader that does not '
                'advertise finiteness. Pass rows_capacity, or give a custom reader a '
                'num_epochs attribute (any non-None value marks it finite).')
        cap = rows_capacity if rows_capacity is not None else _FILL_SAFETY_CAP
        chunks = []
        rows = 0
        try:
            for columns, n, _ in iter_reader_chunks(reader):
                chunks.append(sanitize_columns(columns, self._pad_ragged))
                rows += n
                if rows >= cap:
                    if rows_capacity is None:
                        warnings.warn(
                            'InMemTorchLoader fill hit the {}-row safety cap without an '
                            'explicit rows_capacity; the dataset is TRUNCATED. Pass '
                            'rows_capacity to make the limit intentional.'
                            .format(_FILL_SAFETY_CAP))
                    break
        finally:
            # stop regardless: an infinite reader would otherwise keep its
            # workers running
            reader.stop()
            reader.join()
        if not chunks:
            return {}
        columns = {name: _concat([c[name] for c in chunks]) for name in chunks[0]}
        if rows_capacity is not None:
            columns = {name: col[:rows_capacity] for name, col in columns.items()}
        return columns

    # ------------------------------------------------------------------ iteration

    def __len__(self):
        """Batches per epoch."""
        if self._drop_last:
            return self._num_rows // self.batch_size
        return -(-self._num_rows // self.batch_size)

    @property
    def num_rows(self):
        return self._num_rows

    def __iter__(self):
        if self._num_rows == 0:
            return
        epoch = 0
        while self.num_epochs is None or epoch < self.num_epochs:
            yield from self._iter_epoch(epoch)
            epoch += 1

    def _device_data(self):
        if self._data is None:
            self._data = upload_columns(self._columns, self.device)
            # nothing reads the host copy again; keeping it would hold the
            # dataset twice
            self._columns = None
        return self._data

    def _epoch_indices(self, epoch, shuffle=None):
        """The index vector of epoch ``epoch`` on the device: J4's permutation
        of ``[0, num_rows)`` under the epoch's round keys, or ``arange``
        without shuffle (``shuffle=None`` takes the loader's setting)."""
        shuffle = self._shuffle if shuffle is None else shuffle
        positions = torch.arange(self._num_rows, device=self.device)
        if not shuffle:
            return positions
        return random_index_shuffle(positions, epoch_round_keys(self._seed, epoch),
                                    self._num_rows)

    def _iter_epoch(self, epoch):
        data = self._device_data()
        n = self._num_rows
        idx_all = self._epoch_indices(epoch)
        limit = n - self.batch_size + 1 if self._drop_last else n
        for start in range(0, limit, self.batch_size):
            idx = idx_all[start:min(start + self.batch_size, n)]
            yield {name: col.index_select(0, idx) for name, col in data.items()}

    # -- whole epochs as one program ----------------------------------------------------

    def scan_epochs(self, step_fn, num_epochs=1, epoch_offset=None, shuffle=None, state=None):
        """Run whole training epochs, each as one program: on the card one
        replay of a CUDA graph that holds every step of the epoch (the
        counterpart of the JAX package's ``lax.scan`` under ``jit``: one host
        dispatch per epoch); on ``device='cpu'`` the same steps eagerly.

        Each epoch's J4 runs eagerly (its cycle walk reads back to the host)
        and is copied into the static index buffer that the graph's steps
        slice. Repeated calls with the same ``step_fn`` object reuse its
        program and continue the epoch sequence where the previous call
        stopped (``epoch_offset`` pins the first epoch without moving that
        cursor).

        :param step_fn: ``step_fn(batch) -> aux``: one train step over a dict
            of ``(batch_size, ...)`` tensors, mutating the model and optimizer
            in place (see :mod:`~petastorm_tpu_torch.parallel.graphs` for what
            a captured step may do).
        :param num_epochs: epochs to run.
        :param epoch_offset: epoch index of the first epoch (selects its round
            keys); default continues the loader's cursor.
        :param shuffle: override the loader's shuffle setting for this call.
        :param state: the modules and optimizers ``step_fn`` mutates (required
            on the card, where the capture's warm-up is undone on them).
        :return: a list with, per epoch, the steps' ``aux`` stacked over the
            steps.
        """
        if self._num_rows == 0:
            raise ValueError('scan_epochs on an empty dataset')
        batch_size = self.batch_size
        shuffle = self._shuffle if shuffle is None else shuffle
        n = self._num_rows
        # validate before the upload, which drops the host copy: failing after
        # it would leave the loader unable to iterate
        if n // batch_size == 0:
            raise ValueError('batch_size {} > usable dataset rows {}'.format(batch_size, n))
        if not self._drop_last and n % batch_size != 0:
            raise ValueError(
                'scan_epochs cannot serve the trailing partial batch ({} rows): a '
                'program needs static batch shapes. Use drop_last=True, a divisible '
                'batch_size, or the python iterator.'.format(n % batch_size))
        state = program_state(state, self.device)
        data = self._device_data()
        if self._index is None:
            self._index = torch.empty(n, dtype=torch.int64, device=self.device)
        index = self._index

        def batch_of(i):
            idx = index[i * batch_size:(i + 1) * batch_size]
            return {name: col.index_select(0, idx) for name, col in data.items()}

        key = (step_fn, shuffle)
        program = self._scan_cache.get(
            key, lambda: StepProgram(step_fn, batch_of, n // batch_size, state, self.device))
        start = self._scan_epoch if epoch_offset is None else epoch_offset
        aux_per_epoch = []
        for epoch in range(start, start + num_epochs):
            index.copy_(self._epoch_indices(epoch, shuffle))
            try:
                aux_per_epoch.append(program.run())
            except ValueError:
                self._scan_cache.discard(key)   # a step that cannot be captured
                raise
        if epoch_offset is None:
            # an explicit offset (replay or eval at a pinned epoch) must not
            # move the training cursor
            self._scan_epoch = start + num_epochs
        return aux_per_epoch

    # ------------------------------------------------------------------ lifecycle

    def stop(self):
        pass

    def join(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        pass


def _concat(parts):
    if len(parts) == 1:
        return np.ascontiguousarray(parts[0])
    return np.concatenate(parts, axis=0)
