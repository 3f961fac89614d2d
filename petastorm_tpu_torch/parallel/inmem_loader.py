"""InMemTorchLoader: load a dataset once, then serve seeded epochs of batches
with no further host IO. The counterpart of
``petastorm_tpu.parallel.inmem_loader.InMemJaxLoader``.

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

With a ``mesh`` (a ``DeviceMesh``), as in the JAX package:

- ``__iter__`` keeps the dataset on the host and draws each epoch's order
  from ``np.random.RandomState((seed + epoch) % 2**31).permutation``; each
  batch is uploaded and made a ``DTensor`` from this rank's rows with the
  placements of ``partition_spec``
  (:class:`~petastorm_tpu_torch.parallel.loader.FieldShardings`).
  ``device_put=False`` yields the same batches as host numpy, with or
  without a mesh.
- ``scan_epochs`` takes the loader's rows as the whole dataset (every rank
  along the batch dimension fills the same rows: an unsharded reader) and
  keeps one block of it, shard-blocked residency: the batch dimension has
  ``num_shards`` ranks, each holding rows ``[shard * rows_per_shard, (shard +
  1) * rows_per_shard)`` with ``rows_per_shard = n // num_shards`` (the
  trailing rows are dropped, with a warning). Each epoch shuffles each
  block on its own (J9): J4 over ``rows_per_shard`` with round keys of
  ``(seed, epoch, shard)``; each step gathers ``batch_size / num_shards``
  rows of the rank's own block, and ``step_fn`` sees the global batch as a
  ``DTensor`` with ``Shard(0)`` over the batch dimension. No row leaves its
  shard and no collective runs in the input path.
"""

import warnings

import numpy as np
import torch

from petastorm_tpu_torch.ops.index_shuffle import epoch_round_keys, random_index_shuffle
from petastorm_tpu_torch.parallel.graphs import ProgramCache, StepProgram, program_state
from petastorm_tpu_torch.parallel.loader import (FieldShardings, iter_reader_chunks,
                                                 reader_may_be_infinite, resolve_device,
                                                 resolve_shardings, sanitize_columns,
                                                 upload_columns)
from petastorm_tpu_torch.parallel.mesh import PartitionSpec

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
    :param batch_size: rows per batch (this rank's with a mesh; ``scan_epochs``
        over a mesh: the global batch, divisible by the batch dimension).
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
    :param mesh: optional ``DeviceMesh`` on the loader's device type (see the
        module docstring).
    :param partition_spec: as in
        :class:`~petastorm_tpu_torch.parallel.loader.TorchDataLoader`;
        ``scan_epochs`` takes only None or a spec of one mesh dimension.
    :param device_put: False yields host numpy batches (``scan_epochs``
        refuses it).
    """

    def __init__(self, reader, batch_size, num_epochs=1, rows_capacity=None, shuffle=True,
                 seed=0, pad_ragged=None, drop_last=True, device=None, mesh=None,
                 partition_spec=None, device_put=True):
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
        self._mesh = mesh
        self._partition_spec = partition_spec
        self._shardings = resolve_shardings(mesh, partition_spec, self.device)
        self._device_put = device_put
        self._shuffle = shuffle
        self._seed = seed
        self._pad_ragged = dict(pad_ragged or {})
        self._drop_last = drop_last
        self._columns = self._fill(reader, rows_capacity)
        self._num_rows = next(iter(self._columns.values())).shape[0] if self._columns else 0
        if self._num_rows < batch_size and drop_last:
            raise ValueError('Loaded {} rows < batch_size {} with drop_last=True — '
                             'every epoch would be empty'.format(self._num_rows, batch_size))
        self._data = None  # the dataset (or this rank's block) on the device
        self._shard = None  # (shard, num_shards) of the block scan_epochs holds
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
            if self._device_put and self._mesh is None:
                yield from self._iter_epoch(epoch)
            else:
                yield from self._iter_epoch_host(epoch)
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
        of the rows this rank holds under the epoch's round keys (with
        ``scan_epochs``' block over a mesh: the shard's rows and keys), or
        ``arange`` without shuffle (``shuffle=None`` takes the loader's
        setting)."""
        shuffle = self._shuffle if shuffle is None else shuffle
        shard, num_shards = self._shard or (None, 1)
        rows = self._num_rows // num_shards
        positions = torch.arange(rows, device=self.device)
        if not shuffle:
            return positions
        keys = (epoch_round_keys(self._seed, epoch) if shard is None
                else epoch_round_keys(self._seed, epoch, shard=shard))
        return random_index_shuffle(positions, keys, rows)

    def _iter_epoch(self, epoch):
        data = self._device_data()
        n = self._num_rows
        idx_all = self._epoch_indices(epoch)
        limit = n - self.batch_size + 1 if self._drop_last else n
        for start in range(0, limit, self.batch_size):
            idx = idx_all[start:min(start + self.batch_size, n)]
            yield {name: col.index_select(0, idx) for name, col in data.items()}

    def _iter_epoch_host(self, epoch):
        """The mesh and host path: the JAX package's numpy permutation of the
        host rows, each batch gathered on the host, then uploaded and made
        ``DTensor`` s (``device_put``)."""
        if self._columns is None:
            raise RuntimeError(
                'Python iteration is unavailable after scan_epochs moved the dataset to '
                'the device (the host copy is dropped to avoid holding it twice); keep '
                'using scan_epochs, or build a separate loader for iteration')
        n = self._num_rows
        if self._shuffle:
            perm = np.random.RandomState((self._seed + epoch) % (2 ** 31)).permutation(n)
        else:
            perm = np.arange(n)
        limit = n - self.batch_size + 1 if self._drop_last else n
        for start in range(0, limit, self.batch_size):
            idx = perm[start:start + self.batch_size]
            batch = {name: np.ascontiguousarray(col[idx]) for name, col in self._columns.items()}
            if self._device_put:
                batch = self._shardings.distribute(upload_columns(batch, self.device))
            yield batch

    # -- whole epochs as one program ----------------------------------------------------

    def _batch_axis(self):
        """The mesh dimension that splits the batch for ``scan_epochs``: the
        mesh's first, or the one a single-dimension ``partition_spec`` names
        (a dict of specs has no single batch layout to scan over)."""
        if self._partition_spec is None:
            return self._mesh.mesh_dim_names[0]
        try:
            (axis,) = tuple(self._partition_spec)
        except (TypeError, ValueError):
            axis = None
        if isinstance(axis, str) and axis in self._mesh.mesh_dim_names:
            return axis
        raise ValueError('scan_epochs over a mesh supports partition_spec=None or a '
                         'single-axis PartitionSpec(axis); got {!r}'.format(self._partition_spec))

    def _sharded_data(self, axis):
        """Upload this rank's block of the dataset (shard-blocked residency)."""
        if self._data is None:
            num_shards = self._mesh[axis].size()
            shard = self._mesh.get_local_rank(axis)
            rows = self._num_rows // num_shards
            usable = num_shards * rows
            if usable < self._num_rows:
                warnings.warn('scan_epochs drops {} trailing rows so the dataset splits '
                              'evenly over the {} batch-axis shards'
                              .format(self._num_rows - usable, num_shards))
            block = {name: col[shard * rows:(shard + 1) * rows]
                     for name, col in self._columns.items()}
            self._data = upload_columns(block, self.device)
            self._shard = (shard, num_shards)
            self._columns = None
        return self._data

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

        Over a mesh the dataset resides shard-blocked and each block is
        shuffled on its own (J9, see the module docstring): ``batch_size``
        must be divisible by the batch dimension's size, and a
        ``partition_spec`` must be None or name one mesh dimension.

        :param step_fn: ``step_fn(batch) -> aux``: one train step over a dict
            of ``(batch_size, ...)`` tensors (``DTensor`` s over a mesh),
            mutating the model and optimizer in place (see
            :mod:`~petastorm_tpu_torch.parallel.graphs` for what a captured
            step may do).
        :param num_epochs: epochs to run.
        :param epoch_offset: epoch index of the first epoch (selects its round
            keys); default continues the loader's cursor.
        :param shuffle: override the loader's shuffle setting for this call.
        :param state: the modules and optimizers ``step_fn`` mutates (required
            on the card, where the capture's warm-up is undone on them).
        :return: a list with, per epoch, the steps' ``aux`` stacked over the
            steps.
        """
        if not self._device_put:
            raise ValueError('scan_epochs requires device_put=True')
        if self._num_rows == 0:
            raise ValueError('scan_epochs on an empty dataset')
        batch_size = self.batch_size
        shuffle = self._shuffle if shuffle is None else shuffle
        # validate before the upload, which drops the host copy: failing after
        # it would leave the loader unable to iterate
        if self._mesh is not None:
            axis = self._batch_axis()
            num_shards = self._mesh[axis].size()
            if batch_size % num_shards:
                raise ValueError('scan_epochs over a mesh needs batch_size ({}) divisible by '
                                 'the batch mesh axis size ({})'.format(batch_size, num_shards))
            n = num_shards * (self._num_rows // num_shards)
        else:
            n, num_shards = self._num_rows, 1
        if n // batch_size == 0:
            raise ValueError('batch_size {} > usable dataset rows {}'.format(batch_size, n))
        if not self._drop_last and self._num_rows % batch_size != 0:
            raise ValueError(
                'scan_epochs cannot serve the trailing partial batch ({} rows): a '
                'program needs static batch shapes. Use drop_last=True, a divisible '
                'batch_size, or the python iterator.'.format(self._num_rows % batch_size))
        state = program_state(state, self.device)
        if self._mesh is None:
            data, distribute = self._device_data(), None
        else:
            data = self._sharded_data(axis)
            distribute = FieldShardings(self._mesh, PartitionSpec(axis)).distribute
        local_batch = batch_size // num_shards
        if self._index is None:
            self._index = torch.empty(n // num_shards, dtype=torch.int64, device=self.device)
        index = self._index

        def batch_of(i):
            idx = index[i * local_batch:(i + 1) * local_batch]
            batch = {name: col.index_select(0, idx) for name, col in data.items()}
            return batch if distribute is None else distribute(batch)

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
