"""``make_reader``, ``make_batch_reader`` and the Reader runtime: a trimmed
copy of ``petastorm_tpu.reader``.

The reader ventilates one work item per rowgroup and shuffle-row-drop
partition through a thread or dummy worker pool, in the same seeded order as
``petastorm_tpu`` (so both packages emit the same row stream for the same
store, seed and pool type). ``make_reader`` decodes Unischema stores through
their codecs and gives one row namedtuple per ``next()``;
``make_batch_reader`` reads any Parquet store natively and gives one
namedtuple of column arrays per rowgroup. The loader takes whole columnar
batches through :meth:`Reader.iter_columnar`.

Checkpointing is the JAX package's: :meth:`Reader.state_dict` records the
consumed work items per epoch (and a row cursor on the row path), and
``resume_state=`` continues from it. The state's keys and values are those of
``petastorm_tpu``'s, so a state saved by either package resumes a reader of
the other, apart from the ``lineage`` and ``topology`` blocks, which the port
never writes (it has neither plane) and refuses to resume.

Left for later slices, and absent from the signatures: the process pool,
predicates, rowgroup selectors, caches, NGram windows, retries/quarantine,
telemetry and SLOs, lineage, cost scheduling, autotuning, topology
negotiation, ``shard_seed``, the input service and non-local filesystems.
"""

import threading
import warnings

from petastorm_tpu_torch import decode_engine
from petastorm_tpu_torch.errors import MetadataError, NoDataAvailableError
from petastorm_tpu_torch.etl import dataset_metadata
from petastorm_tpu_torch.fs_utils import normalize_dataset_url_or_urls
from petastorm_tpu_torch.reader_worker import ColumnarBatch, RowGroupWorker, WorkerSetup
from petastorm_tpu_torch.unischema import Unischema
from petastorm_tpu_torch.workers import EmptyResultError
from petastorm_tpu_torch.workers.dummy_pool import DummyPool
from petastorm_tpu_torch.workers.thread_pool import ThreadPool
from petastorm_tpu_torch.workers.ventilator import ConcurrentVentilator

#: extra rowgroups kept in flight beyond the worker count
_VENTILATE_EXTRA_ROWGROUPS = 2


def _make_pool(reader_pool_type, workers_count):
    if reader_pool_type == 'thread':
        return ThreadPool(workers_count)
    if reader_pool_type == 'dummy':
        return DummyPool()
    raise ValueError('Unknown reader_pool_type {!r} (expected thread/dummy)'
                     .format(reader_pool_type))


def make_reader(dataset_url_or_urls, schema_fields=None, reader_pool_type='thread',
                workers_count=10, seed=None, shuffle_rows=False, shuffle_row_groups=True,
                shuffle_row_drop_partitions=1, num_epochs=1, cur_shard=None,
                shard_count=None, transform_spec=None, resume_state=None,
                field_overrides=None, device_decode_fields=None):
    """Reader for stores written with a Unischema (by this package or by
    ``petastorm_tpu``): rows decoded through the codecs.

    :param schema_fields: field names or regex patterns to read (default all).
    :param reader_pool_type: ``'thread'`` or ``'dummy'`` (in-line, deterministic).
    :param workers_count: threads of the thread pool.
    :param seed: seeds the rowgroup order and the in-rowgroup row shuffle.
    :param shuffle_rows: shuffle rows inside each rowgroup.
    :param shuffle_row_groups: visit rowgroups in a new seeded order each epoch.
    :param shuffle_row_drop_partitions: split each rowgroup into this many
        work items of equal row ranges (each read separately).
    :param num_epochs: passes over the data; None = forever.
    :param cur_shard: with ``shard_count``, read only rowgroups ``i`` with
        ``i % shard_count == cur_shard``.
    :param transform_spec: a :class:`~petastorm_tpu_torch.transform.TransformSpec`
        applied on the workers (one row dict at a time, or the rowgroup's
        columns with ``batched=True``).
    :param resume_state: a :meth:`Reader.state_dict` (or a loader's) to
        continue from; the other arguments must be those of the saved reader.
    :param field_overrides: :class:`UnischemaField`s replacing same-named
        stored fields for this read.
    :param device_decode_fields: fields whose codec payloads skip host decode:
        workers pass the DCT coefficients / ``.npy`` bytes / raw deflate frames
        through, and :class:`~petastorm_tpu_torch.parallel.loader.TorchDataLoader`
        decodes them on the card. The ``__hw``/``__enc`` auxiliary columns ride
        :meth:`Reader.iter_columnar` batches only.
    """
    dataset_url_or_urls = normalize_dataset_url_or_urls(dataset_url_or_urls)
    handle = dataset_metadata.open_dataset(dataset_url_or_urls)
    schema = dataset_metadata.get_schema(handle)
    if field_overrides:
        schema = _apply_field_overrides(schema, field_overrides)
    return Reader(handle, schema, _make_pool(reader_pool_type, workers_count),
                  schema_fields=schema_fields, seed=seed, shuffle_rows=shuffle_rows,
                  shuffle_row_groups=shuffle_row_groups,
                  shuffle_row_drop_partitions=shuffle_row_drop_partitions,
                  num_epochs=num_epochs, cur_shard=cur_shard, shard_count=shard_count,
                  transform_spec=transform_spec, resume_state=resume_state,
                  device_decode_fields=device_decode_fields)


def make_batch_reader(dataset_url_or_urls, schema_fields=None, reader_pool_type='thread',
                      workers_count=10, seed=None, shuffle_rows=False,
                      shuffle_row_groups=True, shuffle_row_drop_partitions=1,
                      num_epochs=1, cur_shard=None, shard_count=None, transform_spec=None,
                      resume_state=None):
    """Reader for any Parquet store: native columns (no codec decode; a
    ``list<int32>`` column arrives as a list of int32 arrays), one namedtuple
    of column arrays per rowgroup batch. The arguments are :func:`make_reader`'s.

    ``transform_spec.func`` takes a pandas ``DataFrame`` and returns one, or,
    with ``TransformSpec(batched=True)``, takes and returns a dict of columns
    (no pandas needed: the port's defined difference, see
    :mod:`~petastorm_tpu_torch.transform`). On a store written with a
    Unischema it emits the stored (encoded) values, with a warning.
    """
    dataset_url_or_urls = normalize_dataset_url_or_urls(dataset_url_or_urls)
    handle = dataset_metadata.open_dataset(dataset_url_or_urls)
    try:
        dataset_metadata.get_schema(handle)
        warnings.warn('This store was written with a Unischema; use make_reader to get '
                      'codec-decoded rows. make_batch_reader will emit raw stored values.')
    except MetadataError:
        pass
    schema = Unischema.from_arrow_schema(handle.arrow_dataset.schema)
    return Reader(handle, schema, _make_pool(reader_pool_type, workers_count),
                  schema_fields=schema_fields, seed=seed, shuffle_rows=shuffle_rows,
                  shuffle_row_groups=shuffle_row_groups,
                  shuffle_row_drop_partitions=shuffle_row_drop_partitions,
                  num_epochs=num_epochs, cur_shard=cur_shard, shard_count=shard_count,
                  transform_spec=transform_spec, resume_state=resume_state,
                  is_batched_reader=True)


class Reader(object):
    """Schedules work items through a worker pool, iterates the results and
    accounts for every item consumed."""

    def __init__(self, handle, schema, reader_pool, schema_fields=None, seed=None,
                 shuffle_rows=False, shuffle_row_groups=True, shuffle_row_drop_partitions=1,
                 num_epochs=1, cur_shard=None, shard_count=None, transform_spec=None,
                 resume_state=None, is_batched_reader=False, device_decode_fields=None):
        if (cur_shard is None) != (shard_count is None):
            raise ValueError('cur_shard and shard_count must be specified together')
        if cur_shard is not None and not 0 <= cur_shard < shard_count:
            raise ValueError('cur_shard must be in [0, shard_count)')
        self.num_epochs = num_epochs
        self.is_batched_reader = is_batched_reader
        self.schema = schema
        self.last_row_consumed = False
        self._stopped = False
        if schema_fields is not None:
            fields_to_read = list(schema.create_schema_view(schema_fields).fields)
        else:
            fields_to_read = list(schema.fields)
        partition_names = set(handle.partition_field_names)

        self.device_decode_fields = frozenset(device_decode_fields or ())
        if self.device_decode_fields and transform_spec is not None:
            raise ValueError('device_decode_fields and transform_spec are mutually '
                             'exclusive: host transforms need decoded values')
        missing = sorted(self.device_decode_fields - set(fields_to_read))
        if missing:
            raise ValueError('device_decode_fields name fields not in this read: {}'
                             .format(missing))
        in_partition = sorted(self.device_decode_fields & partition_names)
        if in_partition:
            raise ValueError('device_decode_fields cannot name partition keys: {}'
                             .format(in_partition))
        for name in sorted(self.device_decode_fields):
            decode_engine.validate_device_field(schema.fields[name])

        setup = WorkerSetup(handle.filesystem, schema, fields_to_read,
                            transform_spec=transform_spec, batched_output=is_batched_reader,
                            shuffle_rows=shuffle_rows, seed=seed,
                            partition_field_names=partition_names,
                            device_decode_fields=self.device_decode_fields)
        self.result_schema = setup.result_schema

        row_groups = dataset_metadata.load_row_groups(handle)
        if cur_shard is not None:
            row_groups = [rg for i, rg in enumerate(row_groups)
                          if i % shard_count == cur_shard]
        if not row_groups:
            raise NoDataAvailableError(
                'No rowgroups available for shard {} of {}. Use fewer shards or more '
                'files.'.format(cur_shard, shard_count))
        #: the shard configuration a checkpoint must match on resume (the JAX
        #: package's keys; the port has no shard_seed and no topology plane)
        self._shard_config = {'cur_shard': cur_shard, 'shard_count': shard_count,
                              'shard_seed': None, 'topology': False}
        items = [{'piece_index': piece_index,
                  'fragment_path': rg.fragment_path,
                  'row_group_id': rg.row_group_id,
                  'partition_keys': rg.partition_keys,
                  'shuffle_row_drop_partition': (drop, shuffle_row_drop_partitions)}
                 for piece_index, rg in enumerate(row_groups)
                 for drop in range(shuffle_row_drop_partitions)]

        # Consumption is tracked per work item: every item yields exactly one
        # ColumnarBatch, tagged with its absolute epoch and counted when popped
        # off the results queue (on the row path: when its last row is emitted).
        self._items_per_epoch = len(items)
        self._accounting_lock = threading.Lock()
        self._next_lock = threading.Lock()
        self._epochs_consumed = 0
        self._consumed_by_epoch = {}   # absolute epoch -> {(piece, drop)}
        self._resume_fast_forward = {}
        iterations = num_epochs
        skip_by_iteration = None
        if resume_state is not None:
            self._load_resume_state(resume_state)
            skip_by_iteration = {epoch - self._epochs_consumed: set(ids)
                                 for epoch, ids in self._consumed_by_epoch.items()}
            if num_epochs is not None:
                iterations = num_epochs - self._epochs_consumed
                if iterations <= 0:
                    raise ValueError('resume_state shows all {} epochs already consumed'
                                     .format(num_epochs))

        self._ventilator = ConcurrentVentilator(
            ventilate_fn=reader_pool.ventilate,
            items_to_ventilate=items,
            iterations=iterations,
            max_ventilation_queue_size=reader_pool.workers_count
            + _VENTILATE_EXTRA_ROWGROUPS,
            randomize_item_order=shuffle_row_groups,
            random_seed=seed,
            pre_shuffle_count=self._epochs_consumed,
            skip_ids_by_iteration=skip_by_iteration,
            item_id_fn=_item_id,
            reset_iterations=num_epochs)
        self._pool = reader_pool
        self._pool.start(RowGroupWorker, setup, self._ventilator)
        results_reader = _BatchResultsReader if is_batched_reader else _RowResultsReader
        self._results_reader = results_reader(self.result_schema,
                                              on_batch=self._note_item_consumed,
                                              fast_forward=self._resume_fast_forward)

    # --------------------------------------------------------------- iteration

    def __iter__(self):
        return self

    def __next__(self):
        """One row namedtuple (batch reader: one namedtuple of column arrays)."""
        if self._stopped:
            raise RuntimeError('Trying to read a sample from a stopped reader')
        try:
            with self._next_lock:
                return self._results_reader.read_next(self._pool)
        except EmptyResultError:
            self.last_row_consumed = True
            raise StopIteration

    def iter_columnar(self, include_empty=False):
        """Iterate the :class:`~petastorm_tpu_torch.reader_worker.ColumnarBatch`
        results straight off the pool (one per work item), skipping the per-row
        namedtuples of ``next()``. Do not interleave with ``next()``.
        ``include_empty`` also yields zero-row batches (an item a transform
        emptied): delivery-exact checkpointing must see every item."""
        while True:
            if self._stopped:
                raise RuntimeError('Trying to read from a stopped reader')
            try:
                batch = self._pool.get_results()
            except EmptyResultError:
                self.last_row_consumed = True
                return
            self._note_item_consumed(batch)
            if self._resume_fast_forward and batch.item_id is not None:
                # honour a row-path checkpoint's cursor: skip the rows already
                # emitted before the checkpoint
                start = self._resume_fast_forward.pop(batch.item_id, 0)
                if start:
                    batch = _slice_batch(batch, start)
            if batch.num_rows or include_empty:
                yield batch

    def reset(self):
        """Re-ventilate for another ``num_epochs`` pass; only after full
        consumption."""
        if not self.last_row_consumed:
            raise NotImplementedError('Currently reset() can only be called after the '
                                      'reader was fully consumed')
        self._results_reader.reset()
        self._ventilator.reset()
        self.last_row_consumed = False

    # ------------------------------------------------------- checkpoint / resume

    def _note_item_consumed(self, batch):
        item_id = batch.item_id
        if item_id is None:
            return
        epoch, piece, drop = item_id
        with self._accounting_lock:
            self._consumed_by_epoch.setdefault(epoch, set()).add((piece, drop))
            # epochs close strictly in order; later epochs' items wait in their
            # own sets until the earlier epoch's stragglers are popped
            while (len(self._consumed_by_epoch.get(self._epochs_consumed, ()))
                   >= self._items_per_epoch):
                del self._consumed_by_epoch[self._epochs_consumed]
                self._epochs_consumed += 1

    def _load_resume_state(self, state):
        if not isinstance(state, dict) or state.get('version') != 1:
            raise ValueError('Unrecognized resume_state {!r}'.format(state))
        saved_shard = state.get('shard_config')
        if saved_shard is not None and saved_shard != self._shard_config:
            raise ValueError(
                'resume_state was captured under shard config {!r}, but this reader is '
                'configured with {!r}; resuming would silently replay the wrong row '
                'stream. Rebuild with the original sharding'
                .format(saved_shard, self._shard_config))
        if state.get('topology') is not None:
            raise ValueError('resume_state was captured by a topology-armed reader; the '
                             'port has no topology plane to restore it through')
        if state['items_per_epoch'] != self._items_per_epoch:
            raise ValueError(
                'resume_state was captured from a reader with {} work items per epoch, '
                'but this reader has {}: dataset contents, sharding or '
                'shuffle_row_drop_partitions differ'
                .format(state['items_per_epoch'], self._items_per_epoch))
        self._epochs_consumed = int(state['epochs_consumed'])
        self._consumed_by_epoch = {
            self._epochs_consumed + int(offset): {tuple(item) for item in ids}
            for offset, ids in state['consumed_by_epoch'].items()}
        cursor = state.get('row_cursor')
        if cursor is not None:
            # the partially emitted item is not in the consumed sets, so it
            # re-ventilates in its epoch; its first next_row rows are skipped
            key = (self._epochs_consumed + int(cursor['epoch_offset']),
                   int(cursor['piece']), int(cursor['drop']))
            self._resume_fast_forward[key] = int(cursor['next_row'])

    def state_dict(self):
        """Snapshot of the read position, resumable through ``make_reader(...,
        resume_state=state)`` (or ``make_batch_reader``) with the same
        construction arguments. The same dict as ``petastorm_tpu``'s
        ``Reader.state_dict`` (without its ``lineage`` and ``topology``
        blocks).

        The unit is the work item (rowgroup x drop partition): an item counts
        as consumed once all its rows were emitted (``consumed_by_epoch`` maps
        epoch offsets to consumed ``[piece, drop]`` items; several epochs can be
        partly consumed at once). Taken mid-item on the row path, the state
        also holds a ``row_cursor`` (item and next row) and resume continues at
        that row: exact when the in-item row order is reproducible
        (``shuffle_rows=False`` or a fixed ``seed``). Results published by
        workers but not yet popped are read again. Call from the consuming
        thread, between ``next()`` calls."""
        cursor = None
        if isinstance(self._results_reader, _RowResultsReader):
            with self._next_lock:
                cursor = self._results_reader.cursor()
        with self._accounting_lock:
            state = {
                'version': 1,
                'items_per_epoch': self._items_per_epoch,
                'epochs_consumed': self._epochs_consumed,
                'consumed_by_epoch': {
                    epoch - self._epochs_consumed: sorted(ids)
                    for epoch, ids in self._consumed_by_epoch.items()},
                'shard_config': dict(self._shard_config),
            }
            if cursor is not None:
                (epoch, piece, drop), next_row = cursor
                state['row_cursor'] = {'epoch_offset': epoch - self._epochs_consumed,
                                       'piece': piece, 'drop': drop,
                                       'next_row': next_row}
            return state

    @property
    def items_per_epoch(self):
        """Work items (rowgroups x drop partitions) of this shard per epoch."""
        return self._items_per_epoch

    # --------------------------------------------------------------- lifecycle

    def stop(self):
        self._stopped = True
        self._pool.stop()

    def join(self):
        self._pool.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        self.join()


def _item_id(item):
    """Identity of a ventilated work item for consumption accounting."""
    return (item['piece_index'], item['shuffle_row_drop_partition'][0])


def _slice_batch(batch, start):
    """Drop the first ``start`` rows of a ColumnarBatch (row-cursor fast-forward)."""
    return ColumnarBatch({name: col[start:] for name, col in batch.columns.items()},
                         max(batch.num_rows - start, 0), item_id=batch.item_id)


def _apply_field_overrides(schema, field_overrides):
    by_name = {f.name: f for f in field_overrides}
    unknown = sorted(set(by_name) - set(schema.fields))
    if unknown:
        raise ValueError('field_overrides name fields not in the schema: {}'
                         .format(unknown))
    return Unischema(schema.name,
                     [by_name.get(name, field) for name, field in schema.fields.items()])


class _RowResultsReader(object):
    """Buffers a ColumnarBatch and pops one namedtuple per read. An item is
    acknowledged (``on_batch``) only once its last row was emitted, so a
    checkpoint taken mid-item leaves it unconsumed and :meth:`cursor` names
    the row to resume at; ``fast_forward`` maps ``item_id -> start_row`` for
    replaying such a cursor."""

    def __init__(self, result_schema, on_batch=None, fast_forward=None):
        self._namedtuple = result_schema.namedtuple
        self._field_names = list(result_schema.fields)
        self._on_batch = on_batch
        self._fast_forward = fast_forward if fast_forward is not None else {}
        self.reset()

    def read_next(self, pool):
        while self._columns is None or self._next_row >= self._num_rows:
            batch = pool.get_results()
            item_id = batch.item_id
            start_row = self._fast_forward.pop(item_id, 0) if item_id is not None else 0
            if batch.num_rows == 0 or start_row >= batch.num_rows:
                # nothing (left) to emit: consumed the moment it is popped
                self._on_batch(batch)
                self._columns = None
                continue
            self._columns = [batch.columns[name] for name in self._field_names]
            self._num_rows = batch.num_rows
            self._next_row = start_row
            self._current_batch = batch
        i = self._next_row
        self._next_row = i + 1
        if self._next_row >= self._num_rows:
            self._on_batch(self._current_batch)
        return self._namedtuple._make([col[i] for col in self._columns])

    def cursor(self):
        """``(item_id, next_row)`` of the partly emitted buffered batch, or None."""
        if self._columns is not None and self._next_row < self._num_rows:
            item_id = self._current_batch.item_id
            if item_id is not None:
                return item_id, self._next_row
        return None

    def reset(self):
        self._columns = None
        self._num_rows = 0
        self._next_row = 0
        self._current_batch = None


class _BatchResultsReader(object):
    """Emits one namedtuple of column arrays per non-empty batch; a
    ``fast_forward`` entry (a row-path checkpoint's cursor) slices its batch."""

    def __init__(self, result_schema, on_batch=None, fast_forward=None):
        self._schema = result_schema
        self._on_batch = on_batch
        self._fast_forward = fast_forward if fast_forward is not None else {}

    def read_next(self, pool):
        while True:
            batch = pool.get_results()
            self._on_batch(batch)
            if self._fast_forward and batch.item_id is not None:
                start = self._fast_forward.pop(batch.item_id, 0)
                if start:
                    batch = _slice_batch(batch, start)
            if batch.num_rows:
                return self._schema.make_namedtuple(
                    **{name: batch.columns[name] for name in self._schema.fields})

    def reset(self):
        pass
