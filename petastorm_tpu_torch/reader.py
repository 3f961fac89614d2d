"""``make_reader`` and the Reader runtime: a trimmed copy of
``petastorm_tpu.reader`` for Unischema stores.

The reader ventilates one work item per rowgroup through a thread or dummy
worker pool, rowgroups in the same seeded order as ``petastorm_tpu`` (so both
packages emit the same row stream for the same store, seed and pool type).
Rows come out one namedtuple per ``next()``; the loader takes whole columnar
batches through :meth:`Reader.iter_columnar`.

Left for later slices, and absent from the signature: ``make_batch_reader``,
the process pool, predicates, rowgroup selectors, transform specs, caches,
NGram windows, resume state, retries/quarantine, telemetry and SLOs, lineage,
cost scheduling, autotuning, topology negotiation, the input service and
non-local filesystems.
"""

import threading

from petastorm_tpu_torch import decode_engine
from petastorm_tpu_torch.errors import NoDataAvailableError
from petastorm_tpu_torch.etl import dataset_metadata
from petastorm_tpu_torch.fs_utils import normalize_dataset_url_or_urls
from petastorm_tpu_torch.reader_worker import RowGroupWorker, WorkerSetup
from petastorm_tpu_torch.unischema import Unischema
from petastorm_tpu_torch.workers import EmptyResultError
from petastorm_tpu_torch.workers.dummy_pool import DummyPool
from petastorm_tpu_torch.workers.thread_pool import ThreadPool
from petastorm_tpu_torch.workers.ventilator import ConcurrentVentilator

#: extra rowgroups kept in flight beyond the worker count
_VENTILATE_EXTRA_ROWGROUPS = 2


def make_reader(dataset_url_or_urls, schema_fields=None, reader_pool_type='thread',
                workers_count=10, seed=None, shuffle_rows=False, shuffle_row_groups=True,
                num_epochs=1, cur_shard=None, shard_count=None, field_overrides=None,
                device_decode_fields=None):
    """Reader for stores written with a Unischema (by this package or by
    ``petastorm_tpu``): rows decoded through the codecs.

    :param schema_fields: field names or regex patterns to read (default all).
    :param reader_pool_type: ``'thread'`` or ``'dummy'`` (in-line, deterministic).
    :param workers_count: threads of the thread pool.
    :param seed: seeds the rowgroup order and the in-rowgroup row shuffle.
    :param shuffle_rows: shuffle rows inside each rowgroup.
    :param shuffle_row_groups: visit rowgroups in a new seeded order each epoch.
    :param num_epochs: passes over the data; None = forever.
    :param cur_shard: with ``shard_count``, read only rowgroups ``i`` with
        ``i % shard_count == cur_shard``.
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
    if reader_pool_type == 'thread':
        pool = ThreadPool(workers_count)
    elif reader_pool_type == 'dummy':
        pool = DummyPool()
    else:
        raise ValueError('Unknown reader_pool_type {!r} (expected thread/dummy)'
                         .format(reader_pool_type))
    return Reader(handle, schema, pool, schema_fields=schema_fields, seed=seed,
                  shuffle_rows=shuffle_rows, shuffle_row_groups=shuffle_row_groups,
                  num_epochs=num_epochs, cur_shard=cur_shard, shard_count=shard_count,
                  device_decode_fields=device_decode_fields)


class Reader(object):
    """Schedules rowgroups through a worker pool and iterates the results."""

    def __init__(self, handle, schema, reader_pool, schema_fields=None, seed=None,
                 shuffle_rows=False, shuffle_row_groups=True, num_epochs=1,
                 cur_shard=None, shard_count=None, device_decode_fields=None):
        if (cur_shard is None) != (shard_count is None):
            raise ValueError('cur_shard and shard_count must be specified together')
        if cur_shard is not None and not 0 <= cur_shard < shard_count:
            raise ValueError('cur_shard must be in [0, shard_count)')
        self.num_epochs = num_epochs
        self.schema = schema
        self.last_row_consumed = False
        self._stopped = False
        if schema_fields is not None:
            fields_to_read = list(schema.create_schema_view(schema_fields).fields)
        else:
            fields_to_read = list(schema.fields)
        partition_names = set(handle.partition_field_names)

        self.device_decode_fields = frozenset(device_decode_fields or ())
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
        items = [{'piece_index': piece_index,
                  'fragment_path': rg.fragment_path,
                  'row_group_id': rg.row_group_id,
                  'partition_keys': rg.partition_keys}
                 for piece_index, rg in enumerate(row_groups)]
        self._ventilator = ConcurrentVentilator(
            ventilate_fn=reader_pool.ventilate,
            items_to_ventilate=items,
            iterations=num_epochs,
            max_ventilation_queue_size=reader_pool.workers_count
            + _VENTILATE_EXTRA_ROWGROUPS,
            randomize_item_order=shuffle_row_groups,
            random_seed=seed)
        self._pool = reader_pool
        self._pool.start(RowGroupWorker, setup, self._ventilator)
        self._next_lock = threading.Lock()
        self._row_columns = None
        self._row_count = 0
        self._next_row = 0

    def __iter__(self):
        return self

    def __next__(self):
        """One row namedtuple of the read's schema fields."""
        if self._stopped:
            raise RuntimeError('Trying to read a sample from a stopped reader')
        with self._next_lock:
            while self._row_columns is None or self._next_row >= self._row_count:
                try:
                    batch = self._pool.get_results()
                except EmptyResultError:
                    self.last_row_consumed = True
                    raise StopIteration
                if batch.num_rows:
                    self._row_columns = [batch.columns[name]
                                         for name in self.result_schema.fields]
                    self._row_count = batch.num_rows
                    self._next_row = 0
            i = self._next_row
            self._next_row += 1
            return self.result_schema.namedtuple._make(
                [col[i] for col in self._row_columns])

    def iter_columnar(self):
        """Iterate the non-empty :class:`~petastorm_tpu_torch.reader_worker.ColumnarBatch`
        results straight off the pool (one per rowgroup), skipping the per-row
        namedtuples of ``next()``. Do not interleave with ``next()``."""
        while True:
            if self._stopped:
                raise RuntimeError('Trying to read from a stopped reader')
            try:
                batch = self._pool.get_results()
            except EmptyResultError:
                self.last_row_consumed = True
                return
            if batch.num_rows:
                yield batch

    def reset(self):
        """Re-ventilate for another ``num_epochs`` pass; only after full
        consumption."""
        if not self.last_row_consumed:
            raise NotImplementedError('Currently reset() can only be called after the '
                                      'reader was fully consumed')
        self._row_columns = None
        self._ventilator.reset()
        self.last_row_consumed = False

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


def _apply_field_overrides(schema, field_overrides):
    by_name = {f.name: f for f in field_overrides}
    unknown = sorted(set(by_name) - set(schema.fields))
    if unknown:
        raise ValueError('field_overrides name fields not in the schema: {}'
                         .format(unknown))
    return Unischema(schema.name,
                     [by_name.get(name, field) for name, field in schema.fields.items()])
