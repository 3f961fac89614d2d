"""``make_reader``, ``make_batch_reader`` and the Reader runtime: a trimmed
copy of ``petastorm_tpu.reader``.

The reader ventilates one work item per rowgroup and shuffle-row-drop
partition through a thread, process or dummy worker pool, in the same seeded
order as ``petastorm_tpu`` (so both packages emit the same row stream for the
same store, seed and pool type). The process pool
(:mod:`~petastorm_tpu_torch.workers.process_pool`) spawns its workers as fresh
interpreters that load no torch, and brings their results back through a
shared-memory ring. ``make_reader`` decodes Unischema stores through
their codecs and gives one row namedtuple per ``next()``;
``make_batch_reader`` reads any Parquet store natively and gives one
namedtuple of column arrays per rowgroup. The loader takes whole columnar
batches through :meth:`Reader.iter_columnar`.

The row-space features are the JAX package's, with the same names and
results: ``predicate=`` (:mod:`~petastorm_tpu_torch.predicates`; the worker
reads the predicate's columns first and the others only for the rows kept; a
predicate on partition keys only prunes rowgroups here, before any worker
runs), ``rowgroup_selector=`` over the indexes of
:mod:`~petastorm_tpu_torch.etl.rowgroup_indexing`
(:mod:`~petastorm_tpu_torch.selectors`), ``schema_fields=NGram(...)`` for
windows of consecutive rows (:mod:`~petastorm_tpu_torch.ngram`; one
``{offset: namedtuple}`` per ``next()``, window-major arrays from
:meth:`Reader.iter_columnar`), and the local-disk rowgroup cache
(``cache_type='local-disk'``, :mod:`~petastorm_tpu_torch.cache`).

Checkpointing is the JAX package's: :meth:`Reader.state_dict` records the
consumed work items per epoch (and a row or window cursor on the row and
NGram paths), and ``resume_state=`` continues from it. The state's keys and
values are those of ``petastorm_tpu``'s, so a state saved by either package
resumes a reader of the other, apart from the ``lineage`` and ``topology``
blocks, which the port never writes (it has neither plane) and refuses to
resume.

Resilience is the JAX package's (:mod:`~petastorm_tpu_torch.resilience`):
``on_error='retry'`` retries transient IO failures of dataset open, rowgroup
enumeration and rowgroup loads under ``retry_policy``; ``'skip'`` also
quarantines a rowgroup that still fails (an empty stand-in batch carries its
record, so it counts as consumed in ``state_dict``), and the process pool's
watchdog quarantines one whose worker overruns ``item_deadline_s``. Retries,
the quarantine ledger, tripped breakers and the process pool's counters show
in :attr:`Reader.diagnostics`.

Telemetry is the JAX package's (:mod:`~petastorm_tpu_torch.telemetry`): the
workers' stage spans and flight-recorder events ride each batch's sidecars
and merge into the reader's registry and the process recorder, so
:meth:`Reader.telemetry_snapshot` and :meth:`Reader.dump_trace` cover every
process. ``trace=`` arms the flight recorder, ``metrics_port=`` serves
``/metrics``, ``/healthz`` and ``/vars`` on ``127.0.0.1``, ``slo_policy=``
sets the input-efficiency target of :meth:`Reader.efficiency_report`, and
``autotune=`` starts the closed-loop knob controller
(:mod:`~petastorm_tpu_torch.autotune`; :meth:`Reader.autotune_report`).

Left for later slices, and absent from the signatures: the cost model and
cost scheduling, lineage, incidents, run history, topology negotiation,
``shard_seed``, the input service, the cache's bypass breaker and non-local
filesystems (``filesystem=`` takes a local or wrapped
``pyarrow.fs.FileSystem``).
"""

import logging
import threading
import warnings

from petastorm_tpu_torch import decode_engine
from petastorm_tpu_torch.cache import ArrowIpcDiskCache, LocalDiskCache, NullCache
from petastorm_tpu_torch.errors import MetadataError, NoDataAvailableError
from petastorm_tpu_torch.etl import dataset_metadata
from petastorm_tpu_torch.fs_utils import normalize_dataset_url_or_urls
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.reader_worker import (ColumnarBatch, RowGroupWorker, WorkerSetup,
                                               hang_stand_in_factory)
from petastorm_tpu_torch.resilience import (QuarantineLedger, QuarantineRecord,
                                            resolve_retry_policy, run_with_retry)
from petastorm_tpu_torch.telemetry.tracing import (merge_trace_events, set_trace_enabled,
                                                   trace_enabled, trace_instant)
from petastorm_tpu_torch.unischema import Unischema
from petastorm_tpu_torch.workers import EmptyResultError
from petastorm_tpu_torch.workers.dummy_pool import DummyPool
from petastorm_tpu_torch.workers.thread_pool import ThreadPool
from petastorm_tpu_torch.workers.ventilator import ConcurrentVentilator

logger = logging.getLogger(__name__)

#: extra rowgroups kept in flight beyond the worker count
_VENTILATE_EXTRA_ROWGROUPS = 2


def _make_pool(reader_pool_type, workers_count, results_queue_size=50,
               shm_transport=None, item_deadline_s=None, heartbeat_interval_s=None):
    if reader_pool_type == 'thread':
        return ThreadPool(workers_count, results_queue_size)
    if reader_pool_type == 'process':
        from petastorm_tpu_torch.workers.process_pool import ProcessPool
        kwargs = {}
        if heartbeat_interval_s is not None:
            kwargs['heartbeat_interval_s'] = heartbeat_interval_s
        return ProcessPool(workers_count, results_queue_size, shm_transport=shm_transport,
                           item_deadline_s=item_deadline_s, **kwargs)
    if reader_pool_type == 'dummy':
        return DummyPool()
    raise ValueError('Unknown reader_pool_type {!r} (expected thread/process/dummy)'
                     .format(reader_pool_type))


def _retrying(fn, retry_policy, counter):
    """Run a construction-time filesystem operation under the reader's retry
    policy, adding its retries to ``counter`` (a one-element list)."""
    if retry_policy is None:
        return fn()

    def on_retry(attempt, exc, delay):
        logger.warning('Transient IO failure opening dataset (attempt %d): %s; '
                       'retrying in %.3fs', attempt, exc, delay)
    result, retries = run_with_retry(fn, retry_policy, on_retry=on_retry)
    counter[0] += retries
    return result


def _make_cache(cache_type, cache_location, cache_size_limit, cache_row_size_estimate,
                cache_extra_settings, cache_format, has_transform):
    if cache_type in (None, 'null'):
        return NullCache()
    if cache_type != 'local-disk':
        raise ValueError('Unknown cache_type {!r} (expected null/local-disk)'
                         .format(cache_type))
    if cache_location is None or cache_size_limit is None:
        raise ValueError("cache_type='local-disk' needs cache_location and "
                         'cache_size_limit (bytes)')
    extra = dict(cache_extra_settings or {})
    if cache_format == 'arrow-ipc':
        cache_cls = ArrowIpcDiskCache
        # a transform may mutate its columns in place, and read-only hits
        # would fail it on the warm epoch only: hits are then decoded writable
        # (one copy a column) unless cache_extra_settings says otherwise
        if has_transform:
            extra.setdefault('writable_hits', True)
    elif cache_format == 'pickle':
        cache_cls = LocalDiskCache
    else:
        raise ValueError('Unknown cache_format {!r} (expected arrow-ipc/pickle)'
                         .format(cache_format))
    return cache_cls(cache_location, cache_size_limit, cache_row_size_estimate or 0, **extra)


def make_reader(dataset_url_or_urls, schema_fields=None, reader_pool_type='thread',
                workers_count=10, results_queue_size=50, seed=None, shuffle_rows=False,
                shuffle_row_groups=True, shuffle_row_drop_partitions=1, predicate=None,
                rowgroup_selector=None, num_epochs=1, cur_shard=None, shard_count=None,
                cache_type='null', cache_location=None, cache_size_limit=None,
                cache_row_size_estimate=None, cache_extra_settings=None,
                cache_format='arrow-ipc', transform_spec=None, filesystem=None,
                resume_state=None, reader_pool=None, field_overrides=None, on_error='raise',
                retry_policy=None, shm_transport=None, item_deadline_s=None,
                heartbeat_interval_s=None, device_decode_fields=None, trace=None,
                metrics_port=None, slo_policy=None, autotune=None):
    """Reader for stores written with a Unischema (by this package or by
    ``petastorm_tpu``): rows decoded through the codecs.

    :param schema_fields: field names or regex patterns to read (default all),
        or an :class:`~petastorm_tpu_torch.ngram.NGram` for windows of
        consecutive rows (one ``{offset: namedtuple}`` per ``next()``).
    :param reader_pool_type: ``'thread'``, ``'process'`` (spawned worker
        processes, results through a shared-memory ring) or ``'dummy'``
        (in-line, deterministic).
    :param workers_count: threads or processes of the pool.
    :param results_queue_size: the thread pool's results queue bound.
    :param reader_pool: a pool built by the caller, used instead of
        ``reader_pool_type`` and ``workers_count`` (e.g. a
        :class:`~petastorm_tpu_torch.workers.process_pool.ProcessPool` with its
        watchdog settings).
    :param seed: seeds the rowgroup order and the in-rowgroup row shuffle.
    :param shuffle_rows: shuffle rows inside each rowgroup.
    :param shuffle_row_groups: visit rowgroups in a new seeded order each epoch.
    :param shuffle_row_drop_partitions: split each rowgroup into this many
        work items of equal row ranges (each read separately).
    :param predicate: a :mod:`~petastorm_tpu_torch.predicates` predicate; only
        the rows it includes are read. Not with an NGram.
    :param rowgroup_selector: a :mod:`~petastorm_tpu_torch.selectors` selector
        over the store's rowgroup indexes; only the rowgroups it selects are
        read.
    :param num_epochs: passes over the data; None = forever.
    :param cur_shard: with ``shard_count``, read only rowgroups ``i`` with
        ``i % shard_count == cur_shard``.
    :param cache_type: ``'null'`` or ``'local-disk'`` (decoded rowgroups kept
        under ``cache_location``, at most ``cache_size_limit`` bytes;
        ``cache_row_size_estimate`` sanity-checks the limit,
        ``cache_extra_settings`` goes to the cache's constructor).
    :param cache_format: ``'arrow-ipc'`` (hits memory-mapped, numeric columns
        read-only unless a ``transform_spec`` is given or
        ``cache_extra_settings={'writable_hits': True}``) or ``'pickle'``.
    :param transform_spec: a :class:`~petastorm_tpu_torch.transform.TransformSpec`
        applied on the workers (one row dict at a time, or the rowgroup's
        columns with ``batched=True``).
    :param filesystem: a ``pyarrow.fs.FileSystem`` (local, or wrapping one)
        to read through instead of the local filesystem.
    :param resume_state: a :meth:`Reader.state_dict` (or a loader's) to
        continue from; the other arguments must be those of the saved reader.
    :param field_overrides: :class:`UnischemaField`s replacing same-named
        stored fields for this read.
    :param on_error: ``'raise'`` (the first failure ends the read),
        ``'retry'`` (transient IO failures are retried under ``retry_policy``,
        then raised) or ``'skip'`` (as ``'retry'``, then the rowgroup is
        quarantined: :attr:`Reader.quarantine`, ``diagnostics['quarantine']``).
    :param retry_policy: a :class:`~petastorm_tpu_torch.resilience.RetryPolicy`
        (default one when None); ignored under ``'raise'``.
    :param shm_transport: the process pool's shared-memory ring: None (when
        ``/dev/shm`` can hold it), True (required) or False (off).
    :param item_deadline_s: the process pool reaps a worker holding an item
        longer than this; under ``on_error='skip'`` the item is quarantined
        with ``reason='hang'``.
    :param heartbeat_interval_s: the process pool's heartbeat cadence.
    :param device_decode_fields: fields whose codec payloads skip host decode:
        workers pass the DCT coefficients / ``.npy`` bytes / raw deflate frames
        through, and :class:`~petastorm_tpu_torch.parallel.loader.TorchDataLoader`
        decodes them on the card. The ``__hw``/``__enc`` auxiliary columns ride
        :meth:`Reader.iter_columnar` batches only.
    :param trace: True/False arm/disarm the flight recorder
        (process-global, like ``PETASTORM_TPU_TRACE``; process-pool workers
        spawned by this reader inherit it); None leaves it as it is. Export
        the capture with :meth:`Reader.dump_trace`.
    :param metrics_port: serve ``/metrics`` (Prometheus text of
        :meth:`Reader.telemetry_snapshot`, SLO gauges fresh per scrape),
        ``/healthz`` and ``/vars`` on ``127.0.0.1`` at this port (0: an
        ephemeral one, see :attr:`Reader.metrics_url`) until :meth:`Reader.stop`.
    :param slo_policy: the input-efficiency SLO
        (:class:`~petastorm_tpu_torch.telemetry.slo.SloPolicy`, a float target
        or None for 0.9), read by :meth:`Reader.efficiency_report`.
    :param autotune: True or an
        :class:`~petastorm_tpu_torch.autotune.AutotunePolicy` starts a
        controller thread that samples this reader's telemetry, attributes
        the bottleneck and turns one knob at a time (ventilation depth,
        thread-pool workers, decode threads); :meth:`Reader.autotune_report`.
        A knob changes how fast rows arrive, never which rows an epoch
        delivers.
    """
    if trace is not None:
        set_trace_enabled(bool(trace))
    retry_policy = resolve_retry_policy(on_error, retry_policy)
    retries = [0]
    dataset_url_or_urls = normalize_dataset_url_or_urls(dataset_url_or_urls)
    handle = _retrying(lambda: dataset_metadata.open_dataset(dataset_url_or_urls,
                                                             filesystem=filesystem),
                       retry_policy, retries)
    schema = dataset_metadata.get_schema(handle)
    if field_overrides:
        schema = _apply_field_overrides(schema, field_overrides)
    cache = _make_cache(cache_type, cache_location, cache_size_limit,
                        cache_row_size_estimate, cache_extra_settings, cache_format,
                        transform_spec is not None)
    if reader_pool is None:
        reader_pool = _make_pool(reader_pool_type, workers_count, results_queue_size,
                                 shm_transport, item_deadline_s, heartbeat_interval_s)
    return Reader(handle, schema, reader_pool,
                  schema_fields=schema_fields, seed=seed, shuffle_rows=shuffle_rows,
                  shuffle_row_groups=shuffle_row_groups,
                  shuffle_row_drop_partitions=shuffle_row_drop_partitions,
                  predicate=predicate, rowgroup_selector=rowgroup_selector,
                  num_epochs=num_epochs, cur_shard=cur_shard, shard_count=shard_count,
                  cache=cache, transform_spec=transform_spec, resume_state=resume_state,
                  device_decode_fields=device_decode_fields, on_error=on_error,
                  retry_policy=retry_policy, initial_io_retries=retries[0],
                  metrics_port=metrics_port, slo_policy=slo_policy, autotune=autotune)


def make_batch_reader(dataset_url_or_urls, schema_fields=None, reader_pool_type='thread',
                      workers_count=10, results_queue_size=50, seed=None,
                      shuffle_rows=False, shuffle_row_groups=True,
                      shuffle_row_drop_partitions=1, predicate=None, num_epochs=1,
                      cur_shard=None, shard_count=None, cache_type='null',
                      cache_location=None, cache_size_limit=None,
                      cache_row_size_estimate=None, cache_extra_settings=None,
                      cache_format='arrow-ipc', transform_spec=None, filesystem=None,
                      resume_state=None, reader_pool=None, on_error='raise',
                      retry_policy=None, shm_transport=None, item_deadline_s=None,
                      heartbeat_interval_s=None, device_decode_fields=None, trace=None,
                      metrics_port=None, slo_policy=None, autotune=None):
    """Reader for any Parquet store: native columns (no codec decode; a
    ``list<int32>`` column arrives as a list of int32 arrays), one namedtuple
    of column arrays per rowgroup batch. The arguments are :func:`make_reader`'s
    (no rowgroup selector and no NGram); a ``predicate``'s ``do_include`` gets
    whole columns and returns a boolean mask.

    ``transform_spec.func`` takes a pandas ``DataFrame`` and returns one, or,
    with ``TransformSpec(batched=True)``, takes and returns a dict of columns
    (no pandas needed: the port's defined difference, see
    :mod:`~petastorm_tpu_torch.transform`). On a store written with a
    Unischema it emits the stored (encoded) values, with a warning.

    ``device_decode_fields`` needs the store's Unischema: on a Unischema store
    the named fields ship their raw codec payloads for the loader's device
    decode tail (as :func:`make_reader`'s do) and the other columns stay
    stored values; on a plain Parquet store it raises, since no codec says
    what the bytes are.
    """
    if trace is not None:
        set_trace_enabled(bool(trace))
    retry_policy = resolve_retry_policy(on_error, retry_policy)
    retries = [0]
    dataset_url_or_urls = normalize_dataset_url_or_urls(dataset_url_or_urls)
    handle = _retrying(lambda: dataset_metadata.open_dataset(dataset_url_or_urls,
                                                             filesystem=filesystem),
                       retry_policy, retries)
    stored_schema = None
    try:
        stored_schema = dataset_metadata.get_schema(handle)
        warnings.warn('This store was written with a Unischema; use make_reader to get '
                      'codec-decoded rows. make_batch_reader will emit raw stored values.')
    except MetadataError:
        pass
    if device_decode_fields:
        if stored_schema is None:
            raise ValueError(
                'device_decode_fields requires a Unischema store (the codec '
                'registry tells the ship-raw kernels what the payload bytes '
                'are); this store has none — use make_reader on a Unischema '
                'store instead')
        schema = stored_schema
    else:
        schema = Unischema.from_arrow_schema(handle.arrow_dataset.schema)
    cache = _make_cache(cache_type, cache_location, cache_size_limit,
                        cache_row_size_estimate, cache_extra_settings, cache_format,
                        transform_spec is not None)
    if reader_pool is None:
        reader_pool = _make_pool(reader_pool_type, workers_count, results_queue_size,
                                 shm_transport, item_deadline_s, heartbeat_interval_s)
    return Reader(handle, schema, reader_pool,
                  schema_fields=schema_fields, seed=seed, shuffle_rows=shuffle_rows,
                  shuffle_row_groups=shuffle_row_groups,
                  shuffle_row_drop_partitions=shuffle_row_drop_partitions,
                  predicate=predicate, num_epochs=num_epochs, cur_shard=cur_shard,
                  shard_count=shard_count, cache=cache, transform_spec=transform_spec,
                  resume_state=resume_state, is_batched_reader=True,
                  device_decode_fields=device_decode_fields, on_error=on_error,
                  retry_policy=retry_policy, initial_io_retries=retries[0],
                  metrics_port=metrics_port, slo_policy=slo_policy, autotune=autotune)


class Reader(object):
    """Schedules work items through a worker pool, iterates the results and
    accounts for every item consumed."""

    def __init__(self, handle, schema, reader_pool, schema_fields=None, seed=None,
                 shuffle_rows=False, shuffle_row_groups=True, shuffle_row_drop_partitions=1,
                 predicate=None, rowgroup_selector=None, num_epochs=1, cur_shard=None,
                 shard_count=None, cache=None, transform_spec=None, resume_state=None,
                 is_batched_reader=False, device_decode_fields=None, on_error='raise',
                 retry_policy=None, initial_io_retries=0, metrics_port=None,
                 slo_policy=None, autotune=None):
        if (cur_shard is None) != (shard_count is None):
            raise ValueError('cur_shard and shard_count must be specified together')
        if cur_shard is not None and not 0 <= cur_shard < shard_count:
            raise ValueError('cur_shard must be in [0, shard_count)')
        ngram = schema_fields if isinstance(schema_fields, NGram) else None
        if predicate is not None and ngram is not None:
            raise ValueError('Predicates are not supported together with NGram')
        retry_policy = resolve_retry_policy(on_error, retry_policy)
        self.num_epochs = num_epochs
        self.is_batched_reader = is_batched_reader
        self.on_error = on_error
        #: the skip-with-quarantine ledger: records arrive with the results
        self.quarantine = QuarantineLedger()
        self._io_retries = initial_io_retries
        self._breaker_states = {}
        self.schema = schema
        self.last_row_consumed = False
        self._stopped = False
        self._cache = cache
        self._cache_hits = 0
        self._cache_misses = 0
        self._cache_by_epoch = {}   # absolute epoch -> [hits, misses]
        # rows delivered off the results channel (NGram: windows): the
        # autotuner's goodput numerator
        self._rows_consumed = 0
        self._autotune = None
        self._metrics_server = None
        # the workers' stage times arrive on each batch's sidecar and merge
        # here; the pool's registry merges at snapshot time
        from petastorm_tpu_torch.telemetry import MetricsRegistry
        from petastorm_tpu_torch.telemetry.export import logger_from_env
        from petastorm_tpu_torch.telemetry.slo import (SloTracker, resolve_slo_policy,
                                                       slo_clock)
        self._telemetry = MetricsRegistry()
        # efficiency windows run from construction on the span clock
        self._started_at = slo_clock()
        self._slo = SloTracker(resolve_slo_policy(slo_policy), jsonl=logger_from_env())
        if ngram is not None:
            if is_batched_reader:
                raise ValueError('NGram is not supported by make_batch_reader')
            ngram.resolve_regex_field_names(schema)
            if not ngram.timestamp_overlap and shuffle_row_drop_partitions > 1:
                raise NotImplementedError('timestamp_overlap=False is not supported with '
                                          'shuffle_row_drop_partitions > 1')
            fields_to_read = list(ngram.get_field_names_at_all_timesteps())
        elif schema_fields is not None:
            fields_to_read = list(schema.create_schema_view(schema_fields).fields)
        else:
            fields_to_read = list(schema.fields)
        self.ngram = ngram
        partition_names = set(handle.partition_field_names)

        # a predicate's fields are read even when the view leaves them out; one
        # on partition keys only prunes rowgroups here and no worker runs it
        worker_predicate = predicate
        partition_predicate = None
        if predicate is not None:
            predicate_fields = set(predicate.get_fields())
            if predicate_fields and predicate_fields <= partition_names:
                partition_predicate = predicate
                worker_predicate = None
            else:
                fields_to_read += [f for f in predicate_fields if f not in fields_to_read
                                   and (f in schema.fields or f in partition_names)]

        self.device_decode_fields = frozenset(device_decode_fields or ())
        if self.device_decode_fields and ngram is not None:
            raise ValueError('device_decode_fields is not supported with NGram readers '
                             '(windows need decoded values)')
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
                            device_decode_fields=self.device_decode_fields, ngram=ngram,
                            cache=cache, dataset_path_or_paths=handle.path_or_paths,
                            predicate=worker_predicate, on_error=on_error,
                            retry_policy=retry_policy)
        self.result_schema = setup.result_schema

        # under 'skip' a fragment whose footer is unreadable for good is left out
        # of the schedule and quarantined here (not with a rowgroup selector: its
        # piece indexes refer to the full enumeration). Records are staged per
        # attempt, so a retried enumeration records a fragment once.
        def enumerate_row_groups():
            staged = []
            on_fragment_error = None
            if on_error == 'skip' and rowgroup_selector is None:
                def on_fragment_error(exc, fragment_path, fragment_index):
                    staged.append(QuarantineRecord.from_exception(
                        exc, piece_index=fragment_index, fragment_path=fragment_path,
                        row_group_id=None, attempts=1, epoch=0))
            return dataset_metadata.load_row_groups(
                handle, on_fragment_error=on_fragment_error), staged

        retries = [0]
        row_groups, construction_quarantine = _retrying(enumerate_row_groups,
                                                        retry_policy, retries)
        self._io_retries += retries[0]
        if construction_quarantine and resume_state is not None:
            raise ValueError(
                'Cannot resume: {} fragment(s) became unreadable since the checkpoint '
                'was taken ({}); resume coordinates would not match the checkpoint'
                .format(len(construction_quarantine),
                        ', '.join(r.fragment_path for r in construction_quarantine)))
        for record in construction_quarantine:
            self.quarantine.add(record)
        if rowgroup_selector is not None:
            # the selected piece indexes refer to the full enumeration (what
            # build_rowgroup_index scanned): applied before any other filter
            from petastorm_tpu_torch.etl.rowgroup_indexing import get_row_group_indexes
            selected = rowgroup_selector.select_row_groups(get_row_group_indexes(handle))
            row_groups = [rg for i, rg in enumerate(row_groups) if i in selected]
        if partition_predicate is not None:
            row_groups = [rg for rg in row_groups
                          if partition_predicate.do_include(dict(rg.partition_keys))]
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
                  'worker_predicate': worker_predicate,
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
            ventilate_fn=_traced_ventilate(reader_pool.ventilate),
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
        if hasattr(reader_pool, 'check_picklable') and worker_predicate is not None:
            # every work item carries it to the worker processes
            reader_pool.check_picklable(worker_predicate, 'the predicate')
        if on_error == 'skip' and hasattr(reader_pool, 'set_hang_result_factory'):
            # a rowgroup whose worker the watchdog reaps is quarantined: its
            # stand-in rides the normal delivery path
            reader_pool.set_hang_result_factory(hang_stand_in_factory(ngram))
        self._pool.start(RowGroupWorker, setup, self._ventilator)
        if ngram is not None:
            self._results_reader = _NGramResultsReader(ngram, on_batch=self._note_item_consumed,
                                                       fast_forward=self._resume_fast_forward)
        else:
            results_reader = _BatchResultsReader if is_batched_reader else _RowResultsReader
            self._results_reader = results_reader(self.result_schema,
                                                  on_batch=self._note_item_consumed,
                                                  fast_forward=self._resume_fast_forward)
        from petastorm_tpu_torch.autotune.policy import resolve_policy
        autotune_policy = resolve_policy(autotune)
        if autotune_policy is not None:
            from petastorm_tpu_torch.autotune.controller import setup_reader_autotune
            self._autotune = setup_reader_autotune(self, autotune_policy)
            self._autotune.start()
        # started last, so a scrape never sees a half-built reader
        if metrics_port is not None:
            from petastorm_tpu_torch.telemetry.http_exporter import MetricsHttpServer
            self._metrics_server = MetricsHttpServer(
                snapshot_fn=self._scrape_snapshot, health_fn=self._scrape_health,
                port=int(metrics_port))
            self._metrics_server.start()

    # --------------------------------------------------------------- iteration

    def __iter__(self):
        return self

    def __next__(self):
        """One row namedtuple (batch reader: one namedtuple of column arrays;
        NGram reader: one ``{offset: namedtuple}`` window)."""
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
        ``include_empty`` also yields zero-row batches (an item a transform or
        predicate emptied, a piece of no window): delivery-exact checkpointing
        must see every item.

        An NGram reader yields WINDOW-major batches: each column is
        ``(num_windows, ngram.length, *field_shape)`` and ``num_rows`` counts
        windows, so the loaders' accounting and a resume count windows as
        rows."""
        while True:
            if self._stopped:
                raise RuntimeError('Trying to read from a stopped reader')
            try:
                batch = self._pool.get_results()
            except EmptyResultError:
                self.last_row_consumed = True
                return
            if self.ngram is not None:
                batch = ColumnarBatch(self.ngram.windows_as_arrays(batch.columns, batch.starts),
                                      len(batch.starts), item_id=batch.item_id,
                                      retries=batch.retries, quarantine=batch.quarantine,
                                      breakers=batch.breakers, telemetry=batch.telemetry,
                                      trace=batch.trace)
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
        record = getattr(batch, 'quarantine', None)
        if record is not None:
            self.quarantine.add(record)
        breakers = getattr(batch, 'breakers', None)
        with self._accounting_lock:
            self._io_retries += getattr(batch, 'retries', 0)
            if breakers:
                self._breaker_states.update(breakers)
        stage_times = getattr(batch, 'telemetry', None)
        if stage_times:
            # additive, so a respawned worker's fresh recorder merges like any
            self._telemetry.merge_stage_times(stage_times)
        trace_sidecar = getattr(batch, 'trace', None)
        if trace_sidecar:
            # the producing thread's events land in this process's recorder,
            # keeping their pid: one dump_trace() spans every process
            merge_trace_events(trace_sidecar)
        item_id = batch.item_id
        if item_id is None:
            return
        epoch, piece, drop = item_id
        if trace_enabled():
            # the consumer-side anchor of the rowgroup's trace, on every pool
            trace_instant('rowgroup_consumed', ctx=(epoch, piece, 0),
                          args={'rows': batch.num_rows})
        cache_hit = getattr(batch, 'cache_hit', None)
        with self._accounting_lock:
            self._rows_consumed += batch.num_rows
            if cache_hit is not None:
                if cache_hit:
                    self._cache_hits += 1
                else:
                    self._cache_misses += 1
                self._cache_by_epoch.setdefault(epoch, [0, 0])[0 if cache_hit else 1] += 1
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

    @property
    def io_retries(self):
        """Transient-IO retries spent on this reader's behalf (construction and
        workers)."""
        with self._accounting_lock:
            return self._io_retries

    @property
    def rows_consumed(self):
        """Rows delivered off the results channel so far (NGram: windows), the
        autotuner's goodput numerator."""
        with self._accounting_lock:
            return self._rows_consumed

    # --------------------------------------------------------------- telemetry

    def telemetry_snapshot(self):
        """One JSON-safe telemetry snapshot covering every process: the
        reader's registry (with the workers' stage times) merged with the
        pool's consumer-side registry (``pool_wait``, and on the process pool
        ``shm_map``/``shm_release``/``wire_bytes_copied``). Feed it to
        :func:`~petastorm_tpu_torch.telemetry.analyze.attribute_bottleneck` or
        :func:`~petastorm_tpu_torch.telemetry.export.to_prometheus_text`."""
        from petastorm_tpu_torch.telemetry import merge_snapshots
        pool_registry = getattr(self._pool, 'telemetry', None)
        if pool_registry is None:
            return self._telemetry.snapshot()
        return merge_snapshots(self._telemetry.snapshot(), pool_registry.snapshot())

    def _evaluate_slo(self, snapshot):
        from petastorm_tpu_torch.telemetry.slo import slo_clock
        return self._slo.evaluate(snapshot, slo_clock() - self._started_at,
                                  rows=self.rows_consumed, registry=self._telemetry)

    def efficiency_report(self):
        """One input-efficiency SLO evaluation over this reader's lifetime:
        efficiency in [0, 1] from the recorded consumer wait spans
        (``pool_wait``, or ``shuffle_wait``/``d2d_wait`` when a loader's are
        in the snapshot), the starvation fraction, goodput against ideal
        rows/s, and the edge-triggered breach accounting (``slo_breach``
        counter, JSONL event and trace instant). Also ``diagnostics['slo']``."""
        return self._evaluate_slo(self.telemetry_snapshot())

    def _snapshot_with_slo(self):
        """One telemetry snapshot evaluated against the SLO, with the fresh
        ``slo_*`` gauges spliced in; returns ``(snapshot, slo_report)``."""
        snapshot = self.telemetry_snapshot()
        report = self._evaluate_slo(snapshot)
        gauges = snapshot.setdefault('gauges', {})
        if report['efficiency'] is not None:
            gauges['slo_efficiency'] = report['efficiency']
        gauges['slo_target_efficiency'] = report['target_efficiency']
        # the tracker's trailing points ride /vars (a list: the text scrape
        # ignores it)
        snapshot['slo_history'] = report.get('history', [])
        return snapshot, report

    def _scrape_snapshot(self):
        return self._snapshot_with_slo()[0]

    def _scrape_health(self):
        return {'rows_consumed': self.rows_consumed, 'stopped': self._stopped,
                'rowgroups_quarantined': len(self.quarantine)}

    @property
    def metrics_url(self):
        """The scrape endpoint's base URL, or None without ``metrics_port``."""
        if self._metrics_server is None:
            return None
        return self._metrics_server.url

    def dump_trace(self, path=None):
        """The flight recorder as Chrome-trace/Perfetto JSON: every event of
        this process plus the workers' events merged off the ``trace``
        sidecars, with per-process tracks and worker->consumer flow arrows a
        rowgroup. Written to ``path`` when given; returned either way. Empty
        unless tracing was armed for the read (``trace=True`` or
        ``PETASTORM_TPU_TRACE=1``)."""
        from petastorm_tpu_torch.telemetry.trace_export import (to_chrome_trace,
                                                                write_chrome_trace)
        from petastorm_tpu_torch.telemetry.tracing import trace_snapshot
        snapshot = trace_snapshot()
        if path is not None:
            return write_chrome_trace(path, snapshot)
        return to_chrome_trace(snapshot)

    def trace_summary(self):
        """The non-visual flight-recorder view
        (:func:`~petastorm_tpu_torch.telemetry.trace_export.summarize_trace`):
        event counts by name, dropped events, anomaly instants and the
        longest rowgroup traces."""
        from petastorm_tpu_torch.telemetry.trace_export import summarize_trace
        from petastorm_tpu_torch.telemetry.tracing import trace_snapshot
        return summarize_trace(trace_snapshot())

    def autotune_report(self):
        """The autotuner's state (windows, decision log, frozen-by-breaker
        flag, knob values and bounds), or ``{'enabled': False}`` without
        ``autotune``."""
        if self._autotune is None:
            return {'enabled': False}
        return self._autotune.report()

    @property
    def diagnostics(self):
        """Counters under the JAX package's names: the process pool's own
        (``workers_alive``, ``workers_respawned``, ``shm_batches``, ...: see
        :attr:`~petastorm_tpu_torch.workers.process_pool.ProcessPool.diagnostics`);
        ``io_retries``; ``rowgroups_quarantined`` and ``quarantine`` (the
        ledger's records as dicts); ``breakers``, the tripped circuit breakers
        by name (the workers' filesystem breakers and the pool's shm breaker;
        empty while all are closed); ``cache_hits`` and ``cache_misses``, the
        consumed work items served from and filled into the cache (NGram
        pieces count neither), ``cache_by_epoch`` (the port's own) splitting
        them by absolute epoch as ``{epoch: {'hits': n, 'misses': n}}``,
        ``cache``, a copy of the cache's own ``stats`` (absent without a
        cache); ``telemetry``, one cross-process snapshot with fresh SLO
        gauges, and ``slo``, its efficiency report; ``trace``, the
        flight-recorder summary (only while tracing is armed); ``autotune``,
        the controller's report (only with ``autotune``)."""
        diag = dict(getattr(self._pool, 'diagnostics', None) or {})
        with self._accounting_lock:
            diag.update({'io_retries': self._io_retries,
                         'cache_hits': self._cache_hits,
                         'cache_misses': self._cache_misses,
                         'cache_by_epoch': {epoch: {'hits': hits, 'misses': misses}
                                            for epoch, (hits, misses)
                                            in sorted(self._cache_by_epoch.items())}})
            breakers = dict(self._breaker_states)
        stats = getattr(self._cache, 'stats', None)
        if stats is not None:
            diag['cache'] = dict(stats)
        diag['rowgroups_quarantined'] = len(self.quarantine)
        diag['quarantine'] = self.quarantine.as_dicts()
        from petastorm_tpu_torch.resilience import default_board
        breakers.update(default_board().snapshot(only_tripped=True))
        shm_breaker = diag.get('shm_breaker')
        if shm_breaker is not None and (shm_breaker['failures'] or shm_breaker['opened_count']
                                        or shm_breaker['state'] != 'closed'):
            breakers['shm_transport'] = shm_breaker
        diag['breakers'] = breakers
        snapshot, slo_report = self._snapshot_with_slo()
        diag['slo'] = slo_report
        diag['telemetry'] = snapshot
        if trace_enabled():
            diag['trace'] = self.trace_summary()
        if self._autotune is not None:
            diag['autotune'] = self._autotune.report()
        return diag

    # --------------------------------------------------------------- lifecycle

    def stop(self):
        self._stopped = True
        if self._metrics_server is not None:
            # the scrape plane goes first: a scrape must not race the teardown
            self._metrics_server.stop()
        if self._autotune is not None:
            # no knob turns once the pool starts tearing down
            self._autotune.stop()
        self._pool.stop()

    def join(self):
        self._pool.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        self.join()


def _traced_ventilate(pool_ventilate):
    """A pool's ``ventilate`` that puts each item's birth on the flight
    recorder's timeline: the ``ventilate`` instant is the causal origin of a
    rowgroup's trace. One enabled check an item while tracing is off."""
    def ventilate(**kwargs):
        if trace_enabled():
            trace_instant('ventilate', ctx=(int(kwargs.get('epoch_index', 0)),
                                            int(kwargs['piece_index']), 0))
        pool_ventilate(**kwargs)
    return ventilate


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


class _NGramResultsReader(object):
    """Buffers an :class:`~petastorm_tpu_torch.ngram_worker.NGramWindows`
    payload and emits one ``{offset: namedtuple}`` per read, gathered from
    the shared columns. The checkpoint contract is
    :class:`_RowResultsReader`'s with the window as the row unit: a payload
    is acknowledged once its last window was emitted, :meth:`cursor` names
    the next window, ``fast_forward`` replays a resumed payload from it."""

    def __init__(self, ngram, on_batch=None, fast_forward=None):
        self._ngram = ngram
        self._on_batch = on_batch
        self._fast_forward = fast_forward if fast_forward is not None else {}
        self._plan = None
        self._plan_columns = None
        self.reset()

    def read_next(self, pool):
        while self._payload is None or self._next >= len(self._payload.starts):
            payload = pool.get_results()
            item_id = payload.item_id
            start = self._fast_forward.pop(item_id, 0) if item_id is not None else 0
            if not len(payload.starts) or start >= len(payload.starts):
                # nothing (left) to emit: consumed the moment it is popped
                self._on_batch(payload)
                self._payload = None
                continue
            self._payload = payload
            self._next = start
            columns_key = frozenset(payload.columns)
            if columns_key != self._plan_columns:
                self._plan = self._ngram.window_plan(columns_key)
                self._plan_columns = columns_key
        start = self._payload.starts[self._next]
        self._next += 1
        if self._next >= len(self._payload.starts):
            self._on_batch(self._payload)
        return self._ngram.window_from_plan(self._payload.columns, start, self._plan)

    def cursor(self):
        """``(item_id, next_window)`` of the partly emitted payload, or None."""
        if self._payload is not None and self._next < len(self._payload.starts):
            item_id = self._payload.item_id
            if item_id is not None:
                return item_id, self._next
        return None

    def reset(self):
        self._payload = None
        self._next = 0
