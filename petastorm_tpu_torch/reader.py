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
resumes a reader of the other, its ``lineage`` and ``topology`` blocks
included.

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

``cost_schedule=`` plans the work items from the persisted per-rowgroup
cost ledger (:mod:`~petastorm_tpu_torch.schedule`), and
:meth:`Reader.cost_ledger` folds a traced read into one.

``service_url=`` reads through the disaggregated input service
(:mod:`~petastorm_tpu_torch.service`): decode runs on a shared fleet's
workers instead of a pool in this process, and the results, their sidecars
and the device decode tail's raw columns arrive as the process pool's do.

The JAX package's observability planes ride the reader with the same
formats: ``storage_policy=`` reads through the object-store ingest engine
(:mod:`~petastorm_tpu_torch.storage`; ``storage_*`` counters in
:meth:`Reader.telemetry_snapshot`), ``lineage=`` folds the chained order
digest and writes the batch manifest
(:mod:`~petastorm_tpu_torch.telemetry.lineage`; :meth:`Reader.order_digest`,
a ``lineage`` block in :meth:`Reader.state_dict`), ``incidents=`` captures
one rate-limited evidence bundle a failure edge
(:mod:`~petastorm_tpu_torch.telemetry.incident`) and ``history=`` appends one
run record at :meth:`Reader.stop` and arms the regression sentinel
(:mod:`~petastorm_tpu_torch.telemetry.history`,
:mod:`~petastorm_tpu_torch.telemetry.sentinel`).

Stores live where the JAX package's do (:mod:`~petastorm_tpu_torch.fs_utils`):
local paths and ``file://``, ``hdfs://`` through the namenode resolver with
HA failover (``hdfs_driver`` is the reference API's argument), and every
other scheme through fsspec with ``storage_options`` (``s3://``, ``gs://``,
``memory:///`` and ``local:///`` in tests). Workers receive a picklable
:class:`~petastorm_tpu_torch.fs_utils.FilesystemFactory`, not a live
filesystem. ``shard_seed`` shuffles the rowgroups before the static
``cur_shard``/``shard_count`` split, and ``topology=`` replaces that split by
the negotiated shard map of :mod:`~petastorm_tpu_torch.parallel.topology`
(a durable membership journal, re-deals after a host leaves, a ``topology``
block in :meth:`Reader.state_dict` for
:func:`~petastorm_tpu_torch.parallel.checkpoint.restore_across_topology`).
"""

import logging
import threading
import warnings

import numpy as np

from petastorm_tpu_torch import decode_engine
from petastorm_tpu_torch.cache import ArrowIpcDiskCache, LocalDiskCache, NullCache
from petastorm_tpu_torch.errors import MetadataError, NoDataAvailableError
from petastorm_tpu_torch.etl import dataset_metadata
from petastorm_tpu_torch.fs_utils import (GivenFilesystemFactory, check_hdfs_driver,
                                          make_filesystem_factory,
                                          normalize_dataset_url_or_urls)
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
#: the pool-shape defaults of both factories: a ``service_url`` read names
#: any argument that differs from them as ignored
_POOL_SHAPE_DEFAULTS = (('reader_pool_type', 'thread'), ('workers_count', 10),
                        ('results_queue_size', 50), ('shm_transport', None),
                        ('item_deadline_s', None), ('heartbeat_interval_s', None))


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


def _service_pool(service_url, reader_pool, **pool_shape):
    """The :class:`~petastorm_tpu_torch.service.service_client.ServicePool` of
    a ``service_url`` read; the fleet defines the pool's shape, so pool-shape
    arguments that differ from their defaults are named in a warning. An
    unreachable dispatcher raises ``TransientIOError`` here."""
    if reader_pool is not None:
        raise ValueError('service_url and reader_pool are mutually exclusive — the '
                         'service defines the pool')
    ignored = [name for name, default in _POOL_SHAPE_DEFAULTS
               if pool_shape[name] != default]
    if ignored:
        warnings.warn('service_url was supplied; ignoring pool-shape arguments {} (the '
                      'service fleet defines its own shape)'.format(ignored))
    from petastorm_tpu_torch.service.service_client import ServicePool
    return ServicePool(service_url)


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
    cache = cache_cls(cache_location, cache_size_limit, cache_row_size_estimate or 0, **extra)
    if 'writable_hits' in (cache_extra_settings or {}):
        # the caller said what its consumer needs: not an autotuner knob
        cache.writable_hits_pinned = True
    return cache


def make_reader(dataset_url_or_urls, schema_fields=None, reader_pool_type='thread',
                workers_count=10, results_queue_size=50, seed=None, shuffle_rows=False,
                shuffle_row_groups=True, shuffle_row_drop_partitions=1, predicate=None,
                rowgroup_selector=None, num_epochs=1, cur_shard=None, shard_count=None,
                shard_seed=None, cache_type='null', cache_location=None,
                cache_size_limit=None, cache_row_size_estimate=None,
                cache_extra_settings=None, cache_format='arrow-ipc', transform_spec=None,
                storage_options=None, filesystem=None, resume_state=None, reader_pool=None,
                field_overrides=None, hdfs_driver='libhdfs', on_error='raise',
                retry_policy=None, shm_transport=None, item_deadline_s=None,
                heartbeat_interval_s=None, device_decode_fields=None, trace=None,
                metrics_port=None, slo_policy=None, autotune=None, cost_schedule=None,
                service_url=None, storage_policy=None, lineage=None, incidents=None,
                history=None, topology=None):
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
    :param shard_seed: with ``cur_shard``, shuffle the rowgroups with this
        seed before the modulo split, so each shard draws from the whole
        store.
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
    :param storage_options: options of the fsspec filesystem a remote URL
        (``s3://``, ``gs://``, ``memory:///``, ...) is read through.
    :param filesystem: a ``pyarrow.fs.FileSystem`` to read through instead
        of the URL's own.
    :param resume_state: a :meth:`Reader.state_dict` (or a loader's) to
        continue from; the other arguments must be those of the saved reader.
    :param field_overrides: :class:`UnischemaField`s replacing same-named
        stored fields for this read.
    :param hdfs_driver: the reference API's HDFS driver; ``pyarrow.fs`` has
        libhdfs only, and ``'libhdfs3'`` warns.
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
    :param cost_schedule: True, a ledger path or a
        :class:`~petastorm_tpu_torch.schedule.SchedulePolicy` plans the
        reader's work items from the persisted per-rowgroup cost ledger
        (:mod:`~petastorm_tpu_torch.schedule`): heavy rowgroups interleaved
        with light ones and the heaviest ventilated first, rowgroups past the
        split threshold cut into ``row_range`` sub-items. The plan is frozen
        here, a pure function of the ledger and ``seed``; with no ledger the
        read equals an unscheduled one. The run's measured stage times are
        folded into the ledger at :meth:`Reader.stop`. Not with
        ``resume_state``; :attr:`Reader.diagnostics` ``['schedule']`` reports
        the plan. A ``service_url`` read ships each item's measured cost with
        its submit, and the dispatcher's fair-share scheduler charges it.
    :param service_url: ``'tcp://host:port'`` of an input-service dispatcher
        (:class:`~petastorm_tpu_torch.service.ServiceFleet`): decode runs on
        the fleet's workers, results arrive over TCP (one-shot shared memory
        when co-located) and ``diagnostics['service']`` holds the
        dispatcher's state. Not with ``reader_pool``; the pool-shape
        arguments are ignored with a warning. An unreachable dispatcher
        raises :class:`~petastorm_tpu_torch.errors.TransientIOError` here;
        nothing falls back to a pool in this process.
    :param storage_policy: the object-store ingest engine: None engages it
        only for non-local URL schemes, False never, True (the default
        :class:`~petastorm_tpu_torch.storage.StoragePolicy`) or a policy
        always. The workers then read planned, coalesced and hedged column
        ranges with one footer cache a worker; ``diagnostics['storage']``.
    :param lineage: True, a manifest path or a
        :class:`~petastorm_tpu_torch.telemetry.lineage.LineagePolicy` folds
        every delivered item into the chained order digest
        (:meth:`Reader.order_digest`, equal on every pool for one seed) and
        writes the batch manifest that ``lineage verify`` replays;
        ``state_dict`` then carries a ``lineage`` block.
    :param incidents: True or an
        :class:`~petastorm_tpu_torch.telemetry.incident.IncidentPolicy`
        captures one rate-limited evidence bundle a failure edge (breaker
        open, watchdog reap, quarantine, shm CRC drop, SLO breach, lineage
        divergence); :meth:`Reader.incident_report`.
    :param history: True, a store path or a
        :class:`~petastorm_tpu_torch.telemetry.history.HistoryPolicy` appends
        one run record at :meth:`Reader.stop` and arms the regression
        sentinel; :meth:`Reader.history_report`.
    :param topology: True, a membership journal path or a
        :class:`~petastorm_tpu_torch.parallel.topology.TopologyPolicy`
        replaces ``cur_shard``/``shard_count`` by a shard map negotiated from
        the process identity (``PETASTORM_TPU_PROCESS_INDEX``/``_COUNT``, else
        an initialized ``torch.distributed`` group) and recorded in a durable
        journal (next to a local store, else ``TopologyPolicy(journal_path=)``);
        after a host leaves, the survivors re-deal only the rowgroups not yet
        delivered, and the hosts' lineage digests compose to one global
        digest. Not with ``cur_shard``/``shard_count``/``shard_seed`` or
        ``cost_schedule``.
    """
    if trace is not None:
        set_trace_enabled(bool(trace))
    check_hdfs_driver(hdfs_driver)
    retry_policy = resolve_retry_policy(on_error, retry_policy)
    retries = [0]
    dataset_url_or_urls = normalize_dataset_url_or_urls(dataset_url_or_urls)
    handle = _retrying(lambda: dataset_metadata.open_dataset(dataset_url_or_urls,
                                                             storage_options=storage_options,
                                                             filesystem=filesystem),
                       retry_policy, retries)
    schema = dataset_metadata.get_schema(handle)
    if field_overrides:
        schema = _apply_field_overrides(schema, field_overrides)
    cache = _make_cache(cache_type, cache_location, cache_size_limit,
                        cache_row_size_estimate, cache_extra_settings, cache_format,
                        transform_spec is not None)
    if service_url is not None:
        reader_pool = _service_pool(service_url, reader_pool,
                                    reader_pool_type=reader_pool_type,
                                    workers_count=workers_count,
                                    results_queue_size=results_queue_size,
                                    shm_transport=shm_transport,
                                    item_deadline_s=item_deadline_s,
                                    heartbeat_interval_s=heartbeat_interval_s)
    if reader_pool is None:
        reader_pool = _make_pool(reader_pool_type, workers_count, results_queue_size,
                                 shm_transport, item_deadline_s, heartbeat_interval_s)
    return Reader(handle, schema, reader_pool,
                  schema_fields=schema_fields, seed=seed, shuffle_rows=shuffle_rows,
                  shuffle_row_groups=shuffle_row_groups,
                  shuffle_row_drop_partitions=shuffle_row_drop_partitions,
                  predicate=predicate, rowgroup_selector=rowgroup_selector,
                  num_epochs=num_epochs, cur_shard=cur_shard, shard_count=shard_count,
                  shard_seed=shard_seed, cache=cache, transform_spec=transform_spec,
                  resume_state=resume_state,
                  device_decode_fields=device_decode_fields, on_error=on_error,
                  retry_policy=retry_policy, initial_io_retries=retries[0],
                  metrics_port=metrics_port, slo_policy=slo_policy, autotune=autotune,
                  cost_schedule=cost_schedule, storage_policy=storage_policy,
                  lineage=lineage, incidents=incidents, history=history,
                  dataset_url_or_urls=dataset_url_or_urls, storage_options=storage_options,
                  filesystem=filesystem, topology=topology)


def make_batch_reader(dataset_url_or_urls, schema_fields=None, reader_pool_type='thread',
                      workers_count=10, results_queue_size=50, seed=None,
                      shuffle_rows=False, shuffle_row_groups=True,
                      shuffle_row_drop_partitions=1, predicate=None, num_epochs=1,
                      cur_shard=None, shard_count=None, shard_seed=None,
                      cache_type='null', cache_location=None, cache_size_limit=None,
                      cache_row_size_estimate=None, cache_extra_settings=None,
                      cache_format='arrow-ipc', transform_spec=None, storage_options=None,
                      filesystem=None, resume_state=None, reader_pool=None,
                      hdfs_driver='libhdfs', on_error='raise',
                      retry_policy=None, shm_transport=None, item_deadline_s=None,
                      heartbeat_interval_s=None, device_decode_fields=None, trace=None,
                      metrics_port=None, slo_policy=None, autotune=None,
                      cost_schedule=None, service_url=None, storage_policy=None,
                      lineage=None, incidents=None, history=None, topology=None):
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
    what the bytes are. ``service_url`` reads through an input-service fleet
    as :func:`make_reader`'s does; ``storage_policy``, ``lineage``,
    ``incidents``, ``history`` and ``topology`` arm :func:`make_reader`'s
    planes, and ``storage_options``, ``hdfs_driver`` and ``shard_seed`` are
    its arguments.
    """
    if trace is not None:
        set_trace_enabled(bool(trace))
    check_hdfs_driver(hdfs_driver)
    retry_policy = resolve_retry_policy(on_error, retry_policy)
    retries = [0]
    dataset_url_or_urls = normalize_dataset_url_or_urls(dataset_url_or_urls)
    handle = _retrying(lambda: dataset_metadata.open_dataset(dataset_url_or_urls,
                                                             storage_options=storage_options,
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
    if service_url is not None:
        reader_pool = _service_pool(service_url, reader_pool,
                                    reader_pool_type=reader_pool_type,
                                    workers_count=workers_count,
                                    results_queue_size=results_queue_size,
                                    shm_transport=shm_transport,
                                    item_deadline_s=item_deadline_s,
                                    heartbeat_interval_s=heartbeat_interval_s)
    if reader_pool is None:
        reader_pool = _make_pool(reader_pool_type, workers_count, results_queue_size,
                                 shm_transport, item_deadline_s, heartbeat_interval_s)
    return Reader(handle, schema, reader_pool,
                  schema_fields=schema_fields, seed=seed, shuffle_rows=shuffle_rows,
                  shuffle_row_groups=shuffle_row_groups,
                  shuffle_row_drop_partitions=shuffle_row_drop_partitions,
                  predicate=predicate, num_epochs=num_epochs, cur_shard=cur_shard,
                  shard_count=shard_count, shard_seed=shard_seed, cache=cache,
                  transform_spec=transform_spec,
                  resume_state=resume_state, is_batched_reader=True, decode=False,
                  device_decode_fields=device_decode_fields, on_error=on_error,
                  retry_policy=retry_policy, initial_io_retries=retries[0],
                  metrics_port=metrics_port, slo_policy=slo_policy, autotune=autotune,
                  cost_schedule=cost_schedule, storage_policy=storage_policy,
                  lineage=lineage, incidents=incidents, history=history,
                  dataset_url_or_urls=dataset_url_or_urls, storage_options=storage_options,
                  filesystem=filesystem, topology=topology)


class Reader(object):
    """Schedules work items through a worker pool, iterates the results and
    accounts for every item consumed. Without ``handle`` it opens the store
    at ``dataset_url_or_urls``, and without ``schema`` it takes the one the
    store's Arrow schema gives, as the JAX ``Reader`` does; ``decode=False``
    (``make_batch_reader``'s) emits stored values without codec decode."""

    def __init__(self, handle=None, schema=None, reader_pool=None, schema_fields=None, seed=None,
                 shuffle_rows=False, shuffle_row_groups=True, shuffle_row_drop_partitions=1,
                 predicate=None, rowgroup_selector=None, num_epochs=1, cur_shard=None,
                 shard_count=None, cache=None, transform_spec=None, resume_state=None,
                 is_batched_reader=False, device_decode_fields=None, on_error='raise',
                 retry_policy=None, initial_io_retries=0, metrics_port=None,
                 slo_policy=None, autotune=None, cost_schedule=None, storage_policy=None,
                 lineage=None, incidents=None, history=None, dataset_url_or_urls=None,
                 shard_seed=None, storage_options=None, filesystem=None, topology=None,
                 decode=True):
        if reader_pool is None:
            raise ValueError('Reader needs a reader_pool (make_reader builds one)')
        if handle is None:
            if dataset_url_or_urls is None:
                raise ValueError('Reader needs a handle or dataset_url_or_urls')
            handle = dataset_metadata.open_dataset(dataset_url_or_urls,
                                                   storage_options=storage_options,
                                                   filesystem=filesystem)
        if schema is None:
            schema = Unischema.from_arrow_schema(handle.arrow_dataset.schema)
        if (cur_shard is None) != (shard_count is None):
            raise ValueError('cur_shard and shard_count must be specified together')
        if cur_shard is not None and not 0 <= cur_shard < shard_count:
            raise ValueError('cur_shard must be in [0, shard_count)')
        # the topology plane: the policy now, the HostTopology once the
        # filtered rowgroup list exists (its deal covers exactly that list)
        from petastorm_tpu_torch.parallel.topology import resolve_topology_policy
        self._topology = None
        topology_policy = resolve_topology_policy(topology)
        if topology_policy is not None:
            if cur_shard is not None or shard_seed is not None:
                raise ValueError('topology= and static cur_shard/shard_count/shard_seed '
                                 'are mutually exclusive: the topology plane negotiates '
                                 'the shard map')
            if cost_schedule is not None:
                raise ValueError('topology= is not compatible with cost_schedule: a '
                                 're-planned interleave would shift the global item '
                                 'coordinates a reshard re-deals')
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
        self._transform_spec = transform_spec
        # the observability planes: policies resolved here, recorders built
        # once the work plan is frozen (lineage), the pool runs (incidents)
        # and the incident plane exists (history, whose sentinel files there)
        from petastorm_tpu_torch.storage import resolve_storage_policy
        from petastorm_tpu_torch.telemetry.history import resolve_history_policy
        from petastorm_tpu_torch.telemetry.incident import resolve_incident_policy
        from petastorm_tpu_torch.telemetry.lineage import resolve_lineage_policy
        # a reader built from a handle alone ships the handle's filesystem
        ship_filesystem = filesystem if filesystem is not None else (
            handle.filesystem if dataset_url_or_urls is None else None)
        if dataset_url_or_urls is None:
            dataset_url_or_urls = handle.path_or_paths
        #: the store's URL (the first one of a list): the sidecars' home
        self._state_url = str(dataset_url_or_urls[0]
                              if isinstance(dataset_url_or_urls, (list, tuple))
                              else dataset_url_or_urls)
        self._storage_policy = resolve_storage_policy(storage_policy, dataset_url_or_urls)
        self._lineage_policy = resolve_lineage_policy(lineage)
        self._lineage = None
        self._incident_policy = resolve_incident_policy(incidents)
        self._incidents = None
        self._history_policy = resolve_history_policy(history)
        self._history = None
        self._history_written = False
        self._history_fingerprints = {}
        self._sentinel = None
        # the poll-based incident edges' last seen counts
        self._incident_last_divergence = 0
        self._incident_last_crc_failures = 0
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

        # the workers rebuild the filesystem (the URL's, or the caller's own
        # pickled with the factory); under a retrying on_error policy the
        # resolution retries too
        if ship_filesystem is not None:
            filesystem_factory = GivenFilesystemFactory(ship_filesystem)
        else:
            filesystem_factory = make_filesystem_factory(self._state_url, storage_options,
                                                         retry_policy=retry_policy)
        setup = WorkerSetup(filesystem_factory, schema, fields_to_read,
                            transform_spec=transform_spec, batched_output=is_batched_reader,
                            decode=decode,
                            shuffle_rows=shuffle_rows, seed=seed,
                            partition_field_names=partition_names,
                            device_decode_fields=self.device_decode_fields, ngram=ngram,
                            cache=cache, dataset_path_or_paths=handle.path_or_paths,
                            predicate=worker_predicate, on_error=on_error,
                            retry_policy=retry_policy,
                            lineage_fingerprint_every=(
                                self._lineage_policy.fingerprint_every
                                if self._lineage_policy is not None else 0),
                            storage_policy=self._storage_policy)
        self.result_schema = setup.result_schema
        #: the read's identity, the key of the disk cache and the cost ledger
        self.dataset_token = setup.dataset_token

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
        if topology_policy is not None:
            row_groups = self._negotiate_topology(topology_policy, row_groups, cache)
        else:
            row_groups = self._partition_row_groups(row_groups, cur_shard, shard_count,
                                                    shard_seed)
        if not row_groups:
            raise NoDataAvailableError(
                'No rowgroups available for shard {} of {}. Use fewer shards or more '
                'files.'.format(
                    self._topology.process_index if self._topology else cur_shard,
                    self._topology.process_count if self._topology else shard_count))
        #: the shard configuration a checkpoint must match on resume
        self._shard_config = {'cur_shard': cur_shard, 'shard_count': shard_count,
                              'shard_seed': shard_seed,
                              'topology': self._topology is not None}
        items = [{'piece_index': piece_index,
                  'fragment_path': rg.fragment_path,
                  'row_group_id': rg.row_group_id,
                  'partition_keys': rg.partition_keys,
                  'worker_predicate': worker_predicate,
                  'shuffle_row_drop_partition': (drop, shuffle_row_drop_partitions)}
                 for piece_index, rg in enumerate(row_groups)
                 for drop in range(shuffle_row_drop_partitions)]

        # cost-aware scheduling: the ledger's splits and the epoch order are
        # frozen here (a pure function of ledger and seed, never of timing)
        #: piece index -> (fragment_path, row_group_id), split pieces included
        self._piece_locator = {index: (rg.fragment_path, rg.row_group_id)
                               for index, rg in enumerate(row_groups)}
        self._cost_scheduler = None
        order_fn = None
        from petastorm_tpu_torch.schedule import resolve_schedule_policy
        schedule_policy = resolve_schedule_policy(cost_schedule)
        if schedule_policy is not None:
            if resume_state is not None:
                raise ValueError(
                    'cost_schedule cannot be combined with resume_state: a re-planned '
                    'schedule (ledger-driven splits) would shift the work-item '
                    'coordinates the checkpoint refers to; resume without cost_schedule')
            from petastorm_tpu_torch.dataset_state import cache_state_home
            from petastorm_tpu_torch.schedule import CostAwareScheduler, load_ledger
            path_or_paths = handle.path_or_paths
            url_for_ledger = (path_or_paths[0] if isinstance(path_or_paths, (list, tuple))
                              else path_or_paths)
            ledger, ledger_path = load_ledger(url_for_ledger, self.dataset_token,
                                              cache_location=cache_state_home(cache),
                                              ledger_path=schedule_policy.ledger_path)
            self._cost_scheduler = CostAwareScheduler(self.dataset_token, schedule_policy,
                                                      ledger=ledger, ledger_path=ledger_path)
            locator = {index: (rg.fragment_path, rg.row_group_id, rg.row_group_num_rows)
                       for index, rg in enumerate(row_groups)}
            # NGram windows span rows: interleave, never split. Parts cap at
            # the pool's workers (each re-reads the rowgroup), floored at 2
            items, _ = self._cost_scheduler.plan_items(
                items, locator, allow_split=ngram is None,
                max_parts=max(2, int(getattr(reader_pool, 'workers_count', 1) or 1)))
            self._piece_locator = self._cost_scheduler.piece_locator()
            if shuffle_row_groups:
                order_fn = self._cost_scheduler.order_items
                self._cost_scheduler.live_reorder = True
            else:
                # one static cost-balanced order, the same every epoch
                items = self._cost_scheduler.order_items(items, None)

        # Consumption is tracked per work item: every item yields exactly one
        # ColumnarBatch, tagged with its absolute epoch and counted when popped
        # off the results queue (on the row path: when its last row is emitted).
        self._items_per_epoch = len(items)
        self._accounting_lock = threading.Lock()
        self._next_lock = threading.Lock()
        self._epochs_consumed = 0
        self._consumed_by_epoch = {}   # absolute epoch -> {(piece, drop)}
        self._resume_fast_forward = {}
        self._resume_lineage = None
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

        if self._lineage_policy is not None:
            self._start_lineage(cache, items, row_groups, construction_quarantine, seed,
                                shuffle_row_groups, num_epochs, cur_shard, shard_count,
                                shard_seed, shuffle_row_drop_partitions, resume_state,
                                skip_by_iteration)

        self._ventilator = ConcurrentVentilator(
            ventilate_fn=_traced_ventilate(reader_pool.ventilate, self._lineage),
            items_to_ventilate=items,
            iterations=iterations,
            max_ventilation_queue_size=reader_pool.workers_count
            + _VENTILATE_EXTRA_ROWGROUPS,
            randomize_item_order=shuffle_row_groups,
            random_seed=seed,
            pre_shuffle_count=self._epochs_consumed,
            skip_ids_by_iteration=skip_by_iteration,
            item_id_fn=_item_id,
            reset_iterations=num_epochs,
            order_fn=order_fn)
        self._pool = reader_pool
        if self._cost_scheduler is not None and hasattr(reader_pool, 'set_cost_hint_fn'):
            # service path: each submit carries the item's measured cost, which
            # the dispatcher's DRR charges and routes heavy items by
            reader_pool.set_cost_hint_fn(self._cost_scheduler.cost_hint_for)
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
        if self._incident_policy is not None:
            self._start_incidents(cache, seed, num_epochs, shuffle_row_groups, cur_shard,
                                  shard_count, on_error, reader_pool)
        if self._history_policy is not None:
            self._start_history(cache, seed, num_epochs, shuffle_row_groups, shuffle_rows,
                                cur_shard, shard_count, on_error, reader_pool,
                                is_batched_reader, transform_spec, autotune_policy)
        # started last, so a scrape never sees a half-built reader
        if metrics_port is not None:
            from petastorm_tpu_torch.telemetry.http_exporter import MetricsHttpServer
            self._metrics_server = MetricsHttpServer(
                snapshot_fn=self._scrape_snapshot, health_fn=self._scrape_health,
                port=int(metrics_port))
            self._metrics_server.start()

    # --------------------------------------------------------------- sharding

    @staticmethod
    def _partition_row_groups(row_groups, cur_shard, shard_count, shard_seed):
        """The static split: rowgroups ``i % shard_count == cur_shard``, after a
        ``shard_seed`` shuffle when given (the JAX package's order)."""
        if cur_shard is None:
            return list(row_groups)
        indexed = list(enumerate(row_groups))
        if shard_seed is not None:
            np.random.RandomState(shard_seed).shuffle(indexed)
        return [rg for index, (_, rg) in enumerate(indexed) if index % shard_count == cur_shard]

    def _negotiate_topology(self, policy, row_groups, cache):
        """Join the membership journal and return this host's rowgroups: the
        deal over GLOBAL indices of the filtered list (generation 0 equals the
        static modulo split), or the policy's pinned assignment."""
        from petastorm_tpu_torch.dataset_state import cache_state_home
        from petastorm_tpu_torch.parallel.topology import (HostTopology,
                                                           default_topology_journal_path)
        journal_path = policy.journal_path or default_topology_journal_path(
            self._state_url, cache_state_home(cache))
        if journal_path is None:
            raise ValueError('topology= needs a membership journal on shared storage, but '
                             'this dataset has no local state home (remote store, no '
                             'cache): pass TopologyPolicy(journal_path=...)')
        self._topology = HostTopology(policy, journal_path, len(row_groups),
                                      registry=self._telemetry)
        bad = [i for i in self._topology.assignment if not 0 <= i < len(row_groups)]
        if bad:
            self._topology.close()
            raise ValueError('topology assignment names global rowgroup indices {} outside '
                             'this dataset\'s {} filtered rowgroup(s): the policy was dealt '
                             'against another dataset or filter'.format(bad, len(row_groups)))
        return [row_groups[i] for i in self._topology.assignment]

    # ------------------------------------------------------ observability planes

    def _start_lineage(self, cache, items, row_groups, construction_quarantine, seed,
                       shuffle_row_groups, num_epochs, cur_shard, shard_count, shard_seed,
                       drop_partitions, resume_state, skip_by_iteration):
        """Build the lineage recorder and write its manifest header: the run's
        exact reproduction record (the JAX package's keys), which ``lineage
        verify`` replays without reading data."""
        from petastorm_tpu_torch.dataset_state import cache_state_home
        from petastorm_tpu_torch.telemetry.lineage import (LineageRecorder,
                                                           build_manifest_logger,
                                                           canonical_identity)
        manifest_jsonl, manifest_path = build_manifest_logger(
            self._lineage_policy, self._state_url, self.dataset_token,
            cache_state_home(cache))
        self._lineage = LineageRecorder(
            self.dataset_token, self._lineage_policy, jsonl=manifest_jsonl,
            manifest_path=manifest_path, registry=self._telemetry,
            resume_state=self._resume_lineage)
        header = {
            'dataset_url': self._state_url,
            'seed': seed,
            'shuffle_row_groups': bool(shuffle_row_groups),
            'num_epochs': num_epochs,
            'pre_shuffles': self._epochs_consumed,
            'resumed': resume_state is not None,
            'cur_shard': cur_shard, 'shard_count': shard_count,
            'shard_seed': shard_seed,
            'drop_partitions': drop_partitions,
            'items_per_epoch': len(items),
            # what each epoch's reorder permutes, in construction order:
            # [piece, fragment, rowgroup, row_range, drop], coerced as the
            # deliveries fold, so replay and recording agree on types
            'items': [[int(item['piece_index'])] + canonical_identity(
                0, item['fragment_path'], item['row_group_id'], item.get('row_range'),
                item['shuffle_row_drop_partition'][0])[1:] for item in items],
            # this shard's rowgroups, for the footer-only cross-check
            'shard_rowgroups': [
                [str(rg.fragment_path),
                 int(rg.row_group_id) if rg.row_group_id is not None else None,
                 int(rg.row_group_num_rows)] for rg in row_groups],
            'quarantined_fragments': sorted(record.fragment_path
                                            for record in construction_quarantine),
            'schedule': (self._cost_scheduler.plan_fingerprint()
                         if self._cost_scheduler is not None else None),
        }
        if self._topology is not None:
            # the negotiated identity and shard map, only when armed: a static
            # recording keeps the header the JAX package writes for it
            header['topology'] = self._topology.header()
        if skip_by_iteration:
            header['skip_by_iteration'] = {
                str(k): sorted(list(item) for item in v)
                for k, v in skip_by_iteration.items()}
        self._lineage.write_header(header)

    def _start_incidents(self, cache, seed, num_epochs, shuffle_row_groups, cur_shard,
                         shard_count, on_error, reader_pool):
        """Build the incident recorder: its evidence sources, and the edges it
        subscribes to (every breaker of this process's board, the SLO
        tracker's breach edge; the others are polled per batch)."""
        from petastorm_tpu_torch.dataset_state import cache_state_home
        from petastorm_tpu_torch.resilience import default_board
        from petastorm_tpu_torch.telemetry.incident import (IncidentRecorder,
                                                            default_incident_home)
        self._incidents = IncidentRecorder(
            default_incident_home(cache_state_home(cache)),
            self._incident_policy, registry=self._telemetry)
        self._incidents.add_source('metrics', self.telemetry_snapshot)
        self._incidents.add_source(
            'slo', lambda: self._evaluate_slo(self.telemetry_snapshot()))
        self._incidents.add_source('breakers', self._breaker_evidence)
        self._incidents.add_source('quarantine', self.quarantine.as_dicts)
        if self._cost_scheduler is not None:
            self._incidents.add_source('costs', self._cost_scheduler.report)
        if self._lineage is not None:
            self._incidents.add_source('lineage', self._lineage.report)
        if self._autotune is not None:
            self._incidents.add_source('autotune', self._autotune.report)
        if self._topology is not None:
            self._incidents.add_source('topology', self._topology.report)
            # construction-time edges: a corrupt membership journal, and a
            # reader that came up as a reshard survivor
            if self._topology.frames_dropped:
                self._incidents.trigger('ledger_corrupt', args={
                    'journal': self._topology.journal.path,
                    'frames_dropped': self._topology.frames_dropped, 'plane': 'topology'})
            if self._topology.generation > 0:
                self._incidents.trigger('host_reshard', args={
                    'generation': self._topology.generation,
                    'host_id': self._topology.host_id,
                    'assignment': list(self._topology.assignment)})
        provenance = {
            'dataset_url': self._state_url,
            'dataset_token': self.dataset_token,
            'seed': seed, 'num_epochs': num_epochs,
            'shuffle_row_groups': bool(shuffle_row_groups),
            'cur_shard': cur_shard, 'shard_count': shard_count,
            'topology': self._topology.header() if self._topology is not None else None,
            'on_error': on_error,
            'pool': type(reader_pool).__name__,
            'items_per_epoch': self._items_per_epoch,
        }
        self._incidents.add_source('config', lambda: provenance)
        default_board().observe_transitions(self._incidents.on_breaker_transition)
        self._slo.observe_breaches(self._on_slo_breach)

    def _start_history(self, cache, seed, num_epochs, shuffle_row_groups, shuffle_rows,
                       cur_shard, shard_count, on_error, reader_pool, is_batched_reader,
                       transform_spec, autotune_policy):
        """Build the run historian (one record appended at :meth:`stop`) and
        the regression sentinel, and seed the autotuner from the last good
        record under ``AutotunePolicy(warm_start=True)``."""
        from petastorm_tpu_torch.dataset_state import cache_state_home
        from petastorm_tpu_torch.telemetry.history import (RunHistorian,
                                                           default_history_path,
                                                           fingerprint)
        from petastorm_tpu_torch.telemetry.sentinel import (RegressionSentinel,
                                                            resolve_sentinel_policy)
        history_path = (self._history_policy.path
                        or default_history_path(self._state_url, cache_state_home(cache)))
        if history_path is not None:
            self._history = RunHistorian(history_path, self._history_policy,
                                         registry=self._telemetry)
        # the run's configuration identity, frozen now (the JAX package's keys)
        self._history_fingerprints = {
            'config': fingerprint({
                'seed': seed, 'num_epochs': num_epochs,
                'shuffle_row_groups': bool(shuffle_row_groups),
                'shuffle_rows': bool(shuffle_rows),
                'cur_shard': cur_shard, 'shard_count': shard_count,
                'on_error': on_error,
                'pool': type(reader_pool).__name__,
                'batched': bool(is_batched_reader),
                'transform': transform_spec is not None,
                'device_decode_fields': sorted(self.device_decode_fields),
                'items_per_epoch': self._items_per_epoch}),
            'storage': (fingerprint(repr(self._storage_policy))
                        if self._storage_policy is not None else None),
            'schedule': (self._cost_scheduler.plan_fingerprint()
                         if self._cost_scheduler is not None else None),
        }
        sentinel_policy = resolve_sentinel_policy(self._history_policy.sentinel)
        if sentinel_policy is not None:
            self._sentinel = RegressionSentinel(
                sentinel_policy, owner='reader', registry=self._telemetry,
                incidents=self._incidents, dataset_token=self.dataset_token)
            if self._incidents is not None:
                self._incidents.add_source('sentinel', self._sentinel.report)
        if (self._autotune is not None and self._history is not None
                and getattr(autotune_policy, 'warm_start', False)):
            self._warm_start_autotune()

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
                                      trace=batch.trace, lineage=batch.lineage)
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
            if self._incidents is not None:
                # a reaped hang and a skipped rowgroup are distinct causes
                self._incidents.trigger(
                    'watchdog_reap' if record.reason == 'hang' else 'quarantine',
                    ctx=(record.epoch, record.piece_index, record.attempts),
                    args=record.as_dict())
        breakers = getattr(batch, 'breakers', None)
        opened = []
        with self._accounting_lock:
            self._io_retries += getattr(batch, 'retries', 0)
            if breakers:
                if self._incidents is not None:
                    # worker breakers arrive as states, not callbacks: the
                    # closed -> open edge is read against the last state seen
                    opened = [(name, state) for name, state in breakers.items()
                              if state.get('state') == 'open'
                              and (self._breaker_states.get(name) or {}).get('state')
                              != 'open']
                self._breaker_states.update(breakers)
        for name, state in opened:
            self._incidents.trigger('breaker_open', args={'breaker': name, 'snapshot': state})
        stage_times = getattr(batch, 'telemetry', None)
        if stage_times:
            # additive, so a respawned worker's fresh recorder merges like any
            self._telemetry.merge_stage_times(stage_times)
            if self._cost_scheduler is not None and batch.item_id is not None:
                # the live cost feed: a batch's sidecar holds (mostly) its own
                # rowgroup's stage times, persisted into the ledger at stop()
                self._cost_scheduler.observe(batch.item_id[1], stage_times)
        trace_sidecar = getattr(batch, 'trace', None)
        if trace_sidecar:
            # the producing thread's events land in this process's recorder,
            # keeping their pid: one dump_trace() spans every process
            merge_trace_events(trace_sidecar)
        if self._incidents is not None:
            # the process pool's CRC drops only ever grow: a delta is the edge
            crc_failures = getattr(self._pool, '_shm_crc_failures', 0)
            if crc_failures > self._incident_last_crc_failures:
                self._incident_last_crc_failures = crc_failures
                self._incidents.trigger('shm_crc_drop',
                                        args={'shm_crc_failures': crc_failures})
        if self._sentinel is not None:
            # one float compare a batch; the evaluation runs when a window is due
            from petastorm_tpu_torch.telemetry.slo import slo_clock
            if self._sentinel.due(slo_clock() - self._started_at):
                self._evaluate_slo(self.telemetry_snapshot())
        item_id = batch.item_id
        if item_id is None:
            return
        if self._lineage is not None:
            # one deliver a work item on every pool, folded at its
            # ventilation-order slot
            self._lineage.deliver(item_id, batch.num_rows or 0,
                                  fingerprint=getattr(batch, 'lineage', None),
                                  quarantined=record is not None)
            if self._incidents is not None:
                divergences = self._lineage.divergence_count
                if divergences > self._incident_last_divergence:
                    self._incident_last_divergence = divergences
                    self._incidents.trigger('lineage_divergence', ctx=item_id,
                                            args={'divergence_count': divergences})
        epoch, piece, drop = item_id
        if trace_enabled():
            # the consumer-side anchor of the rowgroup's trace, on every pool
            trace_instant('rowgroup_consumed', ctx=(epoch, piece, 0),
                          args={'rows': batch.num_rows})
        if self._topology is not None:
            # journaled under its global rowgroup index: what a reshard
            # subtracts to re-deal only the undelivered rest
            self._topology.note_progress(epoch, piece, drop)
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
                'stream. Rebuild with the original sharding, or restore across '
                'topologies via petastorm_tpu_torch.parallel.topology.'
                'merge_topology_states'.format(saved_shard, self._shard_config))
        saved_topology = state.get('topology')
        if saved_topology is not None:
            if self._topology is None:
                raise ValueError(
                    'resume_state was captured by a topology-armed reader (identity '
                    '{}/{}), but this reader is static-sharded: restore through '
                    'make_reader(topology=...) (see topology.policy_from_state)'.format(
                        saved_topology.get('process_index'),
                        saved_topology.get('process_count')))
            if list(saved_topology.get('assignment') or []) != \
                    list(self._topology.assignment):
                raise ValueError(
                    'resume_state was dealt assignment {!r}, but this reader negotiated '
                    '{!r}: re-deal the checkpoint with topology.merge_topology_states '
                    'before resuming on a changed topology'.format(
                        saved_topology.get('assignment'),
                        list(self._topology.assignment)))
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
        # the digest's chain value and pending suffix: a resumed reader folds
        # to the digest of an uninterrupted run
        self._resume_lineage = state.get('lineage')
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
        ``Reader.state_dict``: a lineage-armed reader's carries the digest
        state under ``lineage``, a topology-armed one's its identity and
        global assignment under ``topology`` (what
        :func:`~petastorm_tpu_torch.parallel.topology.merge_topology_states`
        re-deals onto another host count).

        The unit is the work item (rowgroup x drop partition): an item counts
        as consumed once all its rows were emitted (``consumed_by_epoch`` maps
        epoch offsets to consumed ``[piece, drop]`` items; several epochs can be
        partly consumed at once). Taken mid-item on the row path, the state
        also holds a ``row_cursor`` (item and next row) and resume continues at
        that row: exact when the in-item row order is reproducible
        (``shuffle_rows=False`` or a fixed ``seed``). Results published by
        workers but not yet popped are read again. Call from the consuming
        thread, between ``next()`` calls.

        A cost-scheduled reader's state carries its plan's fingerprint under
        ``schedule``; one whose plan split rowgroups refuses to checkpoint
        (the sub-range items cannot be resumed)."""
        if self._cost_scheduler is not None and self._cost_scheduler.split_count:
            raise ValueError(
                'state_dict() is not supported on a cost-scheduled reader whose plan '
                'split rowgroups ({} split(s)): the sub-range work-item coordinates '
                'cannot be resumed. Checkpoint with cost_schedule disabled, or a '
                'SchedulePolicy(split=False).'.format(self._cost_scheduler.split_count))
        # outside the accounting lock (the recorder has its own): no deliver
        # interleaves, since this runs on the consuming thread
        lineage_state = self._lineage.state_dict() if self._lineage is not None else None
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
            if self._topology is not None:
                state['topology'] = self._topology.state_block()
            if cursor is not None:
                (epoch, piece, drop), next_row = cursor
                state['row_cursor'] = {'epoch_offset': epoch - self._epochs_consumed,
                                       'piece': piece, 'drop': drop,
                                       'next_row': next_row}
            if lineage_state is not None:
                state['lineage'] = lineage_state
        if self._cost_scheduler is not None:
            state['schedule'] = self._cost_scheduler.plan_fingerprint()
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

    @property
    def telemetry(self):
        """The reader's own :class:`~petastorm_tpu_torch.telemetry.MetricsRegistry`
        (the workers' sidecar stage times merge here); :meth:`telemetry_snapshot`
        adds the pool's."""
        return self._telemetry

    def telemetry_snapshot(self):
        """One JSON-safe telemetry snapshot covering every process: the
        reader's registry (with the workers' stage times) merged with the
        pool's consumer-side registry (``pool_wait``, and on the process pool
        ``shm_map``/``shm_release``/``wire_bytes_copied``). Feed it to
        :func:`~petastorm_tpu_torch.telemetry.analyze.attribute_bottleneck` or
        :func:`~petastorm_tpu_torch.telemetry.export.to_prometheus_text`."""
        from petastorm_tpu_torch.telemetry import merge_snapshots
        pool_registry = getattr(self._pool, 'telemetry', None)
        storage_snapshot = None
        if self._storage_policy is not None:
            # the storage engine's process-local counters: all of them on
            # in-process pools (process-pool workers keep theirs)
            from petastorm_tpu_torch.storage import storage_metrics_snapshot
            storage_snapshot = storage_metrics_snapshot()
        if pool_registry is None and storage_snapshot is None:
            return self._telemetry.snapshot()
        return merge_snapshots(self._telemetry.snapshot(),
                               pool_registry.snapshot() if pool_registry is not None
                               else None,
                               storage_snapshot)

    def _evaluate_slo(self, snapshot):
        from petastorm_tpu_torch.telemetry.slo import slo_clock
        report = self._slo.evaluate(snapshot, slo_clock() - self._started_at,
                                    rows=self.rows_consumed, registry=self._telemetry)
        if self._sentinel is not None:
            # the sentinel windows the SLO report's cumulative series; its own
            # min_window_s keeps extra evaluations from shrinking a window
            self._sentinel.observe(report)
            self._sentinel.export_gauges()
        return report

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
        if self._lineage is not None:
            lineage = self._lineage.report()
            gauges['lineage_items_folded'] = lineage['items_folded']
            gauges['lineage_pending_items'] = lineage['pending_items']
        if self._sentinel is not None:
            gauges.update(self._sentinel.gauges())
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

    def cost_ledger(self, ledger=None):
        """The flight recorder's per-rowgroup span history of this read folded
        into a :class:`~petastorm_tpu_torch.telemetry.cost_model.CostLedger`
        (``ledger`` continues one of the same :attr:`dataset_token`; default a
        fresh one). Empty unless tracing was armed for the read
        (``trace=True`` or ``PETASTORM_TPU_TRACE=1``). Split pieces count
        toward their rowgroup. The one-command form is
        ``petastorm-tpu-torch-throughput costs <dataset_url>``."""
        from petastorm_tpu_torch.telemetry.cost_model import CostLedger
        from petastorm_tpu_torch.telemetry.tracing import trace_snapshot
        if ledger is None:
            ledger = CostLedger(self.dataset_token)
        ledger.ingest_trace(trace_snapshot(), dict(self._piece_locator))
        return ledger

    def order_digest(self):
        """The chained order digest over every item delivered so far: a hex
        string equal on the dummy, thread, process and service pools for one
        seed, shard and schedule, and under worker respawns. None without
        ``lineage``."""
        if self._lineage is None:
            return None
        return self._lineage.order_digest()

    def _breaker_evidence(self):
        """The incident bundle's ``breakers`` source: the workers' states
        merged with this process's board."""
        from petastorm_tpu_torch.resilience import default_board
        with self._accounting_lock:
            breakers = dict(self._breaker_states)
        breakers.update(default_board().snapshot())
        return breakers

    def _on_slo_breach(self, report):
        """The SLO tracker's ok -> breach edge: one ``slo_breach`` incident."""
        if self._incidents is not None:
            self._incidents.trigger('slo_breach',
                                    args={'efficiency': report.get('efficiency'),
                                          'target': report.get('target_efficiency'),
                                          'wait_seconds': report.get('wait_seconds')})

    def incident_report(self):
        """The incident recorder's summary (captures, rate-limited triggers,
        the retained bundles); None without ``incidents``."""
        if self._incidents is None:
            return None
        return self._incidents.report()

    def build_history_record(self):
        """The run record :meth:`stop` appends: fingerprints, rows/s and
        efficiency, stage shares, storage counters, incident and quarantine
        counts. None without ``history``. Knob values are read live, so call
        it before ``stop()`` restores the autotuner's knobs."""
        if self._history_policy is None:
            return None
        from petastorm_tpu_torch.telemetry.history import build_run_record, fingerprint
        from petastorm_tpu_torch.telemetry.slo import efficiency_from_snapshot, slo_clock
        elapsed = slo_clock() - self._started_at
        snapshot = self.telemetry_snapshot()
        rows = self.rows_consumed
        knobs = {}
        try:
            from petastorm_tpu_torch.autotune.knobs import build_reader_knobs
            knobs = {knob.knob_id: float(knob.get()) for knob in build_reader_knobs(self)}
        except Exception:  # noqa: BLE001 - the record is advisory; a dead knob target must not fail stop()
            logger.debug('history: knob capture failed', exc_info=True)
        fingerprints = dict(self._history_fingerprints)
        fingerprints['knobs'] = fingerprint(knobs) if knobs else None
        return build_run_record(
            'reader', self.dataset_token, elapsed, rows, snapshot=snapshot,
            slo_report=efficiency_from_snapshot(snapshot, elapsed, rows=rows),
            fingerprints=fingerprints, knobs=knobs, incidents=self.incident_report(),
            quarantined=len(self.quarantine),
            cost_skew=(self._cost_scheduler.cost_skew()
                       if self._cost_scheduler is not None else None))

    def _warm_start_autotune(self):
        """``AutotunePolicy(warm_start=True)``: seed the knobs from the newest
        same-token, same-platform record before the controller's first
        window; nothing (a debug line) when the store holds none."""
        from petastorm_tpu_torch.telemetry.history import (last_good_record, load_records,
                                                           run_platform)
        try:
            records, _dropped = load_records(self._history.path)
            record = last_good_record(records, self.dataset_token, run_platform())
            if record is None:
                logger.debug('autotune warm start: no comparable run record in %s',
                             self._history.path)
                return
            applied = self._autotune.warm_start(record.get('knobs') or {})
            if applied:
                logger.info('autotune warm start: seeded %s from the run recorded at %s',
                            {k: v['to'] for k, v in applied.items()},
                            record.get('recorded_unix_s'))
        except Exception:  # noqa: BLE001 - a failed warm start means defaults, not a dead reader
            logger.warning('autotune warm start failed; starting from defaults',
                           exc_info=True)

    def _write_history_record(self):
        """Append this run's record (once), before the autotuner restores
        its knobs."""
        if self._history is None or self._history_written:
            return
        self._history_written = True
        try:
            record = self.build_history_record()
            if record is not None:
                self._history.append(record)
        except Exception:  # noqa: BLE001 - a read that succeeded must not fail over its history
            logger.warning('could not record this run in the history store', exc_info=True)

    def history_report(self):
        """The historian's store status (path, appended records, dropped
        frames); None without ``history``."""
        if self._history is None:
            return None
        return self._history.state()

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
        the controller's report (only with ``autotune``); ``schedule``, the
        cost scheduler's report (only with ``cost_schedule``); ``lineage``,
        ``incidents``, ``history``, ``sentinel`` and ``topology``, each plane's
        report, and ``storage``, the ingest engine's policy and counters (each
        only when armed)."""
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
        if self._cost_scheduler is not None:
            diag['schedule'] = self._cost_scheduler.report()
        if self._lineage is not None:
            diag['lineage'] = self._lineage.report()
        if self._incidents is not None:
            diag['incidents'] = self._incidents.report()
        if self._history is not None:
            diag['history'] = self._history.state()
        if self._sentinel is not None:
            diag['sentinel'] = self._sentinel.report()
        if self._topology is not None:
            diag['topology'] = self._topology.report()
        if self._storage_policy is not None:
            counters = snapshot.get('counters') or {}
            diag['storage'] = {
                'policy': {'coalesce_gap_bytes': self._storage_policy.coalesce_gap_bytes,
                           'max_in_flight': self._storage_policy.max_in_flight,
                           'hedge_enabled': self._storage_policy.hedge_enabled},
                'footer_cache_hits': int(counters.get('storage_footer_cache_hit', 0)),
                'footer_cache_misses': int(counters.get('storage_footer_cache_miss', 0)),
                'ranges_coalesced': int(counters.get('storage_ranges_coalesced', 0)),
                'hedges_fired': int(counters.get('storage_hedge_fired', 0)),
                'hedges_won': int(counters.get('storage_hedge_won', 0)),
            }
        return diag

    # --------------------------------------------------------------- lifecycle

    def stop(self):
        self._stopped = True
        if self._metrics_server is not None:
            # the scrape plane goes first: a scrape must not race the teardown
            self._metrics_server.stop()
        # the run record first: the autotuner's stop restores its knobs, and
        # the record keeps the values the run ran with
        self._write_history_record()
        if self._autotune is not None:
            # no knob turns once the pool starts tearing down
            self._autotune.stop()
        if self._cost_scheduler is not None:
            # this run's observations go to the next one; a read never fails
            # over its cost bookkeeping
            try:
                self._cost_scheduler.persist()
            except Exception:  # noqa: BLE001 - ledger persistence is advisory
                logger.warning('could not persist the cost ledger', exc_info=True)
        if self._lineage is not None:
            self._lineage.close()   # flushes the last manifest record
        if self._incidents is not None:
            # detaches the sources; the bundles stay on disk for the autopsy
            self._incidents.close()
        if self._topology is not None:
            # a clean leave, so survivors re-deal without waiting out the lease
            self._topology.close()
        self._pool.stop()

    def join(self):
        self._pool.join()

    def cleanup(self):
        """petastorm's reader API: nothing to release beyond :meth:`stop` and
        :meth:`join`."""

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        self.join()


def _traced_ventilate(pool_ventilate, lineage=None):
    """A pool's ``ventilate`` that puts each item's birth on the flight
    recorder's timeline: the ``ventilate`` instant is the causal origin of a
    rowgroup's trace. One enabled check an item while tracing is off. With a
    lineage recorder each item is also EXPECTED here: ventilation order is the
    digest's fold order, so the digest is equal on pools whose completion
    order is not."""
    def ventilate(**kwargs):
        if trace_enabled():
            trace_instant('ventilate', ctx=(int(kwargs.get('epoch_index', 0)),
                                            int(kwargs['piece_index']), 0))
        if lineage is not None:
            lineage.expect(int(kwargs.get('epoch_index', 0)), int(kwargs['piece_index']),
                           int(kwargs['shuffle_row_drop_partition'][0]),
                           str(kwargs.get('fragment_path', '')),
                           kwargs.get('row_group_id'), kwargs.get('row_range'))
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
