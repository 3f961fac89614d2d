"""The rowgroup worker: loads one Parquet rowgroup (in two phases when a
predicate is given), keeps its shuffle-row-drop partition, decodes it through
the compiled decode plan, serves and fills the rowgroup cache, applies the
seeded in-rowgroup shuffle and the :class:`TransformSpec`, and publishes a
columnar batch; NGram readers publish the piece's windows instead
(:mod:`~petastorm_tpu_torch.ngram_worker`). A trimmed copy of
``petastorm_tpu.reader_worker`` (the object-store ingest engine and the
lineage fingerprints are left out).

Telemetry is the JAX package's: the load, decode, shuffle and transform run
under stage spans (``fs_open``, ``rowgroup_read``, ``decode``, ``shuffle``,
``transform``, ``cache_hit``/``cache_miss``), every item runs under its causal
trace context ``(epoch, rowgroup, attempt)``, and the single publish funnel
drains the thread's stage times and trace events into the payload's
``telemetry`` and ``trace`` sidecars, which the reader merges.

Under ``on_error='retry'`` or ``'skip'`` the load runs under the reader's
:class:`~petastorm_tpu_torch.resilience.RetryPolicy`, behind a circuit breaker
of the fragment's directory; under ``'skip'`` a piece that still fails is
published as an empty batch carrying its
:class:`~petastorm_tpu_torch.resilience.QuarantineRecord`, so the reader's
accounting sees every item once on every pool.
"""

import hashlib
import logging
import os
import pickle
import re
import time

import numpy as np
import pyarrow as pa
import pyarrow.dataset as pads

from petastorm_tpu_torch import decode_engine
from petastorm_tpu_torch.cache import NullCache
from petastorm_tpu_torch.telemetry.spans import drain_stage_times, record_stage, stage_span
from petastorm_tpu_torch.telemetry.tracing import (clear_trace_context,
                                                   current_dispatch_attempt,
                                                   drain_trace_events, set_trace_context,
                                                   trace_instant)
from petastorm_tpu_torch.transform import transform_schema
from petastorm_tpu_torch.workers.serializers import columns_num_rows
from petastorm_tpu_torch.workers.worker_base import WorkerBase

logger = logging.getLogger(__name__)

#: the filesystem breaker of a path prefix (the JAX package's settings): well
#: above one rowgroup's retry budget, so one bad file does not open it for its
#: whole directory, while a stall of every open crosses it within a piece or two
FS_BREAKER_THRESHOLD = 10
FS_BREAKER_RECOVERY_S = 30.0


class ColumnarBatch(object):
    """Decoded columns of (a drop partition of) one rowgroup:
    ``{field_name: ndarray | list}``. ``item_id`` ``(epoch, piece_index,
    drop_partition)`` names the work item that produced it, the unit of the
    reader's checkpoint accounting (empty batches are published to carry it).
    ``cache_hit`` is True when the batch was served from the rowgroup cache,
    False on a miss that filled it, None when no cache applied. ``retries``
    counts the transient-IO retries spent on it; ``quarantine`` is the
    :class:`~petastorm_tpu_torch.resilience.QuarantineRecord` of an empty batch
    that stands in for a skipped rowgroup; ``breakers`` holds the producing
    process's tripped breakers (``{name: state}``, None when all are healthy).
    ``telemetry`` is the stage-span sidecar (``{stage: histogram_snapshot}``
    drained from the producing thread since its previous publish) and
    ``trace`` the flight-recorder sidecar (that thread's drained trace
    events); both are None when empty or off."""

    __slots__ = ('columns', 'num_rows', 'item_id', 'cache_hit', 'retries', 'quarantine',
                 'breakers', 'telemetry', 'trace')

    def __init__(self, columns, num_rows, item_id=None, cache_hit=None, retries=0,
                 quarantine=None, breakers=None, telemetry=None, trace=None):
        self.columns = columns
        self.num_rows = num_rows
        self.item_id = item_id
        self.cache_hit = cache_hit
        self.retries = retries
        self.quarantine = quarantine
        self.breakers = breakers
        self.telemetry = telemetry
        self.trace = trace


class WorkerSetup(object):
    """Per-reader configuration shared by every worker. ``batched_output``
    marks the batch reader: it emits stored values without codec decode, and
    its transform ``func`` takes a ``DataFrame`` unless the spec is
    ``batched``. ``dataset_token`` is the cache key's identity of the store
    and the read configuration. ``retry_policy`` is the one
    :func:`~petastorm_tpu_torch.resilience.resolve_retry_policy` gives for
    ``on_error``."""

    __slots__ = ('filesystem', 'schema', 'fields_to_read', 'result_schema',
                 'transform_spec', 'batched_output', 'shuffle_rows', 'seed',
                 'partition_field_names', 'device_decode_fields', 'ngram', 'cache',
                 'dataset_token', 'predicate_token', 'on_error', 'retry_policy')

    def __init__(self, filesystem, schema, fields_to_read, transform_spec=None,
                 batched_output=False, shuffle_rows=False, seed=None,
                 partition_field_names=(), device_decode_fields=(), ngram=None,
                 cache=None, dataset_path_or_paths=None, predicate=None,
                 on_error='raise', retry_policy=None):
        from petastorm_tpu_torch.resilience import resolve_retry_policy
        self.on_error = on_error
        self.retry_policy = resolve_retry_policy(on_error, retry_policy)
        self.filesystem = filesystem
        self.schema = schema
        self.fields_to_read = list(fields_to_read)
        self.transform_spec = transform_spec
        self.batched_output = batched_output
        self.shuffle_rows = shuffle_rows
        self.seed = seed
        self.partition_field_names = set(partition_field_names)
        #: fields whose payloads skip host decode and ship raw to the loader's
        #: device decode tail
        self.device_decode_fields = frozenset(device_decode_fields)
        self.ngram = ngram
        self.cache = cache or NullCache()
        # cached values are the decoded output, so the identity covers the
        # store, the fields, the decode mode and each field's codec
        field_specs = [
            (name, str(field.numpy_dtype), str(field.shape),
             str(field.codec.to_config()) if field.codec is not None else 'none')
            for name, field in schema.fields.items() if name in self.fields_to_read]
        token = '{}|{}|{}|{}|{}'.format(dataset_path_or_paths, sorted(self.fields_to_read),
                                        not batched_output, transform_spec is not None,
                                        sorted(field_specs))
        if self.device_decode_fields:
            token += '|{}'.format(sorted(self.device_decode_fields))
        if ngram is not None:
            # an NGram entry holds the window starts this NGram formed
            token += '|ngram:{}|{}|{}|{}'.format(
                sorted((offset, sorted(ngram.get_field_names_at_timestep(offset)))
                       for offset in ngram.fields),
                ngram.delta_threshold, ngram.timestamp_field_name, ngram.timestamp_overlap)
        self.dataset_token = hashlib.md5(token.encode('utf-8')).hexdigest()[:16]
        #: the cache key's identity of the worker predicate, made once; None
        #: bypasses the cache (no cache, or a predicate that does not pickle)
        self.predicate_token = (None if isinstance(self.cache, NullCache)
                                else _predicate_token(predicate))
        read_view = schema.create_schema_view(
            [re.escape(name) for name in self.fields_to_read])
        if transform_spec is not None:
            self.result_schema = transform_schema(read_view, transform_spec)
        else:
            self.result_schema = read_view


class RowGroupWorker(WorkerBase):
    """Loads and processes one rowgroup (drop partition) per ventilated item."""

    def __init__(self, worker_id, publish_func, args):
        super().__init__(worker_id, publish_func, args)
        self._setup = args
        self._parquet_format = pads.ParquetFileFormat()
        self._filesystem = None
        # compiled decode plans per (field set, ship raw), kept for the
        # worker's lifetime
        self._decode_plans = {}

    def _fs(self):
        # fs_open: the setup carries a built filesystem, so this times its
        # first resolution in this worker (one span a worker, as the JAX
        # worker's filesystem factory records)
        if self._filesystem is None:
            with stage_span('fs_open'):
                self._filesystem = self._setup.filesystem
        return self._filesystem

    def _publish(self, payload):
        """The single publish funnel: attach this thread's stage times and
        trace events since its previous publish, then hand the payload to the
        pool's results channel."""
        payload.telemetry = drain_stage_times()
        payload.trace = drain_trace_events()
        self.publish_func(payload)

    def process(self, piece_index, fragment_path, row_group_id, partition_keys=None,
                worker_predicate=None, shuffle_row_drop_partition=(0, 1), epoch_index=0):
        # every span and instant of the item, its publish included, carries
        # (epoch, rowgroup, dispatch attempt); the process pool's worker main
        # installs the attempt, the in-process pools leave 0
        set_trace_context(epoch_index, piece_index, current_dispatch_attempt())
        try:
            self._process_item(piece_index, fragment_path, row_group_id, partition_keys,
                               worker_predicate, shuffle_row_drop_partition, epoch_index)
        finally:
            clear_trace_context()

    def _process_item(self, piece_index, fragment_path, row_group_id, partition_keys,
                      worker_predicate, shuffle_row_drop_partition, epoch_index):
        setup = self._setup
        item_id = (epoch_index, piece_index, shuffle_row_drop_partition[0])
        # the retry goes around the loads only (shuffle and transform touch no
        # filesystem); under 'skip' any failure of the piece quarantines it
        retries = [0]

        def with_retry(load_fn):
            if setup.retry_policy is None:
                return load_fn()
            from petastorm_tpu_torch.resilience import (call_with_breaker, default_board,
                                                        run_with_retry)

            def on_retry(attempt, exc, delay):
                retries[0] += 1
                logger.warning('Transient IO failure on piece %s (%s rg %s), attempt %d: '
                               '%s; retrying in %.3fs', piece_index, fragment_path,
                               row_group_id, attempt, exc, delay)

            breaker = default_board().breaker(
                'fs:{}'.format(os.path.dirname(fragment_path) or fragment_path),
                failure_threshold=FS_BREAKER_THRESHOLD,
                recovery_timeout_s=FS_BREAKER_RECOVERY_S)
            return run_with_retry(lambda: call_with_breaker(load_fn, breaker),
                                  setup.retry_policy, key=piece_index,
                                  on_retry=on_retry)[0]

        try:
            if setup.ngram is not None:
                # every piece publishes, a piece of no window too: the reader's
                # accounting must see every item
                from petastorm_tpu_torch.ngram_worker import process_ngram_piece
                payload = process_ngram_piece(self, piece_index, fragment_path,
                                              row_group_id, partition_keys,
                                              shuffle_row_drop_partition, epoch_index,
                                              with_retry)
            else:
                payload = self._process_rows(item_id, fragment_path, row_group_id,
                                             partition_keys, worker_predicate,
                                             shuffle_row_drop_partition, with_retry)
        except Exception as exc:  # noqa: BLE001 - the on_error policy decides
            if setup.on_error != 'skip':
                raise
            payload = self._quarantined(exc, item_id, fragment_path, row_group_id,
                                        retries[0])
        payload.retries = retries[0]
        if setup.retry_policy is not None:
            from petastorm_tpu_torch.resilience import default_board
            payload.breakers = default_board().snapshot(only_tripped=True) or None
        self._publish(payload)

    def _process_rows(self, item_id, fragment_path, row_group_id, partition_keys,
                      worker_predicate, shuffle_row_drop_partition, with_retry):
        setup = self._setup
        piece_index = item_id[1]

        def load():
            return with_retry(lambda: self._load_and_decode(
                fragment_path, row_group_id, partition_keys, worker_predicate,
                shuffle_row_drop_partition))

        cache_hit = None
        if setup.predicate_token is None:
            # no cache, or a predicate with no stable identity: serving its rows
            # from an entry another predicate filled would be wrong
            columns = load()
        else:
            cache_key = '{}:{}:{}:{}:{}'.format(setup.dataset_token, fragment_path,
                                                row_group_id, shuffle_row_drop_partition,
                                                setup.predicate_token)
            filled = []

            def fill():
                filled.append(True)
                return load()

            cache_start = time.perf_counter()
            columns = setup.cache.get(cache_key, fill)
            cache_hit = not filled
            # cache_hit times serving from the cache; cache_miss is an
            # ENVELOPE span (it wraps the rowgroup_read/decode of the fill)
            record_stage('cache_hit' if cache_hit else 'cache_miss',
                         time.perf_counter() - cache_start)
        num_rows = columns_num_rows(columns)
        if num_rows:
            if setup.shuffle_rows:
                # the same seeded permutation petastorm_tpu's worker draws
                with stage_span('shuffle'):
                    seed = (None if setup.seed is None
                            else (setup.seed + piece_index) % (2 ** 31))
                    permutation = np.random.RandomState(seed).permutation(num_rows)
                    columns = {name: _take(col, permutation)
                               for name, col in columns.items()}
            columns, num_rows = self._apply_transform(columns, num_rows)
        # an emptied item is published too: every item yields exactly one
        # result, so the reader's consumption accounting stays exact
        return ColumnarBatch(columns if num_rows else {}, num_rows, item_id=item_id,
                             cache_hit=cache_hit)

    def _quarantined(self, exc, item_id, fragment_path, row_group_id, retries):
        """The empty stand-in of a skipped piece, carrying its record."""
        from petastorm_tpu_torch.resilience import QuarantineRecord
        record = QuarantineRecord.from_exception(
            exc, piece_index=item_id[1], fragment_path=fragment_path,
            row_group_id=row_group_id, attempts=retries + 1, epoch=item_id[0])
        # anomaly marker on the flight-recorder timeline (ctx = this item)
        trace_instant('quarantine', args={'reason': record.reason,
                                          'error_type': record.error_type})
        logger.warning('Quarantining rowgroup piece %s (%s rg %s) after %d attempt(s): '
                       '%s: %s', item_id[1], fragment_path, row_group_id, retries + 1,
                       type(exc).__name__, exc)
        return quarantine_stand_in(self._setup.ngram, item_id, record)

    # -------------------------------------------------------------------- load

    def _make_fragment(self, fragment_path, row_group_id):
        return self._parquet_format.make_fragment(fragment_path, self._fs(),
                                                  row_groups=[row_group_id])

    def _storage_columns(self, field_names):
        return [name for name in field_names
                if name not in self._setup.partition_field_names]

    def _load_and_decode(self, fragment_path, row_group_id, partition_keys,
                         worker_predicate, shuffle_row_drop_partition):
        """The piece's decoded columns: the predicate's survivors (if any),
        then the drop partition's equal share of them."""
        all_fields = self._setup.fields_to_read
        if worker_predicate is not None:
            table, keep = self._two_phase_load(fragment_path, row_group_id, partition_keys,
                                               worker_predicate, all_fields)
        else:
            fragment = self._make_fragment(fragment_path, row_group_id)
            with stage_span('rowgroup_read'):
                table = fragment.to_table(columns=self._storage_columns(all_fields))
            keep = np.arange(table.num_rows)
        part_index, num_parts = shuffle_row_drop_partition
        # the same equal split of the (kept) row indices petastorm_tpu's worker takes
        selected = np.array_split(keep, num_parts)[part_index] if num_parts > 1 else keep
        if len(selected) != table.num_rows:
            table = table.take(selected)
        return self._decode_table(table, partition_keys, all_fields,
                                  fragment_path=fragment_path)

    def _two_phase_load(self, fragment_path, row_group_id, partition_keys,
                        worker_predicate, all_fields):
        """Read the predicate's columns, evaluate it, then read only the other
        columns (each storage column is read once); returns the full table and
        the indices of the rows kept. The predicate evaluates on its decoded
        columns (:func:`~petastorm_tpu_torch.decode_engine.evaluate_predicate_mask`)."""
        setup = self._setup
        predicate_fields = sorted(worker_predicate.get_fields())
        unknown = [f for f in predicate_fields
                   if f not in setup.schema.fields and f not in setup.partition_field_names]
        if unknown:
            raise ValueError('Predicate references unknown fields {}'.format(unknown))
        fragment = self._make_fragment(fragment_path, row_group_id)
        with stage_span('rowgroup_read'):
            predicate_table = fragment.to_table(
                columns=self._storage_columns(predicate_fields))
        # a predicate reads decoded values, even of fields that ship raw
        predicate_columns = self._decode_table(predicate_table, partition_keys,
                                               predicate_fields, fragment_path=fragment_path,
                                               ship_raw=False)
        mask = self._evaluate_predicate(worker_predicate, predicate_columns,
                                        predicate_table.num_rows)
        keep = np.nonzero(mask)[0]
        all_storage = self._storage_columns(all_fields)
        if not len(keep):
            # no survivor: an empty table of the output columns, nothing read
            physical = fragment.physical_schema
            return (pa.table({name: pa.array([], type=physical.field(name).type)
                              for name in all_storage}), keep)
        have = set(predicate_table.column_names)
        remaining = [name for name in all_storage if name not in have]
        if remaining:
            with stage_span('rowgroup_read'):
                remaining_table = fragment.to_table(columns=remaining)
            table = pa.table({name: (predicate_table.column(name) if name in have
                                     else remaining_table.column(name))
                              for name in all_storage})
        else:
            table = predicate_table.select(all_storage)
        return table, keep

    def _evaluate_predicate(self, worker_predicate, predicate_columns, num_rows):
        if self._setup.batched_output:
            mask = np.asarray(worker_predicate.do_include(
                {k: np.asarray(v) for k, v in predicate_columns.items()}))
            if mask.shape != (num_rows,):
                raise ValueError('Batched predicate must return a boolean mask of shape '
                                 '({},); got {}'.format(num_rows, mask.shape))
            return mask
        return decode_engine.evaluate_predicate_mask(worker_predicate, predicate_columns,
                                                     num_rows)

    # ------------------------------------------------------------------ decode

    def _decode_table(self, table, partition_keys, field_names, fragment_path=None,
                      ship_raw=True):
        """Arrow table -> ``{name: ndarray-or-list}`` through the compiled plan
        of ``field_names`` (without the ship-raw kernels when not
        ``ship_raw``)."""
        setup = self._setup
        device_fields = setup.device_decode_fields if ship_raw else frozenset()
        key = (tuple(field_names), bool(device_fields))
        plan = self._decode_plans.get(key)
        if plan is None:
            plan = decode_engine.compile_decode_plan(
                setup.schema, list(field_names),
                partition_field_names=setup.partition_field_names,
                decode=not setup.batched_output, device_decode_fields=device_fields)
            self._decode_plans[key] = plan
        with stage_span('decode'):
            return plan.execute(table, partition_keys or {}, fragment_path=fragment_path)

    # --------------------------------------------------------------- transform

    def _apply_transform(self, columns, num_rows):
        setup = self._setup
        spec = setup.transform_spec
        if spec is None:
            return columns, num_rows
        with stage_span('transform'):
            return self._transform(spec, columns, num_rows)

    def _transform(self, spec, columns, num_rows):
        setup = self._setup
        fields = setup.result_schema.fields
        if spec.func is None:
            # a spec that only deletes, selects or redeclares fields
            return {name: columns[name] for name in fields}, num_rows
        if spec.batched:
            # whole columns in, whole columns out (both readers)
            out_columns = spec.func(dict(columns))
            out = {}
            out_rows = num_rows
            for name, field in fields.items():
                values = out_columns[name]
                if not isinstance(values, np.ndarray):
                    values = decode_engine.stack_if_uniform(list(values), field)
                out[name] = values
                out_rows = len(values)
            return out, out_rows
        if setup.batched_output:
            # the batch reader's pandas contract; pandas is needed only here
            import pandas as pd
            frame = pd.DataFrame({name: list(col) if not isinstance(col, list) else col
                                  for name, col in columns.items()})
            frame = spec.func(frame)
            return ({name: decode_engine.stack_if_uniform(list(frame[name]), field)
                     for name, field in fields.items()}, len(frame))
        # the row reader: func takes one row dict at a time
        rows = [spec.func({name: col[i] for name, col in columns.items()})
                for i in range(num_rows)]
        return ({name: decode_engine.stack_if_uniform([row[name] for row in rows], field)
                 for name, field in fields.items()}, len(rows))


def quarantine_stand_in(ngram, item_id, record):
    """The empty payload published (or, for a hang, made by the pool) in place
    of a quarantined item: an NGram reader's shape when ``ngram`` is set."""
    if ngram is not None:
        from petastorm_tpu_torch.ngram_worker import NGramWindows
        return NGramWindows({}, np.empty(0, np.int64), item_id=item_id, quarantine=record)
    return ColumnarBatch({}, 0, item_id=item_id, quarantine=record)


def hang_stand_in_factory(ngram):
    """The process pool's hang-quarantine hook for a reader under
    ``on_error='skip'``: maps an overdue item's keyword arguments to its empty
    stand-in carrying a ``QuarantineRecord(reason='hang')``."""
    def factory(item_kwargs, elapsed_s):
        from petastorm_tpu_torch.resilience import QuarantineRecord
        epoch = int(item_kwargs.get('epoch_index', 0))
        piece_index = int(item_kwargs['piece_index'])
        record = QuarantineRecord(
            piece_index=piece_index, fragment_path=item_kwargs.get('fragment_path', ''),
            row_group_id=item_kwargs.get('row_group_id'), error_type='WorkerHangError',
            error='no result after {:.3g}s; the worker holding this rowgroup was reaped '
                  'by the watchdog'.format(elapsed_s),
            attempts=1, epoch=epoch, reason='hang')
        item_id = (epoch, piece_index, item_kwargs['shuffle_row_drop_partition'][0])
        return quarantine_stand_in(ngram, item_id, record)
    return factory


def _predicate_token(worker_predicate):
    """A stable cache token of a predicate (an md5 of its pickle), ``'nopred'``
    without one, None when it does not pickle (the caller then bypasses the
    cache)."""
    if worker_predicate is None:
        return 'nopred'
    try:
        return hashlib.md5(pickle.dumps(worker_predicate)).hexdigest()[:12]
    except Exception:  # noqa: BLE001 - any pickling failure means no stable identity
        logger.debug('predicate %s has no stable cache token; bypassing the rowgroup '
                     'cache for it', type(worker_predicate).__name__, exc_info=True)
        return None


def _take(col, indices):
    if isinstance(col, np.ndarray):
        return col[indices]
    return [col[i] for i in indices]
