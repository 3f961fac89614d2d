"""TorchDataLoader: reader -> batches of torch tensors on the card, with a
prefetching producer thread, one pinned upload per batch and input-stall
accounting. The counterpart of ``petastorm_tpu.parallel.loader.JaxDataLoader``.

- Batches are assembled columnar on the host (numpy), optionally through the
  seeded shuffling buffer, which draws the same stream as the JAX loader's.
- A background producer thread keeps ``prefetch`` batches in flight, so host
  IO and decode, the upload and the device decode tail overlap the training
  step.
- Upload (``coalesce_fields``, on by default on the card, off on the CPU):
  every field of a batch is packed into ONE pinned host buffer, copied with
  ``non_blocking=True`` on a side CUDA stream and split on the card into
  per-field ``view(dtype)`` slices. This replaces the JAX loader's coalesced
  upload plus on-device unpack program: JAX exposes no pinned host memory,
  PyTorch does. Off, or for a batch that cannot pack (a column that is not a
  native-endian numeric array), each field is pinned and copied by itself;
  ``stats`` counts both kinds. The device decode tail runs on the same side stream;
  a CUDA event recorded after it is waited on by the consumer's stream before
  the batch is handed out, and every tensor is ``record_stream``-ed on the
  consumer's stream so the allocator does not reuse it early.
- ``stats.input_stall_fraction`` is the share of the consumer's time spent
  blocked waiting for the next batch.

:meth:`TorchDataLoader.scan_stream` runs the stream through whole-chunk
programs instead (one CUDA graph replay per chunk of batches on the card).

:meth:`TorchDataLoader.state_dict` is the JAX loader's delivery-exact read
position: a work item counts as consumed once every one of its rows was
yielded to the caller (uploaded or queued batches do not count), and the
state resumes a reader through ``resume_state=``. :func:`make_torch_loader`
builds the reader and the loader in one call.

With a ``mesh`` (a ``torch.distributed`` ``DeviceMesh``), each field of a
batch is a ``DTensor`` made by ``DTensor.from_local`` from this rank's rows
with the placements of ``partition_spec`` (:class:`FieldShardings`): no
collective runs in the input path, as ``make_array_from_process_local_data``
runs none in the JAX loader. ``batch_size`` counts this rank's rows. The
reader decides which rows a rank holds: shard it by the coordinate of the
mesh dimension that splits the batch
(:func:`~petastorm_tpu_torch.parallel.mesh.mesh_shard_info`), not by the
global rank, so that the ranks along the other dimensions (``'stage'`` of a
``('stage', 'data')`` mesh) read the same rows, which their placements
declare replicated. ``device_put=False`` yields host numpy batches.

Telemetry is the JAX loader's: the stages ``shuffle_wait`` (the training
loop blocked on the prefetch queue), ``collate``, ``h2d``, ``device_decode``
and ``d2d_wait`` land in the loader's registry (and, while tracing is armed,
on the flight recorder's timeline; :meth:`TorchDataLoader.observe_traced`);
:meth:`TorchDataLoader.telemetry_snapshot` merges them with the reader's.
Every span is host wall time: ``h2d`` covers the pinned staging copy and the
asynchronous issue of the upload, not the copy's time on the card, and
``d2d_wait`` the host blocked on the decode tail's ring. The stages are also
``torch.profiler.record_function`` ranges
(``petastorm_tpu_torch.loader.{wait_input,h2d,device_decode}`` and
``petastorm_tpu_torch.loader.scan_stream.h2d``), so they show in a profiler
trace beside the kernels they feed. ``metrics_port=`` serves the merged
snapshot, ``slo_policy=`` sets :meth:`TorchDataLoader.efficiency_report`'s
target, ``PETASTORM_TPU_TELEMETRY_JSONL`` streams periodic snapshots from
the consumer loop, and over a reader built with ``autotune=`` the loader adds
its knobs (prefetch, decode-tail depth, shuffle-buffer floor) to the
reader's controller.

Left for later slices, and absent from the signature: the incident and
history hooks and lineage stamping.
"""

import collections
import queue
import sys
import threading
import time
import warnings

import numpy as np
import torch

from petastorm_tpu_torch.ops.raw_decode import torch_dtype
from petastorm_tpu_torch.parallel.graphs import ProgramCache, StepProgram, program_state
from petastorm_tpu_torch.parallel.shuffling_buffer import (NoopShufflingBuffer,
                                                           RandomShufflingBuffer)
from petastorm_tpu_torch.telemetry import tracing as _tracing

_END = object()
#: scan_stream keeps this many (step_fn, chunk-shape) programs per loader
_SCAN_STREAM_CACHE_MAX = 8
#: byte alignment of each field inside the packed upload buffer (the widest
#: element any ``view(dtype)`` needs, with room for 16-byte vector loads)
_UPLOAD_ALIGN = 16
#: rows a chunk of a reader read row by row (one without ``iter_columnar``)
_ROW_CHUNK = 4096


def resolve_device(device):
    """``torch.device`` for a loader or model entry point: CUDA unless the
    caller asks for the CPU; a CUDA request without a card raises."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('device {} requested but torch.cuda.is_available() is '
                           'False; pass device="cpu" to run on the CPU'.format(device))
    if device.type not in ('cuda', 'cpu'):
        raise ValueError('device must be cuda or cpu, got {}'.format(device))
    return device


class LoaderStats(object):
    """Thread-safe loader counters. ``input_stall_fraction`` is
    ``wait_time_s / total_time_s``: the share of the consumer's time spent
    blocked on the input pipeline. ``device_decode_batches`` counts batches
    that went through the device decode tail, ``device_stored_batches`` those
    whose stored-deflate fields inflated through kernel K1 (its plain version
    on the CPU), ``device_fallback_batches`` reader chunks (rowgroups)
    decoded in host mode. ``coalesced_uploads`` and ``per_field_uploads``
    count batches uploaded as one packed buffer and field by field (see
    ``coalesce_fields``). ``io_retries`` and ``rowgroups_quarantined`` mirror
    the reader's resilience counters (as the JAX loader's do), so a job that
    watches only the loader still sees an epoch that served fewer
    rowgroups."""

    _FIELDS = ('batches', 'rows', 'wait_time_s', 'total_time_s',
               'coalesced_uploads', 'per_field_uploads', 'device_decode_batches', 'device_stored_batches',
               'device_fallback_batches', 'io_retries', 'rowgroups_quarantined')

    def __init__(self):
        self._lock = threading.Lock()
        for name in self._FIELDS:
            setattr(self, name, 0.0 if name.endswith('_s') else 0)

    def add(self, **deltas):
        """Add keyword deltas to counter fields atomically."""
        with self._lock:
            for name, delta in deltas.items():
                if name not in self._FIELDS:
                    raise AttributeError('unknown LoaderStats field {!r}'.format(name))
                setattr(self, name, getattr(self, name) + delta)

    def mirror(self, **values):
        """Set counter fields to absolute values atomically."""
        with self._lock:
            for name, value in values.items():
                if name not in self._FIELDS:
                    raise AttributeError('unknown LoaderStats field {!r}'.format(name))
                setattr(self, name, value)

    @property
    def input_stall_fraction(self):
        with self._lock:
            if self.total_time_s <= 0:
                return 0.0
            return min(1.0, self.wait_time_s / self.total_time_s)

    def as_dict(self):
        with self._lock:
            snapshot = {name: getattr(self, name) for name in self._FIELDS}
        total = snapshot['total_time_s']
        snapshot['input_stall_fraction'] = (min(1.0, snapshot['wait_time_s'] / total)
                                            if total > 0 else 0.0)
        return snapshot


class TorchDataLoader(object):
    """Iterates dicts of tensors on ``device`` assembled from a
    :class:`~petastorm_tpu_torch.reader.Reader`.

    :param reader: a reader from :func:`petastorm_tpu_torch.make_reader` or
        :func:`~petastorm_tpu_torch.make_batch_reader`. An NGram reader's
        windows are the batch axis: each field arrives as ``(batch, length,
        *shape)``. A reader without ``iter_columnar`` (a
        :class:`~petastorm_tpu_torch.WeightedSamplingReader`) is read through
        its batches or rows, and then :meth:`state_dict` is refused.
    :param batch_size: rows per emitted batch on this rank.
    :param shuffling_queue_capacity: >0 enables a random shuffling buffer of
        that many rows.
    :param min_after_retrieve: decorrelation floor (default capacity // 2).
    :param seed: shuffling-buffer seed.
    :param pad_ragged: ``{field: padded_shape}``: ragged fields are zero-padded
        to that per-row shape and an int32 ``<field>_len`` column is added.
    :param prefetch: batches kept in flight by the producer thread.
    :param drop_last: drop the final partial batch.
    :param device: ``'cuda'`` (default) or ``'cpu'``; CUDA without a card raises.
    :param device_transforms: ``{field: DeviceTransform}`` augment chains for
        raw-shipped image fields (reader built with ``device_decode_fields``).
    :param device_buffer_depth: batches the decode tail may queue ahead of the
        training step.
    :param host_decode: with ``device='cpu'``, decode raw-shipped fields through
        the codecs' host math instead of the device path.
    :param mesh: optional ``DeviceMesh`` (on the loader's device type): each
        field becomes a ``DTensor`` over it (see the module docstring).
    :param partition_spec: a :class:`~petastorm_tpu_torch.parallel.mesh.PartitionSpec`
        (or tuple) for every field, default the batch dimension over the
        mesh's first dimension; or a dict ``{field: spec}``, the other fields
        on the default. Needs a mesh.
    :param device_put: False yields host numpy batches (no upload).
    :param coalesce_fields: upload each batch as ONE packed pinned buffer
        (True) or field by field (False); None (default) is True on CUDA and
        False on the CPU, where the packing is a host copy that buys nothing.
        A batch with a column that cannot pack goes field by field. The
        batches are equal either way.
    :param metrics_port: serve the merged snapshot as ``/metrics`` (with
        ``/healthz`` and ``/vars``) on ``127.0.0.1`` at this port (0: an
        ephemeral one, see :attr:`metrics_url`) until :meth:`stop`.
    :param slo_policy: the input-efficiency SLO of :meth:`efficiency_report`
        (an :class:`~petastorm_tpu_torch.telemetry.slo.SloPolicy`, a float
        target, or None for 0.9).
    """

    def __init__(self, reader, batch_size, shuffling_queue_capacity=0,
                 min_after_retrieve=None, seed=None, pad_ragged=None, prefetch=2,
                 drop_last=True, device=None, device_transforms=None,
                 device_buffer_depth=2, host_decode=False, mesh=None, partition_spec=None,
                 device_put=True, coalesce_fields=None, metrics_port=None,
                 slo_policy=None):
        if batch_size < 1:
            raise ValueError('batch_size must be >= 1')
        self.reader = reader
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self._shardings = resolve_shardings(mesh, partition_spec, self.device)
        self._device_put = device_put
        self._coalesce_fields = (self.device.type == 'cuda' if coalesce_fields is None
                                 else bool(coalesce_fields))
        if not device_put and getattr(reader, 'device_decode_fields', None):
            raise ValueError('device_put=False yields host batches; a reader with '
                             'device_decode_fields decodes on the device')
        if host_decode and self.device.type != 'cpu':
            raise ValueError('host_decode applies to device="cpu" only; on the card '
                             'raw-shipped fields always decode on the device')
        self.stats = LoaderStats()
        from petastorm_tpu_torch.telemetry import MetricsRegistry
        from petastorm_tpu_torch.telemetry.export import logger_from_env
        from petastorm_tpu_torch.telemetry.slo import (SloTracker, resolve_slo_policy,
                                                       slo_clock)
        #: the loader's stages (see the module docstring)
        self.telemetry = MetricsRegistry()
        self._telemetry_jsonl = logger_from_env()
        self._started_at = slo_clock()
        self._slo = SloTracker(resolve_slo_policy(slo_policy), jsonl=self._telemetry_jsonl)
        self._metrics_server = None
        self._pad_ragged = dict(pad_ragged or {})
        self._prefetch = max(1, prefetch)
        self._drop_last = drop_last
        self._seed = seed
        self._shuffling_queue_capacity = shuffling_queue_capacity
        self._min_after_retrieve = min_after_retrieve
        self._in_iter = False
        self._error = None
        self._queue = None
        self._producer = None
        self._stop_event = threading.Event()
        # delivery-exact checkpoint accounting: the producer appends
        # [item_id, rows_pending] per reader chunk (FIFO order is emission
        # order without a shuffling buffer); the consumer retires rows as it
        # yields batches and marks an item delivered once all its rows were
        self._delivery_fifo = collections.deque()
        self._fifo_lock = threading.Lock()
        self._epochs_delivered = 0
        self._delivered_by_epoch = {}
        self._scan_stream_used = False
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == 'cuda' and device_put else None)
        self._scan_stream_programs = ProgramCache(
            _SCAN_STREAM_CACHE_MAX,
            'scan_stream built more than {limit} distinct (step_fn, chunk-shape) programs; '
            'pass a stable step_fn object to reuse them')
        self._device_buffer_depth = max(1, int(device_buffer_depth))
        if getattr(reader, 'device_decode_fields', None):
            from petastorm_tpu_torch.parallel.device_stage import DeviceDecodeStage
            self._device_stage = DeviceDecodeStage(reader, device_transforms,
                                                   device_buffer_depth, host_decode)
        else:
            if device_transforms:
                raise ValueError('device_transforms requires a reader built '
                                 'with device_decode_fields')
            self._device_stage = None
        # one controller tunes the whole pipeline: over a reader built with
        # autotune= the loader's knobs join its catalog
        controller = getattr(reader, '_autotune', None)
        if controller is not None:
            from petastorm_tpu_torch.autotune.knobs import build_loader_knobs
            for knob in build_loader_knobs(self):
                controller.catalog.add(knob)
        # started last, so a scrape never sees a half-built loader
        if metrics_port is not None:
            from petastorm_tpu_torch.telemetry.http_exporter import MetricsHttpServer
            self._metrics_server = MetricsHttpServer(
                snapshot_fn=self._scrape_snapshot,
                health_fn=lambda: {'batches': self.stats.batches, 'rows': self.stats.rows},
                port=int(metrics_port))
            self._metrics_server.start()

    # --------------------------------------------------------------- iteration

    def __iter__(self):
        if self._in_iter:
            raise RuntimeError('Concurrent iteration of a TorchDataLoader is not allowed')
        if self._producer is not None and self._producer.is_alive():
            # a previous iteration was broken off: stop and join its producer
            # before it can write stale batches into the new queue
            self._stop_event.set()
            self._drain_queue()
            self._producer.join(timeout=30)
            if self._producer.is_alive():
                raise RuntimeError('Previous producer thread did not stop')
        if self.stats.batches and getattr(self.reader, 'last_row_consumed', False):
            self.reader.reset()
        self._in_iter = True
        self._error = None
        self._stop_event = threading.Event()
        self._queue = queue.Queue(self._prefetch)
        # pending entries of an abandoned iteration belong to a dead stream:
        # their items stay undelivered, so a resume serves their rows again
        self._delivery_fifo.clear()
        self._producer = threading.Thread(target=self._produce,
                                          args=(self._queue, self._stop_event),
                                          daemon=True,
                                          name='petastorm-tpu-torch-loader-producer')
        self._producer.start()
        try:
            last_emit = time.monotonic()
            while True:
                wait_start = time.monotonic()
                with torch.profiler.record_function('petastorm_tpu_torch.loader.wait_input'):
                    item = self._queue.get()
                now = time.monotonic()
                if item is _END:
                    if self._error is not None:
                        raise self._error
                    self._mark_delivered(None)   # drop_last / buffer-drain leftovers
                    return
                batch, rows, done = item
                self.stats.add(wait_time_s=now - wait_start,
                               total_time_s=now - last_emit, batches=1, rows=rows)
                # shuffle_wait: the training loop blocked on the input pipeline
                # for this batch (monotonic clock: the timeline leg back-dates)
                self.observe_traced('shuffle_wait', now - wait_start)
                if self._telemetry_jsonl is not None and self._telemetry_jsonl.due():
                    # one snapshot for the interval line and the SLO check
                    snapshot = self.telemetry_snapshot()
                    self._evaluate_slo(snapshot)
                    self._telemetry_jsonl.emit(snapshot, event='loader_interval')
                last_emit = now
                if done is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(done)
                    for tensor in batch.values():
                        tensor.record_stream(consumer)
                if self._shardings is not None and self._device_put:
                    batch = self._shardings.distribute(batch)
                self._mark_delivered(rows)
                yield batch
        finally:
            self._stop_event.set()
            self._in_iter = False
            self._drain_queue()

    def _drain_queue(self, _empty=queue.Empty, _is_finalizing=sys.is_finalizing):
        # bound at definition time: this runs from generator finalizers, which
        # can fire at interpreter shutdown after module globals are cleared
        if self._queue is None or _is_finalizing():
            return
        try:
            while True:
                self._queue.get_nowait()
        except _empty:
            pass

    # ---------------------------------------------------------------- producer

    def _make_buffer(self):
        if self._shuffling_queue_capacity and self._shuffling_queue_capacity > 0:
            min_after = self._min_after_retrieve
            if min_after is None:
                min_after = self._shuffling_queue_capacity // 2
            return RandomShufflingBuffer(self._shuffling_queue_capacity, min_after,
                                         seed=self._seed)
        return NoopShufflingBuffer()

    def _produce(self, out_queue, stop_event):
        try:
            buffer = self._make_buffer()
            for columns in self._reader_chunks():
                # feed in batch_size slices so one whole-rowgroup chunk cannot
                # blow past the buffer's capacity
                for part in _iter_column_slices(columns, self.batch_size):
                    buffer.add_many(part)
                    self._apply_min_after_retrieve(buffer)
                    while buffer.can_retrieve(self.batch_size):
                        if stop_event.is_set():
                            return
                        self._emit(buffer.retrieve(self.batch_size), out_queue,
                                   stop_event)
                if stop_event.is_set():
                    return
            buffer.finish()
            while buffer.can_retrieve(self.batch_size) and not stop_event.is_set():
                batch = buffer.retrieve(self.batch_size)
                if _num_rows(batch) < self.batch_size and self._drop_last:
                    break
                self._emit(batch, out_queue, stop_event)
        except Exception as exc:  # noqa: BLE001 - re-raised in the consumer
            if not stop_event.is_set():
                self._error = exc
        finally:
            self._put(_END, out_queue, stop_event)

    def _apply_min_after_retrieve(self, buffer):
        """Hand the ``loader_min_after_retrieve`` knob's value to the live
        buffer, on this (the producer's) thread: the buffer is not
        thread-safe, and a floor raised between ``can_retrieve`` and
        ``retrieve`` would fail the retrieve."""
        target = self._min_after_retrieve
        if (target is not None and isinstance(buffer, RandomShufflingBuffer)
                and target != buffer.min_after_retrieve):
            buffer.set_min_after_retrieve(target)

    def _reader_chunks(self):
        """Sanitized columnar chunks from the reader, each work item (emptied
        ones too) queued for delivery accounting."""
        try:
            for columns, num_rows, item_id in iter_reader_chunks(self.reader,
                                                                 include_empty=True):
                with self._fifo_lock:
                    self._delivery_fifo.append([item_id, num_rows])
                self._sync_resilience_stats()
                if num_rows:
                    yield self._sanitize(columns)
        finally:
            self._sync_resilience_stats()

    def _sync_resilience_stats(self):
        """Mirror the reader's retry and quarantine counters into the stats."""
        retries = getattr(self.reader, 'io_retries', None)
        ledger = getattr(self.reader, 'quarantine', None)
        if retries is not None and ledger is not None:
            self.stats.mirror(io_retries=retries, rowgroups_quarantined=len(ledger))

    def _sanitize(self, columns):
        # collate: host batch assembly, sanitizing and padding (with the
        # host-mode decode of raw-shipped fields, also a device_decode span)
        collate_start = time.perf_counter()
        passthrough = frozenset()
        stage = self._device_stage
        if stage is not None:
            decode_start = time.perf_counter()
            columns, decoded_any = stage.sanitize_decode(columns)
            if decoded_any:
                self.stats.add(device_fallback_batches=1)
                self.observe_traced('device_decode', time.perf_counter() - decode_start,
                                    start_pc=decode_start)
            passthrough = stage.passthrough_names
        out = sanitize_columns(columns, self._pad_ragged, passthrough=passthrough)
        self.observe_traced('collate', time.perf_counter() - collate_start,
                            start_pc=collate_start)
        return out

    def _emit(self, columns, out_queue, stop_event):
        rows = _num_rows(columns)
        if not self._device_put:
            self._put((columns, rows, None), out_queue, stop_event)
            return
        stage = self._device_stage
        recipe = None
        prepare_s = 0.0
        if stage is not None and not stage.host_mode:
            # the decode tail's host half: pack/plan raw payloads for upload
            prepare_start = time.perf_counter()
            columns, recipe = stage.prepare(columns)
            prepare_s = time.perf_counter() - prepare_start
        done = None
        if self._stream is not None:
            with torch.cuda.stream(self._stream):
                batch = self._finish(columns, stage, recipe, prepare_s)
                done = torch.cuda.Event()
                done.record(self._stream)
        else:
            batch = self._finish(columns, stage, recipe, prepare_s)
        if recipe:
            waited = stage.throttle(done)
            if waited:
                self.observe_traced('d2d_wait', waited)
        self._put((batch, rows, done), out_queue, stop_event)

    def _finish(self, columns, stage, recipe, prepare_s=0.0):
        """Upload, then run the decode tail, on the current stream. ``h2d``
        times the upload call on the host (staging copy and asynchronous
        issue), ``device_decode`` the decode tail's host time (``prepare_s``
        plus issuing ``finish``'s launches)."""
        h2d_start = time.perf_counter()
        with torch.profiler.record_function('petastorm_tpu_torch.loader.h2d'):
            if self._coalesce_fields and coalescible(columns):
                batch = upload_columns(columns, self.device)
                self.stats.add(coalesced_uploads=1)
            else:
                batch = upload_fields(columns, self.device)
                self.stats.add(per_field_uploads=1)
        self.observe_traced('h2d', time.perf_counter() - h2d_start, start_pc=h2d_start)
        if recipe:
            finish_start = time.perf_counter()
            stored_before = stage.stored_batches
            with torch.profiler.record_function('petastorm_tpu_torch.loader.device_decode'):
                batch = stage.finish(batch, recipe)
            self.stats.add(device_decode_batches=1,
                           device_stored_batches=int(stage.stored_batches > stored_before))
            self.observe_traced('device_decode',
                                prepare_s + time.perf_counter() - finish_start)
        return batch

    def _put(self, item, out_queue, stop_event):
        while not stop_event.is_set():
            try:
                out_queue.put(item, timeout=0.1)
                return
            except queue.Full:
                continue
        if item is _END:
            try:
                out_queue.put_nowait(_END)
            except queue.Full:
                pass

    # ------------------------------------------------------------ whole-chunk programs

    def scan_stream(self, step_fn, chunk_batches=32, seed=None, state=None):
        """Stream the reader through whole-chunk programs: accumulate
        ``chunk_batches`` batches of host rows, upload them as ONE pinned copy
        into the program's static chunk buffer, and run every train step of the
        chunk as ONE replay of a CUDA graph (eagerly on ``device='cpu'``).
        The counterpart of ``JaxDataLoader.scan_stream``, whose chunk is one
        ``lax.scan`` dispatch.

        With a mesh each step's batch is a ``DTensor`` with the loader's
        placements, as in ``__iter__`` (the JAX chunk's scan axis is
        replicated, so each step keeps the batch's spec).

        Rows are shuffled within each chunk by
        ``np.random.RandomState((seed + chunk_index) % 2**31).permutation``,
        the JAX package's order. The trailing smaller chunk runs through a
        program of its own (one more capture); the final sub-batch-size
        remainder is dropped (static shapes). Programs are cached per
        ``(step_fn, batches in the chunk)``: pass a stable ``step_fn`` object.

        :param step_fn: ``step_fn(batch) -> aux``: one train step over a dict of
            ``(batch_size, ...)`` tensors, mutating the model and optimizer in
            place (see :mod:`~petastorm_tpu_torch.parallel.graphs` for what a
            captured step may do).
        :param chunk_batches: batches per chunk.
        :param seed: within-chunk shuffle seed; None keeps the stream order.
        :param state: the modules and optimizers ``step_fn`` mutates (required
            on the card, where the capture's warm-up is undone on them).
        :return: the per-chunk ``aux`` stacked over the chunk's steps, in
            stream order.
        """
        if self._shuffling_queue_capacity:
            raise ValueError('scan_stream has its own in-chunk shuffle; construct '
                             'the loader with shuffling_queue_capacity=0')
        if chunk_batches < 1:
            raise ValueError('chunk_batches must be >= 1')
        if not self._device_put:
            raise ValueError('scan_stream runs device programs; it does not support '
                             'device_put=False (use __iter__ for host batches)')
        if not self._drop_last:
            raise ValueError('scan_stream always drops the sub-batch-size remainder '
                             '(static shapes); construct the loader with '
                             'drop_last=True to make that explicit, or use __iter__ '
                             'to see every row')
        if reader_may_be_infinite(self.reader):
            raise ValueError('scan_stream runs to stream end and cannot consume an '
                             'infinite reader (num_epochs=None); give the reader a '
                             'finite num_epochs and call scan_stream per pass')
        if self._device_stage is not None and not self._device_stage.host_mode:
            raise ValueError('scan_stream does not support device_decode_fields decoded '
                             'on the device (raw payloads cannot pack into a chunk) or '
                             'device_transforms (the chunk path has no augment stage: '
                             'silently training un-augmented would be worse than '
                             'refusing); use __iter__')
        if self._in_iter:
            raise RuntimeError('scan_stream cannot run while __iter__ is active: '
                               'both would consume the same reader')
        state = program_state(state, self.device)
        self._scan_stream_used = True
        if self._producer is not None and self._producer.is_alive():
            # an abandoned __iter__ left its producer prefetching from the
            # reader: stop and join it, as a fresh __iter__ would
            self._stop_event.set()
            self._drain_queue()
            self._producer.join(timeout=30)
            if self._producer.is_alive():
                raise RuntimeError('Previous producer thread did not stop')
        if getattr(self.reader, 'last_row_consumed', False):
            # a fully consumed reader resets for the next pass, as in __iter__
            self.reader.reset()
        batch_size = self.batch_size

        def run_chunk(columns, n_batches, chunk_index):
            usable = n_batches * batch_size
            if seed is not None:
                perm = np.random.RandomState((seed + chunk_index) % (2 ** 31)).permutation(usable)
                columns = {name: col[:usable][perm] for name, col in columns.items()}
            else:
                columns = {name: col[:usable] for name, col in columns.items()}
            chunk = {name: np.ascontiguousarray(
                         col.reshape((n_batches, batch_size) + col.shape[1:]))
                     for name, col in columns.items()}
            key = (step_fn, n_batches)
            program, buffer, layout = self._scan_stream_programs.get(
                key, lambda: self._chunk_program(step_fn, chunk, n_batches, state))
            if layout != _layout_key(chunk):
                raise ValueError('the stream\'s columns changed between chunks: {} then {}'
                                 .format(layout, _layout_key(chunk)))
            # the one pinned chunk copy, outside the graph's replay
            h2d_start = time.perf_counter()
            with torch.profiler.record_function(
                    'petastorm_tpu_torch.loader.scan_stream.h2d'):
                upload_columns(chunk, self.device, out=buffer)
            self.observe_traced('h2d', time.perf_counter() - h2d_start, start_pc=h2d_start)
            self.stats.add(batches=n_batches, rows=usable)
            try:
                return program.run()
            except ValueError:
                self._scan_stream_programs.discard(key)   # a step that cannot be captured
                raise

        pending = []
        pending_rows = 0
        chunk_rows = chunk_batches * batch_size
        chunk_index = 0
        aux_chunks = []
        # read around the delivery FIFO: only __iter__ feeds it
        chunks = (c for c, n, _ in iter_reader_chunks(self.reader) if n)
        for columns in map(self._sanitize, chunks):
            pending.append(columns)
            pending_rows += _num_rows(columns)
            while pending_rows >= chunk_rows:
                merged = _concat_column_chunks(pending)
                head = {name: col[:chunk_rows] for name, col in merged.items()}
                tail = {name: col[chunk_rows:] for name, col in merged.items()}
                aux_chunks.append(run_chunk(head, chunk_batches, chunk_index))
                chunk_index += 1
                pending = [tail]
                pending_rows -= chunk_rows
        if pending_rows >= batch_size:
            aux_chunks.append(run_chunk(_concat_column_chunks(pending),
                                        pending_rows // batch_size, chunk_index))
        return aux_chunks

    def _chunk_program(self, step_fn, chunk, n_batches, state):
        """A program over a static chunk buffer laid out as ``chunk``'s packed
        upload; returns ``(program, buffer, layout)``."""
        layout, nbytes = packed_layout(chunk)
        buffer = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=self.device)
        views = {name: buffer[start:start + col.nbytes].view(torch_dtype(col.dtype))
                 .view(col.shape) for name, start, col in layout}
        shardings = self._shardings

        def batch_of(i):
            batch = {name: view[i] for name, view in views.items()}
            return batch if shardings is None else shardings.distribute(batch)

        program = StepProgram(step_fn, batch_of, n_batches, state, self.device)
        return program, buffer, _layout_key(chunk)

    # ---------------------------------------------------------------- checkpoint

    def _mark_delivered(self, n_rows):
        """Consumer half of the delivery accounting: retire ``n_rows`` from the
        FIFO (``None``, at stream end: everything pending was dropped by
        ``drop_last`` or drained out of the buffer and is not served in this
        run)."""
        fifo = self._delivery_fifo
        remaining = n_rows
        while True:
            with self._fifo_lock:
                if not fifo:
                    break
                head = fifo[0]
                if n_rows is None:
                    take = head[1]
                else:
                    if head[1] > 0 and remaining <= 0:
                        break
                    take = min(head[1], remaining)
                head[1] -= take
                if n_rows is not None:
                    remaining -= take
                if head[1] > 0:
                    break
                fifo.popleft()
            self._note_delivered(head[0])

    def _note_delivered(self, item_id):
        if item_id is None:
            return   # a chunk of a reader without the columnar path
        epoch, piece, drop = item_id
        self._delivered_by_epoch.setdefault(epoch, set()).add((piece, drop))
        items_per_epoch = getattr(self.reader, 'items_per_epoch', None)
        if not items_per_epoch:
            return
        while (len(self._delivered_by_epoch.get(self._epochs_delivered, ()))
               >= items_per_epoch):
            del self._delivered_by_epoch[self._epochs_delivered]
            self._epochs_delivered += 1

    def state_dict(self):
        """Delivery-exact resumable read position, the dict of
        ``JaxDataLoader.state_dict``: a work item counts as consumed only once
        every one of its rows was yielded by ``__iter__``. Rows in the prefetch
        queue, on the side stream or in the producer are not counted and are
        served again on resume (at least once: a partly delivered item is read
        again whole). Rebuild the reader with the same arguments plus
        ``resume_state=state`` and wrap it in a new loader to continue.

        Refused for a reader without the columnar path, after ``scan_stream``
        (it consumes the reader outside this accounting), and while rows wait
        in a shuffling buffer (emission order is not ingest order: checkpoint
        after the iterator is exhausted)."""
        if not hasattr(self.reader, 'iter_columnar'):
            raise ValueError('state_dict requires a Reader with the columnar fast path '
                             '(iter_columnar)')
        if self._scan_stream_used:
            raise ValueError('state_dict is not supported after scan_stream (it '
                             'consumes the reader outside the delivery accounting); '
                             'checkpoint with the __iter__ path instead')
        with self._fifo_lock:
            pending = any(entry[1] > 0 for entry in self._delivery_fifo)
        if pending and self._shuffling_queue_capacity:
            raise ValueError('With a shuffling buffer the loader cannot attribute '
                             'in-flight rows to work items; checkpoint after the '
                             'iterator is exhausted (epoch boundary) instead')
        items_per_epoch = getattr(self.reader, 'items_per_epoch', None)
        if items_per_epoch is None:
            raise ValueError('Reader does not support checkpointing')
        return {
            'version': 1,
            'items_per_epoch': items_per_epoch,
            'epochs_consumed': self._epochs_delivered,
            'consumed_by_epoch': {
                epoch - self._epochs_delivered: sorted(ids)
                for epoch, ids in self._delivered_by_epoch.items()},
        }

    # ------------------------------------------------------------ runtime knobs

    def set_prefetch(self, depth):
        """Runtime-adjust the prefetch queue depth, applied to the live queue.
        Returns the applied value."""
        depth = max(1, int(depth))
        self._prefetch = depth
        out_queue = self._queue
        if out_queue is not None:
            with out_queue.mutex:
                out_queue.maxsize = depth
                out_queue.not_full.notify_all()
        return depth

    @property
    def prefetch(self):
        """The current prefetch queue depth."""
        return self._prefetch

    def set_device_buffer_depth(self, depth):
        """Runtime-adjust the decode tail's ring depth (a clamp when the loader
        has no decode tail). Returns the applied value."""
        if self._device_stage is None:
            self._device_buffer_depth = max(1, int(depth))
            return self._device_buffer_depth
        return self._device_stage.set_depth(depth)

    @property
    def device_buffer_depth(self):
        """The decode tail's ring depth."""
        if self._device_stage is None:
            return self._device_buffer_depth
        return self._device_stage.depth

    # ---------------------------------------------------------------- telemetry

    def observe_traced(self, stage, dur_s, start_pc=None):
        """One loader-stage measurement into the loader's registry and, while
        tracing is armed, the flight recorder's timeline. ``start_pc`` is the
        ``perf_counter`` start; None back-dates by the duration (a stage
        clocked on another timebase, as ``shuffle_wait``)."""
        self.telemetry.observe(stage, dur_s)
        if _tracing.trace_enabled():
            if start_pc is None:
                start_pc = time.perf_counter() - dur_s
            _tracing.trace_complete(stage, start_pc, dur_s)

    def telemetry_snapshot(self):
        """One JSON-safe snapshot of the WHOLE pipeline: the loader's stages
        merged with the reader's cross-process snapshot (workers and pool).
        Feed it to
        :func:`~petastorm_tpu_torch.telemetry.analyze.attribute_bottleneck`."""
        from petastorm_tpu_torch.telemetry import merge_snapshots
        reader_snapshot = getattr(self.reader, 'telemetry_snapshot', None)
        if reader_snapshot is None:
            return self.telemetry.snapshot()
        return merge_snapshots(self.telemetry.snapshot(), reader_snapshot())

    def _evaluate_slo(self, snapshot):
        from petastorm_tpu_torch.telemetry.slo import slo_clock
        return self._slo.evaluate(snapshot, slo_clock() - self._started_at,
                                  rows=self.stats.rows, registry=self.telemetry)

    def efficiency_report(self):
        """One input-efficiency SLO evaluation over this loader's lifetime:
        efficiency in [0, 1] from ``shuffle_wait`` (plus ``d2d_wait``), the
        seconds the training loop sat starved, with goodput against ideal
        rows/s and the edge-triggered breach accounting. Evaluated also at
        every JSONL interval and on every ``/metrics`` scrape."""
        return self._evaluate_slo(self.telemetry_snapshot())

    def _scrape_snapshot(self):
        snapshot = self.telemetry_snapshot()
        report = self._evaluate_slo(snapshot)
        gauges = snapshot.setdefault('gauges', {})
        if report['efficiency'] is not None:
            gauges['slo_efficiency'] = report['efficiency']
        gauges['slo_target_efficiency'] = report['target_efficiency']
        snapshot['slo_history'] = report.get('history', [])
        return snapshot

    @property
    def metrics_url(self):
        """The scrape endpoint's base URL, or None without ``metrics_port``."""
        if self._metrics_server is None:
            return None
        return self._metrics_server.url

    # ---------------------------------------------------------------- lifecycle

    def stop(self):
        if self._metrics_server is not None:
            self._metrics_server.stop()
        self._stop_event.set()
        self.reader.stop()

    def join(self):
        if self._producer is not None:
            self._producer.join(timeout=30)
        self.reader.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
        self.join()


class FieldShardings(object):
    """DTensor placements of a batch's fields on ``mesh``, the counterpart of
    the JAX loader's ``FieldShardings``: the fields a dict ``partition_spec``
    names get their spec, every other field the default (the batch dimension
    over the mesh's first dimension)."""

    def __init__(self, mesh, partition_spec):
        from petastorm_tpu_torch.parallel.mesh import PartitionSpec, batch_sharding
        self.mesh = mesh
        default = PartitionSpec(mesh.mesh_dim_names[0])
        per_field = partition_spec if isinstance(partition_spec, dict) else {}
        self._per_field = {name: batch_sharding(mesh, default if spec is None else spec)
                           for name, spec in per_field.items()}
        self._default = batch_sharding(
            mesh, default if partition_spec is None or per_field else partition_spec)
        self._checked = False

    def placements(self, name):
        return self._per_field.get(name, self._default)

    def check_unused(self, field_names):
        """Warn about spec keys that match no batch field (a typo would leave
        its field on the default)."""
        unused = set(self._per_field) - set(field_names)
        if unused:
            warnings.warn('partition_spec keys {} match no batch field (fields: {}); those '
                          'fields fall back to the default batch-axis sharding'
                          .format(sorted(unused), sorted(field_names)))

    def distribute(self, batch):
        """``{name: DTensor}`` from this rank's ``{name: tensor}``: no
        collective (``run_check=False``), so also inside a CUDA graph
        capture. The first call checks the spec's keys."""
        from torch.distributed.tensor import DTensor
        if not self._checked:
            self._checked = True
            self.check_unused(batch.keys())
        return {name: DTensor.from_local(tensor, self.mesh, self.placements(name),
                                         run_check=False)
                for name, tensor in batch.items()}


def resolve_shardings(mesh, partition_spec, device):
    """:class:`FieldShardings` of ``mesh`` (None without one); a spec without
    a mesh, or a mesh on another device type than ``device``, raises."""
    if mesh is None:
        if partition_spec is not None:
            raise ValueError('partition_spec requires a mesh')
        return None
    if mesh.device_type != device.type:
        raise ValueError('the mesh is on {} but the loader on {}'.format(mesh.device_type,
                                                                        device))
    return FieldShardings(mesh, partition_spec)


def packed_layout(columns):
    """``([(name, start, column)], total_bytes)``: where each numeric host
    column lies in the packed upload buffer, aligned to 16 bytes."""
    layout = []
    offset = 0
    for name in sorted(columns):
        col = np.ascontiguousarray(columns[name])
        offset = -(-offset // _UPLOAD_ALIGN) * _UPLOAD_ALIGN
        layout.append((name, offset, col))
        offset += col.nbytes
    return layout, offset


def upload_columns(columns, device, out=None):
    """Numeric host columns -> tensors on ``device`` through ONE packed uint8
    buffer: pinned and copied asynchronously on the current stream for CUDA,
    used in place on the CPU. Each field is a ``view(dtype)`` slice of the
    device buffer, aligned to 16 bytes. With ``out`` (a uint8 tensor on
    ``device`` of the packed size, e.g. a CUDA graph's static input) the copy
    goes into it."""
    layout, nbytes = packed_layout(columns)
    host = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                       pin_memory=device.type == 'cuda')
    host_np = host.numpy()
    for _, start, col in layout:
        host_np[start:start + col.nbytes] = col.reshape(-1).view(np.uint8)
    if out is not None:
        if (out.shape != host.shape or out.dtype != torch.uint8
                or out.device.type != device.type):
            raise ValueError('out must be a uint8 tensor of {} bytes on {}, got {} {} on {}'
                             .format(host.numel(), device, tuple(out.shape), out.dtype,
                                     out.device))
        buf = out.copy_(host, non_blocking=True)
    elif device.type == 'cuda':
        buf = host.to(device, non_blocking=True)
    else:
        buf = host
    return {name: buf[start:start + col.nbytes].view(torch_dtype(col.dtype))
            .view(col.shape) for name, start, col in layout}


def coalescible(columns):
    """True when every column can ride the packed upload: a numpy array of a
    native-endian bool, int, uint or float dtype that torch has."""
    for col in columns.values():
        if (not isinstance(col, np.ndarray) or col.dtype.kind not in 'biuf'
                or col.dtype.byteorder == '>'):
            return False
        try:
            torch_dtype(col.dtype)
        except ValueError:
            return False
    return True


def upload_fields(columns, device):
    """Host columns -> tensors on ``device``, one copy a field: each pinned
    and copied asynchronously on the current stream for CUDA, a contiguous
    native-endian copy on the CPU."""
    out = {}
    for name, col in columns.items():
        host = np.array(col, dtype=col.dtype.newbyteorder('='), order='C', copy=True)
        tensor = torch.from_numpy(host)
        if device.type == 'cuda':
            tensor = tensor.pin_memory().to(device, non_blocking=True)
        out[name] = tensor
    return out


def reader_may_be_infinite(reader):
    """Conservative infinite-stream detection: ``num_epochs is None`` on the reader or,
    for wrapper readers exposing ``_readers``/``readers``, on any wrapped reader;
    unknown shapes count as infinite (callers should then demand an explicit cap)."""
    if hasattr(reader, 'num_epochs'):
        return reader.num_epochs is None
    inner = getattr(reader, 'readers', None) or getattr(reader, '_readers', None)
    if inner:
        return any(reader_may_be_infinite(r) for r in inner)
    return True


def iter_reader_chunks(reader, include_empty=False):
    """``(columns_dict, num_rows, item_id)`` from any reader: per work item of
    the columnar fast path, with the item's identity for delivery accounting
    (``include_empty`` also yields items a transform or predicate emptied; an
    NGram reader's items are window-major, one window a row); else, for a
    reader without ``iter_columnar`` (such as
    :class:`~petastorm_tpu_torch.weighted_sampling_reader.WeightedSamplingReader`),
    one chunk per batched namedtuple or per ``_ROW_CHUNK`` rows, with no
    identity (None)."""
    iter_columnar = getattr(reader, 'iter_columnar', None)
    if iter_columnar is not None:
        for batch in iter_columnar(include_empty=include_empty):
            yield dict(batch.columns), batch.num_rows, batch.item_id
    elif getattr(reader, 'is_batched_reader', False):
        for batch in reader:
            columns = batch._asdict()
            yield columns, _num_rows(columns), None
    else:
        pending = []
        for row in reader:
            pending.append(row._asdict())
            if len(pending) >= _ROW_CHUNK:
                yield _rows_to_columns(pending), len(pending), None
                pending = []
        if pending:
            yield _rows_to_columns(pending), len(pending), None


def _rows_to_columns(rows):
    """Row dicts -> columns: uniform arrays stacked, ragged ones kept as a
    list (for ``pad_ragged``), strings and None as object arrays."""
    columns = {}
    for name in rows[0]:
        values = [row[name] for row in rows]
        first = values[0]
        if isinstance(first, np.ndarray) and first.ndim >= 1:
            if len({v.shape for v in values}) == 1:
                columns[name] = np.stack(values)
            else:
                columns[name] = values
        elif isinstance(first, (str, bytes)) or first is None:
            columns[name] = np.array(values, dtype=object)
        else:
            columns[name] = np.asarray(values)
    return columns


def sanitize_columns(columns, pad_ragged, passthrough=frozenset()):
    """Make host columns uploadable: datetimes -> int64 ns, ragged fields padded
    per ``pad_ragged`` (adding an int32 ``<field>_len`` column), strings and
    objects rejected with the field named. Columns in ``passthrough`` (raw
    payloads pending device decode, and their auxiliaries) pass untouched."""
    out = {}
    for name, col in columns.items():
        if name in passthrough:
            out[name] = col
            continue
        if name in pad_ragged:
            padded, lengths = _pad_column(col, pad_ragged[name], name)
            out[name] = padded
            out[name + '_len'] = lengths
            continue
        if isinstance(col, list):
            raise ValueError(
                'Field {!r} is ragged (variable shape); pass pad_ragged={{{!r}: '
                '(max_shape...)}} to pad it, or drop it via schema_fields'
                .format(name, name))
        if col.dtype.kind == 'M':
            out[name] = col.astype('datetime64[ns]').astype(np.int64)
        elif col.dtype.kind in ('U', 'S', 'O'):
            raise ValueError('Field {!r} has dtype {} which has no tensor '
                             'representation; drop it via schema_fields'
                             .format(name, col.dtype))
        else:
            out[name] = np.ascontiguousarray(col)
    return out


def _layout_key(columns):
    return [(name, col.dtype.str, col.shape) for name, col in sorted(columns.items())]


def _concat_column_chunks(chunks):
    """Concatenate sanitized column dicts along the row axis (one dict passes
    through without a copy)."""
    if len(chunks) == 1:
        return chunks[0]
    return {name: np.concatenate([c[name] for c in chunks]) for name in chunks[0]}


def _num_rows(columns):
    for col in columns.values():
        return len(col)
    return 0


def _iter_column_slices(columns, slice_rows):
    n = _num_rows(columns)
    if n <= slice_rows:
        yield columns
        return
    for start in range(0, n, slice_rows):
        yield {name: col[start:start + slice_rows] for name, col in columns.items()}


def _pad_column(col, target_shape, name):
    """Zero-pad each row of a ragged column to ``target_shape``; return (padded
    array, int32 first-dim lengths)."""
    values = list(col)
    target_shape = tuple(target_shape)
    first = np.asarray(values[0])
    padded = np.zeros((len(values),) + target_shape, dtype=first.dtype)
    lengths = np.zeros(len(values), dtype=np.int32)
    for i, value in enumerate(values):
        value = np.asarray(value)
        if value.ndim != len(target_shape):
            raise ValueError('pad_ragged[{!r}]={} rank mismatch with value shape {}'
                             .format(name, target_shape, value.shape))
        if any(v > t for v, t in zip(value.shape, target_shape)):
            raise ValueError('Value of field {!r} with shape {} exceeds pad_ragged '
                             'target {}'.format(name, value.shape, target_shape))
        padded[(i,) + tuple(slice(0, s) for s in value.shape)] = value
        lengths[i] = value.shape[0]
    return padded, lengths


def make_torch_loader(dataset_url_or_urls, batch_size, batched=True, loader_kwargs=None,
                      **reader_kwargs):
    """Reader and :class:`TorchDataLoader` in one call, the counterpart of
    ``make_jax_loader``.
    ``batched=True`` reads through ``make_batch_reader`` (native Parquet),
    ``batched=False`` through ``make_reader`` (codec decode); ``reader_kwargs``
    go to the reader (``resume_state=`` among them) and ``loader_kwargs`` to the
    loader, whose ``device`` is CUDA unless ``'cpu'`` is given. Without
    explicit ``cur_shard``/``shard_count`` the shard comes from
    :func:`~petastorm_tpu_torch.parallel.mesh.distributed_shard_info`; with a
    ``mesh`` in ``loader_kwargs`` they must be given
    (:func:`~petastorm_tpu_torch.parallel.mesh.mesh_shard_info` of the
    dimension that splits the batch)."""
    from petastorm_tpu_torch.parallel.mesh import distributed_shard_info
    from petastorm_tpu_torch.reader import make_batch_reader, make_reader
    loader_kwargs = dict(loader_kwargs or {})
    if loader_kwargs.get('mesh') is not None and 'shard_count' not in reader_kwargs:
        raise ValueError('with a mesh pass cur_shard and shard_count: the coordinate of '
                         'the mesh dimension that splits the batch (mesh_shard_info), '
                         'not the global rank')
    # the device is checked before the reader starts its workers
    loader_kwargs['device'] = resolve_device(loader_kwargs.get('device'))
    cur_shard, shard_count = distributed_shard_info(
        reader_kwargs.pop('cur_shard', None), reader_kwargs.pop('shard_count', None))
    if shard_count is not None:
        reader_kwargs['cur_shard'] = cur_shard
        reader_kwargs['shard_count'] = shard_count
    factory = make_batch_reader if batched else make_reader
    reader = factory(dataset_url_or_urls, **reader_kwargs)
    try:
        return TorchDataLoader(reader, batch_size, **loader_kwargs)
    except BaseException:
        reader.stop()
        reader.join()
        raise
