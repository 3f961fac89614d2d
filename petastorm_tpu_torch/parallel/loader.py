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
runs none in the JAX loader. A mesh dimension that shards a later dimension
of a field (``'seq'`` of ``PartitionSpec('data', 'seq')``) cuts this rank's
rows to its coordinate's slice of that dimension, as that function slices a
host's rows. ``batch_size`` counts this rank's rows. The
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
These spans are host wall time: ``h2d`` covers the pinned staging copy and
the asynchronous issue of the upload, and ``d2d_wait`` the host blocked on
the decode tail's ring. The port adds ``deliver``, the loader's own host
time on the training thread from the queue's return to the yield, and on
the card three spans timed by CUDA events (:class:`DeviceSpans`, resolved
off the training thread): ``h2d_on_device`` (the copy on the loader's
stream, from an event recorded after the staging to one recorded after the
copy's issue), ``decode_tail_on_device`` (the end of the copy to the decode
tail's last launch: the kernels and any stretch the stream waited for the
producer thread to issue them) and ``input_stall_on_device`` (the training
stream waiting for the batch beyond its own queued work). These are stream
time, issue included, not kernel time. While torch's profiler
records, each host scope is also the range
``petastorm_tpu_torch.loader.<stage>`` on the thread that runs it
(``shuffle_wait`` as ``wait_input``, ``scan_stream``'s upload as
``scan_stream.h2d``; :mod:`~petastorm_tpu_torch.telemetry.spans`), so a
profile shows the loader's threads beside the kernels they feed.
``metrics_port=`` serves the merged snapshot, ``slo_policy=`` sets :meth:`TorchDataLoader.efficiency_report`'s
target, ``PETASTORM_TPU_TELEMETRY_JSONL`` streams periodic snapshots from
the consumer loop, and over a reader built with ``autotune=`` the loader adds
its knobs (prefetch, decode-tail depth, shuffle-buffer floor) to the
reader's controller.

Over a lineage-armed reader the loader stamps each yielded batch's training
step into the manifest (``LineageRecorder.stamp_step``). ``incidents=``
captures an incident bundle on the loader's own SLO breach or a breaker trip
(over a reader armed with ``incidents`` it reuses the reader's recorder), and
``history=`` appends one ``owner: 'loader'`` run record at :meth:`stop`
(into the reader's store unless a path is given) and arms a loader-side
regression sentinel.
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
from petastorm_tpu_torch.telemetry import spans as _spans
from petastorm_tpu_torch.telemetry import tracing as _tracing
from petastorm_tpu_torch.telemetry.registry import telemetry_enabled

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


class DeviceSpans(object):
    """Spans on the card's clock: each entry is one batch's ``(stage, start,
    end)`` spans between timing-enabled CUDA events (stream time: what the
    stream ran between them and any stretch it stood idle), kept pending
    until every event of the entry has completed, then observed into
    ``registry`` in seconds (a span whose end came first, as a wait that
    never waited, reads 0). Nothing synchronizes: :meth:`resolve` queries
    the leading entries and stops at the first still running. The loader's producer thread calls it
    once a batch, the training thread only at the stream's end: each query
    and observation on the training thread is time the step's issue waits
    for (the thread shares the interpreter lock with the reader's). An entry
    still pending when the loader stops is dropped."""

    def __init__(self, registry):
        self._registry = registry
        self._pending = collections.deque()
        self._lock = threading.Lock()

    def add(self, spans):
        """Queue one batch's spans."""
        with self._lock:
            self._pending.append(spans)

    def resolve(self):
        """Observe every leading entry whose events have all completed."""
        while True:
            with self._lock:
                if not self._pending or not all(
                        start.query() and end.query() for _, start, end in self._pending[0]):
                    return
                spans = self._pending.popleft()
            for stage, start, end in spans:
                self._registry.observe(stage, max(0.0, start.elapsed_time(end)) / 1e3)


def _timing_event():
    return torch.cuda.Event(enable_timing=True)


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
    :param incidents: True or an
        :class:`~petastorm_tpu_torch.telemetry.incident.IncidentPolicy`: a
        loader-level SLO breach or a breaker trip captures a bundle over the
        merged loader and reader telemetry; a reader armed with ``incidents``
        lends its recorder instead.
    :param history: True, a store path or a
        :class:`~petastorm_tpu_torch.telemetry.history.HistoryPolicy`: one
        ``owner: 'loader'`` run record at :meth:`stop` and a regression
        sentinel over the training loop's own series. Without a path the
        record goes into the reader's store; True over an unarmed reader
        warns and records nothing.
    """

    def __init__(self, reader, batch_size, shuffling_queue_capacity=0,
                 min_after_retrieve=None, seed=None, pad_ragged=None, prefetch=2,
                 drop_last=True, device=None, device_transforms=None,
                 device_buffer_depth=2, host_decode=False, mesh=None, partition_spec=None,
                 device_put=True, coalesce_fields=None, metrics_port=None,
                 slo_policy=None, incidents=None, history=None):
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
        # the training step each lineage manifest record lands under,
        # cumulative across re-iterations like stats.batches
        self._lineage_steps = 0
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == 'cuda' and device_put else None)
        #: the card's side of the loader (see the module docstring)
        self._device_spans = DeviceSpans(self.telemetry) if self._stream is not None else None
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
        self._start_incidents(reader, incidents)
        self._start_history(reader, history)
        # started last, so a scrape never sees a half-built loader
        if metrics_port is not None:
            from petastorm_tpu_torch.telemetry.http_exporter import MetricsHttpServer
            self._metrics_server = MetricsHttpServer(
                snapshot_fn=self._scrape_snapshot,
                health_fn=lambda: {'batches': self.stats.batches, 'rows': self.stats.rows},
                port=int(metrics_port))
            self._metrics_server.start()

    def _start_incidents(self, reader, incidents):
        """Reuse the reader's incident recorder (the loader's SLO edge joins
        its triggers), or build a loader-owned one under ``incidents``."""
        from petastorm_tpu_torch.telemetry.incident import resolve_incident_policy
        self._incidents = getattr(reader, '_incidents', None)
        self._owns_incidents = False
        policy = resolve_incident_policy(incidents)
        if policy is not None and self._incidents is None:
            from petastorm_tpu_torch.resilience import default_board
            from petastorm_tpu_torch.telemetry.incident import (IncidentRecorder,
                                                                default_incident_home)
            self._incidents = IncidentRecorder(default_incident_home(None), policy,
                                               registry=self.telemetry)
            self._owns_incidents = True
            self._incidents.add_source('metrics', self.telemetry_snapshot)
            self._incidents.add_source(
                'slo', lambda: self._evaluate_slo(self.telemetry_snapshot()))
            self._incidents.add_source(
                'config', lambda: {'batch_size': self.batch_size,
                                   'prefetch': self._prefetch,
                                   'drop_last': self._drop_last,
                                   'reader': type(reader).__name__})
            default_board().observe_transitions(self._incidents.on_breaker_transition)
        if self._incidents is not None:
            self._slo.observe_breaches(self._on_slo_breach)

    def _start_history(self, reader, history):
        """The loader-layer historian (the reader's store unless a path is
        given) and its regression sentinel."""
        from petastorm_tpu_torch.telemetry.history import resolve_history_policy
        self._history = None
        self._history_policy = resolve_history_policy(history)
        self._history_written = False
        self._sentinel = None
        if self._history_policy is None:
            return
        from petastorm_tpu_torch.telemetry.history import RunHistorian
        from petastorm_tpu_torch.telemetry.sentinel import (RegressionSentinel,
                                                            resolve_sentinel_policy)
        history_path = (self._history_policy.path
                        or getattr(getattr(reader, '_history', None), 'path', None))
        if history_path is not None:
            self._history = RunHistorian(history_path, self._history_policy,
                                         registry=self.telemetry)
        else:
            warnings.warn('TorchDataLoader(history=...) has no store path: pass a path or '
                          'HistoryPolicy(path=...), or arm the reader with '
                          'make_reader(history=...); recording disabled for this run')
        sentinel_policy = resolve_sentinel_policy(self._history_policy.sentinel)
        if sentinel_policy is not None:
            self._sentinel = RegressionSentinel(
                sentinel_policy, owner='loader', registry=self.telemetry,
                incidents=self._incidents,
                dataset_token=getattr(reader, 'dataset_token', None))
            if self._incidents is not None and getattr(reader, '_sentinel', None) is None:
                # the bundle's 'sentinel' slot is the reader's when it has one
                self._incidents.add_source('sentinel', self._sentinel.report)

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
            last_emit = time.perf_counter()
            while True:
                with _spans.host_span('loader', 'wait_input') as wait:
                    item = self._queue.get()
                now = time.perf_counter()
                if item is _END:
                    if self._device_spans is not None:
                        self._device_spans.resolve()
                    if self._error is not None:
                        raise self._error
                    self._mark_delivered(None)   # drop_last / buffer-drain leftovers
                    return
                with _spans.host_span('loader', 'deliver') as deliver:
                    batch, rows, done, copy = item
                    self.stats.add(wait_time_s=wait.seconds,
                                   total_time_s=now - last_emit, batches=1, rows=rows)
                    # shuffle_wait: the training loop blocked on the input
                    # pipeline for this batch
                    self.observe_traced('shuffle_wait', wait.seconds, start_pc=wait.start)
                    if self._telemetry_jsonl is not None and self._telemetry_jsonl.due():
                        # one snapshot for the interval line and the SLO check
                        snapshot = self.telemetry_snapshot()
                        self._evaluate_slo(snapshot)
                        self._telemetry_jsonl.emit(snapshot, event='loader_interval')
                    elif self._sentinel is not None:
                        # the sentinel's windows without a JSONL: one float
                        # compare a batch between them
                        from petastorm_tpu_torch.telemetry.slo import slo_clock
                        if self._sentinel.due(slo_clock() - self._started_at):
                            self._evaluate_slo(self.telemetry_snapshot())
                    last_emit = now
                    if done is not None:
                        self._await_batch(batch, done, copy)
                    if self._shardings is not None and self._device_put:
                        batch = self._shardings.distribute(batch, cut=self._device_decoded())
                    self._mark_delivered(rows)
                    self._lineage_steps += 1
                    lineage = getattr(self.reader, '_lineage', None)
                    if lineage is not None:
                        # manifest records written from here on carry this step
                        lineage.stamp_step(self._lineage_steps)
                self.telemetry.observe('deliver', deliver.seconds)  # pipecheck: disable=telemetry-names -- deliver is the port's own stage (PORT_STAGES), which the JAX package's catalog lacks
                yield batch
        finally:
            self._stop_event.set()
            self._in_iter = False
            self._drain_queue()

    def _await_batch(self, batch, done, copy):
        """Make the training stream wait for the loader's stream at ``done``
        and keep the batch's memory until the training stream's work on it
        ends. With ``copy`` (the upload's events, telemetry on) the batch's
        spans join :class:`DeviceSpans`: the decode tail's only where a
        recipe ran (``done`` is then not the copy's end), and the stall from
        an event the training stream reaches just before its wait to
        ``done``, since the stream stands still from there until ``done``
        completes (0 where ``done`` came first)."""
        consumer = torch.cuda.current_stream(self.device)
        if copy is not None:
            reached = _timing_event()
            reached.record(consumer)
            copy_start, copy_end = copy
            entry = [('h2d_on_device', copy_start, copy_end)]
            if done is not copy_end:
                entry.append(('decode_tail_on_device', copy_end, done))
            entry.append(('input_stall_on_device', reached, done))
            self._device_spans.add(entry)
        consumer.wait_event(done)
        for tensor in batch.values():
            tensor.record_stream(consumer)

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
        with _spans.host_span('loader', 'collate') as collate:
            passthrough = frozenset()
            stage = self._device_stage
            if stage is not None:
                with _spans.host_span('loader', 'device_decode') as decode:
                    columns, decoded_any = stage.sanitize_decode(columns)
                if decoded_any:
                    self.stats.add(device_fallback_batches=1)
                    self.observe_traced('device_decode', decode.seconds,
                                        start_pc=decode.start)
                passthrough = stage.passthrough_names
            out = sanitize_columns(columns, self._pad_ragged, self._device_put,
                                   passthrough=passthrough)
        self.observe_traced('collate', collate.seconds, start_pc=collate.start)
        return out

    def _emit(self, columns, out_queue, stop_event):
        rows = _num_rows(columns)
        if self._device_spans is not None:
            self._device_spans.resolve()
        if not self._device_put:
            self._put((columns, rows, None, None), out_queue, stop_event)
            return
        stage = self._device_stage
        if self._shardings is not None:
            # this rank's piece of each field, cut before the upload
            columns = self._shardings.local_columns(columns, skip=self._device_decoded())
        recipe = None
        prepare_s = 0.0
        if stage is not None and not stage.host_mode:
            # the decode tail's host half: pack/plan raw payloads for upload
            with _spans.host_span('loader', 'device_decode') as prepare:
                columns, recipe = stage.prepare(columns)
            prepare_s = prepare.seconds
        done = copy = None
        if self._stream is not None:
            with torch.cuda.stream(self._stream):
                batch, copy = self._finish(columns, stage, recipe, prepare_s)
                if copy is None:
                    done = torch.cuda.Event()
                    done.record(self._stream)
                elif recipe:
                    done = _timing_event()
                    done.record(self._stream)
                else:
                    done = copy[1]
        else:
            batch, _ = self._finish(columns, stage, recipe, prepare_s)
        if recipe:
            waited = stage.throttle(done)
            if waited:
                self.observe_traced('d2d_wait', waited)
        self._put((batch, rows, done, copy), out_queue, stop_event)

    def _device_decoded(self):
        """The columns decoded on the device: their pieces are cut there."""
        stage = self._device_stage
        return frozenset() if stage is None or stage.host_mode else stage.passthrough_names

    def _finish(self, columns, stage, recipe, prepare_s=0.0):
        """Upload, then run the decode tail, on the current stream; returns
        ``(batch, copy)``. ``h2d`` times the upload call on the host (staging
        copy and asynchronous issue), ``device_decode`` the decode tail's
        host time (``prepare_s`` plus issuing ``finish``'s launches). On the
        loader's CUDA stream with telemetry on, ``copy`` is the pair of
        timing events around the copy alone (recorded after the staging);
        None otherwise."""
        copy = (_timing_event(), _timing_event()) if (
            self._stream is not None and telemetry_enabled()) else None
        before_copy = copy[0].record if copy is not None else None
        with _spans.host_span('loader', 'h2d') as h2d:
            if self._coalesce_fields and coalescible(columns):
                batch = upload_columns(columns, self.device, before_copy=before_copy)
                self.stats.add(coalesced_uploads=1)
            else:
                batch = upload_fields(columns, self.device, before_copy=before_copy)
                self.stats.add(per_field_uploads=1)
            if copy is not None:
                copy[1].record()
        self.observe_traced('h2d', h2d.seconds, start_pc=h2d.start)
        if recipe:
            stored_before = stage.stored_batches
            with _spans.host_span('loader', 'device_decode') as finish:
                batch = stage.finish(batch, recipe)
            self.stats.add(device_decode_batches=1,
                           device_stored_batches=int(stage.stored_batches > stored_before))
            self.observe_traced('device_decode', prepare_s + finish.seconds)
        return batch, copy

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
        Its telemetry is host spans only (``collate`` and ``h2d``, the range
        ``petastorm_tpu_torch.loader.scan_stream.h2d``): no span on the
        card's clock times a chunk.

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
            if self._shardings is not None:
                columns = self._shardings.local_columns(columns)
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
            with _spans.host_span('loader', 'scan_stream.h2d') as h2d:
                upload_columns(chunk, self.device, out=buffer)
            self.observe_traced('h2d', h2d.seconds, start_pc=h2d.start)
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
        summed elsewhere, as ``d2d_wait``)."""
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
        report = self._slo.evaluate(snapshot, slo_clock() - self._started_at,
                                    rows=self.stats.rows, registry=self.telemetry)
        if self._sentinel is not None:
            self._sentinel.observe(report)
            self._sentinel.export_gauges()
        return report

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
        if self._sentinel is not None:
            gauges.update(self._sentinel.gauges())
        snapshot['slo_history'] = report.get('history', [])
        return snapshot

    def _on_slo_breach(self, report):
        """The loader's SLO ok -> breach edge (the training loop starved):
        one ``slo_breach`` incident."""
        if self._incidents is not None:
            self._incidents.trigger('slo_breach',
                                    args={'efficiency': report.get('efficiency'),
                                          'target': report.get('target_efficiency'),
                                          'wait_seconds': report.get('wait_seconds'),
                                          'layer': 'loader'})

    def incident_report(self):
        """The attached incident recorder's summary (the loader's or the
        reader's); None when neither armed ``incidents``."""
        if self._incidents is None:
            return None
        return self._incidents.report()

    def _write_history_record(self):
        """Append the ``owner: 'loader'`` run record (whole-pipeline rows/s
        and shares), once; a run that delivered its batches never fails over
        it."""
        if self._history is None or self._history_written:
            return
        self._history_written = True
        from petastorm_tpu_torch.telemetry.history import build_run_record, fingerprint
        from petastorm_tpu_torch.telemetry.slo import efficiency_from_snapshot, slo_clock
        try:
            elapsed = slo_clock() - self._started_at
            snapshot = self.telemetry_snapshot()
            rows = self.stats.rows
            build_reader_record = getattr(self.reader, 'build_history_record', None)
            reader_record = build_reader_record() if build_reader_record is not None else None
            fingerprints = dict((reader_record or {}).get('fingerprints', {}))
            fingerprints['loader'] = fingerprint({
                'batch_size': self.batch_size, 'prefetch': self._prefetch,
                'drop_last': self._drop_last,
                'shuffling_queue_capacity': self._shuffling_queue_capacity,
                'device_stage': self._device_stage is not None})
            self._history.append(build_run_record(
                'loader', str(getattr(self.reader, 'dataset_token', 'unknown')),
                elapsed, rows, snapshot=snapshot,
                slo_report=efficiency_from_snapshot(snapshot, elapsed, rows=rows),
                fingerprints=fingerprints,
                knobs=dict((reader_record or {}).get('knobs', {})),
                incidents=self.incident_report(),
                quarantined=(reader_record or {}).get('quarantined', 0)))
        except Exception:  # noqa: BLE001 - the run record is advisory
            import logging
            logging.getLogger(__name__).warning(
                'could not record this run in the history store', exc_info=True)

    def history_report(self):
        """The loader-layer historian's store status; None without
        ``history``."""
        if self._history is None:
            return None
        return self._history.state()

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
        # the loader's record first: the reader's stop appends its own to the
        # same store
        self._write_history_record()
        if self._owns_incidents and self._incidents is not None:
            self._incidents.close()   # a reader-owned recorder is the reader's
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

    def local(self, name, rows):
        """This rank's piece of field ``name`` from its rows (a numpy array
        or a tensor): each dimension after the first that a mesh dimension
        shards is cut to the rank's coordinate along it (the first is the
        reader's). A view; ``rows`` itself when nothing is cut."""
        from torch.distributed.tensor import Shard
        for mesh_dim, placement in enumerate(self.placements(name)):
            count = self.mesh.size(mesh_dim)
            if isinstance(placement, Shard) and placement.dim > 0 and count > 1:
                if rows.shape[placement.dim] % count:
                    raise ValueError('field {} dimension {} of size {} does not split into {} '
                                     'shards'.format(name, placement.dim,
                                                     rows.shape[placement.dim], count))
                size = rows.shape[placement.dim] // count
                start = self.mesh.get_local_rank(mesh_dim) * size
                rows = rows[(slice(None),) * placement.dim + (slice(start, start + size),)]
        return rows

    def local_columns(self, columns, skip=frozenset()):
        """:meth:`local` of every column but those named in ``skip``: the
        host's rows cut before the upload, so a rank copies only its piece."""
        return {name: col if name in skip else self.local(name, col)
                for name, col in columns.items()}

    def distribute(self, batch, cut=frozenset()):
        """``{name: DTensor}`` from this rank's ``{name: tensor}``: no
        collective (``run_check=False``), so also inside a CUDA graph
        capture. The fields are this rank's pieces already (cut on the host
        by :meth:`local_columns`) but those named in ``cut``, which are cut
        here (the fields decoded on the device). The first call checks the
        spec's keys."""
        from torch.distributed.tensor import DTensor
        if not self._checked:
            self._checked = True
            self.check_unused(batch.keys())
        return {name: DTensor.from_local(
                    self.local(name, tensor) if name in cut else tensor, self.mesh,
                    self.placements(name), run_check=False)
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


def upload_columns(columns, device, out=None, before_copy=None):
    """Numeric host columns -> tensors on ``device`` through ONE packed uint8
    buffer: pinned and copied asynchronously on the current stream for CUDA,
    used in place on the CPU. Each field is a ``view(dtype)`` slice of the
    device buffer, aligned to 16 bytes. With ``out`` (a uint8 tensor on
    ``device`` of the packed size, e.g. a CUDA graph's static input) the copy
    goes into it. ``before_copy()`` runs after the staging, immediately
    before a CUDA copy is issued."""
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
        if before_copy is not None:
            before_copy()
        buf = out.copy_(host, non_blocking=True)
    elif device.type == 'cuda':
        if before_copy is not None:
            before_copy()
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


def upload_fields(columns, device, before_copy=None):
    """Host columns -> tensors on ``device``, one copy a field: all pinned,
    then each copied asynchronously on the current stream for CUDA, a
    contiguous native-endian copy on the CPU. ``before_copy()`` runs after
    the staging, immediately before the first CUDA copy is issued."""
    out = {}
    for name, col in columns.items():
        host = np.array(col, dtype=col.dtype.newbyteorder('='), order='C', copy=True)
        tensor = torch.from_numpy(host)
        out[name] = tensor.pin_memory() if device.type == 'cuda' else tensor
    if device.type == 'cuda':
        if before_copy is not None:
            before_copy()
        out = {name: tensor.to(device, non_blocking=True) for name, tensor in out.items()}
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


def sanitize_columns(columns, pad_ragged, device_put=True, passthrough=frozenset()):
    """Make host columns uploadable: datetimes -> int64 ns, ragged fields padded
    per ``pad_ragged`` (adding an int32 ``<field>_len`` column), strings and
    objects rejected with the field named when ``device_put`` (the batch goes
    to the device), kept as they are otherwise. Columns in ``passthrough``
    (raw payloads pending device decode, and their auxiliaries) pass
    untouched."""
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
            if device_put:
                raise ValueError('Field {!r} has dtype {} which has no tensor '
                                 'representation; drop it via schema_fields or use '
                                 'device_put=False'.format(name, col.dtype))
            out[name] = col
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
