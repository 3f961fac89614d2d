"""Stage spans: named timing scopes over the data-plane pipeline stages. A
copy of ``petastorm_tpu.telemetry.spans`` with the same catalog, so a
snapshot's names mean the same thing in both packages.

A *stage* is one step a row batch passes through on its way to the card —
``fs_open``, ``rowgroup_read``, ``decode``, ``transform``, ``shuffle``,
``cache_hit`` / ``cache_miss`` / ``cache_store``, ``serialize``,
``shm_slot_wait`` / ``shm_map`` / ``shm_release``, ``shuffle_wait``,
``collate``, ``h2d``, ``device_decode`` / ``d2d_wait``. Every span of the
catalog is host wall time: ``h2d`` times the host's part of an upload (the
pinned staging copy and the asynchronous issue); the copy's stream time on
the card is the port's ``h2d_on_device`` (``PORT_STAGES``). Worker-side
stages execute in whatever process the pool runs them in, so their timings
cannot be written into the consumer's registry directly; instead each worker
thread accumulates them in a process-local :class:`StageRecorder` and the
rowgroup worker **drains** the accumulation into the published batch's
``telemetry`` sidecar, where ``Reader._note_item_consumed`` merges it into the
consumer-side registry. One snapshot therefore covers every process, and a
respawned worker's fresh recorder merges additively like any other (no double
counting, no loss beyond the unpublished in-flight item).

The recorder is sharded per THREAD (``threading.local``): a drain returns only
the calling thread's accumulation, so thread-pool workers never race each other,
and the serialize/slot-wait stages recorded by the process-pool worker main land
on the same thread that publishes the next batch (they ride one item late —
still the same process total).

The catalog is the JAX package's, the topology plane's names included:
``parallel/topology.py`` counts ``topology_frames_dropped`` and
``host_reshard`` into the reader's registry and marks the ``host_reshard``
instant when a reader of ``make_reader(topology=)`` joins as a reshard
survivor. ``PORT_STAGES`` adds
the port's own loader stages: ``deliver`` on the host clock and three spans
on the card's clock (CUDA events, ``DEVICE_CLOCK_STAGES``), and
``graph_capture``, a model's capture of its CUDA graphs on the host clock,
whose counters are ``PORT_COUNTERS``. Each of the three card-clock spans is
stream time: the interval between two points a stream reaches, which holds
the stream's work and any stretch it stood idle waiting for the host to
issue more (the decode tail's span, between the copy's end and the last
launch, holds the launches' issue as well as their kernels). Time-share
attribution leaves them out, since stream time is not a host thread's.

While torch's profiler records, every scoped span also opens
``torch.profiler.record_function('petastorm_tpu_torch.<side>.<stage>')`` on
the thread that does the work (:func:`open_range`): ``stage_span`` as
``petastorm_tpu_torch.reader.<stage>``, the loader's scopes as
``petastorm_tpu_torch.loader.<stage>`` (:class:`host_span`). A profile then
holds the program's spans on the same clock as the card's activity. The
check reads torch's own is-profiling flag, and only where torch is already
imported: this module imports no torch, so process-pool workers load none.
A back-dated :func:`record_stage` opens no range: ``cache_hit`` and
``cache_miss`` (named once the lookup ends), ``range_fetch`` and
``range_hedge`` stay off the profiler's timeline.
"""

from __future__ import annotations

import sys
import threading
import time
from types import TracebackType
from typing import Any, Dict, List, Optional, Type

from petastorm_tpu_torch.telemetry import registry as _registry
from petastorm_tpu_torch.telemetry import tracing as _tracing
from petastorm_tpu_torch.telemetry.registry import (DEFAULT_NUM_BUCKETS, SECONDS_UNIT,
                                                    bucket_index)

#: canonical stage names, pipeline order
STAGES = (
    'fs_open',        # filesystem construction / reconnect (worker)
    'rowgroup_read',  # Parquet rowgroup -> Arrow table (worker)
    'decode',         # codec decode, Arrow -> numpy columns (worker)
    'shuffle',        # in-rowgroup seeded permutation (worker)
    'transform',      # TransformSpec application (worker)
    'cache_hit',      # serving a decoded rowgroup from the cache (worker)
    'cache_miss',     # the full fill of a missed key — ENVELOPES read+decode
    'cache_store',    # writing a filled value to the cache (worker)
    'cache_corrupt',  # detecting+deleting a corrupt entry (worker; count = entries)
    'serialize',      # result -> wire frames (process-pool worker main)
    'shm_slot_wait',  # backpressure wait for a free ring slot (worker main)
    'shm_map',        # slot view + deserialize on the consumer (pool)
    'shm_release',    # slot ack back to the producing worker (pool)
    'pool_wait',      # consumer blocked in pool.get_results (pool)
    'shuffle_wait',   # consumer blocked on the loader's prefetch queue (loader)
    'collate',        # host batch assembly / sanitize (loader)
    'h2d',            # host->device upload, host wall time (loader)
    'device_decode',  # decode-tail work on raw-shipped fields: pack/inflate +
                      # the decode tail's launches, or the host fallback
                      # decode (loader)
    'd2d_wait',       # blocked on the prefetch-to-device ring: the oldest
                      # dispatched device batch had not finished (loader)
    'decode_field',   # ONE field's kernel inside 'decode' — emitted to the
                      # flight-recorder timeline only (never a histogram),
                      # and only while tracing is armed
    'range_fetch',    # one planned multi-range fetch of a rowgroup's column
                      # chunks (storage/fetcher.py)
    'range_hedge',    # lifetime of one hedged duplicate GET, win or lose
                      # (storage/fetcher.py)
)

#: the port's own stages, beside the JAX package's catalog (pipecheck's
#: telemetry-names rule accepts them wherever it accepts STAGES)
PORT_STAGES = (
    'graph_capture',          # a module's warm-up and capture of its forward
                              # and backward graphs, host clock, synchronised
                              # (parallel/graphs.py:ModuleGraphs)
    'deliver',                # the loader's own time on the training thread
                              # from the queue's return to the yield (loader)
    'h2d_on_device',          # the upload's copy on the loader's stream, card
                              # clock: the copy and its issue (loader)
    'decode_tail_on_device',  # the end of the copy to the decode tail's last
                              # launch on the loader's stream, card clock:
                              # kernels and issue (loader)
    'input_stall_on_device',  # the training stream waiting for the loader's
                              # stream beyond its own queued work, card clock
                              # (loader)
)

#: PORT_STAGES timed by CUDA events: stream time, left out of time-share
#: attribution (telemetry/analyze.py)
DEVICE_CLOCK_STAGES = frozenset({'h2d_on_device', 'decode_tail_on_device',
                                 'input_stall_on_device'})

#: the profiler ranges' prefix: ``petastorm_tpu_torch.<side>.<stage>``
RANGE_PREFIX = 'petastorm_tpu_torch.'

#: stages whose span ENVELOPES other recorded stages (cache_miss wraps
#: rowgroup_read+decode) — excluded from time-share attribution so shares of the
#: leaf stages sum sensibly (telemetry/analyze.py)
ENVELOPE_STAGES = frozenset({'cache_miss'})

#: declared event counters (``registry.inc(name)`` call sites), the telemetry
#: name catalog alongside STAGES
COUNTERS = (
    'breaker_open',    # a circuit breaker tripped open (pool consumer side)
    'watchdog_reap',   # a hung worker was SIGKILLed by the watchdog (pool)
    'shm_crc_fail',    # a shm frame failed CRC verification (pool)
    'service_busy',    # the input service rejected a submit (admission control)
    'service_resubmit',  # a service item was re-requested (lost shm segment)
    'slo_breach',      # input-efficiency fell below the SLO target (edge-
                       # triggered: one count per ok->breach transition —
                       # telemetry/slo.py)
    'lineage_divergence',  # a delivered item broke the expected lineage
                           # stream (the lineage plane)
    'incidents_captured',      # an incident bundle was written (the incident
                               # plane)
    'incidents_rate_limited',  # an incident trigger was dropped by the
                               # per-kind token bucket (the incident plane)
    'ledger_frames_dropped',   # dispatcher-ledger journal frames that failed
                               # CRC replay (the input service)
    'storage_footer_cache_hit',   # a Parquet footer was served from the
                                  # metadata cache (the storage engine)
    'storage_footer_cache_miss',  # a footer had to be read from storage
    'storage_ranges_coalesced',   # raw column-chunk ranges merged away by
                                  # gap-threshold coalescing (count = raw -
                                  # merged)
    'storage_hedge_fired',        # a hedged duplicate GET was launched
    'storage_hedge_won',          # the hedge returned before the primary
                                  # (its bytes were committed; the primary's
                                  # were dropped)
    'perf_regression',            # the live regression sentinel's drift test
                                  # fired on a goodput collapse / wait-share
                                  # growth (edge-triggered)
    'history_record_written',     # one run record was appended to the
                                  # longitudinal run-history store
    'history_frames_dropped',     # run-history journal frames that failed
                                  # CRC replay (torn tail / flipped byte)
    'host_reshard',               # a reader joined as a reshard survivor —
                                  # undelivered rowgroups were re-dealt
                                  # after a host join/leave/lease expiry
    'topology_frames_dropped',    # membership-journal frames that failed
                                  # CRC replay (torn tail / flipped byte)
)

#: the port's own counters, beside COUNTERS (pipecheck's telemetry-names rule
#: accepts them wherever it accepts COUNTERS): a module's CUDA graphs
#: (parallel/graphs.py:ModuleGraphs, in its own registry)
PORT_COUNTERS = (
    'model_graph_capture',        # a forward and backward graph pair captured
    'model_graph_replay',         # a training call replayed as the graphs
    'model_graph_eager_on_card',  # a training call on the card that ran
                                  # eagerly (no gradients, inside another
                                  # capture, or the last replay's backward
                                  # still to come)
)

#: declared size histograms (``registry.observe(name, n, unit=BYTES_UNIT)``
#: call sites) — same catalog contract as COUNTERS
SIZE_HISTOGRAMS = (
    'wire_bytes_copied',  # bytes materialized into new host memory per batch
)

#: declared flight-recorder instant events (``tracing.trace_instant(name)``
#: call sites) — same catalog contract as COUNTERS
TRACE_INSTANTS = (
    'ventilate',           # a work item entered the pool (consumer, ventilator thread)
    'rowgroup_consumed',   # the item's result was popped and accounted (consumer)
    'quarantine',          # a rowgroup was quarantined (worker, or consumer hang path)
    'watchdog_reap',       # a hung worker was SIGKILLed by the watchdog (consumer)
    'worker_respawn',      # a dead worker's in-flight item was re-ventilated (consumer)
    'breaker_transition',  # a circuit breaker changed state (any process)
    'shm_crc_drop',        # a shm frame failed CRC and was dropped unread (consumer)
    'shm_fallback',        # a result rode the pipe while the shm ring was enabled
    'autotune_decision',   # the closed-loop autotuner proposed/committed/reverted/froze a knob change (controller)
    'slo_breach',          # input-efficiency fell below the SLO target (consumer; telemetry/slo.py)
    'schedule_plan',       # the cost-aware scheduler planned one epoch's ventilation order
    'lineage_divergence',  # a delivered item broke the expected lineage stream
    'incident_captured',   # an incident bundle was written at this point on the timeline
    'reshard',             # undelivered service work was re-split across a changed worker set
    'ledger_replay',       # a restarting dispatcher replayed its durable token ledger
    'perf_regression',     # the live regression sentinel fired mid-run
    'host_reshard',        # a reader joined as a host-reshard survivor after a topology change
)

#: declared gauge ids (``registry.gauge(name)`` call sites with literal
#: names) — same catalog contract as COUNTERS
GAUGES = (
    'slo_efficiency',          # latest evaluated input efficiency [0,1] (slo.py)
    'slo_target_efficiency',   # the SLO target the efficiency is held against
    'service_queue_depth',       # accepted items queued fleet-wide (dispatcher)
    'service_ready_workers',     # idle decode workers (dispatcher)
    'service_workers',           # registered decode workers (dispatcher)
    'service_admission_window',  # per-client in-flight cap (dispatcher)
    'service_client_window',     # smallest live client window (dispatcher)
    'lineage_items_folded',      # items folded into the order digest so far
    'lineage_pending_items',     # delivered-out-of-order items awaiting
                                 # their fold slot
    'sentinel_rate_ewma',        # the regression sentinel's smoothed windowed
                                 # rows/s
    'sentinel_wait_share_ewma',  # the sentinel's smoothed primary-wait share
                                 # of each window
)


class StageRecorder(object):
    """Per-thread accumulation of stage timings, drained into batch sidecars.

    Each thread owns a private ``{stage: [count, sum, max, {bucket: n}]}`` dict;
    ``record`` appends to it without locks and ``drain`` atomically (per thread)
    hands it off as a JSON-safe ``{stage: histogram_snapshot}`` mapping that
    :meth:`MetricsRegistry.merge_stage_times` understands."""

    __slots__ = ('_local',)

    def __init__(self) -> None:
        self._local = threading.local()

    def _cells(self) -> Dict[str, List[Any]]:
        cells = getattr(self._local, 'cells', None)
        if cells is None:
            cells = {}
            self._local.cells = cells
        return cells

    def record(self, stage: str, seconds: float) -> None:
        """Accumulate one observation of ``stage`` for the calling thread."""
        if not _registry.telemetry_enabled():
            return
        cells = self._cells()
        cell = cells.get(stage)
        if cell is None:
            cell = [0, 0.0, 0.0, {}]
            cells[stage] = cell
        cell[0] += 1
        cell[1] += seconds
        if seconds > cell[2]:
            cell[2] = seconds
        idx = bucket_index(seconds, SECONDS_UNIT, DEFAULT_NUM_BUCKETS)
        cell[3][idx] = cell[3].get(idx, 0) + 1

    def drain(self) -> Optional[Dict[str, Dict[str, Any]]]:
        """Hand off and clear the calling thread's accumulation (None if empty)."""
        cells = getattr(self._local, 'cells', None)
        if not cells:
            return None
        self._local.cells = {}
        return {stage: {'unit': SECONDS_UNIT, 'count': cell[0], 'sum': cell[1],
                        'max': cell[2],
                        'buckets': {str(i): n for i, n in cell[3].items()}}
                for stage, cell in cells.items()}


#: the process-wide recorder every data-plane stage writes to (worker side)
_process_recorder = StageRecorder()


def record_stage(stage: str, seconds: float,
                 trace_args: Optional[Dict[str, Any]] = None) -> None:
    """Record one observation into the process-wide stage recorder (and, when
    the flight recorder is armed, a matching trace event back-dated by the
    measured duration). ``trace_args`` rides only the trace event, never the
    histogram: the storage engine puts each fetch's byte, range and hedge
    totals there."""
    _process_recorder.record(stage, seconds)
    if _tracing.trace_enabled():
        _tracing.trace_complete(stage, time.perf_counter() - seconds, seconds,
                                args=trace_args)


def drain_stage_times() -> Optional[Dict[str, Dict[str, Any]]]:
    """Drain the calling thread's accumulated stage times (for batch sidecars)."""
    return _process_recorder.drain()


#: ``torch.autograd.profiler`` once torch is imported (never imported here)
_autograd_profiler: Any = None


def profiler_recording() -> bool:
    """True while torch's profiler records: torch's own is-profiling flag,
    read only where torch is already in ``sys.modules``."""
    global _autograd_profiler
    if _autograd_profiler is None:
        _autograd_profiler = sys.modules.get('torch.autograd.profiler')
        if _autograd_profiler is None:
            return False
    return bool(_autograd_profiler._is_profiler_enabled)


def open_range(side: str, stage: str) -> Any:
    """The profiler range ``petastorm_tpu_torch.<side>.<stage>``
    (``record_function``), entered on the calling thread while torch's
    profiler records; None otherwise, with the name never built. Close it
    with :func:`close_range`."""
    if not profiler_recording():
        return None
    scope = _autograd_profiler.record_function(RANGE_PREFIX + side + '.' + stage)
    scope.__enter__()
    return scope


def close_range(scope: Any, exc_type: Optional[Type[BaseException]] = None,
                exc: Optional[BaseException] = None,
                tb: Optional[TracebackType] = None) -> None:
    """Exit a range :func:`open_range` returned (None: nothing to close)."""
    if scope is not None:
        scope.__exit__(exc_type, exc, tb)


class host_span(object):
    """A host-clock scope inside the profiler range
    ``petastorm_tpu_torch.<side>.<stage>`` while torch's profiler records:
    ``start`` (``perf_counter``) and, after the block, ``seconds``. The
    caller records them (the loader's scopes, whose stages land in the
    loader's registry)."""

    __slots__ = ('_side', '_stage', '_range', 'start', 'seconds')

    def __init__(self, side: str, stage: str) -> None:
        self._side = side
        self._stage = stage
        self._range: Any = None
        self.start = 0.0
        self.seconds = 0.0

    def __enter__(self) -> 'host_span':
        self._range = open_range(self._side, self._stage)
        self.start = time.perf_counter()
        return self

    def __exit__(self, exc_type: Optional[Type[BaseException]],
                 exc: Optional[BaseException],
                 tb: Optional[TracebackType]) -> None:
        self.seconds = time.perf_counter() - self.start
        close_range(self._range, exc_type, exc, tb)
        self._range = None


class stage_span(object):
    """Context manager timing one stage into the process recorder:
    ``with stage_span('decode'): ...``, inside the profiler range
    ``petastorm_tpu_torch.reader.<stage>`` while torch's profiler records.
    Near-zero cost when telemetry is disabled (one enabled check, no clock
    reads) and the profiler is off (one flag read). Exceptions propagate; the
    partial duration is still recorded (a stage that died slow is exactly the
    signal the bottleneck report wants)."""

    __slots__ = ('_stage', '_start', '_range')

    def __init__(self, stage: str) -> None:
        self._stage = stage
        self._start = 0.0
        self._range: Any = None

    def __enter__(self) -> 'stage_span':
        self._range = open_range('reader', self._stage)
        if _registry.telemetry_enabled() or _tracing.trace_enabled():
            self._start = time.perf_counter()
        return self

    def __exit__(self, exc_type: Optional[Type[BaseException]],
                 exc: Optional[BaseException],
                 tb: Optional[TracebackType]) -> None:
        close_range(self._range, exc_type, exc, tb)
        self._range = None
        if self._start:
            duration = time.perf_counter() - self._start
            _process_recorder.record(self._stage, duration)
            if _tracing.trace_enabled():
                # same measurement feeds both views: the histogram (aggregate)
                # and the flight-recorder timeline (this specific span)
                _tracing.trace_complete(self._stage, self._start, duration)
            self._start = 0.0
