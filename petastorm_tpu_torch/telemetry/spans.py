"""Stage spans: named timing scopes over the data-plane pipeline stages. A
copy of ``petastorm_tpu.telemetry.spans`` with the same catalog, so a
snapshot's names mean the same thing in both packages.

A *stage* is one step a row batch passes through on its way to the card —
``fs_open``, ``rowgroup_read``, ``decode``, ``transform``, ``shuffle``,
``cache_hit`` / ``cache_miss`` / ``cache_store``, ``serialize``,
``shm_slot_wait`` / ``shm_map`` / ``shm_release``, ``shuffle_wait``,
``collate``, ``h2d``, ``device_decode`` / ``d2d_wait``. Every span is host
wall time: ``h2d`` times the host's part of an upload (the pinned staging copy
and the asynchronous issue), not the copy's time on the card. Worker-side
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

The catalog keeps the names of the one plane the port does not have yet
(the ``topology_*`` counters and the ``host_reshard`` instant): nothing in
the port records them.
"""

from __future__ import annotations

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


class stage_span(object):
    """Context manager timing one stage into the process recorder:
    ``with stage_span('decode'): ...``. Near-zero cost when telemetry is
    disabled (one enabled check, no clock reads). Exceptions propagate; the
    partial duration is still recorded (a stage that died slow is exactly the
    signal the bottleneck report wants)."""

    __slots__ = ('_stage', '_start')

    def __init__(self, stage: str) -> None:
        self._stage = stage
        self._start = 0.0

    def __enter__(self) -> 'stage_span':
        if _registry.telemetry_enabled() or _tracing.trace_enabled():
            self._start = time.perf_counter()
        return self

    def __exit__(self, exc_type: Optional[Type[BaseException]],
                 exc: Optional[BaseException],
                 tb: Optional[TracebackType]) -> None:
        if self._start:
            duration = time.perf_counter() - self._start
            _process_recorder.record(self._stage, duration)
            if _tracing.trace_enabled():
                # same measurement feeds both views: the histogram (aggregate)
                # and the flight-recorder timeline (this specific span)
                _tracing.trace_complete(self._stage, self._start, duration)
            self._start = 0.0
