"""Flight recorder: bounded per-process ring-buffer event tracing with a
causal rowgroup context. A copy of ``petastorm_tpu.telemetry.tracing``.

The histograms answer "which stage is slow on average"; this module answers
"what happened to *this* rowgroup during *that* stall". Every process keeps a
**bounded, lock-free ring buffer** of timestamped events:

- **complete events** (``'X'``): one per stage span of the catalog
  (``telemetry/spans.py`` emits them from ``stage_span`` / ``record_stage``
  whenever tracing is on);
- **instant events** (``'i'``): the anomalies — watchdog reaps, circuit-breaker
  transitions, quarantines, shm CRC drops, shm pipe fallbacks, re-ventilations
  (the declared catalog is ``spans.TRACE_INSTANTS``).

Events are tagged with the **causal trace context** ``(epoch, rowgroup,
attempt)``: the epoch/rowgroup pair originates at the ventilator (it already
rides every ventilated item as ``epoch_index``/``piece_index``), the dispatch
*attempt* rides the process pool's existing work frames, and
``process_worker_main`` installs it before each item so worker-side spans are
stitched to the exact delivery attempt — a re-ventilated rowgroup's second life
is a *different* attempt on the timeline.

Cross-process collection reuses the telemetry sidecar ride: the rowgroup worker
**drains** its thread's ring into each published batch's ``trace`` sidecar
(``{'pid': ..., 'events': [...]}``) and the reader merges it into the
consumer-side recorder, so one :func:`trace_snapshot` covers every process.
Ring capacity is ``PETASTORM_TPU_TRACE_RING`` events per thread ring (default
65536); overwritten events are **counted, never silently lost** — the drop
count rides every snapshot and summary. Two bounded tails are inherent to the
sidecar ride and documented rather than counted: spans recorded *during* a
publish (``serialize``/``shm_slot_wait``) ship one batch late — so each
worker's final such span stays in its ring at shutdown — and a thread's
undrained ring is released when the thread exits (same one-item-late contract
as the ``telemetry`` sidecar).

Timestamps are ``time.perf_counter()`` microseconds: on Linux that is
``CLOCK_MONOTONIC``, which is system-wide per boot, so worker and consumer
events of one host share a timebase and interleave correctly on the exported
timeline (the only deployment shape the process pool supports).

Tracing is **off by default** (``PETASTORM_TPU_TRACE=1``, ``make_reader(...,
trace=True)`` or :func:`set_trace_enabled` turn it on); when off, every hook is
one attribute read. Export is :mod:`petastorm_tpu_torch.telemetry.trace_export`
(Chrome-trace/Perfetto JSON + anomaly summary).
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: causal trace context: (absolute epoch, rowgroup piece index, dispatch attempt)
TraceContext = Tuple[int, int, int]
#: one recorded event: (ts_us, dur_us, phase 'X'|'i', name, ctx, tid, args)
TraceEvent = Tuple[float, float, str, str, Optional[TraceContext], int,
                   Optional[Dict[str, Any]]]

_ENV_SWITCH = 'PETASTORM_TPU_TRACE'
_ENV_RING = 'PETASTORM_TPU_TRACE_RING'

#: default per-thread ring capacity (events); also the foreign-event buffer cap
DEFAULT_RING_EVENTS = 65536

_enabled = os.environ.get(_ENV_SWITCH, '0') not in ('0', '', 'false', 'off')


def _ring_capacity_from_env() -> int:
    raw = os.environ.get(_ENV_RING, '')
    try:
        value = int(raw) if raw else DEFAULT_RING_EVENTS
    except ValueError:
        return DEFAULT_RING_EVENTS
    return max(value, 16)


def trace_enabled() -> bool:
    """True when the flight recorder is armed (``PETASTORM_TPU_TRACE=1`` /
    :func:`set_trace_enabled`). Off by default; when off every trace hook is a
    single attribute read."""
    return _enabled


def set_trace_enabled(value: bool) -> None:
    """Override the env-derived tracing switch. Scope mirrors
    :func:`~petastorm_tpu_torch.telemetry.registry.set_telemetry_enabled`: this
    process, plus process-pool workers spawned AFTER the call (the pool
    captures the switch into the worker environment at ``start()``)."""
    global _enabled
    _enabled = bool(value)


class _Ring(object):
    """One thread's private bounded entry storage: a preallocated list written
    round-robin (plain :data:`TraceEvent` tuples in per-thread rings;
    ``(pid, TraceEvent)`` wrappers in the foreign buffer). Single-writer (the
    owning thread); readers tolerate the one in-flight slot being
    mid-overwrite (CPython list-slot assignment is atomic, so they see the
    old or the new entry, never a torn one)."""

    # __weakref__: the recorder's registry holds only weak refs to rings
    __slots__ = ('buf', 'cap', 'n', 'dropped', '__weakref__')

    def __init__(self, cap: int) -> None:
        self.buf: List[Optional[Any]] = [None] * cap
        self.cap = cap
        self.n = 0
        self.dropped = 0

    def append(self, event: Any) -> None:
        if self.n >= self.cap:
            self.dropped += 1
        self.buf[self.n % self.cap] = event
        self.n += 1

    def events(self) -> List[Any]:
        """Buffered entries, oldest first (never clears)."""
        if self.n <= self.cap:
            raw: Sequence[Optional[Any]] = self.buf[:self.n]
        else:
            pivot = self.n % self.cap
            raw = self.buf[pivot:] + self.buf[:pivot]
        return [event for event in raw if event is not None]

    def clear(self) -> None:
        self.buf = [None] * self.cap
        self.n = 0


class _RingHolder(object):
    """The one STRONG reference to a thread's ring, stored in thread-local
    storage: when the thread exits, CPython drops the holder, its finalizer
    retires the ring's undrained tail, and the ring memory is released."""

    __slots__ = ('ring', '__weakref__')

    def __init__(self, ring: _Ring) -> None:
        self.ring = ring


class TraceRecorder(object):
    """Per-process flight recorder: per-thread bounded rings (lock-free record
    path, same discipline as the histogram shards) plus one bounded buffer of
    **foreign** events merged from other processes' ``trace`` sidecars.

    ``record`` appends to the calling thread's ring; ``drain`` hands off and
    clears the calling thread's ring (the worker-publish path); ``snapshot``
    gathers every ring plus the foreign buffer without clearing (the consumer
    dump path). The only lock guards ring REGISTRATION and the foreign buffer
    — never the record path.

    Ring lifetime is thread lifetime: the registry holds only WEAK references
    (the strong one lives in the owning thread's local storage), so a
    long-lived process that keeps creating short-lived reader/worker threads
    does not accumulate dead rings without bound. When a thread exits, a
    finalizer **retires** its undrained tail — remaining events and drop
    count — into one bounded process-wide retired buffer (overflow counted
    there like everywhere else): a ventilator or loader thread that finishes
    before ``snapshot()`` still contributes its events to the capture."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        self._capacity = capacity if capacity is not None \
            else _ring_capacity_from_env()
        self._local = threading.local()
        self._rings: List['weakref.ref[_Ring]'] = []
        self._lock = threading.Lock()
        self._foreign = _Ring(self._capacity)
        self._foreign_dropped = 0
        #: dead threads' undrained events (own process), moved here by the
        #: per-thread finalizer so thread exit never erases a capture
        self._retired = _Ring(self._capacity)
        self._retired_dropped = 0

    def _ring(self) -> _Ring:
        holder = getattr(self._local, 'holder', None)
        if holder is None:
            ring = _Ring(self._capacity)
            holder = _RingHolder(ring)
            with self._lock:
                self._rings = [ref for ref in self._rings
                               if ref() is not None]
                self._rings.append(weakref.ref(ring))
            # The holder lives only in this thread's local storage: thread
            # exit drops it, the finalizer retires the ring's leftovers, and
            # the finalizer's own ref to the ring is released — memory stays
            # bounded while the capture stays complete.
            weakref.finalize(holder, self._retire_ring, ring)
            self._local.holder = holder
        ring_out: _Ring = holder.ring
        return ring_out

    def _retire_ring(self, ring: _Ring) -> None:
        """Move a dead thread's undrained events into the retired buffer."""
        with self._lock:
            for event in ring.events():
                self._retired.append(event)
            self._retired_dropped += ring.dropped
        ring.clear()
        ring.dropped = 0

    def _live_rings(self) -> List[_Ring]:
        # caller holds self._lock
        return [ring for ring in (ref() for ref in self._rings)
                if ring is not None]

    def record(self, ts_us: float, dur_us: float, phase: str, name: str,
               ctx: Optional[TraceContext],
               args: Optional[Dict[str, Any]] = None) -> None:
        """Append one event to the calling thread's ring (no locks)."""
        self._ring().append((ts_us, dur_us, phase, name, ctx,
                             threading.get_ident(), args))

    def drain(self) -> Optional[Tuple[List[TraceEvent], int]]:
        """Hand off and clear the calling thread's ring (None when empty) —
        the worker side of the ``trace`` batch sidecar. Returns ``(events,
        dropped)`` where ``dropped`` is the overwrite count SINCE THE LAST
        DRAIN (a delta, zeroed here): the consumer sums sidecar drop counts,
        so a cumulative figure would be re-added once per later batch."""
        holder = getattr(self._local, 'holder', None)
        ring = holder.ring if holder is not None else None
        if ring is None or ring.n == 0:
            return None
        events = ring.events()
        dropped = ring.dropped
        ring.dropped = 0
        ring.clear()
        return events, dropped

    def merge(self, pid: int, events: Sequence[Sequence[Any]],
              dropped: int = 0) -> None:
        """Fold another process's drained events (one ``trace`` sidecar) into
        the bounded foreign buffer. The producing ``pid`` is kept out-of-band
        (a wrapper tuple, not an ``args`` key) so an event whose own args
        carry a ``pid`` — e.g. an anomaly marker naming a reaped child —
        survives the merge untouched."""
        with self._lock:
            self._foreign_dropped += int(dropped)
            for event in events:
                # sidecars arrive JSON-decoded (lists); normalize the ctx
                ts_us, dur_us, phase, name, ctx, tid, args = event
                norm_ctx: Optional[TraceContext] = (
                    (int(ctx[0]), int(ctx[1]), int(ctx[2])) if ctx else None)
                # foreign-buffer entry shape: (pid, TraceEvent)
                self._foreign.append(
                    (pid, (float(ts_us), float(dur_us), str(phase), str(name),
                           norm_ctx, int(tid), dict(args) if args else None)))

    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe view of the whole recorder: ``{'pid', 'events':
        [{'pid','tid','ts_us','dur_us','ph','name','ctx','args'}, ...],
        'dropped_events', 'capacity'}``. Events are sorted by timestamp;
        foreign events keep their producing pid."""
        own_pid = os.getpid()
        with self._lock:
            rings = self._live_rings()
            foreign_entries = self._foreign.events()
            own_events = [event for ring in rings for event in ring.events()]
            own_events.extend(self._retired.events())
            dropped = (self._foreign.dropped + self._foreign_dropped
                       + self._retired.dropped + self._retired_dropped
                       + sum(ring.dropped for ring in rings))
        records: List[Dict[str, Any]] = []
        for ts_us, dur_us, phase, name, ctx, tid, args in own_events:
            records.append({'pid': own_pid, 'tid': tid, 'ts_us': ts_us,
                            'dur_us': dur_us, 'ph': phase, 'name': name,
                            'ctx': list(ctx) if ctx else None,
                            'args': args})
        for entry in foreign_entries:
            pid, (ts_us, dur_us, phase, name, ctx, tid, args) = entry
            records.append({'pid': int(pid), 'tid': tid, 'ts_us': ts_us,
                            'dur_us': dur_us, 'ph': phase, 'name': name,
                            'ctx': list(ctx) if ctx else None,
                            'args': args})
        records.sort(key=lambda rec: rec['ts_us'])
        return {'pid': own_pid, 'events': records, 'dropped_events': dropped,
                'capacity': self._capacity}

    def dropped_events(self) -> int:
        """Events overwritten (own/retired rings) or discarded (foreign
        buffer) so far."""
        with self._lock:
            rings = self._live_rings()
            dropped = (self._foreign.dropped + self._foreign_dropped
                       + self._retired.dropped + self._retired_dropped)
        return dropped + sum(ring.dropped for ring in rings)

    def reset(self) -> None:
        """Clear every ring and the foreign/retired buffers (tests, between
        captures)."""
        with self._lock:
            for ring in self._live_rings():
                ring.clear()
                ring.dropped = 0
            self._foreign = _Ring(self._capacity)
            self._foreign_dropped = 0
            self._retired = _Ring(self._capacity)
            self._retired_dropped = 0


#: the process-wide recorder every trace hook writes to
_process_recorder = TraceRecorder()

#: thread-local causal context (set around each worker item)
_ctx_local = threading.local()


def set_trace_context(epoch: int, rowgroup: int, attempt: int) -> None:
    """Install the calling thread's causal context ``(epoch, rowgroup,
    attempt)``; every event recorded until :func:`clear_trace_context` is
    tagged with it (explicit ``ctx=`` arguments win)."""
    _ctx_local.ctx = (int(epoch), int(rowgroup), int(attempt))


def clear_trace_context() -> None:
    """Drop the calling thread's causal context."""
    _ctx_local.ctx = None


def current_trace_context() -> Optional[TraceContext]:
    """The calling thread's causal context, or None outside an item."""
    ctx: Optional[TraceContext] = getattr(_ctx_local, 'ctx', None)
    return ctx


def set_dispatch_attempt(attempt: int) -> None:
    """Record the dispatch attempt the pool sent with the current work item
    (``process_worker_main`` calls this per item; thread/dummy pools leave the
    default 0). Thread-local, like the context it feeds."""
    _ctx_local.attempt = int(attempt)


def current_dispatch_attempt() -> int:
    """The dispatch attempt installed for the calling thread (0 by default)."""
    attempt: int = getattr(_ctx_local, 'attempt', 0)
    return attempt


def trace_complete(name: str, start_s: float, dur_s: float,
                   ctx: Optional[TraceContext] = None,
                   args: Optional[Dict[str, Any]] = None) -> None:
    """Record one complete ('X') event for a stage span measured on the
    ``time.perf_counter`` clock (``start_s`` seconds, ``dur_s`` duration).
    No-op while tracing is off."""
    if not _enabled:
        return
    if ctx is None:
        ctx = current_trace_context()
    _process_recorder.record(start_s * 1e6, dur_s * 1e6, 'X', name, ctx, args)


def trace_instant(name: str, ctx: Optional[TraceContext] = None,
                  args: Optional[Dict[str, Any]] = None) -> None:
    """Record one instant ('i') event — an anomaly marker on the timeline.
    ``name`` must be declared in ``spans.TRACE_INSTANTS``. No-op while tracing
    is off."""
    if not _enabled:
        return
    if ctx is None:
        ctx = current_trace_context()
    _process_recorder.record(time.perf_counter() * 1e6, 0.0, 'i', name, ctx,
                             args)


def drain_trace_events() -> Optional[Dict[str, Any]]:
    """Drain the calling thread's ring into a JSON-safe ``trace`` batch sidecar
    (``{'pid', 'events', 'dropped'}``), or None when empty/disabled — the
    worker side of cross-process collection (rides next to the ``telemetry``
    sidecar)."""
    if not _enabled:
        return None
    drained = _process_recorder.drain()
    if drained is None:
        return None
    events, dropped = drained
    return {'pid': os.getpid(),
            'events': [list(event) for event in events],
            'dropped': dropped}


def merge_trace_events(sidecar: Optional[Dict[str, Any]]) -> None:
    """Fold a ``trace`` batch sidecar produced by :func:`drain_trace_events`
    in another process into this process's recorder (consumer side)."""
    if not sidecar or not _enabled:
        return
    _process_recorder.merge(int(sidecar.get('pid', 0)),
                            sidecar.get('events') or (),
                            dropped=int(sidecar.get('dropped', 0)))


def trace_snapshot() -> Dict[str, Any]:
    """One JSON-safe snapshot of the process recorder (own + merged foreign
    events, sorted by timestamp, with the cumulative drop count). Feed it to
    :func:`petastorm_tpu_torch.telemetry.trace_export.to_chrome_trace` or
    :func:`~petastorm_tpu_torch.telemetry.trace_export.summarize_trace`."""
    return _process_recorder.snapshot()


def reset_tracing() -> None:
    """Clear the process recorder (tests / between flight captures)."""
    _process_recorder.reset()
