"""Low-overhead metrics registry: counters, gauges, and fixed-bucket latency
histograms. A copy of ``petastorm_tpu.telemetry.registry``: the same buckets,
snapshot shape and merge rules, so a snapshot of either package reads in the
other. Each package keeps its own switch; ``PETASTORM_TPU_TELEMETRY=0`` turns
both off.

Design constraints, in order:

1. **Hot-path cost**: ``Histogram.observe`` runs once per stage per rowgroup (and
   once per batch on the loader path), potentially from several worker threads at
   once. Each thread writes to its OWN shard (a plain list of ints plus three
   scalars) — no lock, no atomic, no allocation on the hot path.
2. **Snapshot while writing**: ``snapshot()`` merges the shards without stopping
   writers. Under CPython's int-assignment atomicity the merged view is *monotone
   but may lag* concurrent writes; the one invariant callers may rely on is
   ``sum(buckets) >= count`` (observe increments the bucket before the count), so
   a snapshot never shows phantom observations.
3. **Mergeable across processes**: a snapshot is a plain JSON-safe dict, and
   ``merge_histogram_snapshot`` folds one into a live histogram — this is how
   worker-process stage times, shipped on the results-channel sidecar, land in the
   consumer-side registry (one snapshot covers all processes).

Buckets are powers of two of a configurable base ``unit`` (1 µs for latencies,
1 byte for sizes): bucket ``i`` counts observations in ``(unit*2**(i-1),
unit*2**i]`` (bucket 0 is ``[0, unit]``, the last bucket absorbs everything
larger). 32 buckets span 1 µs .. ~36 min — wide enough that no data-plane stage
ever falls off the top in practice, and narrow enough that a histogram snapshot
stays a handful of sparse entries.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional

#: default bucket count: pow-2 buckets 0..31 over the base unit
DEFAULT_NUM_BUCKETS = 32
#: base unit for latency histograms: one microsecond
SECONDS_UNIT = 1e-6
#: base unit for size histograms: one byte
BYTES_UNIT = 1.0

_ENV_SWITCH = 'PETASTORM_TPU_TELEMETRY'

_enabled = os.environ.get(_ENV_SWITCH, '1') not in ('0', 'false', 'off')


def telemetry_enabled() -> bool:
    """True unless telemetry is globally disabled (``PETASTORM_TPU_TELEMETRY=0``
    or :func:`set_telemetry_enabled`). Disabled mode turns every span and observe
    into a near-no-op — the escape hatch if the measured overhead ever matters."""
    return _enabled


def set_telemetry_enabled(value: bool) -> None:
    """Override the env-derived telemetry switch (tests, embedding apps).

    Scope: this process, plus any process-pool workers spawned AFTER the call
    (the pool captures the switch into the worker environment at ``start()``).
    Workers already running keep their own setting — their sidecars are dropped
    consumer-side while the switch is off, so snapshots stay silent either way;
    set ``PETASTORM_TPU_TELEMETRY=0`` before launch to disable fleet-wide."""
    global _enabled
    _enabled = bool(value)


def bucket_index(value: float, unit: float,
                 num_buckets: int = DEFAULT_NUM_BUCKETS) -> int:
    """Power-of-two bucket for ``value``: 0 for ``value <= unit`` (including 0 and
    negatives), else ``ceil(log2(value/unit))`` clamped to ``num_buckets - 1``."""
    if value <= unit:
        return 0
    # ceil(log2(n)) for integer n >= 2 is (n-1).bit_length(); -(-a // b) is
    # integer ceil-divide, exact where float log2 would wobble at boundaries.
    n = -int(-value // unit)
    return min(num_buckets - 1, (n - 1).bit_length())


def bucket_upper_bound(index: int, unit: float,
                       num_buckets: int = DEFAULT_NUM_BUCKETS) -> float:
    """Inclusive upper bound of bucket ``index`` (``inf`` for the last bucket)."""
    if index >= num_buckets - 1:
        return float('inf')
    return unit * (1 << index)


class _Shard(object):
    """One thread's private histogram storage (no locks on the write path)."""

    __slots__ = ('buckets', 'count', 'total', 'max')

    def __init__(self, num_buckets: int) -> None:
        self.buckets: List[int] = [0] * num_buckets
        self.count = 0
        self.total = 0.0
        self.max = 0.0


class Histogram(object):
    """Fixed-bucket power-of-two histogram with lock-free per-thread write shards.

    ``observe`` touches only the calling thread's shard; ``snapshot`` merges every
    shard plus any cross-process snapshots folded in via ``merge_snapshot``. The
    only lock guards shard REGISTRATION (once per writing thread) and the merged
    cross-process accumulator — never the observe path."""

    __slots__ = ('name', 'unit', 'num_buckets', '_local', '_shards',
                 '_shards_lock', '_merged')

    def __init__(self, name: str, unit: float = SECONDS_UNIT,
                 num_buckets: int = DEFAULT_NUM_BUCKETS) -> None:
        self.name = name
        self.unit = unit
        self.num_buckets = num_buckets
        self._local = threading.local()
        self._shards: List[_Shard] = []
        self._shards_lock = threading.Lock()
        self._merged: Optional[_Shard] = None

    def _shard(self) -> _Shard:
        shard = getattr(self._local, 'shard', None)
        if shard is None:
            shard = _Shard(self.num_buckets)
            with self._shards_lock:
                self._shards.append(shard)
            self._local.shard = shard
        return shard

    def observe(self, value: float) -> None:
        """Record one observation (hot path — see module docstring ordering:
        bucket before count keeps snapshots free of phantom observations)."""
        shard = self._shard()
        shard.buckets[bucket_index(value, self.unit, self.num_buckets)] += 1
        shard.count += 1
        shard.total += value
        if value > shard.max:
            shard.max = value

    def merge_snapshot(self, snap: Dict[str, Any]) -> None:
        """Fold a histogram snapshot (same unit/bucketing — e.g. one produced in a
        worker process) into this histogram's cross-process accumulator."""
        with self._shards_lock:
            if self._merged is None:
                self._merged = _Shard(self.num_buckets)
            merged = self._merged
            for key, n in (snap.get('buckets') or {}).items():
                idx = min(int(key), self.num_buckets - 1)
                merged.buckets[idx] += int(n)
            merged.count += int(snap.get('count', 0))
            merged.total += float(snap.get('sum', 0.0))
            merged.max = max(merged.max, float(snap.get('max', 0.0)))

    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe merged view: ``{'unit', 'count', 'sum', 'max', 'mean',
        'buckets': {str(index): n}}`` with only non-empty buckets listed."""
        buckets = [0] * self.num_buckets
        count = 0
        total = 0.0
        maximum = 0.0
        with self._shards_lock:
            shards = list(self._shards)
            if self._merged is not None:
                shards.append(self._merged)
        for shard in shards:
            # count first, buckets after: a concurrent observe between the two
            # reads can only make sum(buckets) exceed count, never undershoot
            count += shard.count
            total += shard.total
            maximum = max(maximum, shard.max)
            for i, n in enumerate(shard.buckets):
                buckets[i] += n
        return {
            'unit': self.unit,
            'count': count,
            'sum': total,
            'max': maximum,
            'mean': (total / count) if count else 0.0,
            'buckets': {str(i): n for i, n in enumerate(buckets) if n},
        }


class Counter(object):
    """Monotone counter with the same per-thread-shard discipline as
    :class:`Histogram` (observe-side lock freedom, merge on snapshot)."""

    __slots__ = ('name', '_local', '_cells', '_lock', '_merged')

    def __init__(self, name: str) -> None:
        self.name = name
        self._local = threading.local()
        self._cells: List[List[int]] = []
        self._lock = threading.Lock()
        self._merged = 0

    def inc(self, n: int = 1) -> None:
        """Add ``n`` to the calling thread's cell (no lock)."""
        cell = getattr(self._local, 'cell', None)
        if cell is None:
            cell = [0]
            with self._lock:
                self._cells.append(cell)
            self._local.cell = cell
        cell[0] += n

    def merge_value(self, n: int) -> None:
        """Fold a cross-process counter value into this counter."""
        with self._lock:
            self._merged += int(n)

    def value(self) -> int:
        """Merged total across every thread cell and cross-process merges."""
        with self._lock:
            cells = list(self._cells)
            merged = self._merged
        return merged + sum(cell[0] for cell in cells)


class Gauge(object):
    """Last-set value (non-monotone): queue depths, configured sizes."""

    __slots__ = ('name', '_value', '_lock')

    def __init__(self, name: str) -> None:
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        """Replace the gauge's value."""
        with self._lock:
            self._value = float(value)

    def value(self) -> float:
        """Current value."""
        with self._lock:
            return self._value


class MetricsRegistry(object):
    """Named metrics with on-demand creation and one JSON-safe ``snapshot()``.

    Histogram names double as stage names across the data plane
    (:data:`~petastorm_tpu_torch.telemetry.spans.STAGES`). ``merge_snapshot`` folds another
    registry's snapshot in — the cross-process merge primitive used for
    worker-sidecar stage times and for pool-level registries."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._histograms: Dict[str, Histogram] = {}
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}

    def histogram(self, name: str, unit: float = SECONDS_UNIT) -> Histogram:
        """Get or create the histogram ``name`` (``unit`` applies on creation)."""
        hist = self._histograms.get(name)
        if hist is None:
            with self._lock:
                hist = self._histograms.setdefault(name, Histogram(name, unit))
        return hist

    def counter(self, name: str) -> Counter:
        """Get or create the counter ``name``."""
        counter = self._counters.get(name)
        if counter is None:
            with self._lock:
                counter = self._counters.setdefault(name, Counter(name))
        return counter

    def gauge(self, name: str) -> Gauge:
        """Get or create the gauge ``name``."""
        gauge = self._gauges.get(name)
        if gauge is None:
            with self._lock:
                gauge = self._gauges.setdefault(name, Gauge(name))
        return gauge

    def observe(self, name: str, value: float,
                unit: float = SECONDS_UNIT) -> None:
        """``histogram(name, unit).observe(value)`` unless telemetry is disabled."""
        if _enabled:
            self.histogram(name, unit).observe(value)

    def inc(self, name: str, n: int = 1) -> None:
        """``counter(name).inc(n)`` unless telemetry is disabled."""
        if _enabled:
            self.counter(name).inc(n)

    def merge_stage_times(self, stage_times: Dict[str, Dict[str, Any]]) -> None:
        """Merge a worker-sidecar ``{stage: histogram_snapshot}`` dict (what
        :func:`petastorm_tpu_torch.telemetry.spans.drain_stage_times` produced in the
        worker process) into this registry's latency histograms. No-op while
        telemetry is disabled, so sidecars from workers that predate a
        ``set_telemetry_enabled(False)`` are dropped rather than merged."""
        if not _enabled:
            return
        for stage, snap in (stage_times or {}).items():
            unit = float(snap.get('unit', SECONDS_UNIT))
            self.histogram(stage, unit).merge_snapshot(snap)

    def merge_snapshot(self, snapshot: Dict[str, Any]) -> None:
        """Merge a full registry snapshot (histograms + counters; gauges are
        last-writer-wins) — e.g. a pool-level registry into a reader's."""
        for name, snap in (snapshot.get('histograms') or {}).items():
            unit = float(snap.get('unit', SECONDS_UNIT))
            self.histogram(name, unit).merge_snapshot(snap)
        for name, value in (snapshot.get('counters') or {}).items():
            self.counter(name).merge_value(int(value))
        for name, value in (snapshot.get('gauges') or {}).items():
            self.gauge(name).set(float(value))

    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe view of every metric: ``{'histograms': {name: hist_snap},
        'counters': {name: int}, 'gauges': {name: float}}``."""
        with self._lock:
            histograms = dict(self._histograms)
            counters = dict(self._counters)
            gauges = dict(self._gauges)
        return {
            'histograms': {name: h.snapshot() for name, h in histograms.items()},
            'counters': {name: c.value() for name, c in counters.items()},
            'gauges': {name: g.value() for name, g in gauges.items()},
        }


def merge_snapshots(*snapshots: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Combine registry snapshots (None entries skipped) into one snapshot dict —
    additive for histograms/counters, last-writer-wins for gauges."""
    merged = MetricsRegistry()
    for snap in snapshots:
        if snap:
            merged.merge_snapshot(snap)
    return merged.snapshot()
