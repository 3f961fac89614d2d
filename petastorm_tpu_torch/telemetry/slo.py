"""Input-efficiency SLOs: starvation fraction and goodput-vs-ideal derived
from the wait-stage spans the pipeline already records. A copy of
``petastorm_tpu.telemetry.slo``.

The mission line this measures against: the input pipeline should keep the
accelerator >= 90% busy (``SloPolicy(target_efficiency=0.9)``). The signal
already exists — ``shuffle_wait`` (training loop blocked on the loader's
prefetch queue), ``pool_wait`` (consumer blocked in ``pool.get_results``) and
``d2d_wait`` (blocked on the prefetch-to-device ring) are exactly the seconds
the CONSUMER side sat starved — this module just divides it by wall time:

    starvation_fraction = consumer_wait_seconds / elapsed_seconds
    efficiency          = 1 - starvation_fraction          (clamped to [0, 1])

``shuffle_wait`` and ``pool_wait`` measure the same starvation one layer
apart (the loader's producer blocks in ``pool_wait`` while the training loop
blocks in ``shuffle_wait``), so summing both would double-count a single
stall: the PRIMARY wait stage is ``shuffle_wait`` when present (a loader is
consuming), else ``pool_wait``; ``d2d_wait`` (a distinct, device-tail block
on the consumer path) is added on top. ``h2d`` seconds are reported
informationally — upload time is work, not starvation, but it bounds what
overlap can still hide.

:class:`SloTracker` holds the breach accounting: ``evaluate()`` computes the
report, refreshes the ``slo_efficiency`` / ``slo_target_efficiency`` gauges
in the supplied registry, and — EDGE-TRIGGERED, once per ok→breach
transition, so a dashboard polling ``diagnostics`` cannot inflate the count —
increments the ``slo_breach`` counter, emits an ``slo_breach`` JSONL event
(when a :class:`~petastorm_tpu_torch.telemetry.export.JsonlEventLogger` is
attached) and drops an ``slo_breach`` instant on the flight-recorder
timeline. Surfaces: ``Reader.efficiency_report()`` /
``diagnostics['slo']``, ``TorchDataLoader.efficiency_report()``, and every
``/metrics`` scrape (the gauges refresh per scrape).
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, Optional

from petastorm_tpu_torch.telemetry import registry as _registry
from petastorm_tpu_torch.telemetry import tracing as _tracing
from petastorm_tpu_torch.telemetry.export import JsonlEventLogger
from petastorm_tpu_torch.telemetry.registry import SECONDS_UNIT, MetricsRegistry

#: consumer-facing wait stages, in PRIMARY preference order: the first one
#: present in the snapshot is the starvation measure (they observe the same
#: stall one layer apart — see module docstring); ``d2d_wait`` adds on top
PRIMARY_WAIT_STAGES = ('shuffle_wait', 'pool_wait')
#: device-tail wait added on top of the primary stage
EXTRA_WAIT_STAGES = ('d2d_wait',)
#: informational (upload is work, not starvation)
UPLOAD_STAGE = 'h2d'


@dataclass(frozen=True)
class SloPolicy:
    """Input-efficiency target: breach below ``target_efficiency``; windows
    shorter than ``min_elapsed_s`` are reported but never counted as breaches
    (construction/warmup noise would otherwise page on every startup)."""

    target_efficiency: float = 0.9
    min_elapsed_s: float = 1.0

    def __post_init__(self) -> None:
        """Validate the target is a sane fraction."""
        if not 0.0 < self.target_efficiency <= 1.0:
            raise ValueError('target_efficiency must be in (0, 1], got {!r}'
                             .format(self.target_efficiency))


def resolve_slo_policy(policy: Any) -> SloPolicy:
    """Accept ``None`` (the default 0.9 policy), a float target, or an
    :class:`SloPolicy` — the ``slo_policy=`` kwarg contract of
    ``make_reader`` and ``TorchDataLoader``."""
    if policy is None:
        return SloPolicy()
    if isinstance(policy, SloPolicy):
        return policy
    if isinstance(policy, (int, float)):
        return SloPolicy(target_efficiency=float(policy))
    raise ValueError('slo_policy must be None, a float target, or an '
                     'SloPolicy, got {!r}'.format(policy))


def _stage_seconds(snapshot: Dict[str, Any], stage: str) -> float:
    hist = (snapshot.get('histograms') or {}).get(stage)
    if not hist:
        return 0.0
    if float(hist.get('unit', SECONDS_UNIT)) != SECONDS_UNIT:
        return 0.0
    return float(hist.get('sum', 0.0))


def efficiency_from_snapshot(snapshot: Dict[str, Any],
                             elapsed_s: float,
                             rows: int = 0) -> Dict[str, Any]:
    """Pure efficiency math over one telemetry snapshot (no breach state).

    Returns ``{'efficiency', 'starvation_fraction', 'wait_seconds',
    'wait_stage_seconds', 'primary_wait_stage', 'h2d_seconds', 'elapsed_s',
    'rows', 'goodput_rows_per_sec', 'ideal_rows_per_sec'}`` — all JSON-safe.
    ``ideal_rows_per_sec`` is the rate the same read would have achieved with
    the recorded starvation removed (``rows / (elapsed - wait)``), so
    ``goodput / ideal == efficiency``: the goodput-vs-ideal framing of the
    same number."""
    elapsed_s = max(float(elapsed_s), 0.0)
    primary: Optional[str] = None
    for stage in PRIMARY_WAIT_STAGES:
        if _stage_seconds(snapshot, stage) > 0.0:
            primary = stage
            break
    wait_stage_seconds: Dict[str, float] = {}
    for stage in PRIMARY_WAIT_STAGES + EXTRA_WAIT_STAGES:
        seconds = _stage_seconds(snapshot, stage)
        if seconds:
            wait_stage_seconds[stage] = round(seconds, 6)
    wait = _stage_seconds(snapshot, primary) if primary else 0.0
    wait += sum(_stage_seconds(snapshot, stage)
                for stage in EXTRA_WAIT_STAGES)
    starvation = min(wait / elapsed_s, 1.0) if elapsed_s > 0 else 0.0
    efficiency = max(0.0, 1.0 - starvation)
    goodput = rows / elapsed_s if elapsed_s > 0 else 0.0
    productive = max(elapsed_s - wait, 1e-12)
    ideal = rows / productive if rows else 0.0
    return {
        'efficiency': round(efficiency, 6),
        'starvation_fraction': round(starvation, 6),
        'wait_seconds': round(wait, 6),
        'wait_stage_seconds': wait_stage_seconds,
        'primary_wait_stage': primary,
        'h2d_seconds': round(_stage_seconds(snapshot, UPLOAD_STAGE), 6),
        'elapsed_s': round(elapsed_s, 6),
        'rows': int(rows),
        'goodput_rows_per_sec': round(goodput, 3),
        'ideal_rows_per_sec': round(ideal, 3),
    }


class SloTracker(object):
    """Breach accounting around :func:`efficiency_from_snapshot` (module
    docstring): edge-triggered breach events, cumulative counters, gauge
    refresh. Thread-safe — ``diagnostics`` and a scrape thread may evaluate
    concurrently."""

    #: evaluation points the in-process ring buffer retains (the short tail
    #: ``efficiency_report()['history']`` and ``/vars`` expose)
    HISTORY_SIZE = 32

    def __init__(self, policy: Optional[SloPolicy] = None,
                 jsonl: Optional[JsonlEventLogger] = None,
                 on_breach: Optional[Callable[[Dict[str, Any]], None]] = None,
                 history_size: int = HISTORY_SIZE) -> None:
        self.policy = policy if policy is not None else SloPolicy()
        self._jsonl = jsonl
        self._on_breach = on_breach
        self._lock = threading.Lock()
        self._breaches = 0
        self._evaluations = 0
        self._in_breach = False
        self._history: Deque[Dict[str, Any]] = collections.deque(
            maxlen=max(int(history_size), 1))

    def observe_breaches(self, callback: Callable[[Dict[str, Any]], None]) -> None:
        """Attach (or replace) the ok→breach edge observer: called once a
        transition with the evaluation report, outside the tracker lock (the
        incident recorder's ``slo_breach`` trigger)."""
        self._on_breach = callback

    @property
    def breaches(self) -> int:
        """Cumulative ok→breach transitions observed by :meth:`evaluate`."""
        with self._lock:
            return self._breaches

    def history(self) -> list:
        """The trailing evaluated points (oldest first, bounded by
        ``history_size``): ``{'elapsed_s', 'efficiency',
        'goodput_rows_per_sec', 'wait_seconds', 'breached'}`` each. Also carried on every
        :meth:`evaluate` report as ``report['history']`` and in the
        ``/vars`` document as ``slo_history``."""
        with self._lock:
            return [dict(point) for point in self._history]

    def evaluate(self, snapshot: Dict[str, Any], elapsed_s: float,
                 rows: int = 0,
                 registry: Optional[MetricsRegistry] = None) -> Dict[str, Any]:
        """One SLO evaluation: the efficiency report plus breach state.

        Adds ``{'target_efficiency', 'met', 'breached', 'evaluated',
        'breaches', 'evaluations', 'history'}`` to the
        :func:`efficiency_from_snapshot` fields (``history`` is the
        tracker's trailing ring buffer — :meth:`history`). ``evaluated`` is False below ``min_elapsed_s``: the report
        then carries the explicit not-enough-data shape — ``efficiency``
        (and ``starvation_fraction``) are ``None``, ``reason`` says
        ``'not_enough_data'``, no breach is counted and no gauge is set, so
        a warmup window can never read as a spurious 0.0 efficiency or trip
        a breach edge. On an ok→breach transition: ``slo_breach`` counter
        (in ``registry``), ``slo_breach`` JSONL event and ``slo_breach`` trace
        instant — once, until the efficiency recovers to the target."""
        report = efficiency_from_snapshot(snapshot, elapsed_s, rows=rows)
        target = self.policy.target_efficiency
        evaluated = elapsed_s >= self.policy.min_elapsed_s
        if not evaluated:
            report['efficiency'] = None
            report['starvation_fraction'] = None
            report['reason'] = 'not_enough_data'
        breached = bool(evaluated and report['efficiency'] < target)
        with self._lock:
            self._evaluations += 1
            is_transition = breached and not self._in_breach
            if evaluated:
                self._in_breach = breached
                # ring-buffer tail of evaluated points (warmup windows carry
                # no efficiency and would only pad the series with Nones)
                self._history.append({
                    'elapsed_s': report['elapsed_s'],
                    'efficiency': report['efficiency'],
                    'goodput_rows_per_sec': report['goodput_rows_per_sec'],
                    'wait_seconds': report['wait_seconds'],
                    'breached': breached,
                })
            if is_transition:
                self._breaches += 1
            breaches = self._breaches
            evaluations = self._evaluations
            history = [dict(point) for point in self._history]
        report.update({
            'target_efficiency': target,
            'met': not breached,
            'breached': breached,
            'evaluated': evaluated,
            'breaches': breaches,
            'evaluations': evaluations,
            'history': history,
        })
        if registry is not None and _registry.telemetry_enabled():
            if evaluated:
                registry.gauge('slo_efficiency').set(report['efficiency'])
            registry.gauge('slo_target_efficiency').set(target)
            if is_transition:
                registry.inc('slo_breach')
        if is_transition:
            _tracing.trace_instant(
                'slo_breach',
                args={'efficiency': report['efficiency'],
                      'target': target,
                      'wait_seconds': report['wait_seconds']})
            if self._jsonl is not None:
                self._jsonl.emit(snapshot, event='slo_breach',
                                 slo={'efficiency': report['efficiency'],
                                      'target': target,
                                      'wait_seconds': report['wait_seconds'],
                                      'elapsed_s': report['elapsed_s']})
            if self._on_breach is not None:
                try:
                    self._on_breach(dict(report))
                except Exception:  # noqa: BLE001 - an observer must not break evaluation
                    logging.getLogger(__name__).exception('slo breach observer failed')
        return report


def slo_clock() -> float:
    """The monotonic timebase efficiency windows are measured on
    (``time.perf_counter`` — the same clock the stage spans use), exposed so
    owners stamp their construction time consistently."""
    return time.perf_counter()
