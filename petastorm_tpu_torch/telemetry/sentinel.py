"""Live regression sentinel: streaming EWMA + Page–Hinkley drift detection
over the rows/s and primary-wait-share series the SLO tracker already
computes. A copy of ``petastorm_tpu.telemetry.sentinel``.

The static SLO edge (``telemetry/slo.py``) only fires when efficiency
crosses an absolute target — a run that collapses from 50k rows/s to 20k
while staying above the target is invisible to it, and a slow decay never
crosses anything sharply. The sentinel watches *this run against its own
recent past*: each observation closes a window (cumulative rows / wait
deltas over at least ``min_window_s`` of the owner's elapsed-time series —
the sentinel reads NO clock of its own, so tests drive it with synthetic
time) and feeds two one-sided Page–Hinkley drift tests:

- **rate drop** — relative deviations of the window rows/s below the running
  mean, so the test is scale-free (a 50k->35k collapse and a 500->350 one
  score the same);
- **wait-share growth** — absolute deviations of the window's
  primary-wait-share above its running mean (shares live in [0, 1]).

Each test accumulates ``m += dev - delta`` and alarms when ``m - min(m)``
exceeds its threshold: a step drop overwhelms the slack in one or two
windows, a slow drift outruns the lagging running mean and accumulates, and
zero-mean noise carries the built-in ``-delta`` down-drift so a stationary
series never rings. An alarm fully resets the detector — the new level
becomes the new baseline — which is what makes the ``perf_regression``
anomaly edge-triggered: one count per collapse, not one per window spent
collapsed.

On alarm the sentinel fires the ``perf_regression`` counter + trace instant
and triggers the incident plane (``telemetry/incident.py``), so the autopsy
bundle's manifest carries the detector's evidence: pre/post window rates,
the grown (primary-wait) stage, and the window geometry. Armed on readers,
loaders, and the dispatcher pump whenever run history is on
(``history=True`` / :class:`~petastorm_tpu_torch.telemetry.history.HistoryPolicy`
with ``sentinel`` set).
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from petastorm_tpu_torch.telemetry import registry as _registry
from petastorm_tpu_torch.telemetry import tracing as _tracing
from petastorm_tpu_torch.telemetry.registry import MetricsRegistry

logger = logging.getLogger(__name__)

_EPS = 1e-9


@dataclass(frozen=True)
class SentinelPolicy:
    """Regression-sentinel tuning — the ``sentinel`` field of a
    :class:`~petastorm_tpu_torch.telemetry.history.HistoryPolicy`.

    A window closes once ``min_window_s`` of owner-elapsed time has passed
    since the last one; the first ``warmup_windows`` windows only seed the
    running means (startup ramp must not read as drift). ``rate_delta`` /
    ``rate_threshold`` tune the scale-free rate-drop test (defaults: ignore
    sustained dips under ~5%, alarm when the accumulated excess drop reaches
    ~60% of a window); ``wait_delta`` / ``wait_threshold`` tune the absolute
    wait-share-growth test. ``ewma_alpha`` smooths the evidence/gauge series
    only — detection runs on the Page–Hinkley statistics. ``max_alarms``
    caps fires per run (a pathological series must not flood the incident
    plane past its own rate limiter)."""

    min_window_s: float = 2.0
    warmup_windows: int = 3
    ewma_alpha: float = 0.3
    rate_delta: float = 0.05
    rate_threshold: float = 0.6
    wait_delta: float = 0.03
    wait_threshold: float = 0.4
    max_alarms: int = 8

    def __post_init__(self) -> None:
        """Validate bounds at construction time."""
        if self.min_window_s <= 0:
            raise ValueError('min_window_s must be > 0, got {!r}'
                             .format(self.min_window_s))
        if self.warmup_windows < 1:
            raise ValueError('warmup_windows must be >= 1, got {!r}'
                             .format(self.warmup_windows))
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError('ewma_alpha must be in (0, 1], got {!r}'
                             .format(self.ewma_alpha))
        if self.rate_threshold <= 0 or self.wait_threshold <= 0:
            raise ValueError('thresholds must be > 0')
        if self.max_alarms < 1:
            raise ValueError('max_alarms must be >= 1, got {!r}'
                             .format(self.max_alarms))


def resolve_sentinel_policy(value: Any) -> Optional[SentinelPolicy]:
    """Accept ``None``/``False`` (disarmed), ``True`` (defaults), or a
    :class:`SentinelPolicy` — the ``HistoryPolicy.sentinel`` field
    contract."""
    if value is None or value is False:
        return None
    if value is True:
        return SentinelPolicy()
    if isinstance(value, SentinelPolicy):
        return value
    raise ValueError('sentinel must be None, a bool, or a SentinelPolicy, '
                     'got {!r}'.format(value))


class DriftDetector(object):
    """One-sided Page–Hinkley drift test over a sample series.

    Deviations are measured against the running mean of all samples *before*
    the current one (so a collapsing sample is judged against the
    pre-collapse baseline), optionally normalized by that mean
    (``relative=True`` — scale-free), with ``direction`` selecting which
    side alarms ('drop': samples below the mean; 'rise': above). The test
    statistic ``m`` accumulates ``dev - delta`` and alarms when it rises
    ``threshold`` above its running minimum; an alarm fully resets the
    detector, so a level shift fires exactly once. Not thread-safe — the
    owning sentinel serializes updates."""

    def __init__(self, delta: float, threshold: float, warmup: int,
                 relative: bool = True, direction: str = 'drop') -> None:
        if direction not in ('drop', 'rise'):
            raise ValueError("direction must be 'drop' or 'rise', got {!r}"
                             .format(direction))
        self.delta = delta
        self.threshold = threshold
        self.warmup = warmup
        self.relative = relative
        self.direction = direction
        self._n = 0
        self._mean = 0.0
        self._m = 0.0
        self._m_min = 0.0

    def reset(self) -> None:
        """Forget the baseline — the next sample seeds a fresh running mean
        (called after every alarm: the post-shift level becomes normal)."""
        self._n = 0
        self._mean = 0.0
        self._m = 0.0
        self._m_min = 0.0

    @property
    def mean(self) -> float:
        """Running mean of every sample since the last reset — the alarm
        evidence's 'pre' level."""
        return self._mean

    @property
    def samples(self) -> int:
        """Samples absorbed since the last reset."""
        return self._n

    def update(self, x: float) -> bool:
        """Absorb one sample; True exactly when the drift test alarms."""
        if self._n == 0:
            self._n = 1
            self._mean = x
            return False
        dev = (self._mean - x) if self.direction == 'drop' \
            else (x - self._mean)
        if self.relative:
            dev /= max(abs(self._mean), _EPS)
        self._n += 1
        self._mean += (x - self._mean) / self._n
        if self._n <= self.warmup:
            return False
        self._m += dev - self.delta
        self._m_min = min(self._m_min, self._m)
        if self._m - self._m_min > self.threshold:
            self.reset()
            return True
        return False


class RegressionSentinel(object):
    """The armed, streaming side: windows a cumulative (elapsed, rows,
    wait) series, runs both drift tests, and fires the ``perf_regression``
    anomaly on an alarm edge.

    Clock-free by construction: every entry point takes the owner's
    ``elapsed_s`` (the SLO report already carries it), so detector tests
    drive synthetic time and an armed owner adds no clock reads of its own.
    :meth:`due` is the cheap gate — owners skip building a telemetry
    snapshot entirely until a window is ready to close. Thread-safe (a
    consumer thread and ``diagnostics`` may observe concurrently)."""

    def __init__(self, policy: Optional[SentinelPolicy] = None,
                 owner: str = 'reader',
                 registry: Optional[MetricsRegistry] = None,
                 incidents: Optional[Any] = None,
                 dataset_token: Optional[str] = None,
                 on_alarm: Optional[
                     Callable[[Dict[str, Any]], None]] = None) -> None:
        self.policy = policy if policy is not None else SentinelPolicy()
        self.owner = owner
        self.dataset_token = dataset_token
        self._registry = registry
        self._incidents = incidents
        self._on_alarm = on_alarm
        self._lock = threading.Lock()
        self._rate = DriftDetector(self.policy.rate_delta,
                                   self.policy.rate_threshold,
                                   self.policy.warmup_windows,
                                   relative=True, direction='drop')
        self._wait = DriftDetector(self.policy.wait_delta,
                                   self.policy.wait_threshold,
                                   self.policy.warmup_windows,
                                   relative=False, direction='rise')
        self._last_elapsed: Optional[float] = None
        self._last_rows = 0
        self._last_wait: Optional[float] = None
        self._windows = 0
        self._alarms = 0
        self._last_alarm: Optional[Dict[str, Any]] = None
        self._rate_ewma: Optional[float] = None
        self._wait_ewma: Optional[float] = None

    def attach_incidents(self, incidents: Optional[Any]) -> None:
        """Late-bind the incident recorder (owners build the sentinel before
        the recorder during ``__init__`` ordering)."""
        self._incidents = incidents

    def due(self, elapsed_s: float) -> bool:
        """True when enough owner time has passed to close a window — the
        pre-snapshot gate, so arming costs one float compare per item batch
        between windows."""
        with self._lock:
            if self._alarms >= self.policy.max_alarms:
                return False
            if self._last_elapsed is None:
                return True
            return (elapsed_s - self._last_elapsed
                    >= self.policy.min_window_s)

    def observe(self, report: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Feed one SLO evaluation report (``telemetry/slo.py`` — carries
        ``elapsed_s``, ``rows``, ``wait_seconds``, ``primary_wait_stage``).
        Returns the alarm evidence when this window fired, else None."""
        return self.observe_sample(
            float(report.get('elapsed_s', 0.0) or 0.0),
            int(report.get('rows', 0) or 0),
            wait_seconds=report.get('wait_seconds'),
            primary_wait_stage=report.get('primary_wait_stage'))

    def observe_sample(self, elapsed_s: float, rows: int,
                       wait_seconds: Optional[float] = None,
                       primary_wait_stage: Optional[str] = None
                       ) -> Optional[Dict[str, Any]]:
        """Feed one cumulative (elapsed, rows[, wait]) sample; closes a
        window when ``min_window_s`` has passed since the last one. The
        dispatcher pump calls this directly with items-retired as ``rows``
        and no wait series. Returns alarm evidence or None."""
        with self._lock:
            evidence = self._observe_locked(elapsed_s, rows, wait_seconds,
                                            primary_wait_stage)
        if evidence is None:
            return None
        self._fire(evidence)
        return evidence

    def _observe_locked(self, elapsed_s: float, rows: int,
                        wait_seconds: Optional[float],
                        primary_wait_stage: Optional[str]
                        ) -> Optional[Dict[str, Any]]:
        if self._alarms >= self.policy.max_alarms:
            return None
        if self._last_elapsed is None:
            # first sample anchors the series; no window to close yet
            self._last_elapsed = elapsed_s
            self._last_rows = rows
            self._last_wait = wait_seconds
            return None
        window_s = elapsed_s - self._last_elapsed
        if window_s < self.policy.min_window_s:
            return None
        rate = max(rows - self._last_rows, 0) / window_s
        wait_share: Optional[float] = None
        if wait_seconds is not None and self._last_wait is not None:
            wait_share = min(max(
                (float(wait_seconds) - float(self._last_wait)) / window_s,
                0.0), 1.0)
        self._last_elapsed = elapsed_s
        self._last_rows = rows
        self._last_wait = wait_seconds
        self._windows += 1
        alpha = self.policy.ewma_alpha
        self._rate_ewma = (rate if self._rate_ewma is None
                           else alpha * rate + (1 - alpha) * self._rate_ewma)
        if wait_share is not None:
            self._wait_ewma = (wait_share if self._wait_ewma is None
                               else alpha * wait_share
                               + (1 - alpha) * self._wait_ewma)
        pre_rate = self._rate.mean
        pre_wait = self._wait.mean
        series: Optional[str] = None
        if self._rate.update(rate):
            series = 'rate'
            self._wait.reset()  # one collapse must not double-fire via its
            # wait-side shadow in the very next window
        elif wait_share is not None and self._wait.update(wait_share):
            series = 'wait_share'
            self._rate.reset()
        if series is None:
            return None
        self._alarms += 1
        evidence: Dict[str, Any] = {
            'series': series,
            'owner': self.owner,
            'dataset_token': self.dataset_token,
            'elapsed_s': round(elapsed_s, 6),
            'window_s': round(window_s, 6),
            'windows': self._windows,
            'alarm': self._alarms,
            'pre_rate_rows_per_sec': round(pre_rate, 3),
            'post_rate_rows_per_sec': round(rate, 3),
            'pre_wait_share': round(pre_wait, 6),
            'post_wait_share': (round(wait_share, 6)
                                if wait_share is not None else None),
            'grown_stage': primary_wait_stage,
        }
        self._last_alarm = evidence
        return evidence

    def _fire(self, evidence: Dict[str, Any]) -> None:
        # outside the lock: counter + instant + incident trigger + observer
        if self._registry is not None and _registry.telemetry_enabled():
            self._registry.inc('perf_regression')
        _tracing.trace_instant('perf_regression', args=evidence)
        logger.warning(
            'perf_regression: %s %s collapsed (%s %.1f -> %.1f rows/s, '
            'grown stage %s)', self.owner, evidence['series'],
            self.dataset_token or '-', evidence['pre_rate_rows_per_sec'],
            evidence['post_rate_rows_per_sec'], evidence['grown_stage'])
        if self._incidents is not None:
            try:
                self._incidents.trigger('perf_regression', args=evidence)
            except Exception:  # noqa: BLE001 - capture must not break the run
                logger.exception('perf_regression incident capture failed')
        if self._on_alarm is not None:
            try:
                self._on_alarm(dict(evidence))
            except Exception:  # noqa: BLE001 - observer must not break the run
                logger.exception('perf_regression alarm observer failed')

    def gauges(self) -> Dict[str, float]:
        """The smoothed series for a metrics scrape (``sentinel_rate_ewma``
        / ``sentinel_wait_share_ewma``) — only keys with data so a wait-less
        owner (dispatcher) never exports a misleading 0.0 share."""
        with self._lock:
            out: Dict[str, float] = {}
            if self._rate_ewma is not None:
                out['sentinel_rate_ewma'] = round(self._rate_ewma, 3)
            if self._wait_ewma is not None:
                out['sentinel_wait_share_ewma'] = round(self._wait_ewma, 6)
            return out

    def export_gauges(self) -> None:
        """Refresh the registry gauges from :meth:`gauges` (called by owners
        next to their SLO gauge refresh)."""
        if self._registry is None or not _registry.telemetry_enabled():
            return
        for name, value in self.gauges().items():
            self._registry.gauge(name).set(value)

    @property
    def alarms(self) -> int:
        """Alarm edges fired so far this run."""
        with self._lock:
            return self._alarms

    def report(self) -> Dict[str, Any]:
        """JSON-safe sentinel state — the incident plane's ``sentinel``
        evidence source (``add_source('sentinel', sentinel.report)``) and
        the diagnostics block; ``analyze_bundle`` reads ``alarms`` and
        ``last_alarm`` from exactly this shape."""
        with self._lock:
            return {
                'armed': True,
                'owner': self.owner,
                'dataset_token': self.dataset_token,
                'windows': self._windows,
                'alarms': self._alarms,
                'last_alarm': (dict(self._last_alarm)
                               if self._last_alarm else None),
                'rate_ewma': (round(self._rate_ewma, 3)
                              if self._rate_ewma is not None else None),
                'wait_share_ewma': (round(self._wait_ewma, 6)
                                    if self._wait_ewma is not None else None),
                'policy': {
                    'min_window_s': self.policy.min_window_s,
                    'warmup_windows': self.policy.warmup_windows,
                    'rate_threshold': self.policy.rate_threshold,
                    'wait_threshold': self.policy.wait_threshold,
                },
            }
