"""Incident autopsy plane: edge-triggered black-box capture, bounded bundle
retention, and root-cause-ranked postmortems. A copy of
``petastorm_tpu.telemetry.incident``: the same bundle layout, causes and
exit codes, so either package's autopsy ranks the other's bundles.

Every anomaly surface so far — breaker transitions, watchdog reaps, shm CRC
drops, quarantines, SLO breaches, lineage divergence, service poison items —
is *pull*-shaped: if nobody was scraping ``/metrics`` or dumping the trace
ring at the moment of failure, the evidence dies with the process. This
module gives the pipeline flight-recorder semantics: the
:class:`IncidentRecorder` subscribes to those edges and, on trigger,
atomically writes a self-contained **bundle** directory under the dataset's
state home:

- ``manifest.json`` — trigger kind, mapped cause class, ``(epoch, rowgroup,
  attempt)`` context, trigger args, capture timestamps;
- ``trace.json`` — the drained flight-recorder ring as Perfetto/Chrome JSON,
  cut to the *pre-trigger context window* so the bundle shows what led up to
  the edge, not just the aftermath;
- ``environment.json`` — interpreter/platform/pid/argv plus the
  pipeline-relevant environment variables;
- one ``<source>.json`` per attached evidence source (metrics snapshot,
  breaker board, quarantine ledger, cost-ledger slice, lineage digest,
  autotune state, config provenance, service state — whatever the owner
  wired via :meth:`IncidentRecorder.add_source`).

Captures are **rate-limited** by a token bucket per trigger kind (a breaker
flapping open cannot write a thousand bundles) and **retention-bounded**
(the N+1th bundle evicts the oldest). Both counters are first-class metrics:
``incidents_captured`` / ``incidents_rate_limited``.

Fleet wiring: service workers capture locally and ship a
compact :func:`bundle_reference` — inlining the bundle's files under a size
cap — to the dispatcher as a ``w_incident`` heartbeat frame; the dispatcher
:meth:`IncidentRecorder.adopt`\\ s inline bundles into its own home and
correlates same-cause references across workers into one fleet incident.

The analyzer rides the ``petastorm-tpu-torch-throughput autopsy <bundle>`` CLI
(:func:`main`): :func:`analyze_bundle` walks the captured evidence,
correlates trigger → trace context → breaker/quarantine/cost/lineage
records, and ranks probable cause classes; the process exit code names the
top cause (``hang`` 10 / ``corruption`` 11 / ``storage-path`` 12 /
``scheduling-skew`` 13 / ``divergence`` 14), so a babysitting script can
branch on the verdict without parsing the report.

Attach points: ``make_reader(incidents=True | IncidentPolicy)``,
``TorchDataLoader(incidents=...)``, ``Dispatcher(incidents=...)`` /
``ServiceFleet(incidents=...)`` / ``petastorm-tpu-torch-throughput serve
--incidents``; the doctor surfaces recent bundles in
``report['incidents']``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import platform
import shutil
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from petastorm_tpu_torch.telemetry import registry as _registry
from petastorm_tpu_torch.telemetry import tracing as _tracing
from petastorm_tpu_torch.telemetry.registry import MetricsRegistry
from petastorm_tpu_torch.telemetry.trace_export import to_chrome_trace

logger = logging.getLogger(__name__)

#: the trigger kinds a recorder accepts — every edge event the pipeline
#: already emits, by the name the autopsy report uses
TRIGGER_KINDS: Tuple[str, ...] = (
    'breaker_open',        # a circuit breaker transitioned closed->open
    'watchdog_reap',       # a hung worker was reaped (pool watchdog or
                           # dispatcher staleness sweep)
    'shm_crc_drop',        # a shm frame failed CRC and was dropped unread
    'quarantine',          # a rowgroup left the stream (error path)
    'slo_breach',          # input-efficiency fell below the SLO target
    'lineage_divergence',  # a delivered item broke the lineage stream
    'service_poison_item',  # a service item exhausted its attempt budget
    'reshard',             # the service re-split undelivered work after an
                           # elastic worker join/leave (service/dispatcher.py)
    'ledger_corrupt',      # the dispatcher's durable token ledger failed CRC
                           # replay and the fleet degraded to
                           # replay-from-clients (service/ledger.py)
    'perf_regression',     # the live regression sentinel's drift test fired
                           # on a mid-run goodput collapse or wait-share
                           # growth (telemetry/sentinel.py)
    'host_reshard',        # a reader came up as a host-reshard survivor —
                           # undelivered rowgroups were re-dealt after a
                           # host join/leave/lease expiry
                           # (the JAX package's parallel/topology.py)
)

#: ranked-cause classes the autopsy report can name, with their CLI exit
#: codes (distinct per class so scripts can branch on the verdict)
CAUSE_CLASSES: Tuple[str, ...] = ('hang', 'corruption', 'storage-path',
                                  'scheduling-skew', 'divergence')
EXIT_CODES: Dict[str, int] = {'hang': 10, 'corruption': 11,
                              'storage-path': 12, 'scheduling-skew': 13,
                              'divergence': 14}
#: autopsy exit for a bundle that carries no rankable evidence
EXIT_UNKNOWN = 1
#: autopsy exit for a missing / unreadable bundle
EXIT_BAD_BUNDLE = 2

#: static trigger -> cause-class mapping ('quarantine' is resolved
#: dynamically from the record's reason/error_type — see _trigger_cause)
_CAUSE_FOR_TRIGGER: Dict[str, str] = {
    'breaker_open': 'storage-path',
    'watchdog_reap': 'hang',
    'shm_crc_drop': 'corruption',
    'slo_breach': 'scheduling-skew',
    'lineage_divergence': 'divergence',
    'service_poison_item': 'hang',
    'reshard': 'scheduling-skew',
    'ledger_corrupt': 'corruption',
    'perf_regression': 'scheduling-skew',
    'host_reshard': 'scheduling-skew',
}

#: bundle directory name prefix (retention and the doctor scan key off it)
BUNDLE_PREFIX = 'incident-'

#: environment variable overriding every default bundle home
INCIDENT_HOME_ENV = 'PETASTORM_TPU_INCIDENT_HOME'

#: environment keys worth preserving in a bundle (pipeline + CUDA/torch wiring)
_ENV_PREFIXES = ('PETASTORM_TPU_', 'CUDA_', 'TORCH_', 'BENCH_')


@dataclass(frozen=True)
class IncidentPolicy:
    """Capture policy for one :class:`IncidentRecorder` — the
    ``incidents=`` kwarg contract of ``make_reader`` / ``TorchDataLoader`` /
    ``Dispatcher`` / ``ServiceFleet`` (``True`` means this default policy).

    ``home`` overrides the bundle directory (default: the owner's
    dataset-state home, or the shared tempdir fallback). ``max_bundles``
    bounds retention; the token bucket allows ``bucket_capacity`` captures
    per trigger kind, refilling one token every ``refill_interval_s``.
    ``pre_trigger_window_s`` cuts the trace ring to the window leading up to
    the edge; ``ship_bytes_cap`` bounds what a service worker inlines into
    its ``w_incident`` frame (larger bundles ship as references only)."""

    home: Optional[str] = None
    max_bundles: int = 8
    bucket_capacity: int = 1
    refill_interval_s: float = 60.0
    pre_trigger_window_s: float = 30.0
    ship_bytes_cap: int = 256 * 1024
    triggers: Tuple[str, ...] = field(default_factory=lambda: TRIGGER_KINDS)

    def __post_init__(self) -> None:
        """Validate bounds and trigger names at construction time."""
        if self.max_bundles < 1:
            raise ValueError('max_bundles must be >= 1, got {!r}'
                             .format(self.max_bundles))
        if self.bucket_capacity < 1:
            raise ValueError('bucket_capacity must be >= 1, got {!r}'
                             .format(self.bucket_capacity))
        if self.refill_interval_s <= 0:
            raise ValueError('refill_interval_s must be > 0, got {!r}'
                             .format(self.refill_interval_s))
        unknown = set(self.triggers) - set(TRIGGER_KINDS)
        if unknown:
            raise ValueError('unknown trigger kind(s) {}; known: {}'
                             .format(sorted(unknown), TRIGGER_KINDS))


def resolve_incident_policy(value: Any) -> Optional[IncidentPolicy]:
    """Accept ``None``/``False`` (disabled), ``True`` (default policy) or an
    :class:`IncidentPolicy` — the ``incidents=`` kwarg contract."""
    if value is None or value is False:
        return None
    if value is True:
        return IncidentPolicy()
    if isinstance(value, IncidentPolicy):
        return value
    raise ValueError('incidents must be None, a bool, or an IncidentPolicy, '
                     'got {!r}'.format(value))


def default_incident_home(state_home: Optional[str] = None) -> str:
    """The bundle directory for an owner whose dataset-state home is
    ``state_home``: ``$PETASTORM_TPU_INCIDENT_HOME`` when set, else
    ``<state_home>/incidents``, else a shared per-user tempdir fallback
    (read-only stores / service dispatchers have no dataset-state home)."""
    env = os.environ.get(INCIDENT_HOME_ENV)
    if env:
        return env
    if state_home:
        return os.path.join(state_home, 'incidents')
    return os.path.join(tempfile.gettempdir(),
                        'petastorm-tpu-torch-incidents-{}'.format(os.getuid()
                                                            if hasattr(os, 'getuid')
                                                            else 'any'))


class _TokenBucket(object):
    """Per-trigger-kind capture budget: ``capacity`` tokens, one refilled
    every ``refill_interval_s`` on the injected clock."""

    __slots__ = ('_capacity', '_refill_interval_s', '_clock', '_tokens',
                 '_last_refill')

    def __init__(self, capacity: int, refill_interval_s: float,
                 clock: Callable[[], float]) -> None:
        self._capacity = capacity
        self._refill_interval_s = refill_interval_s
        self._clock = clock
        self._tokens = float(capacity)
        self._last_refill = clock()

    def take(self) -> bool:
        """Spend one token if available (refilling lazily first)."""
        now = self._clock()
        elapsed = max(now - self._last_refill, 0.0)
        if elapsed > 0:
            self._tokens = min(float(self._capacity),
                               self._tokens + elapsed / self._refill_interval_s)
            self._last_refill = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False


def _json_default(value: Any) -> Any:
    """Last-resort JSON encoder for evidence payloads (numpy scalars,
    tuples-in-sets, exception objects...)."""
    try:
        return value.item()  # numpy scalar
    except AttributeError:
        return repr(value)


def _write_json(path: str, payload: Any) -> None:
    """Write one evidence document (sorted keys, lenient encoding)."""
    with open(path, 'w') as f:
        json.dump(payload, f, indent=1, sort_keys=True, default=_json_default)


def _environment_doc() -> Dict[str, Any]:
    """The ``environment.json`` payload: enough to reproduce the process
    shape without leaking the whole environ."""
    env = {key: value for key, value in os.environ.items()
           if key.startswith(_ENV_PREFIXES)}
    return {'python': sys.version.split()[0],
            'platform': platform.platform(),
            'pid': os.getpid(),
            'argv': list(sys.argv),
            'cwd': os.getcwd(),
            'env': env}


def _windowed_trace_snapshot(window_s: float) -> Dict[str, Any]:
    """The live trace-ring snapshot cut to the pre-trigger context window:
    events whose timestamp falls within ``window_s`` of the newest recorded
    event (clock-independent — the ring's own timestamps decide)."""
    snapshot = _tracing.trace_snapshot()
    events = snapshot.get('events') or []
    if events and window_s > 0:
        newest = max(float(e.get('ts_us', 0.0)) + float(e.get('dur_us') or 0.0)
                     for e in events)
        floor = newest - window_s * 1e6
        events = [e for e in events if float(e.get('ts_us', 0.0)) >= floor]
    return {'pid': snapshot.get('pid'), 'events': events,
            'dropped_events': snapshot.get('dropped_events', 0),
            'capacity': snapshot.get('capacity', 0),
            'pre_trigger_window_s': window_s}


def _trigger_cause(kind: str, args: Optional[Dict[str, Any]]) -> str:
    """Map a trigger kind (plus its args) to the cause class the autopsy
    ranks first. ``quarantine`` is resolved from the record itself: a hang
    reason is a hang, a transient/IO error type is a storage-path failure,
    anything else is data corruption."""
    if kind == 'quarantine':
        args = args or {}
        if args.get('reason') == 'hang':
            return 'hang'
        error_type = str(args.get('error_type', ''))
        if any(marker in error_type for marker in
               ('Transient', 'IOError', 'OSError', 'Timeout', 'Connection')):
            return 'storage-path'
        return 'corruption'
    return _CAUSE_FOR_TRIGGER.get(kind, 'hang')


class IncidentRecorder(object):
    """Edge-triggered black-box capture into bounded bundle retention
    (module docstring). Thread-safe: triggers can arrive from the consumer
    thread, a scrape thread and breaker callbacks concurrently; the clock is
    injectable so rate-limit tests never sleep."""

    def __init__(self, home: str, policy: Optional[IncidentPolicy] = None,
                 registry: Optional[MetricsRegistry] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.policy = policy if policy is not None else IncidentPolicy()
        self.home = self.policy.home or home
        self._registry = registry
        self._clock = clock
        self._lock = threading.Lock()
        self._sources: Dict[str, Callable[[], Any]] = {}
        self._buckets: Dict[str, _TokenBucket] = {}
        self._captured = 0
        self._rate_limited = 0
        self._bundles: List[str] = []
        self._pending_refs: List[Dict[str, Any]] = []
        self._seq = self._next_seq()
        self._closed = False

    # ------------------------------------------------------------ wiring

    def add_source(self, name: str, fn: Callable[[], Any]) -> None:
        """Attach one evidence source: ``fn()`` is evaluated at capture time
        and written as ``<name>.json`` into every bundle. A raising source
        records its error in place of the payload — evidence gathering must
        never kill a capture."""
        with self._lock:
            self._sources[str(name)] = fn

    def on_breaker_transition(self, name: str, old_state: str,
                              new_state: str) -> None:
        """A :meth:`CircuitBreaker.observe_transitions` /
        :meth:`BreakerBoard.observe_transitions` observer: captures on every
        closed→open edge (half-open→open re-trips ride the rate limiter)."""
        if new_state == 'open':
            self.trigger('breaker_open',
                         args={'breaker': name, 'from_state': old_state,
                               'to_state': new_state})

    # ------------------------------------------------------------ capture

    def trigger(self, kind: str,
                ctx: Optional[Tuple[int, int, int]] = None,
                args: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """One edge event: rate-limit, gather evidence, write the bundle
        atomically, enforce retention. Returns the bundle path, or ``None``
        when the trigger was filtered, rate-limited, or the write failed
        (captures must never take down the data plane)."""
        if self._closed or kind not in self.policy.triggers:
            return None
        with self._lock:
            bucket = self._buckets.get(kind)
            if bucket is None:
                bucket = _TokenBucket(self.policy.bucket_capacity,
                                      self.policy.refill_interval_s,
                                      self._clock)
                self._buckets[kind] = bucket
            allowed = bucket.take()
            if allowed:
                seq = self._seq
                self._seq += 1
        if not allowed:
            with self._lock:
                self._rate_limited += 1
            if self._registry is not None and _registry.telemetry_enabled():
                self._registry.inc('incidents_rate_limited')
            return None
        try:
            path = self._capture(seq, kind, ctx, args)
        except Exception:  # noqa: BLE001 - capture is best-effort by contract
            logger.exception('incident capture failed (kind=%s)', kind)
            return None
        with self._lock:
            self._captured += 1
            self._bundles.append(path)
            self._pending_refs.append(
                bundle_reference(path, ship_bytes_cap=self.policy.ship_bytes_cap))
        if self._registry is not None and _registry.telemetry_enabled():
            self._registry.inc('incidents_captured')
        _tracing.trace_instant('incident_captured', ctx=ctx,
                               args={'kind': kind,
                                     'bundle': os.path.basename(path)})
        logger.warning('incident captured (kind=%s, cause=%s): %s',
                       kind, _trigger_cause(kind, args), path)
        return path

    def _capture(self, seq: int, kind: str,
                 ctx: Optional[Tuple[int, int, int]],
                 args: Optional[Dict[str, Any]]) -> str:
        name = '{}{:05d}-{}'.format(BUNDLE_PREFIX, seq, kind)
        final = os.path.join(self.home, name)
        staging = os.path.join(self.home, '.tmp-{}'.format(name))
        if os.path.isdir(staging):
            shutil.rmtree(staging, ignore_errors=True)
        os.makedirs(staging, exist_ok=True)
        manifest = {'schema': 1, 'kind': kind,
                    'cause': _trigger_cause(kind, args),
                    'ctx': list(ctx) if ctx is not None else None,
                    'args': args or {},
                    'captured_unix_s': time.time(),
                    'captured_monotonic_s': self._clock(),
                    'pid': os.getpid()}
        _write_json(os.path.join(staging, 'manifest.json'), manifest)
        _write_json(os.path.join(staging, 'environment.json'),
                    _environment_doc())
        trace = _windowed_trace_snapshot(self.policy.pre_trigger_window_s)
        _write_json(os.path.join(staging, 'trace.json'),
                    to_chrome_trace(trace))
        with self._lock:
            sources = dict(self._sources)
        for source_name, fn in sources.items():
            try:
                payload = fn()
            except Exception as exc:  # noqa: BLE001 - evidence must not kill capture
                payload = {'error': repr(exc)}
            _write_json(os.path.join(staging,
                                     '{}.json'.format(source_name)), payload)
        os.replace(staging, final)
        self._enforce_retention()
        return final

    def _next_seq(self) -> int:
        """Resume the bundle sequence past anything already retained, so a
        restarted owner never reuses (and silently clobbers) a name."""
        try:
            os.makedirs(self.home, exist_ok=True)
            existing = [entry for entry in os.listdir(self.home)
                        if entry.startswith(BUNDLE_PREFIX)]
        except OSError:
            return 0
        top = 0
        for entry in existing:
            part = entry[len(BUNDLE_PREFIX):].split('-', 1)[0]
            try:
                top = max(top, int(part) + 1)
            except ValueError:
                continue
        return top

    def _enforce_retention(self) -> None:
        """Evict oldest bundles beyond ``max_bundles`` (name order == seq
        order — the N+1th capture deletes the oldest)."""
        try:
            bundles = sorted(entry for entry in os.listdir(self.home)
                             if entry.startswith(BUNDLE_PREFIX))
        except OSError:
            return
        for entry in bundles[:-self.policy.max_bundles]:
            shutil.rmtree(os.path.join(self.home, entry), ignore_errors=True)

    # ------------------------------------------------------------ fleet

    def drain_references(self) -> List[Dict[str, Any]]:
        """Hand off (and clear) the compact references of bundles captured
        since the last drain — the service worker's ``w_incident`` shipping
        queue (drained from the heartbeat thread)."""
        with self._lock:
            refs = self._pending_refs
            self._pending_refs = []
        return refs

    def adopt(self, reference: Dict[str, Any]) -> Optional[str]:
        """Materialize a worker-shipped reference into this recorder's home
        (dispatcher side). Inline bundles are written as first-class local
        bundles (joining retention); reference-only ships are recorded but
        leave the files on the worker. Not rate-limited — the shipping side
        already was."""
        if self._closed:
            return None
        inline = reference.get('inline')
        if not inline:
            return None
        kind = str(reference.get('kind', 'unknown'))
        with self._lock:
            seq = self._seq
            self._seq += 1
        name = '{}{:05d}-{}'.format(BUNDLE_PREFIX, seq, kind)
        final = os.path.join(self.home, name)
        staging = os.path.join(self.home, '.tmp-{}'.format(name))
        try:
            if os.path.isdir(staging):
                shutil.rmtree(staging, ignore_errors=True)
            os.makedirs(staging, exist_ok=True)
            for filename, text in inline.items():
                safe = os.path.basename(str(filename))
                with open(os.path.join(staging, safe), 'w') as f:
                    f.write(str(text))
            os.replace(staging, final)
            self._enforce_retention()
        except OSError:
            logger.exception('incident adopt failed (kind=%s)', kind)
            return None
        with self._lock:
            self._captured += 1
            self._bundles.append(final)
        if self._registry is not None and _registry.telemetry_enabled():
            self._registry.inc('incidents_captured')
        return final

    # ------------------------------------------------------------ surfaces

    @property
    def captured(self) -> int:
        """Bundles written (including adopted fleet ships)."""
        with self._lock:
            return self._captured

    @property
    def rate_limited(self) -> int:
        """Triggers dropped by the per-kind token bucket."""
        with self._lock:
            return self._rate_limited

    def report(self) -> Dict[str, Any]:
        """JSON-safe summary for diagnostics / ``state()`` surfaces:
        ``{'home', 'captured', 'rate_limited', 'retained', 'bundles'}``."""
        with self._lock:
            captured = self._captured
            rate_limited = self._rate_limited
        retained = scan_bundles(self.home)
        return {'home': self.home, 'captured': captured,
                'rate_limited': rate_limited, 'retained': len(retained),
                'bundles': [entry['bundle'] for entry in retained]}

    def close(self) -> None:
        """Stop accepting triggers (idempotent; retained bundles stay)."""
        self._closed = True


def bundle_reference(path: str, ship_bytes_cap: int = 0) -> Dict[str, Any]:
    """The compact fleet-shipping form of one bundle: manifest summary plus
    total size; when the bundle fits under ``ship_bytes_cap`` its files are
    inlined so the dispatcher can materialize a first-class copy."""
    manifest: Dict[str, Any] = {}
    try:
        with open(os.path.join(path, 'manifest.json')) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        pass
    files: Dict[str, str] = {}
    total = 0
    try:
        for entry in sorted(os.listdir(path)):
            full = os.path.join(path, entry)
            if os.path.isfile(full):
                total += os.path.getsize(full)
    except OSError:
        pass
    reference: Dict[str, Any] = {
        'bundle': path, 'kind': manifest.get('kind', 'unknown'),
        'cause': manifest.get('cause'), 'ctx': manifest.get('ctx'),
        'captured_unix_s': manifest.get('captured_unix_s'),
        'size_bytes': total}
    if 0 < total <= ship_bytes_cap:
        try:
            for entry in sorted(os.listdir(path)):
                full = os.path.join(path, entry)
                if os.path.isfile(full):
                    with open(full) as f:
                        files[entry] = f.read()
            reference['inline'] = files
        except OSError:
            reference.pop('inline', None)
    return reference


def scan_bundles(home: Optional[str],
                 limit: int = 0) -> List[Dict[str, Any]]:
    """Manifest summaries of the bundles retained under ``home``, newest
    first (``limit`` > 0 truncates) — the doctor's and ``report()``'s shared
    scan."""
    if not home or not os.path.isdir(home):
        return []
    try:
        names = sorted((entry for entry in os.listdir(home)
                        if entry.startswith(BUNDLE_PREFIX)), reverse=True)
    except OSError:
        return []
    out: List[Dict[str, Any]] = []
    for name in names:
        if limit and len(out) >= limit:
            break
        path = os.path.join(home, name)
        manifest: Dict[str, Any] = {}
        try:
            with open(os.path.join(path, 'manifest.json')) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            pass
        out.append({'bundle': name, 'path': path,
                    'kind': manifest.get('kind', 'unknown'),
                    'cause': manifest.get('cause'),
                    'ctx': manifest.get('ctx'),
                    'captured_unix_s': manifest.get('captured_unix_s')})
    return out


# ---------------------------------------------------------------- autopsy


def _load_evidence(bundle: str) -> Dict[str, Any]:
    """Every ``*.json`` document in the bundle, keyed by stem. Raises
    ``OSError``/``ValueError`` only for a missing/corrupt manifest — other
    evidence files degrade to an ``{'error': ...}`` placeholder."""
    with open(os.path.join(bundle, 'manifest.json')) as f:
        manifest = json.load(f)
    evidence: Dict[str, Any] = {'manifest': manifest}
    for entry in sorted(os.listdir(bundle)):
        if not entry.endswith('.json') or entry == 'manifest.json':
            continue
        stem = entry[:-len('.json')]
        try:
            with open(os.path.join(bundle, entry)) as f:
                evidence[stem] = json.load(f)
        except (OSError, ValueError) as exc:
            evidence[stem] = {'error': repr(exc)}
    return evidence


def _trace_events(evidence: Dict[str, Any]) -> List[Dict[str, Any]]:
    trace = evidence.get('trace') or {}
    events = trace.get('traceEvents') if isinstance(trace, dict) else None
    return [e for e in events or [] if isinstance(e, dict)]


def _instant_count(events: List[Dict[str, Any]], name: str) -> int:
    return sum(1 for e in events
               if e.get('ph') == 'i' and e.get('name') == name)


def _counter_value(evidence: Dict[str, Any], name: str) -> int:
    metrics = evidence.get('metrics') or {}
    counters = metrics.get('counters') if isinstance(metrics, dict) else None
    try:
        return int((counters or {}).get(name, 0))
    except (TypeError, ValueError):
        return 0


def analyze_bundle(bundle: str) -> Dict[str, Any]:
    """Walk one bundle's evidence and rank probable cause classes.

    Returns ``{'bundle', 'trigger', 'cause', 'ctx', 'causes': [{'cause',
    'score', 'evidence': [...]}...], 'top_cause', 'exit_code',
    'trace_events'}`` — causes sorted by descending score, the
    trigger-mapped class seeded with a base score so corroborating evidence
    reorders but an evidence-free bundle still names its trigger."""
    evidence = _load_evidence(bundle)
    manifest = evidence['manifest']
    kind = str(manifest.get('kind', 'unknown'))
    args = manifest.get('args') or {}
    trigger_cause = str(manifest.get('cause')
                        or _trigger_cause(kind, args))
    events = _trace_events(evidence)
    scores: Dict[str, float] = {cause: 0.0 for cause in CAUSE_CLASSES}
    clues: Dict[str, List[str]] = {cause: [] for cause in CAUSE_CLASSES}

    def score(cause: str, points: float, clue: str) -> None:
        scores[cause] += points
        clues[cause].append(clue)

    if trigger_cause in scores:
        score(trigger_cause, 3.0,
              'trigger {!r} maps to this cause class'.format(kind))

    # hang: reaped workers, hang-reason quarantines, stale departures
    quarantine = evidence.get('quarantine')
    records = quarantine if isinstance(quarantine, list) else []
    hang_records = [r for r in records
                    if isinstance(r, dict) and r.get('reason') == 'hang']
    if hang_records:
        score('hang', 2.0, '{} hang-reason quarantine record(s)'
              .format(len(hang_records)))
    reaps = _counter_value(evidence, 'watchdog_reap')
    if reaps:
        score('hang', 1.0, 'watchdog_reap counter = {}'.format(reaps))
    n = _instant_count(events, 'watchdog_reap')
    if n:
        score('hang', 1.0, '{} watchdog_reap instant(s) in the pre-trigger '
                           'trace window'.format(n))
    service = evidence.get('service_state')
    if isinstance(service, dict):
        departed = int(service.get('workers_departed', 0) or 0)
        if departed:
            score('hang', 1.0, '{} service worker(s) departed'
                  .format(departed))
        failed = int(service.get('items_failed', 0) or 0)
        if failed:
            score('hang', 0.5, '{} service item(s) failed their attempt '
                               'budget'.format(failed))

    # corruption: CRC drops, corrupt cache entries, decode-error quarantines
    crc = _counter_value(evidence, 'shm_crc_fail')
    if crc:
        score('corruption', 2.0, 'shm_crc_fail counter = {}'.format(crc))
    n = _instant_count(events, 'shm_crc_drop')
    if n:
        score('corruption', 1.0, '{} shm_crc_drop instant(s) in the trace '
                                 'window'.format(n))
    corrupt_records = [
        r for r in records if isinstance(r, dict)
        and r.get('reason') == 'error'
        and not any(marker in str(r.get('error_type', ''))
                    for marker in ('Transient', 'IOError', 'OSError',
                                   'Timeout', 'Connection'))]
    if corrupt_records:
        score('corruption', 1.0, '{} non-transient error quarantine '
                                 'record(s)'.format(len(corrupt_records)))

    # storage-path: open breakers, transient-IO quarantines
    breakers = evidence.get('breakers')
    open_breakers = [name for name, state in (breakers or {}).items()
                     if isinstance(state, dict)
                     and state.get('state') == 'open'] \
        if isinstance(breakers, dict) else []
    if open_breakers:
        score('storage-path', 2.0, 'open breaker(s): {}'
              .format(', '.join(sorted(open_breakers))))
    n = _instant_count(events, 'breaker_transition')
    if n:
        score('storage-path', 0.5, '{} breaker_transition instant(s) in the '
                                   'trace window'.format(n))
    transient_records = [
        r for r in records if isinstance(r, dict)
        and r.get('reason') == 'error'
        and any(marker in str(r.get('error_type', ''))
                for marker in ('Transient', 'IOError', 'OSError', 'Timeout',
                               'Connection'))]
    if transient_records:
        score('storage-path', 1.0, '{} transient-IO quarantine record(s)'
              .format(len(transient_records)))

    # scheduling-skew: SLO breach state, cost-ledger skew
    slo = evidence.get('slo')
    if isinstance(slo, dict) and slo.get('breached'):
        score('scheduling-skew', 2.0,
              'SLO breached: efficiency {} < target {}'
              .format(slo.get('efficiency'), slo.get('target_efficiency')))
    costs = evidence.get('costs')
    if isinstance(costs, dict):
        skew = costs.get('skew_p95_over_median')
        try:
            if skew is not None and float(skew) > 2.0:
                score('scheduling-skew', 1.0,
                      'rowgroup cost skew p95/median = {:.2f}'
                      .format(float(skew)))
        except (TypeError, ValueError):
            pass
    n = _instant_count(events, 'slo_breach')
    if n:
        score('scheduling-skew', 0.5, '{} slo_breach instant(s) in the '
                                      'trace window'.format(n))
    n = _instant_count(events, 'perf_regression')
    if n:
        score('scheduling-skew', 1.0, '{} perf_regression instant(s) in the '
                                      'trace window'.format(n))
    sentinel = evidence.get('sentinel')
    if isinstance(sentinel, dict) and sentinel.get('alarms'):
        evidence_doc = sentinel.get('last_alarm') or {}
        score('scheduling-skew', 1.0,
              'regression sentinel fired {} time(s); last: {} {} -> {}'
              .format(sentinel.get('alarms'),
                      evidence_doc.get('series', 'rate'),
                      evidence_doc.get('pre_rate_rows_per_sec'),
                      evidence_doc.get('post_rate_rows_per_sec')))

    # divergence: lineage report, divergence instants
    lineage = evidence.get('lineage')
    if isinstance(lineage, dict):
        div = int(lineage.get('divergence', 0) or 0)
        if div:
            score('divergence', 2.0, 'lineage divergence count = {}'
                  .format(div))
    n = _instant_count(events, 'lineage_divergence')
    if n:
        score('divergence', 1.0, '{} lineage_divergence instant(s) in the '
                                 'trace window'.format(n))

    ranked = sorted(({'cause': cause, 'score': round(scores[cause], 2),
                      'evidence': clues[cause]}
                     for cause in CAUSE_CLASSES if scores[cause] > 0),
                    key=lambda entry: -float(entry['score']))  # type: ignore[arg-type]
    top = str(ranked[0]['cause']) if ranked else None
    return {'bundle': os.path.abspath(bundle),
            'trigger': kind,
            'cause': trigger_cause,
            'ctx': manifest.get('ctx'),
            'args': args,
            'captured_unix_s': manifest.get('captured_unix_s'),
            'causes': ranked,
            'top_cause': top,
            'exit_code': EXIT_CODES.get(top or '', EXIT_UNKNOWN),
            'trace_events': len(events)}


def format_autopsy(report: Dict[str, Any]) -> str:
    """Human rendering of one :func:`analyze_bundle` report."""
    lines = ['incident autopsy: {}'.format(report['bundle']),
             '  trigger: {} (cause class: {})'.format(report['trigger'],
                                                      report['cause'])]
    ctx = report.get('ctx')
    if ctx:
        lines.append('  context: epoch={} rowgroup={} attempt={}'
                     .format(*(list(ctx) + [0, 0, 0])[:3]))
    lines.append('  trace: {} event(s) in the pre-trigger window'
                 .format(report.get('trace_events', 0)))
    causes = report.get('causes') or []
    if not causes:
        lines.append('  no rankable evidence — bundle carries the trigger '
                     'only')
    else:
        lines.append('  probable causes (ranked):')
        for i, entry in enumerate(causes):
            lines.append('    {}. {} (score {})'.format(
                i + 1, entry['cause'], entry['score']))
            for clue in entry['evidence']:
                lines.append('       - {}'.format(clue))
    top = report.get('top_cause')
    lines.append('  verdict: {} (exit {})'.format(
        top or 'unknown', report['exit_code']))
    return '\n'.join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    """``petastorm-tpu-torch-throughput autopsy <bundle>``: rank probable causes
    from one captured bundle; the exit code names the top cause class
    (hang 10 / corruption 11 / storage-path 12 / scheduling-skew 13 /
    divergence 14; 1 = no rankable evidence, 2 = unreadable bundle)."""
    parser = argparse.ArgumentParser(
        prog='petastorm-tpu-torch-throughput autopsy',
        description='Root-cause-ranked postmortem over one incident bundle')
    parser.add_argument('bundle',
                        help='bundle directory (or a home directory — the '
                             'newest bundle inside is analyzed)')
    parser.add_argument('--json', action='store_true',
                        help='emit the report as JSON instead of text')
    args = parser.parse_args(argv)
    bundle = args.bundle
    if os.path.isdir(bundle) and not os.path.isfile(
            os.path.join(bundle, 'manifest.json')):
        retained = scan_bundles(bundle, limit=1)
        if retained:
            bundle = retained[0]['path']
    try:
        report = analyze_bundle(bundle)
    except (OSError, ValueError) as exc:
        print('autopsy: cannot read bundle {!r}: {}'.format(args.bundle, exc),
              file=sys.stderr)
        return EXIT_BAD_BUNDLE
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True,
                         default=_json_default))
    else:
        print(format_autopsy(report))
    return int(report['exit_code'])


if __name__ == '__main__':  # pragma: no cover
    sys.exit(main())
