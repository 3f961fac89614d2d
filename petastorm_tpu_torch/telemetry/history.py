"""Longitudinal run historian: cross-run goodput records, robust trailing
baselines, and change-point attribution. A copy of
``petastorm_tpu.telemetry.history``: the same CRC-framed store and record
schema, so either package reads and compares the other's runs.

Every observability plane so far observes a single instant or a single run —
the metrics/SLO plane, the cost ledger, lineage, incidents. This module is
the memory layer over all of them: at ``stop()`` each armed owner (reader /
loader / service dispatcher) appends ONE structured **run record** to an
append-only CRC-framed store keyed by dataset token under the shared
``dataset_state`` home — the same journal discipline as the dispatcher's
durable token ledger (``service/ledger.py``): flush-per-append durability,
atomic compacting rotation (temp file + ``os.replace``), and replay that
stops at the FIRST bad frame (a torn tail is counted in
``history_frames_dropped``, never guessed past).

A run record carries what the next run needs to judge itself against:
config / knob / storage-policy / schedule-plan fingerprints, headline rows/s
and goodput efficiency, per-stage time shares from the telemetry snapshot,
cost-ledger skew, storage counters (footer-cache hit rate, hedge win rate)
and incident/quarantine counts.

The **compare engine** builds a robust trailing baseline — median/MAD over
the last N same-token, same-platform records — and the
``petastorm-tpu-torch-throughput history list|show|compare`` CLI diffs two runs or
a run against its trailing baseline, *attributing* a regression by naming
the stage whose time share grew and any fingerprint/knob that changed
("decode share +18%, knob decode_threads 4 -> 2"). Distinct exit codes per
verdict (:data:`COMPARE_EXIT_CODES`) let a babysitting script branch without
parsing the report.

Attach points: ``make_reader/make_batch_reader(history=True|path|
HistoryPolicy)``, ``TorchDataLoader(history=...)``, ``Dispatcher/ServiceFleet
(history=...)`` / ``serve --history``. ``history=True`` also arms the live
regression sentinel (``telemetry/sentinel.py``) on the same owner. The
autotuner's warm start (``AutotunePolicy(warm_start=True)``) seeds its
knobs from the last-good record's knob fingerprint.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import platform as _platform_mod
import struct
import sys
import tempfile
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from petastorm_tpu_torch.telemetry import registry as _registry
from petastorm_tpu_torch.telemetry.registry import SECONDS_UNIT, MetricsRegistry

logger = logging.getLogger(__name__)

#: store basename inside a dataset's local state home (underscore prefix
#: keeps it out of Parquet directory listings, like every other sidecar)
HISTORY_BASENAME = '_petastorm_tpu_run_history.bin'

#: run-record schema version (bump on incompatible shape changes; replay
#: skips newer-schema records instead of misreading them)
RUN_RECORD_SCHEMA = 1

#: the closed registry of recording layers: every ``build_run_record('x',
#: ...)`` call site must name one of these, and baseline/attribution
#: filtering groups by them — an undeclared owner would write records no
#: comparison ever selects
RUN_RECORD_OWNERS: Tuple[str, ...] = ('reader', 'loader', 'dispatcher')

#: frame header: payload length + CRC32(payload) — the ledger.py discipline
_FRAME_HEADER = struct.Struct('>II')

#: store size that triggers a compacting rotation (runs are one record each,
#: so this bound is generous)
DEFAULT_ROTATE_BYTES = 1 << 20

#: the verdicts ``compare_records`` can return, each with its own CLI exit
#: code so scripts branch on the comparison without parsing the report
COMPARE_VERDICTS: Tuple[str, ...] = ('within-noise', 'improved', 'regressed',
                                     'insufficient-history')
COMPARE_EXIT_CODES: Dict[str, int] = {'within-noise': 0, 'improved': 5,
                                      'regressed': 6,
                                      'insufficient-history': 7}
#: CLI exit for a missing / unreadable store
EXIT_BAD_STORE = 2

#: MAD -> sigma scale for a normal distribution (the robust noise band)
_MAD_SIGMA = 1.4826


@dataclass(frozen=True)
class HistoryPolicy:
    """Run-historian policy — the ``history=`` kwarg contract of
    ``make_reader`` / ``TorchDataLoader`` / ``Dispatcher`` / ``ServiceFleet``
    (``True`` means this default policy; a path string sets ``path``).

    ``path`` overrides the store location (default: the dataset's local
    state home). ``max_records`` bounds the store — a compacting rotation
    keeps the newest N. The trailing baseline is median/MAD over the last
    ``baseline_window`` same-token, same-platform records and needs at least
    ``min_baseline_runs`` of them; a delta is signal only beyond
    ``noise_mads`` robust sigmas AND ``min_rel_delta`` relative change, but
    the band is capped at ``max_rel_delta`` of the baseline median — a
    short noisy history (one cold-start outlier can blow the MAD up past
    the median itself) must never swallow a halved throughput as noise.
    ``sentinel`` arms the live regression sentinel on the same owner
    (``True``/``False`` or a
    :class:`~petastorm_tpu_torch.telemetry.sentinel.SentinelPolicy`)."""

    path: Optional[str] = None
    max_records: int = 128
    baseline_window: int = 8
    min_baseline_runs: int = 3
    noise_mads: float = 3.0
    min_rel_delta: float = 0.05
    max_rel_delta: float = 0.5
    sentinel: Any = True

    def __post_init__(self) -> None:
        """Validate bounds at construction time."""
        if self.max_records < 1:
            raise ValueError('max_records must be >= 1, got {!r}'
                             .format(self.max_records))
        if self.baseline_window < 1:
            raise ValueError('baseline_window must be >= 1, got {!r}'
                             .format(self.baseline_window))
        if self.min_baseline_runs < 1:
            raise ValueError('min_baseline_runs must be >= 1, got {!r}'
                             .format(self.min_baseline_runs))
        if self.noise_mads < 0 or self.min_rel_delta < 0:
            raise ValueError('noise_mads and min_rel_delta must be >= 0')
        if self.max_rel_delta < self.min_rel_delta:
            raise ValueError('max_rel_delta must be >= min_rel_delta, got '
                             '{!r} < {!r}'.format(self.max_rel_delta,
                                                  self.min_rel_delta))


def resolve_history_policy(value: Any) -> Optional[HistoryPolicy]:
    """Accept ``None``/``False`` (disabled — the off path builds nothing),
    ``True`` (default policy), a store/dataset path string, or a
    :class:`HistoryPolicy` — the ``history=`` kwarg contract."""
    if value is None or value is False:
        return None
    if value is True:
        return HistoryPolicy()
    if isinstance(value, str):
        return HistoryPolicy(path=value)
    if isinstance(value, HistoryPolicy):
        return value
    raise ValueError('history must be None, a bool, a path string, or a '
                     'HistoryPolicy, got {!r}'.format(value))


def default_history_path(dataset_url_or_path: str,
                         cache_location: Optional[str] = None
                         ) -> Optional[str]:
    """The store path for a dataset's local state home
    (``dataset_state.sidecar_path`` — the same placement the cost ledger,
    lineage manifest and dispatcher ledger use); None when the dataset has
    no local home."""
    from petastorm_tpu_torch.dataset_state import sidecar_path
    return sidecar_path(dataset_url_or_path, HISTORY_BASENAME,
                        cache_location)


def run_platform() -> str:
    """The platform tag stamped on every record — baselines only ever
    compare same-platform runs (a GPU round against a CPU fallback round
    would shift every number by an order of magnitude)."""
    return _platform_mod.platform()


def fingerprint(payload: Any) -> str:
    """Stable 12-hex-char fingerprint of one JSON-safe payload (sorted keys,
    so dict ordering never flips the hash)."""
    import hashlib
    text = json.dumps(payload, sort_keys=True, default=repr)
    return hashlib.md5(text.encode('utf-8')).hexdigest()[:12]


def stage_time_shares(snapshot: Dict[str, Any],
                      elapsed_s: float) -> Dict[str, float]:
    """Per-stage share of wall time from one cumulative telemetry snapshot:
    ``{stage: seconds/elapsed}`` for every recorded leaf stage (envelope
    stages excluded so shares sum sensibly — same exclusion
    ``telemetry/analyze.py`` applies)."""
    from petastorm_tpu_torch.telemetry.spans import ENVELOPE_STAGES
    shares: Dict[str, float] = {}
    if elapsed_s <= 0:
        return shares
    for stage, hist in (snapshot.get('histograms') or {}).items():
        if stage in ENVELOPE_STAGES or not isinstance(hist, dict):
            continue
        if float(hist.get('unit', SECONDS_UNIT)) != SECONDS_UNIT:
            continue
        seconds = float(hist.get('sum', 0.0))
        if seconds > 0:
            shares[stage] = round(seconds / elapsed_s, 6)
    return shares


def _counter(snapshot: Dict[str, Any], name: str) -> int:
    try:
        return int((snapshot.get('counters') or {}).get(name, 0))
    except (TypeError, ValueError):
        return 0


def _hit_rate(hits: int, misses: int) -> Optional[float]:
    total = hits + misses
    if total <= 0:
        return None
    return round(hits / total, 6)


def build_run_record(owner: str,
                     dataset_token: str,
                     elapsed_s: float,
                     rows: int,
                     snapshot: Optional[Dict[str, Any]] = None,
                     slo_report: Optional[Dict[str, Any]] = None,
                     fingerprints: Optional[Dict[str, Optional[str]]] = None,
                     knobs: Optional[Dict[str, float]] = None,
                     incidents: Optional[Dict[str, Any]] = None,
                     quarantined: int = 0,
                     cost_skew: Optional[float] = None,
                     platform: Optional[str] = None,
                     recorded_unix_s: Optional[float] = None
                     ) -> Dict[str, Any]:
    """Assemble one JSON-safe run record from an owner's end-of-run state.

    ``owner`` names the recording layer (``reader`` / ``loader`` /
    ``dispatcher``); ``fingerprints`` carries the config / knob / storage /
    schedule identity hashes; ``knobs`` the raw knob values the attribution
    engine diffs ("decode_threads 4 -> 2"). ``recorded_unix_s`` is
    injectable so record-identity tests never read the wall clock."""
    snapshot = snapshot or {}
    slo_report = slo_report or {}
    elapsed_s = max(float(elapsed_s), 0.0)
    rows = int(rows)
    record: Dict[str, Any] = {
        'schema': RUN_RECORD_SCHEMA,
        'kind': 'run',
        'owner': str(owner),
        'dataset_token': str(dataset_token),
        'platform': platform if platform is not None else run_platform(),
        'recorded_unix_s': (float(recorded_unix_s)
                            if recorded_unix_s is not None else time.time()),
        'elapsed_s': round(elapsed_s, 6),
        'rows': rows,
        'rows_per_sec': round(rows / elapsed_s, 3) if elapsed_s > 0 else 0.0,
        'efficiency': slo_report.get('efficiency'),
        'wait_seconds': slo_report.get('wait_seconds'),
        'primary_wait_stage': slo_report.get('primary_wait_stage'),
        'stage_shares': stage_time_shares(snapshot, elapsed_s),
        'fingerprints': dict(fingerprints or {}),
        'knobs': {str(k): v for k, v in (knobs or {}).items()},
        'quarantined': int(quarantined),
    }
    footer_rate = _hit_rate(_counter(snapshot, 'storage_footer_cache_hit'),
                            _counter(snapshot, 'storage_footer_cache_miss'))
    hedge_rate = _hit_rate(_counter(snapshot, 'storage_hedge_won'),
                           max(_counter(snapshot, 'storage_hedge_fired')
                               - _counter(snapshot, 'storage_hedge_won'), 0))
    record['storage'] = {'footer_cache_hit_rate': footer_rate,
                         'hedge_win_rate': hedge_rate}
    if incidents:
        record['incidents'] = {
            'captured': int(incidents.get('captured', 0) or 0),
            'rate_limited': int(incidents.get('rate_limited', 0) or 0)}
    else:
        record['incidents'] = {'captured': 0, 'rate_limited': 0}
    if cost_skew is not None:
        record['cost_skew_p95_over_median'] = round(float(cost_skew), 4)
    return record


# ----------------------------------------------------------------- journal


def read_history(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """Every CRC-verified run record in store order, plus the dropped-frame
    count. Stops at the FIRST bad frame (short header, short payload, CRC
    mismatch, non-JSON payload) — framing after an unreadable frame cannot
    be trusted, so the suffix is abandoned: counted, never guessed at.
    Records with a schema newer than this build understands are skipped
    (counted as records, not as drops)."""
    records: List[Dict[str, Any]] = []
    dropped = 0
    with open(path, 'rb') as f:
        while True:
            header = f.read(_FRAME_HEADER.size)
            if not header:
                break
            if len(header) < _FRAME_HEADER.size:
                dropped += 1
                break
            length, crc = _FRAME_HEADER.unpack(header)
            payload = f.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                dropped += 1
                break
            try:
                record = json.loads(payload.decode('utf-8'))
            except (UnicodeDecodeError, ValueError):
                dropped += 1
                break
            if (isinstance(record, dict)
                    and int(record.get('schema', 0)) <= RUN_RECORD_SCHEMA):
                records.append(record)
    return records, dropped


def load_records(path: Optional[str]) -> Tuple[List[Dict[str, Any]], int]:
    """:func:`read_history` tolerant of a missing store (first run: no
    records, no drops) and of an unreadable one (no records, one drop — the
    caller degrades loudly, like the ledger's replay)."""
    if not path or not os.path.exists(path):
        return [], 0
    try:
        return read_history(path)
    except OSError as exc:
        logger.error('history: store %s is unreadable (%s)', path, exc)
        return [], 1


def _frame(record: Dict[str, Any]) -> bytes:
    payload = json.dumps(record, sort_keys=True).encode('utf-8')
    return _FRAME_HEADER.pack(len(payload), zlib.crc32(payload)) + payload


class RunHistorian(object):
    """Append-only CRC-framed run-record store with atomic compaction.

    One record per run, appended at ``stop()`` — the writer opens, appends
    one flushed frame and closes per call (no long-lived handle to leak
    across a crash), then rotates when the store outgrows ``rotate_bytes``
    or ``policy.max_records``: the newest ``max_records`` are rewritten into
    a temp file and ``os.replace``d over the store — the same atomic-publish
    discipline every sidecar in this repo uses. Appends are serialized by an
    internal lock (a loader and its reader may both record at teardown)."""

    def __init__(self, path: str,
                 policy: Optional[HistoryPolicy] = None,
                 registry: Optional[MetricsRegistry] = None,
                 rotate_bytes: int = DEFAULT_ROTATE_BYTES) -> None:
        self.path = path
        self.policy = policy if policy is not None else HistoryPolicy()
        self.rotate_bytes = rotate_bytes
        self._registry = registry
        self._lock = threading.Lock()
        self._appended = 0
        self._last_dropped = 0

    def append(self, record: Dict[str, Any]) -> bool:
        """Append one run record (flushed to the OS — it survives any
        SIGKILL of the owner). Store write failures are logged, not raised:
        the historian is an upgrade, never a new way to fail a run that
        already succeeded. Returns True when the record landed."""
        frame = _frame(record)
        with self._lock:
            try:
                parent = os.path.dirname(self.path)
                if parent:
                    os.makedirs(parent, exist_ok=True)
                with open(self.path, 'ab') as f:
                    f.write(frame)
                    f.flush()
                self._appended += 1
                self._maybe_rotate(latest=record)
            except OSError:
                logger.exception('history: append to %s failed; this run is '
                                 'not recorded', self.path)
                return False
        if self._registry is not None and _registry.telemetry_enabled():
            self._registry.inc('history_record_written')
        return True

    def _maybe_rotate(self, latest: Optional[Dict[str, Any]] = None) -> None:
        # called under _lock
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return
        if size < self.rotate_bytes:
            records, dropped = read_history(self.path)
            if dropped == 0 and len(records) <= self.policy.max_records:
                return
        else:
            records, dropped = read_history(self.path)
        if dropped and latest is not None:
            # replay stops at the torn frame, so the frame just appended
            # after it is invisible to read_history — re-add it or the
            # healing compaction would silently drop this run's record
            records = records + [latest]
        keep = records[-self.policy.max_records:]
        parent = os.path.dirname(self.path) or '.'
        fd, tmp_path = tempfile.mkstemp(dir=parent, prefix='.history-rotate-')
        try:
            with os.fdopen(fd, 'wb') as tmp:
                for record in keep:
                    tmp.write(_frame(record))
                tmp.flush()
                os.fsync(tmp.fileno())
            os.replace(tmp_path, self.path)
        except OSError:
            logger.exception('history: rotation of %s failed; store keeps '
                             'growing until the next attempt', self.path)
        finally:
            # no-op after a successful os.replace; on ANY failure path
            # (OSError or not) the orphaned temp file is removed
            try:
                os.unlink(tmp_path)
            except OSError:
                pass

    def records(self) -> List[Dict[str, Any]]:
        """Replay the store (CRC-verified records, store order); a torn tail
        is counted into ``history_frames_dropped`` and surfaced by
        :meth:`state`."""
        records, dropped = load_records(self.path)
        with self._lock:
            self._last_dropped = dropped
        if (dropped and self._registry is not None
                and _registry.telemetry_enabled()):
            self._registry.inc('history_frames_dropped', dropped)
        return records

    def state(self) -> Dict[str, Any]:
        """JSON-safe store status for diagnostics / doctor."""
        with self._lock:
            return {'path': self.path, 'appended': self._appended,
                    'frames_dropped': self._last_dropped,
                    'max_records': self.policy.max_records}


# ---------------------------------------------------------------- baseline


def select_records(records: List[Dict[str, Any]],
                   dataset_token: Optional[str] = None,
                   platform: Optional[str] = None,
                   owner: Optional[str] = None) -> List[Dict[str, Any]]:
    """The records comparable to one run: same token, same platform (and
    optionally same owner layer), store order preserved."""
    out = []
    for record in records:
        if dataset_token is not None \
                and record.get('dataset_token') != dataset_token:
            continue
        if platform is not None and record.get('platform') != platform:
            continue
        if owner is not None and record.get('owner') != owner:
            continue
        out.append(record)
    return out


def robust_baseline(values: List[float]) -> Dict[str, float]:
    """Median/MAD summary of one metric series — the noise model a trailing
    baseline holds a candidate against (robust: one outlier run cannot drag
    the baseline the way a mean would)."""
    if not values:
        return {'count': 0, 'median': 0.0, 'mad': 0.0}
    ordered = sorted(values)
    n = len(ordered)
    mid = n // 2
    median = (ordered[mid] if n % 2
              else (ordered[mid - 1] + ordered[mid]) / 2.0)
    deviations = sorted(abs(v - median) for v in ordered)
    mad = (deviations[mid] if n % 2
           else (deviations[mid - 1] + deviations[mid]) / 2.0)
    return {'count': n, 'median': median, 'mad': mad}


def trailing_baseline(records: List[Dict[str, Any]],
                      dataset_token: str,
                      platform: str,
                      window: int = 8,
                      owner: Optional[str] = None) -> Dict[str, Any]:
    """The robust trailing baseline for one (token, platform) stream: the
    last ``window`` comparable records summarized as median/MAD of rows/s
    and efficiency, plus the per-stage median shares the attribution engine
    diffs against."""
    comparable = select_records(records, dataset_token, platform,
                                owner=owner)[-window:]
    rates = [float(r.get('rows_per_sec', 0.0)) for r in comparable]
    efficiencies = [float(r['efficiency']) for r in comparable
                    if r.get('efficiency') is not None]
    stages: Dict[str, List[float]] = {}
    for record in comparable:
        for stage, share in (record.get('stage_shares') or {}).items():
            stages.setdefault(stage, []).append(float(share))
    return {
        'count': len(comparable),
        'window': window,
        'rows_per_sec': robust_baseline(rates),
        'efficiency': robust_baseline(efficiencies),
        'stage_shares': {stage: robust_baseline(values)['median']
                         for stage, values in stages.items()},
        'records': comparable,
    }


# ----------------------------------------------------------- compare engine


def _diff_fingerprints(candidate: Dict[str, Any],
                       reference: Dict[str, Any]) -> List[str]:
    changed = []
    cand = candidate.get('fingerprints') or {}
    ref = reference.get('fingerprints') or {}
    for key in sorted(set(cand) | set(ref)):
        if cand.get(key) != ref.get(key):
            changed.append('{} {} -> {}'.format(key, ref.get(key),
                                                cand.get(key)))
    return changed


def _diff_knobs(candidate: Dict[str, Any],
                reference: Dict[str, Any]) -> List[str]:
    changed = []
    cand = candidate.get('knobs') or {}
    ref = reference.get('knobs') or {}
    for key in sorted(set(cand) | set(ref)):
        if cand.get(key) != ref.get(key):
            changed.append('knob {} {} -> {}'.format(
                key, _fmt_value(ref.get(key)), _fmt_value(cand.get(key))))
    return changed


def _fmt_value(value: Any) -> str:
    if isinstance(value, float) and value == int(value):
        return str(int(value))
    return str(value)


def _grown_stages(candidate: Dict[str, Any],
                  baseline_shares: Dict[str, float],
                  min_share_delta: float = 0.03) -> List[Dict[str, Any]]:
    grown = []
    for stage, share in (candidate.get('stage_shares') or {}).items():
        delta = float(share) - float(baseline_shares.get(stage, 0.0))
        if delta >= min_share_delta:
            grown.append({'stage': stage, 'share': round(float(share), 4),
                          'share_delta': round(delta, 4)})
    grown.sort(key=lambda entry: -float(entry['share_delta']))
    return grown


def compare_records(candidate: Dict[str, Any],
                    baseline: Dict[str, Any],
                    policy: Optional[HistoryPolicy] = None
                    ) -> Dict[str, Any]:
    """Judge one run against a :func:`trailing_baseline` and attribute the
    outcome.

    Verdicts: ``insufficient-history`` (fewer than
    ``policy.min_baseline_runs`` comparable records), ``regressed`` /
    ``improved`` (the rows/s delta clears the noise band — ``noise_mads``
    robust sigmas AND ``min_rel_delta`` relative, capped at
    ``max_rel_delta`` of the median), else ``within-noise``.
    A regression's ``attribution`` names the grown stage(s) and every
    changed fingerprint/knob vs the newest baseline record."""
    policy = policy if policy is not None else HistoryPolicy()
    base_rate = baseline.get('rows_per_sec') or {}
    count = int(baseline.get('count', 0))
    rate = float(candidate.get('rows_per_sec', 0.0))
    report: Dict[str, Any] = {
        'candidate': {
            'owner': candidate.get('owner'),
            'dataset_token': candidate.get('dataset_token'),
            'recorded_unix_s': candidate.get('recorded_unix_s'),
            'rows_per_sec': rate,
            'efficiency': candidate.get('efficiency'),
        },
        'baseline': {
            'count': count,
            'window': baseline.get('window'),
            'median_rows_per_sec': round(float(base_rate.get('median', 0.0)),
                                         3),
            'mad_rows_per_sec': round(float(base_rate.get('mad', 0.0)), 3),
            'median_efficiency': round(float(
                (baseline.get('efficiency') or {}).get('median', 0.0)), 6),
        },
    }
    if count < policy.min_baseline_runs:
        report['verdict'] = 'insufficient-history'
        report['exit_code'] = COMPARE_EXIT_CODES['insufficient-history']
        report['reason'] = ('{} comparable record(s); need >= {}'
                            .format(count, policy.min_baseline_runs))
        return report
    median = float(base_rate.get('median', 0.0))
    mad = float(base_rate.get('mad', 0.0))
    # MAD band floored at min_rel_delta and CAPPED at max_rel_delta of the
    # median: a 4-run history with one cold-start outlier can push the MAD
    # past the median itself, and an uncapped band would then read a halved
    # throughput as within-noise
    band = max(policy.noise_mads * _MAD_SIGMA * mad,
               policy.min_rel_delta * median)
    band = min(band, policy.max_rel_delta * median)
    delta = rate - median
    delta_pct = (delta / median * 100.0) if median > 0 else 0.0
    report['delta_rows_per_sec'] = round(delta, 3)
    report['delta_pct'] = round(delta_pct, 2)
    report['noise_band_rows_per_sec'] = round(band, 3)
    if delta < -band:
        verdict = 'regressed'
    elif delta > band:
        verdict = 'improved'
    else:
        verdict = 'within-noise'
    report['verdict'] = verdict
    report['exit_code'] = COMPARE_EXIT_CODES[verdict]
    baseline_records = baseline.get('records') or []
    reference = baseline_records[-1] if baseline_records else {}
    attribution: Dict[str, Any] = {
        'grown_stages': _grown_stages(
            candidate, baseline.get('stage_shares') or {}),
        'changed_fingerprints': _diff_fingerprints(candidate, reference),
        'changed_knobs': _diff_knobs(candidate, reference),
    }
    report['attribution'] = attribution
    clauses: List[str] = []
    for entry in attribution['grown_stages'][:2]:
        clauses.append('{} share {:+.0f}%'.format(
            entry['stage'], float(entry['share_delta']) * 100.0))
    clauses.extend(attribution['changed_knobs'][:3])
    clauses.extend(attribution['changed_fingerprints'][:2])
    report['reason'] = ('rows/s {:+.1f}% vs trailing median {:.1f}{}'
                        .format(delta_pct, median,
                                ' ({})'.format(', '.join(clauses))
                                if clauses else ''))
    return report


def compare_against_history(records: List[Dict[str, Any]],
                            candidate: Dict[str, Any],
                            policy: Optional[HistoryPolicy] = None
                            ) -> Dict[str, Any]:
    """One-call form: build the candidate's trailing baseline from ``records``
    (excluding the candidate itself when it is the stored tail) and compare.
    What a CI gate or the bench baseline check calls."""
    policy = policy if policy is not None else HistoryPolicy()
    pool = [r for r in records if r is not candidate]
    baseline = trailing_baseline(pool,
                                 str(candidate.get('dataset_token')),
                                 str(candidate.get('platform')),
                                 window=policy.baseline_window,
                                 owner=candidate.get('owner'))
    return compare_records(candidate, baseline, policy)


def last_good_record(records: List[Dict[str, Any]],
                     dataset_token: str,
                     platform: Optional[str] = None
                     ) -> Optional[Dict[str, Any]]:
    """The newest same-token (and same-platform, when given) record — the
    autotuner's warm-start seed (``AutotunePolicy(warm_start=True)``); None
    when no comparable record exists, which gates warm start off."""
    comparable = select_records(records, dataset_token, platform)
    return comparable[-1] if comparable else None


# --------------------------------------------------------------------- CLI


def _record_summary(index: int, record: Dict[str, Any]) -> str:
    recorded = record.get('recorded_unix_s')
    stamp = (time.strftime('%Y-%m-%d %H:%M:%S',
                           time.localtime(float(recorded)))
             if recorded else '-')
    return ('[{:>3}] {}  {:<10} token={} {:>10.1f} rows/s  eff={}  {}'
            .format(index, stamp, str(record.get('owner', '?')),
                    record.get('dataset_token'),
                    float(record.get('rows_per_sec', 0.0)),
                    record.get('efficiency'),
                    record.get('platform', '')))


def format_compare(report: Dict[str, Any]) -> str:
    """Human rendering of one :func:`compare_records` report."""
    lines = ['history compare: {}'.format(report['verdict'].upper()),
             '  candidate: {:.1f} rows/s (owner={}, token={})'.format(
                 float(report['candidate']['rows_per_sec']),
                 report['candidate'].get('owner'),
                 report['candidate'].get('dataset_token')),
             '  baseline:  median {:.1f} rows/s over {} run(s) '
             '(MAD {:.1f})'.format(
                 float(report['baseline']['median_rows_per_sec']),
                 report['baseline']['count'],
                 float(report['baseline']['mad_rows_per_sec']))]
    if 'delta_pct' in report:
        lines.append('  delta: {:+.1f}% (noise band +/-{:.1f} rows/s)'
                     .format(float(report['delta_pct']),
                             float(report['noise_band_rows_per_sec'])))
    attribution = report.get('attribution') or {}
    grown = attribution.get('grown_stages') or []
    if grown:
        lines.append('  grown stages:')
        for entry in grown:
            lines.append('    - {} share {:+.0f}% (now {:.0f}%)'.format(
                entry['stage'], float(entry['share_delta']) * 100.0,
                float(entry['share']) * 100.0))
    for key, label in (('changed_knobs', 'changed knobs'),
                       ('changed_fingerprints', 'changed fingerprints')):
        entries = attribution.get(key) or []
        if entries:
            lines.append('  {}:'.format(label))
            for entry in entries:
                lines.append('    - {}'.format(entry))
    lines.append('  reason: {}'.format(report.get('reason', '')))
    lines.append('  verdict: {} (exit {})'.format(report['verdict'],
                                                  report['exit_code']))
    return '\n'.join(lines)


def _resolve_store(target: str) -> Optional[str]:
    """A CLI ``store`` argument is either the store file itself or a dataset
    path/URL whose local state home holds one."""
    if os.path.isfile(target):
        return target
    return default_history_path(target)


def main(argv: Optional[List[str]] = None) -> int:
    """``petastorm-tpu-torch-throughput history list|show|compare``: inspect the
    longitudinal run-record store and judge runs against their trailing
    baseline. ``compare`` exits with the verdict's code (within-noise 0 /
    improved 5 / regressed 6 / insufficient-history 7; 2 = unreadable
    store)."""
    parser = argparse.ArgumentParser(
        prog='petastorm-tpu-torch-throughput history',
        description='Longitudinal run history: list/show/compare recorded '
                    'runs')
    sub = parser.add_subparsers(dest='cmd', required=True)

    p_list = sub.add_parser('list', help='list recorded runs, oldest first')
    p_list.add_argument('store', help='history store file, or a dataset '
                                      'path/URL with a local state home')
    p_list.add_argument('--token', default=None,
                        help='only runs of this dataset token')
    p_list.add_argument('--json', action='store_true')

    p_show = sub.add_parser('show', help='print one run record as JSON')
    p_show.add_argument('store')
    p_show.add_argument('--index', type=int, default=-1,
                        help='record index from `list` (default: newest)')

    p_cmp = sub.add_parser(
        'compare',
        help='diff two runs, or a run against its trailing baseline')
    p_cmp.add_argument('store')
    p_cmp.add_argument('--index', type=int, default=-1,
                       help='candidate record index (default: newest)')
    p_cmp.add_argument('--against', type=int, default=None,
                       help='baseline record index (default: the trailing '
                            'median/MAD baseline of the candidate\'s '
                            'token+platform stream)')
    p_cmp.add_argument('--window', type=int, default=None,
                       help='trailing-baseline window (default: policy '
                            'default)')
    p_cmp.add_argument('--json', action='store_true')

    args = parser.parse_args(argv)
    path = _resolve_store(args.store)
    if path is None:
        print('history: {!r} has no local state home; pass the store file '
              'path'.format(args.store), file=sys.stderr)
        return EXIT_BAD_STORE
    records, dropped = load_records(path)
    if not records and not os.path.exists(path):
        print('history: no store at {!r}'.format(path), file=sys.stderr)
        return EXIT_BAD_STORE
    if dropped:
        print('history: WARNING: {} torn/corrupt frame(s) dropped from the '
              'store tail'.format(dropped), file=sys.stderr)

    if args.cmd == 'list':
        listed = (select_records(records, dataset_token=args.token)
                  if args.token else records)
        if args.json:
            print(json.dumps(listed, indent=1, sort_keys=True))
        else:
            for index, record in enumerate(listed):
                print(_record_summary(index, record))
            print('{} record(s) in {}'.format(len(listed), path))
        return 0

    try:
        candidate = records[args.index]
    except IndexError:
        print('history: no record at index {} ({} recorded)'
              .format(args.index, len(records)), file=sys.stderr)
        return EXIT_BAD_STORE

    if args.cmd == 'show':
        print(json.dumps(candidate, indent=1, sort_keys=True))
        return 0

    # compare
    policy = HistoryPolicy() if args.window is None else HistoryPolicy(
        baseline_window=args.window)
    if args.against is not None:
        try:
            reference = records[args.against]
        except IndexError:
            print('history: no record at index {}'.format(args.against),
                  file=sys.stderr)
            return EXIT_BAD_STORE
        baseline = {
            'count': 1, 'window': 1,
            'rows_per_sec': robust_baseline(
                [float(reference.get('rows_per_sec', 0.0))]),
            'efficiency': robust_baseline(
                [float(reference['efficiency'])]
                if reference.get('efficiency') is not None else []),
            'stage_shares': {k: float(v) for k, v in
                             (reference.get('stage_shares') or {}).items()},
            'records': [reference],
        }
        report = compare_records(candidate, baseline,
                                 HistoryPolicy(min_baseline_runs=1,
                                               baseline_window=1))
    else:
        report = compare_against_history(records, candidate, policy)
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True))
    else:
        print(format_compare(report))
    return int(report['exit_code'])


if __name__ == '__main__':  # pragma: no cover
    sys.exit(main())
