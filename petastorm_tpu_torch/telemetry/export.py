"""Export surfaces for telemetry snapshots: Prometheus text exposition and a
periodic JSONL event log. A copy of ``petastorm_tpu.telemetry.export``: the
exposition is byte for byte the JAX package's for the same snapshot (same
``petastorm_tpu`` metric prefix, so one dashboard reads both).

Both operate on the plain-dict snapshots produced by
:meth:`~petastorm_tpu_torch.telemetry.registry.MetricsRegistry.snapshot` (also found
under ``Reader.diagnostics['telemetry']`` and
``TorchDataLoader.telemetry_snapshot()``), so exporting never holds any pipeline
lock — take a snapshot, hand it to an exporter.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from petastorm_tpu_torch.telemetry.registry import (DEFAULT_NUM_BUCKETS,
                                              bucket_upper_bound)

#: the prefix of every metric name: the JAX package's, so one dashboard reads
#: both packages
METRIC_PREFIX = 'petastorm_tpu'

_NAME_SANITIZE = re.compile(r'[^a-zA-Z0-9_:]')
#: the full legal Prometheus metric-name grammar — what every emitted name
#: must match after sanitization (first char may not be a digit)
METRIC_NAME_RE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*$')


def sanitize_metric_name(name: str) -> str:
    """Map an arbitrary metric id onto the legal Prometheus name grammar
    ``[a-zA-Z_:][a-zA-Z0-9_:]*``: every illegal character becomes ``_`` and a
    leading digit (or empty name) gets a ``_`` prefix — so a stage/knob id
    containing ``.``/``-``/spaces or starting with a digit degrades to an ugly
    but VALID name instead of an exposition the scraper rejects."""
    sanitized = _NAME_SANITIZE.sub('_', name)
    if not sanitized or sanitized[0].isdigit():
        sanitized = '_' + sanitized
    return sanitized


def _metric_name(name: str) -> str:
    return sanitize_metric_name('{}_{}'.format(METRIC_PREFIX, name))


def _series_labels(name: str) -> Dict[str, str]:
    """The label set every series of this metric carries: a ``raw_name``
    label whenever the metric id itself is not already a legal Prometheus
    name (``.``/``-``/spaces, a leading digit) — the original id must stay
    queryable after sanitization."""
    return {'raw_name': name} if sanitize_metric_name(name) != name else {}


def _format_labels(labels: Dict[str, str]) -> str:
    """``{k="v",...}`` rendering (empty string for no labels), values escaped
    per the exposition format."""
    if not labels:
        return ''
    return '{{{}}}'.format(','.join(
        '{}="{}"'.format(key, escape_label_value(value))
        for key, value in sorted(labels.items())))


def _format_value(value: float) -> str:
    if value == float('inf'):
        return '+Inf'
    if float(value).is_integer():
        return str(int(value))
    return repr(float(value))


def escape_label_value(value: str) -> str:
    """Escape a label value per the Prometheus text exposition format: inside
    the double quotes of ``{label="..."}``, backslash, double-quote and newline
    must appear as ``\\\\``, ``\\"`` and ``\\n`` — a raw newline splits the
    series line and makes scrapers reject the whole exposition."""
    return (str(value).replace('\\', '\\\\').replace('"', '\\"')
            .replace('\n', '\\n'))


def _escape_help(text: str) -> str:
    # HELP text escaping differs from label values: only backslash and newline
    # (quotes are legal in HELP text per the exposition format)
    return str(text).replace('\\', '\\\\').replace('\n', '\\n')


def _help_line(metric: str, kind: str, name: str) -> str:
    return '# HELP {} petastorm_tpu {} {} (docs/observability.md)'.format(
        metric, kind, _escape_help(name))


def _render_histogram_series(lines: List[str], metric: str,
                             hist: Dict[str, Any],
                             labels: Dict[str, str]) -> None:
    """Append one label-set's cumulative ``_bucket``/``_sum``/``_count``
    series for ``metric`` (HELP/TYPE are the caller's job)."""
    unit = float(hist.get('unit', 1e-6))
    buckets = {int(k): int(v) for k, v in (hist.get('buckets') or {}).items()}
    cumulative = 0
    top = max(buckets) if buckets else -1
    # finite buckets only — the histogram's last bucket IS +Inf, which the
    # unconditional line below emits exactly once (duplicate le="+Inf"
    # series make scrapers reject the whole exposition)
    for idx in range(min(top + 1, DEFAULT_NUM_BUCKETS - 1)):
        cumulative += buckets.get(idx, 0)
        le = bucket_upper_bound(idx, unit)
        bucket_labels = dict(labels)
        bucket_labels['le'] = _format_value(le)
        lines.append('{}_bucket{} {}'.format(
            metric, _format_labels(bucket_labels), cumulative))
    inf_labels = dict(labels)
    inf_labels['le'] = '+Inf'
    lines.append('{}_bucket{} {}'.format(
        metric, _format_labels(inf_labels),
        int(hist.get('count', cumulative))))
    suffix = _format_labels(labels)
    lines.append('{}_sum{} {}'.format(
        metric, suffix, _format_value(float(hist.get('sum', 0.0)))))
    lines.append('{}_count{} {}'.format(metric, suffix,
                                        int(hist.get('count', 0))))


def to_prometheus_text(snapshot: Dict[str, Any]) -> str:
    """Render a registry snapshot in the Prometheus text exposition format.

    Every metric emits a ``# HELP``/``# TYPE`` pair. Histograms emit the
    conventional cumulative ``_bucket{le=...}`` series plus ``_sum`` and
    ``_count``; bucket boundaries come from the histogram's power-of-two layout
    (``le`` values are in the histogram's base unit — seconds for latency
    stages). Counters map to ``counter``, gauges to ``gauge``. Metric names are
    sanitized onto the legal grammar ``[a-zA-Z_:][a-zA-Z0-9_:]*``
    (:func:`sanitize_metric_name`); whenever sanitization changed the id, the
    original rides a ``raw_name`` label so it stays queryable. Label values /
    HELP text are escaped per the exposition format (backslash, quote,
    newline — :func:`escape_label_value`), so a pathological stage name
    degrades to an ugly series, never to an exposition the scraper rejects.
    Every name starts with :data:`METRIC_PREFIX`."""
    lines: List[str] = []
    for name, value in sorted((snapshot.get('counters') or {}).items()):
        metric = _metric_name(name)
        series = _format_labels(_series_labels(name))
        lines.append(_help_line(metric, 'counter', name))
        lines.append('# TYPE {} counter'.format(metric))
        lines.append('{}{} {}'.format(metric, series, _format_value(value)))
    for name, value in sorted((snapshot.get('gauges') or {}).items()):
        metric = _metric_name(name)
        series = _format_labels(_series_labels(name))
        lines.append(_help_line(metric, 'gauge', name))
        lines.append('# TYPE {} gauge'.format(metric))
        lines.append('{}{} {}'.format(metric, series, _format_value(value)))
    for name, hist in sorted((snapshot.get('histograms') or {}).items()):
        metric = _metric_name(name)
        lines.append(_help_line(metric, 'histogram', name))
        lines.append('# TYPE {} histogram'.format(metric))
        _render_histogram_series(lines, metric, hist, _series_labels(name))
    return '\n'.join(lines) + '\n'


class JsonlEventLogger(object):
    """Append-only JSONL telemetry log: one ``{"ts", "event", "telemetry", ...}``
    object per line.

    ``maybe_emit`` is the periodic entry point — call it from any hot-ish loop
    (the device loader calls it once per yielded batch when
    ``PETASTORM_TPU_TELEMETRY_JSONL`` names a path); it writes at most once per
    ``interval_s`` and costs one monotonic-clock read otherwise. ``emit`` writes
    unconditionally (final flush, epoch boundary). Thread-safe; write failures
    disable the logger after one warning rather than breaking the pipeline.

    ``max_bytes`` (default None = unbounded, the prior behavior) caps the log
    file: when appending a line would push it past the cap, the current file
    rotates to ``<path>.1`` and a fresh file starts — a week-long run driven
    by ``PETASTORM_TPU_TELEMETRY_JSONL`` keeps bounded disk instead of
    filling it. ``max_rotations`` (default 1, the prior behavior) is how many
    rotated generations survive: each rotation shifts the chain
    ``<path>.1 -> <path>.2 -> ... -> <path>.N`` (the oldest falls off), so a
    long-running manifest log keeps ``(max_rotations + 1) * max_bytes`` of
    history instead of losing everything but one generation. Env forms:
    ``PETASTORM_TPU_TELEMETRY_JSONL_MAX_BYTES`` /
    ``PETASTORM_TPU_TELEMETRY_JSONL_ROTATIONS`` (read by
    :func:`logger_from_env`)."""

    def __init__(self, path: str, interval_s: float = 10.0,
                 max_bytes: Optional[int] = None,
                 max_rotations: int = 1) -> None:
        self._path = path
        self._interval_s = float(interval_s)
        self._max_bytes = int(max_bytes) if max_bytes else None
        self._max_rotations = max(1, int(max_rotations))
        self._lock = threading.Lock()
        self._next_emit = 0.0
        self._failed = False

    @property
    def path(self) -> str:
        """Destination file path."""
        return self._path

    def due(self) -> bool:
        """Cheap periodicity check (one clock read): True when the next
        ``maybe_emit`` would write. Lets hot loops skip building the snapshot
        entirely between intervals."""
        return not self._failed and time.monotonic() >= self._next_emit

    def maybe_emit(self, snapshot: Dict[str, Any], event: str = 'interval',
                   **extra: Any) -> bool:
        """Emit if at least ``interval_s`` elapsed since the last write; returns
        whether a line was written."""
        now = time.monotonic()
        if now < self._next_emit:
            return False
        return self.emit(snapshot, event=event, **extra)

    def emit(self, snapshot: Dict[str, Any], event: str = 'snapshot',
             **extra: Any) -> bool:
        """Append one JSONL record unconditionally; returns success.

        Dual-clock convention: every record carries
        BOTH ``ts_unix`` (``time.time()`` — aligns the stream with external
        monitoring systems that live on the wall clock) and ``ts_mono``
        (``time.perf_counter()`` — the same monotonic timebase the flight
        recorder's ``ts_us`` stamps use, so a JSONL record can be placed on a
        trace timeline without wall-clock skew). ``ts`` is kept as an alias of
        ``ts_unix`` for pre-existing consumers."""
        if self._failed:
            return False
        now_unix = time.time()
        record = {'ts': now_unix, 'ts_unix': now_unix,
                  'ts_mono': time.perf_counter(), 'event': event,
                  'pid': os.getpid(), 'telemetry': snapshot}
        record.update(extra)
        line = json.dumps(record) + '\n'
        with self._lock:
            self._next_emit = time.monotonic() + self._interval_s
            try:
                self._maybe_rotate(len(line))
                with open(self._path, 'a') as f:
                    f.write(line)
            except OSError:
                import logging
                logging.getLogger(__name__).warning(
                    'telemetry JSONL log %s is unwritable; disabling the logger',
                    self._path, exc_info=True)
                self._failed = True
                return False
        return True

    def _maybe_rotate(self, incoming_bytes: int) -> None:
        """Size-capped rotation (caller holds the lock): when the pending line
        would push the file past ``max_bytes``, the generation chain shifts —
        ``.{N-1} -> .N`` (oldest dropped), down to the current file becoming
        ``.1`` — each link an atomic ``os.replace``. A missing file counts as
        size 0; other stat errors fall through to the append, whose own
        failure path disables the logger."""
        if self._max_bytes is None:
            return
        try:
            size = os.path.getsize(self._path)
        except OSError:
            return  # nothing to rotate (first write, or unstatable path)
        if size + incoming_bytes <= self._max_bytes:
            return
        for generation in range(self._max_rotations - 1, 0, -1):
            older = '{}.{}'.format(self._path, generation)
            if os.path.exists(older):
                os.replace(older, '{}.{}'.format(self._path, generation + 1))
        os.replace(self._path, self._path + '.1')


def env_rotation_settings() -> Tuple[Optional[int], int]:
    """The ``(max_bytes, max_rotations)`` pair the env configures:
    ``$PETASTORM_TPU_TELEMETRY_JSONL_MAX_BYTES`` (default unbounded) arms
    size-capped rotation, ``$PETASTORM_TPU_TELEMETRY_JSONL_ROTATIONS``
    (default 1) sets how many rotated generations survive (read by
    :func:`logger_from_env`)."""
    raw_cap = os.environ.get('PETASTORM_TPU_TELEMETRY_JSONL_MAX_BYTES', '')
    try:
        max_bytes: Optional[int] = int(raw_cap) if raw_cap else None
    except ValueError:
        max_bytes = None
    raw_rotations = os.environ.get('PETASTORM_TPU_TELEMETRY_JSONL_ROTATIONS',
                                   '')
    try:
        max_rotations = int(raw_rotations) if raw_rotations else 1
    except ValueError:
        max_rotations = 1
    return max_bytes, max_rotations


def logger_from_env(interval_s: float = 10.0) -> Optional[JsonlEventLogger]:
    """A :class:`JsonlEventLogger` targeting ``$PETASTORM_TPU_TELEMETRY_JSONL``,
    or None when the variable is unset/empty.
    ``$PETASTORM_TPU_TELEMETRY_JSONL_MAX_BYTES`` (optional, default unbounded)
    arms size-capped rotation and
    ``$PETASTORM_TPU_TELEMETRY_JSONL_ROTATIONS`` (optional, default 1) sets
    the surviving generation count (:func:`env_rotation_settings`)."""
    path = os.environ.get('PETASTORM_TPU_TELEMETRY_JSONL')
    if not path:
        return None
    max_bytes, max_rotations = env_rotation_settings()
    return JsonlEventLogger(path, interval_s=interval_s, max_bytes=max_bytes,
                            max_rotations=max_rotations)


def load_snapshot(path: str) -> Dict[str, Any]:
    """Read a telemetry snapshot from ``path``: either a bare snapshot JSON file,
    a JSON report containing a ``telemetry`` key (``Reader.diagnostics``), or a
    JSONL event log (the LAST line's ``telemetry`` field wins — the cumulative
    view)."""
    with open(path) as f:
        text = f.read().strip()
    if not text:
        raise ValueError('{} is empty'.format(path))
    lines = text.splitlines()
    try:
        obj = json.loads(text)
    except ValueError:
        obj = json.loads(lines[-1])  # JSONL: last (cumulative) record
    if isinstance(obj, dict) and 'telemetry' in obj:
        obj = obj['telemetry']
    if isinstance(obj, dict) and 'snapshot' in obj and 'histograms' not in obj:
        obj = obj['snapshot']  # a report nesting it under telemetry.snapshot
    if not isinstance(obj, dict) or 'histograms' not in obj:
        raise ValueError('{} does not contain a telemetry snapshot '
                         '(expected a "histograms" key)'.format(path))
    return obj
