"""Persistent per-rowgroup / per-field cost profiler: a copy of
``petastorm_tpu.telemetry.cost_model``.

The flight recorder records every ``rowgroup_read`` / ``decode`` span tagged
with its ``(epoch, rowgroup, attempt)`` context (and per-field
``decode_field`` spans while tracing is armed); this module folds that span
history into a :class:`CostLedger` keyed by the dataset token, persists it as
an atomic JSON sidecar (temp file + ``os.replace``) and reloads it across
runs. The file format, the keys of :meth:`CostLedger.to_dict` and the sidecar
name are the JAX package's, so a ledger written by either package loads in
the other.

Consumers: ``petastorm-tpu-torch-throughput costs <dataset_url>`` (one
trace-armed epoch folded into the ledger, the expensive rowgroups, the
p95/median skew and the what-if rows), :meth:`Reader.cost_ledger` over any
traced read, and the cost-aware scheduler
(:mod:`~petastorm_tpu_torch.schedule`), which reads the persisted ledger:
``make_reader(cost_schedule=True)`` interleaves and splits from it, and
``costs --json`` carries a ``schedule_preview`` of its plan.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Mapping, Optional, Tuple

#: stage spans folded into per-rowgroup costs — must be a subset of
#: ``spans.STAGES`` (pipecheck's telemetry-names rule enforces it); the sum
#: over these IS a rowgroup's cost (``decode_field`` nests inside ``decode``
#: and is tracked separately per field, never added to the total)
COST_STAGES = ('rowgroup_read', 'decode', 'range_fetch')

#: the per-field span name (emitted by the decode plan while tracing is on)
FIELD_STAGE = 'decode_field'

#: ledger file format version (bumped on incompatible schema changes)
LEDGER_VERSION = 1

#: default ledger basename pattern next to the disk cache / dataset
LEDGER_BASENAME = '_petastorm_tpu_costs_{token}.json'


def percentile(sorted_values: List[float], q: float) -> float:
    """Deterministic nearest-rank percentile over an ASCENDING-sorted list
    (``q`` clamped into [0, 1]; empty input -> 0.0). Nearest-rank (not
    interpolated) so persist → reload → recompute is bit-identical, and the
    rank is double-clamped so a tiny population (a 1-entry ledger) can never
    IndexError."""
    if not sorted_values:
        return 0.0
    q = min(1.0, max(0.0, float(q)))
    rank = min(len(sorted_values) - 1,
               max(0, int(math.ceil(q * len(sorted_values))) - 1))
    return sorted_values[rank]


def default_ledger_path(dataset_url_or_path: str, dataset_token: str,
                        cache_location: Optional[str] = None
                        ) -> Optional[str]:
    """Where the ledger sidecar lives: the dataset's local state home
    (:func:`petastorm_tpu_torch.dataset_state.sidecar_path` — next to the disk
    cache when one is configured, else next to a LOCAL dataset); None for
    remote stores with no cache — the caller must pass an explicit path."""
    from petastorm_tpu_torch.dataset_state import sidecar_path
    return sidecar_path(dataset_url_or_path,
                        LEDGER_BASENAME.format(token=dataset_token),
                        cache_location)


class CostLedger(object):
    """Per-rowgroup cost history for ONE dataset token (module docstring).

    Entries are keyed ``'<fragment_path>#<row_group_id>'`` and hold per-stage
    ``{count, sum_s, max_s}`` plus per-field ``{count, sum_s}`` decode costs.
    A ``range_fetch`` span (the JAX package's storage engine; the port has
    no such engine yet, but loads and merges ledgers that carry it) folds its
    per-fetch totals into an optional ``fetch`` cell per entry: ``{bytes,
    ranges, hedges_fired, hedges_won, sum_s, count}``.
    All mutation is additive, so ledgers merge across runs, processes and
    re-dispatched attempts exactly like histogram snapshots do."""

    def __init__(self, dataset_token: str) -> None:
        self.dataset_token = dataset_token
        self._entries: Dict[str, Dict[str, Any]] = {}

    # ------------------------------------------------------------ ingestion

    @staticmethod
    def _rowgroup_key(fragment_path: str, row_group_id: Any) -> str:
        return '{}#{}'.format(fragment_path,
                              row_group_id if row_group_id is not None
                              else 'all')

    def _entry(self, key: str) -> Dict[str, Any]:
        entry = self._entries.get(key)
        if entry is None:
            entry = {'stages': {}, 'fields': {}}
            self._entries[key] = entry
        return entry

    def ingest_trace(self, trace_snapshot: Mapping[str, Any],
                     piece_map: Mapping[int, Tuple[str, Any]]) -> int:
        """Fold one flight-recorder snapshot
        (:func:`~petastorm_tpu_torch.telemetry.tracing.trace_snapshot`) into the
        ledger. ``piece_map`` maps the trace context's rowgroup piece index
        to ``(fragment_path, row_group_id)`` — the reader's shard
        enumeration. Spans of re-dispatched attempts accumulate additively
        (the rowgroup genuinely cost that much fleet time). Returns the
        number of spans ingested."""
        ingested = 0
        for event in trace_snapshot.get('events') or []:
            if event.get('ph') != 'X':
                continue
            name = event.get('name')
            is_field = name == FIELD_STAGE
            if name not in COST_STAGES and not is_field:
                continue
            ctx = event.get('ctx')
            if not ctx or len(ctx) < 2:
                continue
            located = piece_map.get(int(ctx[1]))
            if located is None:
                continue
            seconds = float(event.get('dur_us', 0.0)) / 1e6
            entry = self._entry(self._rowgroup_key(located[0], located[1]))
            if is_field:
                args = event.get('args') or {}
                field = args.get('field')
                if not field:
                    continue
                cell = entry['fields'].setdefault(
                    str(field), {'count': 0, 'sum_s': 0.0})
                cell['count'] += 1
                cell['sum_s'] += seconds
            else:
                cell = entry['stages'].setdefault(
                    str(name), {'count': 0, 'sum_s': 0.0, 'max_s': 0.0})
                cell['count'] += 1
                cell['sum_s'] += seconds
                cell['max_s'] = max(float(cell['max_s']), seconds)
                if name == 'range_fetch':
                    self._fold_fetch(entry, event.get('args') or {}, seconds)
            ingested += 1
        return ingested

    @staticmethod
    def _fold_fetch(entry: Dict[str, Any], args: Mapping[str, Any],
                    seconds: float) -> None:
        """Fold one ``range_fetch`` span's trace args (bytes / ranges /
        hedge totals) into the entry's additive
        ``fetch`` cell."""
        cell = entry.setdefault('fetch', {
            'bytes': 0, 'ranges': 0, 'hedges_fired': 0, 'hedges_won': 0,
            'sum_s': 0.0, 'count': 0})
        cell['bytes'] += int(args.get('bytes', 0))
        cell['ranges'] += int(args.get('ranges', 0))
        cell['hedges_fired'] += int(args.get('hedges_fired', 0))
        cell['hedges_won'] += int(args.get('hedges_won', 0))
        cell['sum_s'] += seconds
        cell['count'] += 1

    def merge(self, other: 'CostLedger') -> None:
        """Fold another ledger in additively (same dataset token required —
        costs of different field sets / stores must never mix)."""
        if other.dataset_token != self.dataset_token:
            raise ValueError(
                'cannot merge cost ledgers of different dataset tokens '
                '({!r} vs {!r}) — the store, field set or decode mode '
                'differ'.format(other.dataset_token, self.dataset_token))
        for key, entry in other._entries.items():
            mine = self._entry(key)
            for stage, cell in entry['stages'].items():
                acc = mine['stages'].setdefault(
                    stage, {'count': 0, 'sum_s': 0.0, 'max_s': 0.0})
                acc['count'] += int(cell['count'])
                acc['sum_s'] += float(cell['sum_s'])
                acc['max_s'] = max(float(acc['max_s']), float(cell['max_s']))
            for field, cell in entry['fields'].items():
                acc = mine['fields'].setdefault(
                    field, {'count': 0, 'sum_s': 0.0})
                acc['count'] += int(cell['count'])
                acc['sum_s'] += float(cell['sum_s'])
            fetch = entry.get('fetch')
            if fetch:
                acc = mine.setdefault('fetch', {
                    'bytes': 0, 'ranges': 0, 'hedges_fired': 0,
                    'hedges_won': 0, 'sum_s': 0.0, 'count': 0})
                for k in ('bytes', 'ranges', 'hedges_fired', 'hedges_won',
                          'count'):
                    acc[k] += int(fetch.get(k, 0))
                acc['sum_s'] += float(fetch.get('sum_s', 0.0))

    # ------------------------------------------------------------- analysis

    def __len__(self) -> int:
        return len(self._entries)

    def rowgroup_cost(self, key: str) -> float:
        """Total recorded cost of one rowgroup (sum over ``COST_STAGES``)."""
        entry = self._entries.get(key)
        if entry is None:
            return 0.0
        return sum(float(cell['sum_s'])
                   for stage, cell in entry['stages'].items()
                   if stage in COST_STAGES)

    def total_seconds(self) -> float:
        """Total recorded cost across every rowgroup."""
        return sum(self.rowgroup_cost(key) for key in self._entries)

    def ranking(self, top_n: int = 10) -> List[Dict[str, Any]]:
        """The most expensive rowgroups, descending (ties broken by key so
        the order survives persist → reload byte-identically): ``{'rowgroup',
        'seconds', 'share', 'stages', 'top_fields'}`` rows."""
        total = self.total_seconds()
        costs = sorted(((self.rowgroup_cost(key), key)
                        for key in self._entries),
                       key=lambda item: (-item[0], item[1]))
        rows = []
        for seconds, key in costs[:max(top_n, 1)]:
            entry = self._entries[key]
            fields = sorted(((float(cell['sum_s']), field)
                             for field, cell in entry['fields'].items()),
                            key=lambda item: (-item[0], item[1]))
            row = {
                'rowgroup': key,
                'seconds': round(seconds, 6),
                'share': round(seconds / total, 4) if total else 0.0,
                'stages': {stage: round(float(cell['sum_s']), 6)
                           for stage, cell in sorted(entry['stages'].items())},
                'top_fields': [{'field': field, 'seconds': round(s, 6)}
                               for s, field in fields[:3]],
            }
            fetch = entry.get('fetch')
            if fetch:
                row['fetch'] = {
                    'bytes': int(fetch['bytes']),
                    'ranges': int(fetch['ranges']),
                    'hedges_fired': int(fetch['hedges_fired']),
                    'hedges_won': int(fetch['hedges_won']),
                    'seconds': round(float(fetch['sum_s']), 6),
                }
            rows.append(row)
        return rows

    def what_if(self) -> List[Dict[str, Any]]:
        """What-if rows for the bottleneck report: per scope (``total`` plus
        each cost stage), "if every rowgroup costing more than the p95
        dropped to the median, total {scope} time −X%" — the skew exposure a
        cost-aware scheduler would exploit. Deterministic (nearest-rank
        percentiles, sorted keys), so persist → reload → recompute yields an
        identical ranking."""
        rows: List[Dict[str, Any]] = []
        scopes: List[Tuple[str, Dict[str, float]]] = []
        totals = {key: self.rowgroup_cost(key) for key in self._entries}
        scopes.append(('total', totals))
        for stage in COST_STAGES:
            per_stage = {
                key: float(entry['stages'].get(stage, {}).get('sum_s', 0.0))
                for key, entry in self._entries.items()}
            scopes.append((stage, per_stage))
        for scope, costs in scopes:
            values = sorted(v for v in costs.values() if v > 0.0)
            if not values:
                if not costs:
                    continue
                # every entry recorded zero for this scope (e.g. a ledger from
                # a clock too coarse to time a trivial stage): emit an honest
                # flat row — skew 1.0, nothing to save — instead of silently
                # dropping the scope (or dividing by a zero median)
                rows.append({
                    'scope': scope, 'rowgroups': len(costs),
                    'total_s': 0.0, 'median_s': 0.0, 'p95_s': 0.0,
                    'skew_p95_over_median': 1.0, 'saving_fraction': 0.0,
                    'detail': 'no {} cost recorded — flat distribution, '
                              'nothing to reschedule'.format(scope),
                })
                continue
            total = sum(values)
            median = percentile(values, 0.5)
            p95 = percentile(values, 0.95)
            # "the p95 cost drops to the median": every rowgroup AT or above
            # the p95 is capped (>= — with nearest-rank percentiles over a
            # small population the p95 IS the max, and the tail must still
            # count); a flat distribution (p95 == median) saves nothing
            capped = sum(median if (v >= p95 and p95 > median) else v
                         for v in values)
            saving = (total - capped) / total if total else 0.0
            rows.append({
                'scope': scope,
                'rowgroups': len(values),
                'total_s': round(total, 6),
                'median_s': round(median, 6),
                'p95_s': round(p95, 6),
                # a flat (all-equal, incl. single-rowgroup) distribution is
                # skew 1.0 by definition — never NaN/0.0, so dashboards can
                # alert on "skew > threshold" without special cases
                'skew_p95_over_median': round(p95 / median, 3)
                if median > 0.0 else 1.0,
                'saving_fraction': round(saving, 4),
                'detail': 'if every rowgroup above the p95 {} cost dropped '
                          'to the median, total {} time -{:.1%}'.format(
                              scope, scope, saving),
            })
        rows.sort(key=lambda row: (-row['saving_fraction'], row['scope']))
        return rows

    # ---------------------------------------------------------- persistence

    def to_dict(self) -> Dict[str, Any]:
        """JSON-safe ledger document (sorted keys — stable on disk)."""
        return {
            'version': LEDGER_VERSION,
            'dataset_token': self.dataset_token,
            'rowgroups': {key: self._entries[key]
                          for key in sorted(self._entries)},
        }

    @classmethod
    def from_dict(cls, doc: Mapping[str, Any]) -> 'CostLedger':
        """Rebuild a ledger from :meth:`to_dict` output (version-checked)."""
        if int(doc.get('version', -1)) != LEDGER_VERSION:
            raise ValueError('unsupported cost-ledger version {!r} '
                             '(this build reads version {})'.format(
                                 doc.get('version'), LEDGER_VERSION))
        ledger = cls(str(doc['dataset_token']))
        for key, entry in (doc.get('rowgroups') or {}).items():
            mine = ledger._entry(str(key))
            for stage, cell in (entry.get('stages') or {}).items():
                mine['stages'][str(stage)] = {
                    'count': int(cell['count']),
                    'sum_s': float(cell['sum_s']),
                    'max_s': float(cell['max_s'])}
            for field, cell in (entry.get('fields') or {}).items():
                mine['fields'][str(field)] = {
                    'count': int(cell['count']),
                    'sum_s': float(cell['sum_s'])}
            fetch = entry.get('fetch')
            if fetch:
                # optional additive cell (absent in pre-storage-engine
                # ledgers — same LEDGER_VERSION, purely additive schema)
                mine['fetch'] = {
                    'bytes': int(fetch.get('bytes', 0)),
                    'ranges': int(fetch.get('ranges', 0)),
                    'hedges_fired': int(fetch.get('hedges_fired', 0)),
                    'hedges_won': int(fetch.get('hedges_won', 0)),
                    'sum_s': float(fetch.get('sum_s', 0.0)),
                    'count': int(fetch.get('count', 0))}
        return ledger

    def save(self, path: str) -> str:
        """Atomically persist the ledger: write ``<path>.tmp.<pid>``, then
        ``os.replace`` — a reader or a crashed writer can never observe a
        half-written sidecar. Returns ``path``."""
        tmp = '{}.tmp.{}'.format(path, os.getpid())
        with open(tmp, 'w') as f:
            json.dump(self.to_dict(), f, sort_keys=True)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> 'CostLedger':
        """Read a persisted ledger (:meth:`save` format)."""
        with open(path) as f:
            return cls.from_dict(json.load(f))


def format_cost_report(ledger: CostLedger, top_n: int = 5) -> str:
    """Human-readable ledger summary: totals, top-N expensive rowgroups
    (with their dominant fields), and the what-if rows."""
    lines = ['per-rowgroup cost ledger (dataset token {}, {} rowgroup(s), '
             '{:.3f}s recorded)'.format(ledger.dataset_token, len(ledger),
                                        ledger.total_seconds())]
    for row in ledger.ranking(top_n):
        fields = ', '.join('{} {:.3f}s'.format(f['field'], f['seconds'])
                           for f in row['top_fields'])
        lines.append('  {:>6.1%}  {:>9.3f}s  {}{}'.format(
            row['share'], row['seconds'], row['rowgroup'],
            '  [{}]'.format(fields) if fields else ''))
    for row in ledger.what_if():
        lines.append('  [what-if] {}'.format(row['detail']))
    if len(ledger) == 0:
        lines.append('  (empty — run a trace-armed read first: '
                     'petastorm-tpu-torch-throughput costs <dataset_url>)')
    return '\n'.join(lines)


def profile_dataset(dataset_url: str, workers: int = 2,
                    ledger_path: Optional[str] = None,
                    **reader_kwargs: Any) -> Tuple[CostLedger, str]:
    """One trace-armed epoch over ``dataset_url`` folded into the persisted
    ledger (created when absent): the ``costs`` CLI's engine. Returns
    ``(ledger, path)``. A user-armed flight capture
    (``PETASTORM_TPU_TRACE=1``) is left intact; otherwise the recorder is
    armed for just this read and restored after.

    ``reader_kwargs`` go to ``make_reader`` (the port's addition): the read
    configuration (fields, ``device_decode_fields``, ...) is part of the
    ledger's dataset token, and a scheduled reader plans only from a ledger
    of its own configuration."""
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.telemetry import tracing
    was_enabled = tracing.trace_enabled()
    try:
        if not was_enabled:
            tracing.reset_tracing()
            tracing.set_trace_enabled(True)
        with make_reader(dataset_url, workers_count=workers, num_epochs=1,
                         shuffle_row_groups=False, **reader_kwargs) as reader:
            for _ in reader.iter_columnar():
                pass
            ledger = reader.cost_ledger()
            token = reader.dataset_token
    finally:
        tracing.set_trace_enabled(was_enabled)
        if not was_enabled:
            tracing.reset_tracing()
    path = ledger_path or default_ledger_path(dataset_url, token)
    if path is None:
        raise ValueError(
            'no default ledger location for remote store {!r} — pass '
            '--ledger <path> (or configure a local disk cache)'.format(
                dataset_url))
    if os.path.exists(path):
        try:
            previous = CostLedger.load(path)
            ledger.merge(previous)
        except ValueError as exc:
            import logging
            logging.getLogger(__name__).warning(
                'existing cost ledger at %s is incompatible (%s); '
                'starting fresh', path, exc)
    ledger.save(path)
    return ledger, path


def main(argv: Optional[List[str]] = None) -> int:
    """``petastorm-tpu-torch-throughput costs`` entry: profile one epoch (or just
    inspect an existing ledger with ``--no-read``), persist, print."""
    import argparse
    parser = argparse.ArgumentParser(
        description='Profile per-rowgroup read+decode costs into a '
                    'persistent ledger and rank the expensive rowgroups')
    parser.add_argument('dataset_url')
    parser.add_argument('--ledger', default=None,
                        help='ledger sidecar path (default: next to a local '
                             'dataset / the disk cache)')
    parser.add_argument('--workers', type=int, default=2,
                        help='reader workers for the profiling epoch')
    parser.add_argument('--top', type=int, default=5,
                        help='expensive rowgroups to print (default 5)')
    parser.add_argument('--no-read', action='store_true',
                        help='skip the profiling read; just load and print '
                             'the existing ledger (--ledger required)')
    parser.add_argument('--json', action='store_true',
                        help='print one machine-readable JSON line instead')
    args = parser.parse_args(argv)
    if args.no_read:
        if not args.ledger:
            parser.error('--no-read requires --ledger')
        ledger = CostLedger.load(args.ledger)
        path = args.ledger
    else:
        ledger, path = profile_dataset(args.dataset_url,
                                       workers=args.workers,
                                       ledger_path=args.ledger)
    if args.json:
        # schedule_preview: what the cost-aware scheduler WOULD do with this
        # ledger (planned interleave order + split decisions) so operators
        # can inspect the plan without running an epoch
        from petastorm_tpu_torch.schedule import plan_preview
        print(json.dumps({'ledger_path': path,
                          'dataset_token': ledger.dataset_token,
                          'rowgroups': len(ledger),
                          'total_seconds': round(ledger.total_seconds(), 6),
                          'ranking': ledger.ranking(args.top),
                          'what_if': ledger.what_if(),
                          'schedule_preview': plan_preview(ledger)}))
    else:
        print(format_cost_report(ledger, top_n=args.top))
        print('ledger: {}'.format(path))
    return 0


if __name__ == '__main__':
    import sys
    sys.exit(main())
