"""Export surfaces for the flight recorder: Chrome-trace/Perfetto JSON and the
anomaly/trace summary. A copy of ``petastorm_tpu.telemetry.trace_export``:
the same events give the same JSON in both packages (process tracks keep the
``petastorm_tpu consumer``/``worker`` labels).

:func:`to_chrome_trace` renders a :func:`~petastorm_tpu_torch.telemetry.tracing.
trace_snapshot` in the Chrome Trace Event format (the JSON dialect Perfetto's
https://ui.perfetto.dev loads directly): one track per process (worker
processes appear under their own pid with a ``petastorm_tpu worker`` label),
stage spans as complete ('X') slices, anomalies as instant ('i') markers, and
synthesized **flow arrows** (``s``/``f`` pairs) stitching each rowgroup's last
worker-side span to its first consumer-side event — the visual proof that one
``(epoch, rowgroup)``'s life crosses the process boundary.

:func:`summarize_trace` is the non-visual view: event counts by name, the
dropped-event count (drops are counted, never silent), every anomaly instant,
and the top-N longest rowgroup traces (first event to last event per
``(epoch, rowgroup)`` — the "what happened to THIS rowgroup during THAT
2-second stall" ranking).

CLI: ``python -m petastorm_tpu_torch.telemetry.trace_export <dataset_url> -o
trace.json`` captures a flight recording of a real read and writes the
Perfetto JSON (:func:`main`).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: Chrome-trace category for pipeline stage slices / anomaly instants / flows
_CAT_STAGE = 'stage'
_CAT_ANOMALY = 'anomaly'
_CAT_LIFECYCLE = 'lifecycle'
_CAT_FLOW = 'rowgroup'

#: instant names that mark a rowgroup's normal life, not an anomaly — they
#: stay on the timeline but out of the summary's anomaly list
LIFECYCLE_INSTANTS = frozenset({'ventilate', 'rowgroup_consumed'})


def _ctx_args(record: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    args = dict(record.get('args') or {})
    ctx = record.get('ctx')
    if ctx:
        args.update({'epoch': ctx[0], 'rowgroup': ctx[1], 'attempt': ctx[2]})
    return args or None


def to_chrome_trace(snapshot: Dict[str, Any]) -> Dict[str, Any]:
    """Render a trace snapshot as a Chrome-trace JSON dict (``{'traceEvents':
    [...], ...}``) loadable by Perfetto / ``chrome://tracing``.

    Emits per-process ``process_name`` metadata (the snapshot's own pid is the
    consumer; every other pid a worker), 'X' slices for stage spans, 'i'
    instants (process scope) for anomalies, and one ``s``→``f`` flow arrow per
    ``(epoch, rowgroup)`` whose events span more than one process — anchored at
    the end of the last producer-side event and the start of the first
    consumer-side event."""
    consumer_pid = int(snapshot.get('pid', 0))
    events: List[Dict[str, Any]] = []
    pids: Dict[int, int] = {}
    for record in snapshot.get('events') or []:
        pid = int(record['pid'])
        pids[pid] = pids.get(pid, 0) + 1
        entry: Dict[str, Any] = {
            'name': record['name'],
            'ph': record['ph'],
            'cat': (_CAT_STAGE if record['ph'] != 'i'
                    else _CAT_LIFECYCLE if record['name'] in LIFECYCLE_INSTANTS
                    else _CAT_ANOMALY),
            'pid': pid,
            'tid': int(record['tid']),
            'ts': round(float(record['ts_us']), 3),
        }
        if record['ph'] == 'X':
            entry['dur'] = round(float(record['dur_us']), 3)
        else:
            entry['s'] = 'p'  # instant scope: whole process track
        args = _ctx_args(record)
        if args:
            entry['args'] = args
        events.append(entry)
    events.extend(_flow_events(snapshot, consumer_pid))
    meta = [{'name': 'process_name', 'ph': 'M', 'pid': pid,
             'args': {'name': ('petastorm_tpu consumer (pid {})'.format(pid)
                               if pid == consumer_pid else
                               'petastorm_tpu worker (pid {})'.format(pid))}}
            for pid in sorted(pids)]
    return {'traceEvents': meta + sorted(events, key=lambda e: e.get('ts', 0)),
            'displayTimeUnit': 'ms',
            'otherData': {
                'producer': 'petastorm_tpu flight recorder',
                'dropped_events': int(snapshot.get('dropped_events', 0)),
            }}


def _flow_events(snapshot: Dict[str, Any],
                 consumer_pid: int) -> List[Dict[str, Any]]:
    """Synthesize one worker→consumer flow arrow per rowgroup whose events
    span two or more processes (binding by ``(epoch, rowgroup)`` — a
    re-ventilated attempt hands its flow to whichever attempt delivered)."""
    producer_last: Dict[Tuple[int, int], Dict[str, Any]] = {}
    consumer_events: Dict[Tuple[int, int], List[Dict[str, Any]]] = {}
    for record in snapshot.get('events') or []:
        ctx = record.get('ctx')
        if not ctx:
            continue
        key = (int(ctx[0]), int(ctx[1]))
        end_us = float(record['ts_us']) + float(record['dur_us'])
        if int(record['pid']) != consumer_pid:
            best = producer_last.get(key)
            if best is None or end_us > float(best['ts_us']) + float(best['dur_us']):
                producer_last[key] = record
        else:
            consumer_events.setdefault(key, []).append(record)
    flows: List[Dict[str, Any]] = []
    for key, producer in producer_last.items():
        handoff_us = float(producer['ts_us']) + float(producer['dur_us'])
        # the arrow lands on the first consumer-side event AFTER the worker
        # handed the rowgroup off (the ventilate instant precedes the worker's
        # spans and must not catch the arrow)
        arrivals = [record for record in consumer_events.get(key, ())
                    if float(record['ts_us']) >= handoff_us]
        if not arrivals:
            continue
        consumer = min(arrivals, key=lambda record: float(record['ts_us']))
        flow_id = 'rg-{}-{}'.format(key[0], key[1])
        flows.append({'name': _CAT_FLOW, 'cat': _CAT_FLOW, 'ph': 's',
                      'id': flow_id, 'pid': int(producer['pid']),
                      'tid': int(producer['tid']),
                      'ts': round(float(producer['ts_us'])
                                  + float(producer['dur_us']), 3)})
        flows.append({'name': _CAT_FLOW, 'cat': _CAT_FLOW, 'ph': 'f',
                      'bp': 'e', 'id': flow_id, 'pid': int(consumer['pid']),
                      'tid': int(consumer['tid']),
                      'ts': round(float(consumer['ts_us']), 3)})
    return flows


def write_chrome_trace(path: str, snapshot: Dict[str, Any]) -> Dict[str, Any]:
    """Write :func:`to_chrome_trace` JSON to ``path``; returns the trace dict."""
    trace = to_chrome_trace(snapshot)
    with open(path, 'w') as f:
        json.dump(trace, f)
    return trace


def summarize_trace(snapshot: Dict[str, Any], top_n: int = 5) -> Dict[str, Any]:
    """The summary view of a trace snapshot: ``{'events',
    'dropped_events', 'processes', 'by_name', 'anomaly_instants',
    'top_rowgroup_traces'}`` — all JSON-safe, never raises on an empty
    snapshot.

    ``top_rowgroup_traces`` ranks ``(epoch, rowgroup)`` groups by wall span
    (first event start to last event end) — the per-request tail-latency view
    aggregates cannot give; each entry lists the distinct delivery attempts
    seen, so a re-ventilation shows up as ``attempts: [0, 1]``."""
    records: Sequence[Dict[str, Any]] = snapshot.get('events') or []
    by_name: Dict[str, int] = {}
    instants: List[Dict[str, Any]] = []
    groups: Dict[Tuple[int, int], Dict[str, Any]] = {}
    pids = set()
    for record in records:
        pids.add(int(record['pid']))
        by_name[record['name']] = by_name.get(record['name'], 0) + 1
        if record['ph'] == 'i' and record['name'] not in LIFECYCLE_INSTANTS:
            instants.append({'name': record['name'],
                             'ts_us': round(float(record['ts_us']), 1),
                             'pid': int(record['pid']),
                             'ctx': record.get('ctx'),
                             'args': record.get('args')})
        ctx = record.get('ctx')
        if not ctx:
            continue
        key = (int(ctx[0]), int(ctx[1]))
        end_us = float(record['ts_us']) + float(record['dur_us'])
        group = groups.get(key)
        if group is None:
            group = {'start_us': float(record['ts_us']), 'end_us': end_us,
                     'events': 0, 'attempts': set(), 'pids': set()}
            groups[key] = group
        group['start_us'] = min(group['start_us'], float(record['ts_us']))
        group['end_us'] = max(group['end_us'], end_us)
        group['events'] += 1
        group['attempts'].add(int(ctx[2]))
        group['pids'].add(int(record['pid']))
    ranked = sorted(groups.items(),
                    key=lambda item: item[1]['end_us'] - item[1]['start_us'],
                    reverse=True)
    top = [{'epoch': key[0], 'rowgroup': key[1],
            'duration_ms': round((group['end_us'] - group['start_us']) / 1e3, 3),
            'events': group['events'],
            'attempts': sorted(group['attempts']),
            'processes': len(group['pids'])}
           for key, group in ranked[:max(top_n, 1)]]
    return {'events': len(records),
            'dropped_events': int(snapshot.get('dropped_events', 0)),
            'processes': sorted(pids),
            'rowgroups_traced': len(groups),
            'by_name': dict(sorted(by_name.items())),
            'anomaly_instants': instants,
            'top_rowgroup_traces': top if groups else []}


def format_trace_summary(summary: Dict[str, Any]) -> str:
    """Human-readable rendering of a :func:`summarize_trace` report."""
    lines = ['flight recorder: {} event(s) across {} process(es), '
             '{} rowgroup trace(s), {} dropped'.format(
                 summary.get('events', 0), len(summary.get('processes', [])),
                 summary.get('rowgroups_traced', 0),
                 summary.get('dropped_events', 0))]
    for instant in summary.get('anomaly_instants', [])[:10]:
        lines.append('  anomaly: {} ctx={} {}'.format(
            instant['name'], instant.get('ctx'), instant.get('args') or ''))
    for trace in summary.get('top_rowgroup_traces', []):
        lines.append('  slowest: epoch {} rowgroup {} — {} ms over {} event(s),'
                     ' attempts {}, {} process(es)'.format(
                         trace['epoch'], trace['rowgroup'],
                         trace['duration_ms'], trace['events'],
                         trace['attempts'], trace['processes']))
    return '\n'.join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    """CLI entry: capture a flight recording of a real read and write the
    Perfetto-loadable JSON."""
    import argparse
    parser = argparse.ArgumentParser(
        description='Capture a petastorm_tpu_torch flight recording: read a dataset '
                    'with tracing on and export Chrome-trace/Perfetto JSON '
                    '(load it at https://ui.perfetto.dev)')
    parser.add_argument('dataset_url')
    parser.add_argument('-o', '--output', default='petastorm_tpu_torch_trace.json',
                        help='output trace JSON path (default %(default)s)')
    parser.add_argument('-p', '--pool-type',
                        choices=['thread', 'process', 'dummy'],
                        default='process',
                        help='reader pool (process shows cross-process tracks)')
    parser.add_argument('-w', '--workers-count', type=int, default=2)
    parser.add_argument('-n', '--num-epochs', type=int, default=1)
    parser.add_argument('--batch-reader', action='store_true',
                        help='use make_batch_reader (plain Parquet stores)')
    parser.add_argument('--json', action='store_true',
                        help='print the summary as one JSON line instead')
    args = parser.parse_args(argv)

    from petastorm_tpu_torch.telemetry import tracing
    tracing.reset_tracing()
    tracing.set_trace_enabled(True)
    try:
        from petastorm_tpu_torch.reader import make_batch_reader, make_reader
        factory = make_batch_reader if args.batch_reader else make_reader
        rows = 0
        with factory(args.dataset_url, reader_pool_type=args.pool_type,
                     workers_count=args.workers_count,
                     num_epochs=args.num_epochs) as reader:
            for batch in reader.iter_columnar():
                rows += batch.num_rows
            snapshot = tracing.trace_snapshot()
            write_chrome_trace(args.output, snapshot)
    finally:
        tracing.set_trace_enabled(False)
    summary = summarize_trace(snapshot)
    summary['rows'] = rows
    summary['output'] = args.output
    if args.json:
        print(json.dumps(summary))
    else:
        print(format_trace_summary(summary))
        print('wrote {} ({} rows read) — open it at https://ui.perfetto.dev'
              .format(args.output, rows))
    return 0


if __name__ == '__main__':
    import sys
    sys.exit(main())
