"""Bottleneck attribution: rank pipeline stages by time share and map the top
stage to the knob that moves it. A copy of ``petastorm_tpu.telemetry.analyze``
(its advice names the port's objects; the cost profiler's ``what_if`` rows
wait with the cost model).

The input is any telemetry snapshot (``Reader.diagnostics['telemetry']``,
``TorchDataLoader.telemetry_snapshot()``, a JSONL event log). Shares are
computed over the LEAF latency stages only — envelope stages like
``cache_miss`` (which wraps ``rowgroup_read`` + ``decode``) are reported but
excluded from the denominator, so the shares of independent work sum sensibly.
Stage seconds are summed across every process and thread that contributed, so
a share is "fraction of all pipeline CPU/IO time", not wall-clock — with N
parallel workers a 0.9 share can still hide behind prefetch, which is why the
report pairs the ranking with the consumer-side ``shuffle_wait``/``pool_wait``
stages: those measure time the TRAINING side actually sat idle.

CLI: ``python -m petastorm_tpu_torch.telemetry.analyze <snapshot.json|events.jsonl>``.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, List, Optional

from petastorm_tpu_torch.telemetry.registry import SECONDS_UNIT
from petastorm_tpu_torch.telemetry.spans import ENVELOPE_STAGES

#: knob advice per dominant stage: (headline, detail) — the JAX package's
#: headlines, with details that name the port's objects
_KNOBS: Dict[str, Any] = {
    'fs_open': ('check storage connectivity / keep filesystems warm',
                'Filesystem construction dominates: remote stores with flaky '
                'connections reconnect per retry — check on_error/retry_policy '
                'counters and the storage backend before touching pool knobs.'),
    'rowgroup_read': ('raise workers_count (IO-bound read)',
                      'Parquet rowgroup IO dominates: more parallel readers '
                      'overlap more IO (workers_count), and a local-disk cache '
                      '(cache_type="local-disk", cache_format="arrow-ipc") '
                      'removes the re-read on warm epochs entirely.'),
    'decode': ('raise workers_count or cache decoded rowgroups',
               'Codec decode dominates: decode parallelizes across workers '
               '(workers_count; reader_pool_type="process" escapes the GIL for '
               'pure-python codecs), and cache_format="arrow-ipc" makes warm '
               'epochs skip decode via zero-copy mmap hits.'),
    'shuffle': ('lower shuffle cost (shuffle_rows=False or smaller rowgroups)',
                'In-rowgroup shuffling dominates — unusual; consider '
                'shuffle_rows=False plus a loader shuffling buffer.'),
    'transform': ('vectorize the TransformSpec or move it on-device',
                  'TransformSpec dominates: batched (make_batch_reader) '
                  'transforms amortize per-row Python cost; device-side ops '
                  '(petastorm_tpu_torch.ops) remove it from the host entirely.'),
    'cache_hit': ('cache serving dominates — use cache_format="arrow-ipc"',
                  'Cache hits dominate and are slow: the pickle cache format '
                  'pays a full unpickle per hit; arrow-ipc serves zero-copy '
                  'mmap views.'),
    'cache_store': ('cache writes dominate — put cache_location on faster disk',
                    'Filling the rowgroup cache dominates: first-epoch-only '
                    'cost; if it persists, the cache disk is too slow or the '
                    'size limit is forcing eviction churn.'),
    'serialize': ('shrink the wire payload (arrow-ipc serializer, fewer fields)',
                  'Worker-side result serialization dominates: columns that '
                  'are not numeric arrays fall off the Arrow IPC path into '
                  'the pickled sidecar; trim schema_fields.'),
    'shm_slot_wait': ('raise shm_slot_bytes / shm_slots_per_worker',
                      'Workers block waiting for free shm ring slots: the '
                      'consumer is not releasing slots fast enough for the '
                      'configured ring — more/bigger slots (the pool\'s '
                      'set_shm_slot_config, for its next ring) or a faster '
                      'consumer loop.'),
    'shm_map': ('payload deserialize dominates — check sidecar columns',
                'Mapping shm results dominates consumer time: columns falling '
                'into the pickled sidecar (ragged/object dtypes) copy on every '
                'batch; keep columns numeric/uniform for zero-copy receive.'),
    'shm_release': ('slot release dominates — raise shm_slots_per_worker',
                    'Releasing shm slots dominates — pipe backpressure; more '
                    'slots per worker decouple the ack path.'),
    'pool_wait': ('raise workers_count (consumer starved)',
                  'The consumer sits idle in pool.get_results: the worker pool '
                  'cannot keep up — raise workers_count, or remove the '
                  'bottleneck the worker-side ranking names.'),
    'shuffle_wait': ('raise workers_count / prefetch (input-bound training)',
                     'The training loop blocks on the input pipeline: raise '
                     'workers_count and loader prefetch; if worker stages are '
                     'cheap, the host->device link is the limit (see h2d).'),
    'collate': ('batch assembly dominates — larger batches / fewer ragged pads',
                'Host batch assembly (sanitize/pad) dominates: bigger '
                'batch_size amortizes per-batch cost; pad_ragged fields copy '
                'every row — pack or pre-pad in the store.'),
    'h2d': ('coalesce uploads / raise batch size (link-bound)',
            'Host->device transfer dominates: coalesce_fields=True collapses '
            'per-field transfers to one; a larger batch_size amortizes '
            'per-transfer dispatch RTT; scan_stream uploads whole chunks.'),
    'cache_miss': ('first-epoch fills — see rowgroup_read/decode',
                   'cache_miss envelopes the fill work; the leaf ranking names '
                   'the actual cost.'),
    'device_decode': ('decode-tail host half dominates — check inflate share',
                      'The device decode tail spends host time packing or '
                      'inflating raw payloads before upload: stored-block '
                      'frames inflate on the card (the stored-copy kernel) — '
                      're-encode stores at zlib level 0, or move '
                      'huffman-heavy fields back to host decode.'),
    'd2d_wait': ('raise device_buffer_depth (decode-bound device tail)',
                 'The producer blocks on the prefetch-to-device ring: device '
                 'decode programs finish slower than batches arrive — raise '
                 'TorchDataLoader device_buffer_depth so more decode work '
                 'overlaps the train step, or shrink the augment chain.'),
    # ------------------------------------------------------ input service
    # Service-backed readers surface their pressure as COUNTERS/GAUGES, not
    # stage histograms — these entries feed the counter advisories below. The
    # port has no input service yet; a JAX package snapshot read through this
    # module still gets the same advice.
    'service_busy': ('raise the admission window or add decode workers',
                     'The dispatcher rejected submits with busy: the '
                     'per-client in-flight window is full. If the queue is '
                     'shallow, raise the admission window (serve CLI '
                     '--admission-window, or Dispatcher(autotune=True) to '
                     'retune it live); if deep, the fleet is saturated — add '
                     'workers (ServiceFleet.spawn_worker).'),
    'service_resubmit': ('co-located shm delivery is flaky — check /dev/shm',
                         'Items were re-requested after shm segment '
                         'attach/verify failures: false co-location or an '
                         'exhausted /dev/shm. Redeliveries are wire-pinned, '
                         'so throughput degrades to TCP — fix the segment '
                         'store or run the clients truly co-located.'),
    'service_queue_depth': ('queue depth exceeds the fleet — add workers',
                            'Accepted items sit queued behind a saturated '
                            'worker fleet: admission is not the limit, decode '
                            'capacity is — add service workers or lower '
                            'client demand.'),
}

_DEFAULT_ADVICE = ('inspect the stage histogram',
                   'No canned knob for this stage; inspect its histogram in the '
                   'snapshot.')

#: counter names that trigger a service advisory when non-zero in the
#: snapshot (the service's pressure signals have no latency histogram).
#: NOTE the semantics follow the snapshot handed in: a cumulative snapshot
#: (diagnostics dump, the analyze CLI) advises on totals since process start,
#: a window delta (the autotune controller's snapshot_delta) on fresh
#: movement only — the 'value' field says how much either way.
_ADVISORY_COUNTERS = ('service_busy', 'service_resubmit')
#: gauge names that trigger an advisory when non-zero
_ADVISORY_GAUGES = ('service_queue_depth',)


def _service_advisories(snapshot: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Counter/gauge-driven advice rows for service-backed readers: each
    non-zero advisory signal yields ``{'signal', 'value', 'recommendation',
    'detail'}`` from the ``_KNOBS`` map — the canned advice the stage ranking
    cannot provide for non-histogram pressure."""
    advisories = []
    counters = snapshot.get('counters') or {}
    gauges = snapshot.get('gauges') or {}
    for name in _ADVISORY_COUNTERS:
        value = int(counters.get(name, 0) or 0)
        if value > 0:
            headline, detail = _KNOBS[name]
            advisories.append({'signal': name, 'value': value,
                               'recommendation': headline, 'detail': detail})
    for name in _ADVISORY_GAUGES:
        value = float(gauges.get(name, 0) or 0)
        if value > 0:
            headline, detail = _KNOBS[name]
            advisories.append({'signal': name, 'value': value,
                               'recommendation': headline, 'detail': detail})
    return advisories


def attribute_bottleneck(snapshot: Dict[str, Any],
                         top_n: int = 5) -> Dict[str, Any]:
    """Rank leaf stages by total-time share and name the knob for the top one.

    Returns ``{'total_stage_seconds', 'ranked': [{'stage', 'seconds', 'share',
    'count', 'mean_s'}], 'top_stage', 'top_share', 'recommendation', 'detail',
    'envelopes': {stage: seconds}, 'advisories': [...]}`` — all JSON-safe.
    ``advisories`` carries the counter/gauge-driven service advice rows
    (``service_busy``/``service_resubmit``/``service_queue_depth`` — pressure
    that has no latency histogram to rank). An empty snapshot yields
    ``top_stage=None`` with a no-data recommendation (never raises)."""
    histograms = snapshot.get('histograms') or {}
    leaves = []
    envelopes = {}
    for name, hist in histograms.items():
        if float(hist.get('unit', SECONDS_UNIT)) != SECONDS_UNIT:
            continue  # size histograms (bytes) are not time shares
        total = float(hist.get('sum', 0.0))
        if total <= 0:
            continue
        if name in ENVELOPE_STAGES:
            envelopes[name] = round(total, 6)
        else:
            leaves.append((name, total, int(hist.get('count', 0))))
    leaves.sort(key=lambda item: item[1], reverse=True)
    total_s = sum(total for _, total, _ in leaves)
    ranked = [{'stage': name,
               'seconds': round(total, 6),
               'share': round(total / total_s, 4) if total_s else 0.0,
               'count': count,
               'mean_s': round(total / count, 6) if count else 0.0}
              for name, total, count in leaves[:max(top_n, 1)]]
    advisories = _service_advisories(snapshot)
    if not ranked:
        return {'total_stage_seconds': 0.0, 'ranked': [], 'envelopes': envelopes,
                'top_stage': None, 'top_share': 0.0,
                'advisories': advisories,
                'recommendation': 'no stage timings recorded',
                'detail': 'The snapshot holds no latency histograms — run an '
                          'instrumented read first (telemetry is on by default; '
                          'PETASTORM_TPU_TELEMETRY=0 disables it).'}
    top = ranked[0]
    headline, detail = _KNOBS.get(top['stage'], _DEFAULT_ADVICE)
    return {'total_stage_seconds': round(total_s, 6),
            'ranked': ranked,
            'envelopes': envelopes,
            'top_stage': top['stage'],
            'top_share': top['share'],
            'advisories': advisories,
            'recommendation': headline,
            'detail': detail}


def format_report(report: Dict[str, Any]) -> str:
    """Human-readable rendering of an :func:`attribute_bottleneck` report."""
    lines = ['pipeline stage attribution '
             '(total {:.3f}s of stage time across all processes)'.format(
                 report.get('total_stage_seconds', 0.0))]
    for entry in report.get('ranked', []):
        lines.append('  {:>6.1%}  {:<14} {:>10.3f}s  ({} spans, mean {:.3f}ms)'
                     .format(entry['share'], entry['stage'], entry['seconds'],
                             entry['count'], entry['mean_s'] * 1e3))
    for stage, seconds in sorted((report.get('envelopes') or {}).items()):
        lines.append('  [envelope] {:<14} {:>7.3f}s (wraps leaf stages above)'
                     .format(stage, seconds))
    if report.get('top_stage'):
        lines.append('  bottleneck: {} ({:.1%}) -> {}'.format(
            report['top_stage'], report['top_share'],
            report['recommendation']))
        lines.append('  {}'.format(report.get('detail', '')))
    else:
        lines.append('  ' + report.get('recommendation', 'no data'))
    for advisory in report.get('advisories') or []:
        lines.append('  [service] {}={:g} -> {}'.format(
            advisory['signal'], advisory['value'],
            advisory['recommendation']))
    return '\n'.join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    """``analyze`` CLI entry: load a snapshot file, print the attribution report
    (or ``--json`` one machine-readable line)."""
    import argparse
    parser = argparse.ArgumentParser(
        description='Rank petastorm_tpu_torch pipeline stages by time share and name '
                    'the knob that moves the top one')
    parser.add_argument('snapshot_path',
                        help='telemetry snapshot: a JSON snapshot/report file or '
                             'a JSONL event log (last line wins)')
    parser.add_argument('--json', action='store_true',
                        help='print one machine-readable JSON line instead')
    parser.add_argument('--top', type=int, default=5,
                        help='stages to rank (default 5)')
    args = parser.parse_args(argv)
    from petastorm_tpu_torch.telemetry.export import load_snapshot
    snapshot = load_snapshot(args.snapshot_path)
    report = attribute_bottleneck(snapshot, top_n=args.top)
    if args.json:
        print(json.dumps(report))
    else:
        print(format_report(report))
    return 0


if __name__ == '__main__':
    sys.exit(main())
