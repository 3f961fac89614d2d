"""Environment doctor of the port: one command that answers "is this install
healthy, and what will it be fast at?". The port of ``petastorm_tpu.tools.doctor``.

``petastorm-tpu-torch-doctor`` (or ``python -m petastorm_tpu_torch.tools.doctor``)
checks, in order:

1. **Versions**: python, torch, ``torch.version.cuda``, pyarrow, numpy.
2. **CUDA backend**: ``torch.cuda`` probed in a SUBPROCESS with a hard
   timeout (a CUDA initialisation that hangs must not wedge the doctor):
   the status, the device count and the first device's name.
3. **Link**: the dispatch round trip and H2D/D2H bandwidth of
   :mod:`~petastorm_tpu_torch.benchmark.linkprobe` on the card, also in a
   subprocess with a timeout, when the backend is up; with the streaming
   ceiling it implies for 1 KiB rows.
4. **Store round trip**: a small store written to a temp dir through the
   codec and metadata path, read back with ``make_reader`` on the thread
   pool (``on_error='retry'``, the flight recorder, a long-window
   autotuner, manifest-less lineage and a temporary history store armed),
   every row checked, rows/s reported; its ``telemetry`` (snapshot and
   bottleneck), ``trace``, ``resilience``, ``autotune``, ``slo``,
   ``lineage`` and ``history`` blocks are lifted to the report's top level
   with the JAX doctor's keys.
5. **Input service**: when ``--service-url`` (or the
   ``PETASTORM_TPU_SERVICE_URL`` env var) names an input-service dispatcher
   (:mod:`~petastorm_tpu_torch.service`), its state: reachable? workers
   registered? queue depth? (``report['service']``; an unreachable
   configured service prints a WARNING — readers pointed at it will fail),
   and its durable token ledger (``report['ledger']``: armed, epoch, last
   replay, frames the CRC dropped).
6. **Incidents**: the retained bundles of the default incident home
   (``PETASTORM_TPU_INCIDENT_HOME``), newest first (``report['incidents']``).
7. **Storage**: a read of a small local store with the object-store ingest
   engine force-armed: footer-cache hits and misses, ranges coalesced,
   hedges fired and won (``report['storage']``; a hedge-win rate above 50%
   prints a WARNING).
8. **Topology**: when ``--topology-journal`` (or the
   ``PETASTORM_TPU_TOPOLOGY_JOURNAL`` env var) names a membership journal of
   :mod:`~petastorm_tpu_torch.parallel.topology`, its replay: generation,
   members, stale leases (a WARNING: a host crashed without a leave record)
   and frames the CRC dropped (a WARNING) (``report['topology']``).
9. **Static analysis**: the port's pipecheck
   (:mod:`~petastorm_tpu_torch.analysis`) over the installed package: does
   it still satisfy its own data-plane invariants (pipe and ZMQ kinds,
   telemetry names, the ratchet)? (``report['pipecheck']``; findings print
   a WARNING and never make the install unhealthy).

Prints a human report, or with ``--json`` one JSON line (the dict
:func:`collect_report` returns). The exit code is 0 iff the store round trip
passed: a CPU-only install is a healthy install, and backend or link failures
are reported as findings.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

#: the backend probe's child: torch only; its last stdout line is
#: ``cuda <count> <name>``, and no card is a non-zero exit
PROBE_CODE = (
    "import torch\n"
    "if not torch.cuda.is_available():\n"
    "    raise SystemExit('no CUDA device: torch.cuda.is_available() is False')\n"
    "print('cuda', torch.cuda.device_count(), torch.cuda.get_device_name(0))\n")

#: the link probe's child: the port's probe on the card; its tagged last line
#: survives any other output
LINK_PROBE_CODE = (
    "import json\n"
    "from petastorm_tpu_torch.benchmark.linkprobe import (\n"
    "    probe_link, streaming_ceiling_rows_per_sec)\n"
    "link = probe_link(sizes_mb=(1, 4), dispatch_iters=10, transfer_iters=3,\n"
    "                  device='cuda')\n"
    "link['streaming_ceiling_rows_per_sec_at_1kib'] = round(\n"
    "    streaming_ceiling_rows_per_sec(link, {row_bytes}, {batch}), 1)\n"
    "print('LINKPROBE_JSON ' + json.dumps(link))\n")


def check_versions():
    """python, torch, its CUDA build, pyarrow, numpy and the port."""
    import numpy
    import pyarrow
    report = {'python': sys.version.split()[0],
              'numpy': numpy.__version__,
              'pyarrow': pyarrow.__version__}
    try:
        import torch
        report['torch'] = torch.__version__
        report['cuda'] = torch.version.cuda
    except ImportError:
        report['torch'] = None
        report['cuda'] = None
    from importlib import metadata
    try:
        report['petastorm_tpu_torch'] = metadata.version('petastorm_tpu')
    except metadata.PackageNotFoundError:
        report['petastorm_tpu_torch'] = 'source checkout'
    return report


def _child_env():
    """The environment of a probe child: this one, with the package's root
    first on ``PYTHONPATH`` (the doctor may run from a source checkout)."""
    env = dict(os.environ)
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    existing = env.get('PYTHONPATH', '')
    # no trailing separator when unset: an empty entry would mean the cwd
    env['PYTHONPATH'] = pkg_root + os.pathsep + existing if existing else pkg_root
    return env


def _probe_subprocess(code, timeout_s, timeout_detail):
    """Run probe ``code`` in a subprocess with a hard timeout: ``(completed,
    None)`` on a clean exit, else ``(None, {'status': 'timeout'|'down',
    'detail': ...})`` with the child's last stderr line."""
    try:
        out = subprocess.run([sys.executable, '-c', code], env=_child_env(),
                             capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return None, {'status': 'timeout', 'detail': timeout_detail.format(timeout_s)}
    if out.returncode != 0:
        return None, {'status': 'down',
                      'detail': out.stderr.strip().splitlines()[-1][:200]
                      if out.stderr.strip() else 'unknown'}
    return out, None


def check_backend(timeout_s=60):
    """Probe ``torch.cuda`` in a subprocess with a hard timeout:
    ``{'status': 'up'|'down'|'timeout', 'platform', 'devices',
    'device_name'}`` (and ``detail`` when not up)."""
    out, error = _probe_subprocess(PROBE_CODE, timeout_s,
                                   'CUDA initialisation exceeded {}s: hung?')
    if error is not None:
        error.update(platform=None, devices=0, device_name=None)
        return error
    try:
        platform, count, name = out.stdout.strip().splitlines()[-1].split(' ', 2)
        return {'status': 'up', 'platform': platform, 'devices': int(count),
                'device_name': name}
    except (IndexError, ValueError):
        return {'status': 'down', 'platform': None, 'devices': 0, 'device_name': None,
                'detail': 'unparseable probe output: {!r}'.format(out.stdout.strip()[-200:])}


def check_link(reference_row_bytes=1024, reference_batch=1024, timeout_s=180):
    """The link probe on the card and the streaming ceiling it implies for
    ``reference_row_bytes`` rows, in a subprocess with a hard timeout (call it
    when the backend is up). A hang is reported as ``status`` 'timeout', a
    failure as 'fail'."""
    code = LINK_PROBE_CODE.format(row_bytes=int(reference_row_bytes),
                                  batch=int(reference_batch))
    out, error = _probe_subprocess(code, timeout_s, 'link probe exceeded {}s')
    if error is not None:
        if error['status'] == 'down':
            error['status'] = 'fail'   # the backend was up: a link failure
        return error
    for line in reversed(out.stdout.strip().splitlines()):
        if line.startswith('LINKPROBE_JSON '):
            try:
                return json.loads(line[len('LINKPROBE_JSON '):])
            except ValueError:
                break
    return {'status': 'fail',
            'detail': 'unparseable link probe output: {!r}'.format(out.stdout.strip()[-200:])}


def check_store_roundtrip(rows=200, workers=2):
    """Write a store (scalar and ndarray codecs) to a temp dir, read it back
    through ``make_reader``, check every row, report rows/s and the reader's
    telemetry, trace, resilience, autotune, SLO, lineage and history views."""
    import numpy as np
    import pyarrow as pa

    from petastorm_tpu_torch.autotune import AutotunePolicy
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.telemetry import tracing
    from petastorm_tpu_torch.telemetry.lineage import LineagePolicy
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema('DoctorSchema', [
        UnischemaField('idx', np.int64, (), ScalarCodec(pa.int64()), False),
        UnischemaField('vec', np.float32, (8,), NdarrayCodec(), False),
    ])
    # the flight recorder is armed for the round trip and restored (its ring
    # cleared) after; a capture the user armed is left intact
    trace_was_enabled = tracing.trace_enabled()
    try:
        if not trace_was_enabled:
            tracing.reset_tracing()
        tracing.set_trace_enabled(True)
        with tempfile.TemporaryDirectory(prefix='petastorm_tpu_torch_doctor_') as tmp:
            url = 'file://' + tmp
            write_rows(url, schema, ({'idx': i, 'vec': np.full(8, i, np.float32)}
                                     for i in range(rows)), rowgroup_size_mb=1)
            start = time.perf_counter()
            seen = []
            # on_error='retry' probes the resilience path; the autotuner's
            # window outlasts the read, so it wires up and turns no knob;
            # lineage folds a digest without a manifest file, and the run
            # record goes into a store in the temp dir
            hist_path = os.path.join(tmp, 'run_history.bin')
            with make_reader(url, workers_count=workers, num_epochs=1, on_error='retry',
                             lineage=LineagePolicy(manifest=False), history=hist_path,
                             autotune=AutotunePolicy(window_s=3600.0)) as reader:
                for row in reader:
                    seen.append(int(row.idx))
                    if row.vec[0] != row.idx:
                        return {'status': 'fail',
                                'detail': 'row {} decoded wrong vec'.format(row.idx)}
                diag = reader.diagnostics
                telemetry = reader.telemetry_snapshot()
                trace = reader.trace_summary()
                autotune = reader.autotune_report()
                slo = reader.efficiency_report()
                lineage = diag.get('lineage')
                sentinel = diag.get('sentinel')
            elapsed = time.perf_counter() - start
            history = check_history(hist_path, sentinel)
    finally:
        tracing.set_trace_enabled(trace_was_enabled)
        if not trace_was_enabled:
            tracing.reset_tracing()
    if sorted(seen) != list(range(rows)):
        return {'status': 'fail',
                'detail': 'expected {} distinct rows, got {}'.format(rows, len(set(seen)))}
    return {'status': 'ok', 'rows': rows,
            'rows_per_sec': round(rows / elapsed, 1),
            'io_retries': diag.get('io_retries', 0),
            'rowgroups_quarantined': diag.get('rowgroups_quarantined', 0),
            'quarantine': diag.get('quarantine', []),
            # lifted to the report's top level by collect_report
            'telemetry': telemetry,
            'trace': trace,
            'autotune': autotune,
            'slo': slo,
            'lineage': lineage,
            'history': history,
            'resilience': {
                'breakers': diag.get('breakers', {}),
                'workers_hung_reaped': diag.get('workers_hung_reaped', 0),
                'shm_crc_failures': diag.get('shm_crc_failures', 0),
                'cache_corrupt_entries': diag.get('cache', {}).get('corrupt_entries', 0),
                'rowgroups_quarantined': diag.get('rowgroups_quarantined', 0),
            }}


def check_history(path, sentinel=None):
    """Replay the round trip's run-history store: records, frames the CRC
    dropped (a torn append the store healed around), the newest record's
    rows/s and platform, and whether the sentinel was armed."""
    from petastorm_tpu_torch.telemetry.history import load_records
    records, dropped = load_records(path)
    block = {'status': 'ok' if records and not dropped else 'degraded',
             'records': len(records), 'frames_dropped': dropped,
             'sentinel_armed': bool(sentinel)}
    if records:
        block['rows_per_sec'] = records[-1].get('rows_per_sec')
        block['platform'] = records[-1].get('platform')
    return block


def check_incidents(home=None):
    """The retained bundles of the incident home (newest first): names,
    trigger kinds and ranked causes, without opening their evidence."""
    from petastorm_tpu_torch.telemetry.incident import default_incident_home, scan_bundles
    home = home or default_incident_home(None)
    bundles = scan_bundles(home)
    return {'status': 'ok', 'home': home, 'retained': len(bundles),
            'bundles': bundles[:8]}


def check_storage(rows=64, workers=1):
    """A read of a small local store with the object-store ingest engine
    force-armed (two epochs, so the second hits the footer cache), and the
    engine's counters. On a healthy local disk hedges should almost never
    fire; the human report warns when more than half of those that fire win."""
    import numpy as np
    import pyarrow as pa

    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.storage import reset_storage_metrics, storage_metrics_snapshot
    from petastorm_tpu_torch.telemetry.registry import (set_telemetry_enabled,
                                                        telemetry_enabled)
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema('DoctorStorageSchema', [
        UnischemaField('idx', np.int64, (), ScalarCodec(pa.int64()), False),
        UnischemaField('val', np.float64, (), ScalarCodec(pa.float64()), False),
    ])
    was_enabled = telemetry_enabled()
    set_telemetry_enabled(True)   # the counters follow the telemetry switch
    reset_storage_metrics()       # this probe's reads only
    try:
        with tempfile.TemporaryDirectory(prefix='petastorm_tpu_torch_doctor_') as tmp:
            url = 'file://' + tmp
            write_rows(url, schema, ({'idx': i, 'val': float(i)} for i in range(rows)),
                       rowgroup_size_mb=1)
            seen = []
            with make_reader(url, workers_count=workers, num_epochs=2,
                             storage_policy=True) as reader:
                for row in reader:
                    seen.append(int(row.idx))
        counters = storage_metrics_snapshot().get('counters', {})
    finally:
        set_telemetry_enabled(was_enabled)
        reset_storage_metrics()   # the probe's counts stay out of real reads
    if sorted(set(seen)) != list(range(rows)):
        return {'status': 'fail',
                'detail': 'engine-armed read returned {} distinct rows, expected {}'
                          .format(len(set(seen)), rows)}
    fired = int(counters.get('storage_hedge_fired', 0))
    won = int(counters.get('storage_hedge_won', 0))
    return {'status': 'ok',
            'footer_cache_hits': int(counters.get('storage_footer_cache_hit', 0)),
            'footer_cache_misses': int(counters.get('storage_footer_cache_miss', 0)),
            'ranges_coalesced': int(counters.get('storage_ranges_coalesced', 0)),
            'hedges_fired': fired,
            'hedges_won': won,
            'hedge_win_rate': round(won / fired, 3) if fired else 0.0}


def check_service(service_url=None, timeout_s=2.0):
    """Probe the input service when one is configured — ``service_url``
    argument or the ``PETASTORM_TPU_SERVICE_URL`` env var. Returns
    ``{'status': 'unconfigured'}`` when no URL is set, ``{'status': 'ok',
    'workers': N, 'clients': N, 'queue_depth': N, ...}`` when the dispatcher
    answers a state request, or ``{'status': 'unreachable', 'detail': ...}``
    — which the human report prints as a WARNING: a reader pointed at that
    URL will fail its hello."""
    url = service_url or os.environ.get('PETASTORM_TPU_SERVICE_URL')
    if not url:
        return {'status': 'unconfigured'}
    # tripped client-transport breakers of any ServicePool this process made
    # (they live on the default board, as in Reader.diagnostics)
    from petastorm_tpu_torch.resilience import default_board
    breakers = {name: state for name, state
                in default_board().snapshot(only_tripped=True).items()
                if name.startswith('service:')}
    try:
        from petastorm_tpu_torch.service.service_client import fetch_service_state
        state = fetch_service_state(url, timeout_s=timeout_s)
    except Exception as exc:  # noqa: BLE001 - unreachability is the finding, not a doctor failure
        return {'status': 'unreachable', 'service_url': url,
                'detail': repr(exc), 'breakers': breakers}
    workers = state.get('workers') or []
    return {'status': 'ok', 'service_url': url,
            'workers': len(workers),
            'clients': len(state.get('clients') or []),
            'queue_depth': state.get('queue_depth', 0),
            'in_flight': state.get('in_flight', 0),
            'busy_rejections': state.get('busy_rejections', 0),
            'items_requeued': state.get('items_requeued', 0),
            'workers_departed': state.get('workers_departed', 0),
            'breakers': breakers,
            'state': state}


def check_ledger(service_report=None):
    """The probed dispatcher's durable-ledger health, derived from the
    :func:`check_service` state snapshot: ``{'status': 'unarmed'}`` when no
    service is configured or the dispatcher runs without a ledger, else
    journal path, ledger epoch, the last replay result (``ok`` /
    ``corrupt`` / ``absent`` / ``discarded``) and the CRC-dropped frame
    count — a nonzero drop count means a past restart degraded to
    replay-from-clients."""
    state = ((service_report or {}).get('state') or {}).get('ledger') or {}
    if not state.get('armed'):
        return {'status': 'unarmed'}
    return {'status': 'ok',
            'path': state.get('path'),
            'epoch': state.get('epoch'),
            'last_replay': state.get('last_replay'),
            'frames_dropped': state.get('frames_dropped', 0),
            'records_replayed': state.get('records_replayed', 0)}


def check_topology(journal_path=None):
    """Replay the membership journal named by ``journal_path`` or the
    ``PETASTORM_TPU_TOPOLOGY_JOURNAL`` env var: ``{'status': 'unarmed'}``
    when none is named, ``{'status': 'absent', ...}`` when the file does not
    exist yet, else the replayed view: generation, members, stale leases
    (hosts whose lease expired without a leave: reshard candidates),
    delivered items, reshards and the frames the CRC dropped."""
    path = journal_path or os.environ.get('PETASTORM_TPU_TOPOLOGY_JOURNAL')
    if not path:
        return {'status': 'unarmed'}
    from petastorm_tpu_torch.parallel.topology import replay_topology_journal
    replay = replay_topology_journal(path)
    if replay.result == 'absent':
        return {'status': 'absent', 'path': path}
    return {'status': replay.result, 'path': path,
            'generation': replay.generation,
            'members': sorted(replay.members),
            'stale_leases': replay.stale_leases(time.time()),
            'delivered': len(replay.delivered),
            'resharded': replay.resharded,
            'frames_dropped': replay.frames_dropped,
            'records': replay.records}


def check_pipecheck():
    """Run the port's pipecheck static analysis over the installed package
    (docs/static-analysis.md) and summarize: ``{'status': 'ok'|'findings',
    'findings': N, 'suppressed': M, 'files': F, 'callgraph_functions': G,
    'by_rule': {...}, 'first': <first finding or None>}``.

    Static findings mean the installed code has drifted from its own
    data-plane invariants: a WARNING in the human report, not an
    install-health failure."""
    from petastorm_tpu_torch.analysis import run_pipecheck
    report = run_pipecheck()
    return {'status': 'ok' if report.clean else 'findings',
            'findings': len(report.findings),
            'suppressed': report.suppressed,
            'files': report.files,
            'callgraph_functions': report.callgraph_functions,
            'by_rule': report.by_rule(),
            'first': report.findings[0].format() if report.findings else None}


def collect_report(probe_timeout_s=60, link=True, link_timeout_s=180, service_url=None,
                   topology_journal=None):
    """Run every check; returns the report dict (no printing)."""
    report = {'versions': check_versions()}
    report['backend'] = check_backend(timeout_s=probe_timeout_s)
    if link and report['backend']['status'] == 'up':
        try:
            report['link'] = check_link(timeout_s=link_timeout_s)
        except Exception as exc:  # noqa: BLE001 - the link probe is best-effort
            report['link'] = {'status': 'fail', 'detail': repr(exc)}
    try:
        report['store_roundtrip'] = check_store_roundtrip()
    except Exception as exc:  # noqa: BLE001 - the report must always complete
        report['store_roundtrip'] = {'status': 'fail', 'detail': repr(exc)}
    roundtrip = report['store_roundtrip']
    # the round trip's views, one stable key each whether or not it ran
    snapshot = roundtrip.pop('telemetry', None)
    if snapshot is not None:
        from petastorm_tpu_torch.telemetry.analyze import attribute_bottleneck
        report['telemetry'] = {'snapshot': snapshot,
                               'bottleneck': attribute_bottleneck(snapshot)}
    trace = roundtrip.pop('trace', None)
    if trace is None:
        from petastorm_tpu_torch.telemetry.trace_export import summarize_trace
        trace = summarize_trace({})
    report['trace'] = trace
    resilience = roundtrip.pop('resilience', None)
    report['resilience'] = resilience if resilience is not None else {
        'breakers': {}, 'workers_hung_reaped': 0, 'shm_crc_failures': 0,
        'cache_corrupt_entries': 0, 'rowgroups_quarantined': 0}
    autotune = roundtrip.pop('autotune', None)
    report['autotune'] = autotune if autotune is not None else {'enabled': False}
    slo = roundtrip.pop('slo', None)
    report['slo'] = slo if slo is not None else {'evaluated': False}
    lineage = roundtrip.pop('lineage', None)
    report['lineage'] = lineage if lineage is not None else {'enabled': False}
    history = roundtrip.pop('history', None)
    report['history'] = history if history is not None else {
        'status': 'unprobed', 'records': 0, 'frames_dropped': 0, 'sentinel_armed': False}
    # the static-analysis block: always present; a failure of the analyzer
    # itself is reported, never fatal to the doctor
    try:
        report['pipecheck'] = check_pipecheck()
    except Exception as exc:  # noqa: BLE001 - the report must always complete
        report['pipecheck'] = {'status': 'fail', 'detail': repr(exc)}
    # the service and ledger blocks: always present so --json consumers find
    # one stable key; an unconfigured service is a healthy install
    try:
        report['service'] = check_service(service_url)
    except Exception as exc:  # noqa: BLE001 - the report must always complete
        report['service'] = {'status': 'fail', 'detail': repr(exc)}
    try:
        report['ledger'] = check_ledger(report['service'])
    except Exception as exc:  # noqa: BLE001 - the report must always complete
        report['ledger'] = {'status': 'fail', 'detail': repr(exc)}
    # always present, as the service's blocks are; an unarmed topology is a
    # healthy install
    try:
        report['topology'] = check_topology(topology_journal)
    except Exception as exc:  # noqa: BLE001 - the report must always complete
        report['topology'] = {'status': 'fail', 'detail': repr(exc)}
    try:
        report['incidents'] = check_incidents()
    except Exception as exc:  # noqa: BLE001 - the report must always complete
        report['incidents'] = {'status': 'fail', 'detail': repr(exc)}
    try:
        report['storage'] = check_storage()
    except Exception as exc:  # noqa: BLE001 - the report must always complete
        report['storage'] = {'status': 'fail', 'detail': repr(exc)}
    report['healthy'] = roundtrip.get('status') == 'ok'
    return report


def pipecheck_line(pipecheck):
    """The human report's line for a ``check_pipecheck`` block (None for no
    block)."""
    if pipecheck.get('status') == 'ok':
        return ('  pipecheck: clean: {} files, {} call-graph function(s), '
                '{} suppression(s) honored (docs/static-analysis.md)'.format(
                    pipecheck.get('files', 0), pipecheck.get('callgraph_functions', 0),
                    pipecheck.get('suppressed', 0)))
    if pipecheck.get('status') == 'findings':
        return ('  WARNING: pipecheck found {} data-plane invariant violation(s) ({}); '
                'first: {}; run `petastorm-tpu-torch-pipecheck` for the full list'.format(
                    pipecheck.get('findings', 0),
                    ', '.join('{}={}'.format(rule, count) for rule, count
                              in sorted(pipecheck.get('by_rule', {}).items())),
                    pipecheck.get('first')))
    if pipecheck:
        return '  pipecheck: FAIL ({}): the analyzer itself errored'.format(
            pipecheck.get('detail', 'unknown'))
    return None


def _print_human(report):
    v = report['versions']
    print('petastorm-tpu-torch doctor')
    print('  versions: petastorm_tpu_torch {} / python {} / torch {} (CUDA {}) / '
          'pyarrow {} / numpy {}'.format(v['petastorm_tpu_torch'], v['python'], v['torch'],
                                         v['cuda'], v['pyarrow'], v['numpy']))
    b = report['backend']
    if b['status'] == 'up':
        print('  backend: UP: {} x{} ({})'.format(b['platform'], b['devices'],
                                                  b['device_name']))
    else:
        print('  backend: {} ({}): CPU development still works; the card paths '
              'need a device'.format(b['status'].upper(), b.get('detail', '')))
    link = report.get('link')
    if link and 'dispatch_rtt_ms' in link:
        print('  link: RTT {} ms, H2D {} MB/s, D2H {} MB/s -> streaming ceiling ~{} '
              'rows/s at 1 KiB rows'.format(link['dispatch_rtt_ms'],
                                            link['h2d_mbytes_per_sec'],
                                            link['d2h_mbytes_per_sec'],
                                            link['streaming_ceiling_rows_per_sec_at_1kib']))
    elif link:
        print('  link: FAIL ({}): device up but unmeasurable'.format(
            link.get('detail', 'unknown')))
    s = report['store_roundtrip']
    if s.get('status') == 'ok':
        print('  store roundtrip: OK: {} rows at {} rows/s'.format(s['rows'],
                                                                   s['rows_per_sec']))
        if s.get('io_retries') or s.get('rowgroups_quarantined'):
            print('  resilience: {} transient-IO retries, {} rowgroups quarantined: '
                  'local reads should never need these; check the disk'.format(
                      s.get('io_retries', 0), s.get('rowgroups_quarantined', 0)))
    else:
        print('  store roundtrip: FAIL: {}'.format(s.get('detail')))
    telemetry = report.get('telemetry')
    if telemetry and telemetry['bottleneck'].get('top_stage'):
        bottleneck = telemetry['bottleneck']
        print('  telemetry: top stage {} ({:.0%} of {:.3f}s stage time) -> {}'.format(
            bottleneck['top_stage'], bottleneck['top_share'],
            bottleneck.get('total_stage_seconds', 0.0), bottleneck['recommendation']))
    slo = report.get('slo') or {}
    if slo.get('evaluated'):
        print('  input efficiency: {:.1%} (target {:.0%}; consumer waited {:.3f}s of '
              '{:.3f}s)'.format(slo.get('efficiency', 0.0), slo.get('target_efficiency', 0.0),
                                slo.get('wait_seconds', 0.0), slo.get('elapsed_s', 0.0)))
        if slo.get('breached'):
            print('  WARNING: input efficiency is BELOW the SLO target: the consumer sat '
                  'starved {:.0%} of the time'.format(slo.get('starvation_fraction', 0.0)))
    trace = report.get('trace') or {}
    if trace.get('events'):
        slowest = (trace.get('top_rowgroup_traces') or [{}])[0]
        print('  trace: {} event(s) across {} process(es), {} rowgroup trace(s), {} '
              'dropped; {} anomaly instant(s){}'.format(
                  trace.get('events', 0), len(trace.get('processes', [])),
                  trace.get('rowgroups_traced', 0), trace.get('dropped_events', 0),
                  len(trace.get('anomaly_instants') or []),
                  '; slowest rowgroup {} at {} ms'.format(
                      slowest.get('rowgroup'), slowest.get('duration_ms'))
                  if slowest else ''))
    resilience = report.get('resilience') or {}
    open_breakers = sorted(name for name, state
                           in (resilience.get('breakers') or {}).items()
                           if state.get('state') != 'closed')
    if open_breakers:
        print('  WARNING: circuit breaker(s) not closed: {}: a dependency is being '
              'routed around'.format(', '.join(open_breakers)))
    autotune = report.get('autotune') or {}
    if autotune.get('enabled'):
        decisions = autotune.get('decisions') or []
        print('  autotune: {} knob(s) catalogued, {} window(s), {} decision(s)'.format(
            len(autotune.get('knobs') or {}), autotune.get('windows', 0), len(decisions)))
    service = report.get('service') or {}
    if service.get('status') == 'ok':
        print('  service: {}: {} worker(s), {} client(s), queue depth {}'.format(
            service['service_url'], service['workers'], service['clients'],
            service['queue_depth']))
        if not service['workers']:
            print('  WARNING: input service at {} has NO registered decode workers: '
                  'readers will stall until one joins'.format(service['service_url']))
    elif service.get('status') == 'unreachable':
        print('  WARNING: input service at {} is UNREACHABLE ({}): readers with this '
              'service_url will fail their hello; is the dispatcher running?'.format(
                  service['service_url'], service.get('detail', '')))
    ledger = report.get('ledger') or {}
    if ledger.get('status') == 'ok':
        print('  ledger: armed at {}: epoch {}, last replay {} ({} record(s), {} '
              'frame(s) CRC-dropped)'.format(
                  ledger['path'], ledger['epoch'], ledger['last_replay'],
                  ledger['records_replayed'], ledger['frames_dropped']))
        if ledger['frames_dropped']:
            print('  WARNING: the dispatcher ledger dropped {} journal frame(s) on its '
                  'last replay: a restart degraded to replay-from-clients'.format(
                      ledger['frames_dropped']))
    lineage = report.get('lineage') or {}
    if lineage.get('enabled'):
        print('  lineage: digest {}... over {} item(s), {} pending, {} divergence(s)'.format(
            (lineage.get('order_digest') or '')[:12], lineage.get('items_folded', 0),
            lineage.get('pending_items', 0), lineage.get('divergence', 0)))
        if lineage.get('divergence'):
            print('  WARNING: sample-lineage verification FAILED {} time(s) (last: {})'
                  .format(lineage.get('divergence'),
                          (lineage.get('last_divergence') or {}).get('reason')))
    history = report.get('history') or {}
    if history.get('status') != 'unprobed':
        print('  history: {} run record(s) replayed ({} CRC-dropped frame(s)); sentinel {}'
              .format(history.get('records', 0), history.get('frames_dropped', 0),
                      'armed' if history.get('sentinel_armed') else 'unarmed'))
        if history.get('frames_dropped'):
            print('  WARNING: the run-history store dropped torn frame(s): an append '
                  'was interrupted and the store healed around it')
    topology = report.get('topology') or {}
    if topology.get('status') in ('ok', 'corrupt'):
        print('  topology: journal {}: generation {}, {} member(s), {} item(s) journaled '
              'delivered, {} reshard(s)'.format(
                  topology.get('path'), topology.get('generation'),
                  len(topology.get('members') or []), topology.get('delivered', 0),
                  topology.get('resharded', 0)))
        if topology.get('stale_leases'):
            print('  WARNING: topology member(s) with EXPIRED leases and no leave record: '
                  '{}: they look crashed or partitioned; survivors should reshard their '
                  'undelivered rest (`petastorm-tpu-torch-throughput chaos --hosts N '
                  '--kill-host` rehearses exactly this)'.format(
                      ', '.join(sorted(topology.get('stale_leases')))))
        if topology.get('frames_dropped'):
            print('  WARNING: the membership journal dropped {} torn frame(s) on replay: '
                  'a past append was interrupted; membership resumed from the intact '
                  'prefix'.format(topology.get('frames_dropped')))
    elif topology.get('status') == 'absent':
        print('  topology: journal {} configured but not created yet: no topology-armed '
              'reader has opened it'.format(topology.get('path')))
    incidents = report.get('incidents') or {}
    if incidents.get('retained'):
        newest = (incidents.get('bundles') or [{}])[0]
        print('  WARNING: {} incident bundle(s) retained in {} (newest: {}, {}, cause {}); '
              'run `petastorm-tpu-torch-throughput autopsy <bundle>`'.format(
                  incidents.get('retained'), incidents.get('home'),
                  newest.get('bundle'), newest.get('kind'), newest.get('cause')))
    storage = report.get('storage') or {}
    if storage.get('status') == 'ok':
        print('  storage engine: footer cache {} hit(s) / {} miss(es), {} range(s) '
              'coalesced, {} hedge(s) fired / {} won'.format(
                  storage.get('footer_cache_hits', 0), storage.get('footer_cache_misses', 0),
                  storage.get('ranges_coalesced', 0), storage.get('hedges_fired', 0),
                  storage.get('hedges_won', 0)))
        if storage.get('hedges_fired', 0) and storage.get('hedge_win_rate', 0.0) > 0.5:
            print('  WARNING: hedge-win rate is {:.0%}: storage is tail-heavy enough '
                  'that hedges routinely beat the primary'.format(
                      storage.get('hedge_win_rate', 0.0)))
    elif storage:
        print('  storage engine: FAIL ({}): the force-armed probe read errored'.format(
            storage.get('detail', 'unknown')))
    line = pipecheck_line(report.get('pipecheck') or {})
    if line is not None:
        print(line)
    print('  verdict: {}'.format('healthy' if report['healthy'] else 'BROKEN'))


def main(argv=None):
    """CLI: run every check, print the report, exit 0 iff healthy."""
    parser = argparse.ArgumentParser(description='petastorm-tpu-torch environment doctor')
    parser.add_argument('--json', action='store_true',
                        help='print one machine-readable JSON line instead')
    parser.add_argument('--probe-timeout', type=int, default=60,
                        help='backend probe subprocess timeout (seconds)')
    parser.add_argument('--link-timeout', type=int, default=180,
                        help='link probe subprocess timeout (seconds)')
    parser.add_argument('--no-link', action='store_true',
                        help='skip the link bandwidth probe')
    parser.add_argument('--service-url', default=None,
                        help='probe this input-service dispatcher (default: '
                             'PETASTORM_TPU_SERVICE_URL when set)')
    parser.add_argument('--topology-journal', default=None,
                        help='replay this membership journal (default: '
                             'PETASTORM_TPU_TOPOLOGY_JOURNAL when set)')
    args = parser.parse_args(argv)
    report = collect_report(probe_timeout_s=args.probe_timeout, link=not args.no_link,
                            link_timeout_s=args.link_timeout,
                            service_url=args.service_url,
                            topology_journal=args.topology_journal)
    if args.json:
        print(json.dumps(report))
    else:
        _print_human(report)
    return 0 if report['healthy'] else 1


if __name__ == '__main__':
    sys.exit(main())
