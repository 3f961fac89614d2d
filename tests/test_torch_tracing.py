"""The port's flight recorder against the JAX package's: ring capacity and
drop counting, the Chrome-trace export and summary of one event list (equal
JSON), and whole reads through both packages on the same store and seed
(``'dummy'``, then ``'thread'`` with one worker, through ``make_reader`` /
``make_batch_reader`` and ``JaxDataLoader`` / ``TorchDataLoader(device='cpu')``):
the same stage names and counts, and the same set of ``(name, epoch,
rowgroup, attempt)`` trace events. Times are never compared."""

import json

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import petastorm_tpu as jax_pkg
from petastorm_tpu.parallel.loader import JaxDataLoader
from petastorm_tpu.telemetry import trace_export as jax_trace_export
from petastorm_tpu.telemetry import tracing as jax_tracing
from petastorm_tpu_torch import make_batch_reader, make_reader
from petastorm_tpu_torch.parallel.loader import TorchDataLoader
from petastorm_tpu_torch.telemetry import spans, trace_export, tracing

ROWS = 64
FILES = 8


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    """64 rows in 8 files of one rowgroup: ``id`` and a float32 (8,) ``vec``."""
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('Traced', [
        UnischemaField('id', np.int64, (), ScalarCodec(), False),
        UnischemaField('vec', np.float32, (8,), NdarrayCodec(), False)])
    rng = np.random.RandomState(5)
    url = 'file://' + str(tmp_path_factory.mktemp('trace') / 'store')
    write_rows(url, schema, [{'id': i, 'vec': rng.randn(8).astype(np.float32)}
                             for i in range(ROWS)], n_files=FILES, rowgroup_size_mb=1)
    return url


@pytest.fixture(scope='module')
def plain_store(tmp_path_factory):
    """A plain Parquet store: 4 files of 16 rows."""
    path = tmp_path_factory.mktemp('trace_plain')
    for part in range(4):
        ids = np.arange(part * 16, (part + 1) * 16, dtype=np.int64)
        pq.write_table(pa.table({'id': ids, 'value': ids * 0.5}),
                       str(path / 'part-{}.parquet'.format(part)))
    return 'file://' + str(path)


@pytest.fixture
def armed():
    """Both packages' flight recorders armed and empty; disarmed and cleared
    after the test (each package keeps its own recorder)."""
    for module in (tracing, jax_tracing):
        module.reset_tracing()
        module.set_trace_enabled(True)
    try:
        yield
    finally:
        for module in (tracing, jax_tracing):
            module.set_trace_enabled(False)
            module.reset_tracing()
        spans.drain_stage_times()


def _events(snapshot):
    return sorted({(e['name'], tuple(e['ctx']) if e['ctx'] else None)
                   for e in snapshot['events']})


def _counts(snapshot):
    return {name: hist['count'] for name, hist in snapshot['histograms'].items()}


def _scripted_snapshot():
    """One consumer (pid 100) and two workers: spans, instants, a
    re-ventilated rowgroup (attempts 0 and 1) and an event without context."""
    events = []
    ts = 1000.0
    for rowgroup in range(4):
        worker = 200 + rowgroup % 2
        ctx = [0, rowgroup, 0]
        events.append({'pid': 100, 'tid': 1, 'ts_us': ts, 'dur_us': 0.0, 'ph': 'i',
                       'name': 'ventilate', 'ctx': ctx, 'args': None})
        for stage, dur in (('rowgroup_read', 40.0), ('decode', 25.5)):
            ts += 5.0
            events.append({'pid': worker, 'tid': 7, 'ts_us': ts, 'dur_us': dur, 'ph': 'X',
                           'name': stage, 'ctx': ctx, 'args': None})
            ts += dur
        ts += 3.25
        events.append({'pid': 100, 'tid': 1, 'ts_us': ts, 'dur_us': 12.0, 'ph': 'X',
                       'name': 'shm_map', 'ctx': ctx, 'args': None})
        events.append({'pid': 100, 'tid': 1, 'ts_us': ts + 13, 'dur_us': 0.0, 'ph': 'i',
                       'name': 'rowgroup_consumed', 'ctx': ctx, 'args': {'rows': 8}})
    events.append({'pid': 100, 'tid': 1, 'ts_us': 1500.0, 'dur_us': 0.0, 'ph': 'i',
                   'name': 'worker_respawn', 'ctx': [0, 2, 0],
                   'args': {'worker_slot': 0, 'new_attempt': 1}})
    events.append({'pid': 201, 'tid': 9, 'ts_us': 1600.0, 'dur_us': 80.0, 'ph': 'X',
                   'name': 'rowgroup_read', 'ctx': [0, 2, 1], 'args': None})
    events.append({'pid': 100, 'tid': 3, 'ts_us': 1700.0, 'dur_us': 0.0, 'ph': 'i',
                   'name': 'breaker_transition', 'ctx': None,
                   'args': {'breaker': 'shm_transport', 'from_state': 'closed',
                            'to_state': 'open'}})
    return {'pid': 100, 'events': sorted(events, key=lambda e: e['ts_us']),
            'dropped_events': 3, 'capacity': 65536}


def test_chrome_trace_and_summary_match_jax():
    snapshot = _scripted_snapshot()
    trace = trace_export.to_chrome_trace(snapshot)
    assert json.dumps(trace) == json.dumps(jax_trace_export.to_chrome_trace(snapshot))
    flows = [e for e in trace['traceEvents'] if e['ph'] in ('s', 'f')]
    # one arrow (s + f) for each rowgroup whose worker events precede a
    # consumer event: rowgroup 2's second attempt ends after its consumer's
    assert len(flows) == 6
    for top_n in (1, 5):
        summary = trace_export.summarize_trace(snapshot, top_n=top_n)
        assert summary == jax_trace_export.summarize_trace(snapshot, top_n=top_n)
    assert summary['dropped_events'] == 3
    assert [a['name'] for a in summary['anomaly_instants']] == ['worker_respawn',
                                                                 'breaker_transition']
    assert trace_export.format_trace_summary(summary) == \
        jax_trace_export.format_trace_summary(summary)
    empty = {'pid': 1, 'events': []}
    assert trace_export.summarize_trace(empty) == jax_trace_export.summarize_trace(empty)


def test_ring_counts_overwritten_events_as_jax_does():
    port, jax = tracing.TraceRecorder(capacity=16), jax_tracing.TraceRecorder(capacity=16)
    for recorder in (port, jax):
        for i in range(40):
            recorder.record(float(i), 1.0, 'X', 'decode', (0, i, 0))
    assert port.dropped_events() == jax.dropped_events() == 24
    drained, jax_drained = port.drain(), jax.drain()
    assert drained[1] == jax_drained[1] == 24
    assert [e[:5] for e in drained[0]] == [e[:5] for e in jax_drained[0]]
    assert [e[0] for e in drained[0]] == [float(i) for i in range(24, 40)]
    assert port.drain() is None
    # a drained sidecar merges into another recorder, keeping its pid
    port.merge(4242, [list(e) for e in drained[0]], dropped=drained[1])
    snap = port.snapshot()
    assert {e['pid'] for e in snap['events']} == {4242}
    # the drain handed its drop count off with the events (no double count)
    assert snap['dropped_events'] == 24


def test_trace_hooks_are_off_by_default_and_contexts_are_thread_local():
    assert not tracing.trace_enabled()
    tracing.trace_instant('ventilate')
    tracing.trace_complete('decode', 0.0, 1.0)
    assert tracing.drain_trace_events() is None
    tracing.set_trace_context(3, 4, 1)
    try:
        assert tracing.current_trace_context() == (3, 4, 1)
    finally:
        tracing.clear_trace_context()
    assert tracing.current_trace_context() is None


@pytest.mark.parametrize('pool', ['dummy', 'thread'])
def test_a_row_read_gives_the_jax_stage_counts_and_trace_events(store, pool, armed):
    kwargs = dict(reader_pool_type=pool, workers_count=1, seed=3, shuffle_rows=True,
                  shuffle_row_drop_partitions=2, num_epochs=2, trace=True)
    with jax_pkg.make_reader(store, **kwargs) as reader:
        jax_rows = [int(row.id) for row in reader]
        jax_snapshot = reader.telemetry_snapshot()
        jax_trace = jax_tracing.trace_snapshot()
    with make_reader(store, **kwargs) as reader:
        rows = [int(row.id) for row in reader]
        snapshot = reader.telemetry_snapshot()
        trace = tracing.trace_snapshot()
        summary = reader.trace_summary()
        diag = reader.diagnostics
    assert rows == jax_rows and sorted(rows) == sorted(list(range(ROWS)) * 2)
    assert _counts(snapshot) == _counts(jax_snapshot)
    assert snapshot['histograms']['rowgroup_read']['count'] == 2 * FILES * 2
    assert _events(trace) == _events(jax_trace)
    assert summary['rowgroups_traced'] == 2 * FILES and summary['dropped_events'] == 0
    assert diag['trace']['events'] >= summary['events']
    assert set(diag['telemetry']['histograms']) == set(snapshot['histograms'])
    assert diag['slo']['rows'] == 2 * ROWS


@pytest.mark.parametrize('pool', ['dummy', 'thread'])
def test_a_batch_read_through_the_loaders_matches_jax(plain_store, pool, armed):
    kwargs = dict(reader_pool_type=pool, workers_count=1, seed=1, num_epochs=1,
                  trace=True)
    with jax_pkg.make_batch_reader(plain_store, **kwargs) as reader:
        loader = JaxDataLoader(reader, batch_size=6, shuffling_queue_capacity=20, seed=2)
        jax_batches = [np.asarray(batch['id']).tolist() for batch in loader]
        jax_snapshot = loader.telemetry_snapshot()
        jax_trace = jax_tracing.trace_snapshot()
    with make_batch_reader(plain_store, **kwargs) as reader:
        loader = TorchDataLoader(reader, batch_size=6, shuffling_queue_capacity=20, seed=2,
                                 device='cpu')
        batches = [batch['id'].tolist() for batch in loader]
        snapshot = loader.telemetry_snapshot()
        trace = tracing.trace_snapshot()
    assert batches == jax_batches
    # the port's loader adds its own deliver stage, once a batch
    assert _counts(snapshot) == dict(_counts(jax_snapshot), deliver=len(batches))
    for stage in ('shuffle_wait', 'h2d'):
        assert snapshot['histograms'][stage]['count'] == len(batches) == 10
    assert snapshot['histograms']['collate']['count'] == 4
    assert _events(trace) == _events(jax_trace)
    names = {name for name, _ in _events(trace)}
    assert {'shuffle_wait', 'collate', 'h2d', 'ventilate', 'rowgroup_consumed'} <= names


def test_trace_export_cli_writes_a_perfetto_trace(store, tmp_path, capsys):
    out = tmp_path / 'trace.json'
    try:
        assert trace_export.main([store, '-o', str(out), '-p', 'dummy', '--json']) == 0
    finally:
        tracing.reset_tracing()
        spans.drain_stage_times()
    assert not tracing.trace_enabled()
    summary = json.loads(capsys.readouterr().out)
    assert summary['rows'] == ROWS and summary['rowgroups_traced'] == FILES
    trace = json.loads(out.read_text())
    assert {e['name'] for e in trace['traceEvents']} >= {'process_name', 'rowgroup_read',
                                                         'decode', 'ventilate'}
