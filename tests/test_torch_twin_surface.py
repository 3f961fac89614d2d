"""The public names, methods and parameters the port took from its JAX twin
to close the twin audit (``tests/test_torch_twin_audit.py``), each held
against the JAX package on the same inputs: petastorm's row-dict API
(``insert_explicit_nulls``, ``make_namedtuple_from_dict``, ``NGram.form_ngram``
and ``make_namedtuples``), the telemetry exporters' ``prefix``/``labels``, the
SLO tracker's ``history_size``, the breaker board's ``reset`` and
``on_transition``, the pools' ``get_results(timeout=)`` and ``diagnostics``,
the wire's ``decode_columnar(stats=)`` and ``writable``, the shm ring's
``checksum`` and ``slot_range``, and the rest of the audit's list."""

import json
import types

import numpy as np
import pytest

import petastorm_tpu as jax_package
import petastorm_tpu_torch as port_package
from petastorm_tpu import errors as jax_errors
from petastorm_tpu import ngram as jax_ngram
from petastorm_tpu import resilience as jax_resilience
from petastorm_tpu import unischema as jax_unischema
from petastorm_tpu.autotune import controller as jax_controller
from petastorm_tpu.autotune import knobs as jax_knobs
from petastorm_tpu.autotune import policy as jax_policy
from petastorm_tpu.telemetry import export as jax_export
from petastorm_tpu.telemetry import http_exporter as jax_http
from petastorm_tpu.telemetry import registry as jax_registry
from petastorm_tpu.telemetry import slo as jax_slo
from petastorm_tpu.workers import dummy_pool as jax_dummy
from petastorm_tpu.workers import serializers as jax_serializers
from petastorm_tpu.workers import shm_ring as jax_shm_ring
from petastorm_tpu.workers import thread_pool as jax_thread_pool
from petastorm_tpu_torch import errors, ngram, resilience, unischema
from petastorm_tpu_torch.autotune import controller, knobs, policy
from petastorm_tpu_torch.telemetry import export, http_exporter, registry, slo
from petastorm_tpu_torch.workers import dummy_pool, serializers, shm_ring, thread_pool

BOTH = {'jax': types.SimpleNamespace(
            unischema=jax_unischema, ngram=jax_ngram, errors=jax_errors,
            resilience=jax_resilience, export=jax_export, http=jax_http,
            registry=jax_registry, slo=jax_slo, dummy=jax_dummy,
            thread_pool=jax_thread_pool, serializers=jax_serializers,
            shm_ring=jax_shm_ring, controller=jax_controller, knobs=jax_knobs,
            policy=jax_policy, package=jax_package),
        'port': types.SimpleNamespace(
            unischema=unischema, ngram=ngram, errors=errors, resilience=resilience,
            export=export, http=http_exporter, registry=registry, slo=slo,
            dummy=dummy_pool, thread_pool=thread_pool, serializers=serializers,
            shm_ring=shm_ring, controller=controller, knobs=knobs, policy=policy,
            package=port_package)}


def _same_in_both(fn, raises=None):
    """``fn(modules)`` of each package must give equal results, or raise an
    exception of the same type, ``raises`` (a type name) when given."""
    out = {}
    for name, m in BOTH.items():
        try:
            out[name] = fn(m)
        except Exception as exc:  # noqa: BLE001 - the type is the answer
            if raises is None:
                raise
            out[name] = ('raised', type(exc).__name__)
    assert out['port'] == out['jax']
    if raises is not None:
        assert out['port'] == ('raised', raises)
    return out['port']


# ------------------------------------------------------------- row dicts

def _schema(u):
    return u.Unischema('Rows', [
        u.UnischemaField('id', np.int64, (), None, False),
        u.UnischemaField('name', np.str_, (), None, True),
        u.UnischemaField('vec', np.float32, (2,), None, True)])


ROW_CASES = {
    'complete': {'id': 1, 'name': 'a', 'vec': [1.0, 2.0]},
    'nullable_missing': {'id': 2},
    'extra_key': {'id': 3, 'name': 'b', 'vec': None, 'other': 9},
    'required_missing': {'name': 'c'},
}


@pytest.mark.parametrize('case', sorted(ROW_CASES))
def test_insert_explicit_nulls_and_make_namedtuple_from_dict(case):
    def run(m):
        schema = _schema(m.unischema)
        row = m.unischema.insert_explicit_nulls(schema, dict(ROW_CASES[case]))
        record = schema.make_namedtuple_from_dict(row)
        return row, type(record)._fields, tuple(record)

    if case == 'required_missing':
        _same_in_both(run, raises='ValueError')
    else:
        assert _same_in_both(run)[0]['id'] == ROW_CASES[case]['id']


NGRAM_ROWS = [{'ts': ts, 'a': i, 'b': -i, 'c': 10 * i}
              for i, ts in enumerate([0, 1, 2, 4, 5, 6, 7, 20, 21, 22])]


@pytest.mark.parametrize('overlap', [True, False], ids=['overlap', 'no_overlap'])
@pytest.mark.parametrize('offsets', [(0, 1), (-1, 1), (0, 1, 2)], ids=str)
def test_form_ngram_and_make_namedtuples(offsets, overlap):
    def run(m):
        u = m.unischema
        fields = {name: u.UnischemaField(name, np.int64, (), None, False)
                  for name in ('ts', 'a', 'b', 'c')}
        spec = {offset: [fields['ts'], fields['a'] if i % 2 == 0 else fields['b']]
                for i, offset in enumerate(offsets)}
        spec[offsets[-1]].append(fields['c'])
        gram = m.ngram.NGram(spec, delta_threshold=2, timestamp_field=fields['ts'],
                             timestamp_overlap=overlap)
        windows = gram.form_ngram([dict(row) for row in NGRAM_ROWS])
        tuples = [gram.make_namedtuples(window) for window in windows]
        return windows, [{k: (type(v)._fields, tuple(v)) for k, v in t.items()}
                         for t in tuples]

    windows, tuples = _same_in_both(run)
    assert windows and len(tuples) == len(windows)


def test_process_ngram_piece_refuses_a_predicate():
    from petastorm_tpu.ngram_worker import process_ngram_piece as jax_piece
    from petastorm_tpu_torch.ngram_worker import process_ngram_piece
    worker = types.SimpleNamespace(_setup=types.SimpleNamespace(ngram=None))
    with pytest.raises(NotImplementedError):
        jax_piece(worker, 0, 'f', 0, {}, object(), (0, 1))
    with pytest.raises(NotImplementedError):
        process_ngram_piece(worker, 0, 'f', 0, {}, (0, 1), worker_predicate=object())


# ------------------------------------------------------------- telemetry

def _snapshot(m):
    reg = m.registry.MetricsRegistry()
    for value in (0.001, 0.004, 0.2):
        reg.observe('decode', value)
    reg.observe('odd.stage-name', 0.5)
    reg.inc('rows', 7)
    reg.gauge('queue depth').set(3.5)
    return reg.snapshot()


EXPOSITIONS = {
    'default': {},
    'prefix': {'prefix': 'ptt'},
    'empty_prefix': {'prefix': ''},
    'labels': {'labels': {'worker': '3', 'host': 'a"b'}},
    'both': {'prefix': 'x', 'labels': {'client': 'c\n1'}},
}


@pytest.mark.parametrize('case', sorted(EXPOSITIONS))
def test_prometheus_text_prefix_and_labels(case):
    snapshot = _snapshot(BOTH['jax'])
    texts = {name: m.export.to_prometheus_text(snapshot, **EXPOSITIONS[case])
             for name, m in BOTH.items()}
    assert texts['port'] == texts['jax']
    assert texts['port'].endswith('\n')


def test_http_server_and_service_state_prefix():
    snapshot = _snapshot(BOTH['jax'])
    state = {'clients': [{'name': 'c0', 'queued': 2, 'in_flight': 1, 'served': 5,
                          'window_size': 4}],
             'workers': [{'id': 1, 'assigned': 3, 'heartbeat_age_s': 0.25}]}

    def run(m):
        server = m.http.MetricsHttpServer(lambda: snapshot, prefix='svc',
                                          labeled_fn=lambda: {'0': snapshot})
        return server.render_metrics(), m.http.service_state_text(state, prefix='svc')

    metrics, state_text = _same_in_both(run)
    assert 'svc_decode_count' in metrics and 'svc_worker_decode_count' in metrics
    assert 'svc_service_client_queued{client="c0"} 2' in state_text


@pytest.mark.parametrize('history_size', [1, 3, 40])
def test_slo_tracker_history_size(history_size):
    snapshot = {'histograms': {'pool_wait': {'unit': 1e-6, 'count': 4, 'sum': 2.0,
                                             'max': 1.0, 'buckets': {}}},
                'counters': {}, 'gauges': {}}

    def run(m):
        tracker = m.slo.SloTracker(history_size=history_size)
        lengths = [len(tracker.evaluate(snapshot, 10.0 + i, rows=100 * i)['history'])
                   for i in range(5)]
        return lengths, len(tracker.history())

    lengths, final = _same_in_both(run)
    assert final == min(history_size, 5) and lengths[-1] == final


# ------------------------------------------------------------- resilience

def test_breaker_board_on_transition_and_reset():
    def run(m):
        now = [0.0]
        seen = []
        board = m.resilience.BreakerBoard()
        brk = board.breaker('fs:/x', failure_threshold=2, recovery_timeout_s=5.0,
                            clock=lambda: now[0],
                            on_transition=lambda *t: seen.append(t))
        assert board.breaker('fs:/x') is brk
        brk.record_failure()
        brk.record_failure()
        now[0] = 6.0
        allowed = brk.allow()
        brk.record_success()
        board.reset()
        fresh = board.breaker('fs:/x', failure_threshold=2)
        return seen, allowed, fresh is brk, board.snapshot()

    seen, allowed, same, snapshot = _same_in_both(run)
    assert [t[1:] for t in seen] == [('closed', 'open'), ('open', 'half_open'),
                                     ('half_open', 'closed')]
    assert allowed and not same and list(snapshot) == ['fs:/x']


def test_errors_worker_hang_and_quarantine_cause():
    def run(m):
        cause = OSError('gone')
        err = m.errors.QuarantinedRowGroupError('skipped', piece_index=3, attempts=2,
                                                cause=cause)
        return (issubclass(m.errors.WorkerHangError, m.errors.PetastormTpuError),
                err.cause is cause, err.piece_index, str(err))

    assert _same_in_both(run) == (True, True, 3, 'skipped')


# ------------------------------------------------------------- workers

class _EchoWorker(object):
    def __init__(self, worker_id, publish_func, args):
        self.worker_id = worker_id
        self._publish = publish_func

    def process(self, value):
        self._publish(value)

    def shutdown(self):
        pass


class _Never(object):
    """A ventilator that never completes and feeds nothing."""
    error = None

    def start(self):
        pass

    def processed_item(self):
        pass

    def completed(self):
        return False

    def stop(self):
        pass


@pytest.mark.parametrize('pool', ['thread', 'dummy'])
def test_pools_timeout_diagnostics_and_signatures(pool):
    def run(m):
        if pool == 'thread':
            p = m.thread_pool.ThreadPool(1, results_queue_size=4, max_workers_count=2)
        else:
            p = m.dummy.DummyPool(results_queue_size=4)
        p.start(_EchoWorker, None, ventilator=_Never() if pool == 'thread' else None)
        try:
            p.ventilate(value=5)
            first = p.get_results(timeout=5)
            try:
                p.ventilate(6)
                ventilate_positional = 'accepted'
            except TypeError:
                ventilate_positional = 'TypeError'
            diagnostics = sorted(p.diagnostics)
            resized = p.set_workers_count(9) if pool == 'thread' else None
            if pool == 'thread':
                try:
                    p.get_results(timeout=0.2)
                    timeout = 'returned'
                except Exception as exc:  # noqa: BLE001 - the type is the answer
                    timeout = type(exc).__name__
            else:
                timeout = None
            return first, ventilate_positional, diagnostics, resized, timeout
        finally:
            p.stop()
            p.join()

    first, positional, diagnostics, resized, timeout = _same_in_both(run)
    assert first == 5 and diagnostics == ['output_queue_size']
    if pool == 'thread':
        assert positional == 'TypeError' and resized == 2
        assert timeout == 'TimeoutWaitingForResultError'


def test_ventilator_base_and_shuffling_buffer_base():
    from petastorm_tpu.parallel import shuffling_buffer as jax_buffers
    from petastorm_tpu.workers import ventilator as jax_ventilator
    from petastorm_tpu_torch.parallel import shuffling_buffer as buffers
    from petastorm_tpu_torch.workers import ventilator
    for vent_module, buffer_module in ((jax_ventilator, jax_buffers), (ventilator, buffers)):
        assert issubclass(vent_module.ConcurrentVentilator, vent_module.Ventilator)
        base = vent_module.Ventilator(lambda **kw: None)
        for method in ('start', 'processed_item', 'completed', 'stop'):
            with pytest.raises(NotImplementedError):
                getattr(base, method)()
        assert issubclass(buffer_module.RandomShufflingBuffer,
                          buffer_module.ShufflingBufferBase)
        assert issubclass(buffer_module.NoopShufflingBuffer,
                          buffer_module.ShufflingBufferBase)

    def can_add_trace(module):
        buf = module.RandomShufflingBuffer(10, 2, seed=3)
        trace = [buf.can_add()]
        for n in (4, 6):
            buf.add_many({'x': np.arange(n)})
            trace.append(buf.can_add())
        trace.append(sorted(buf.retrieve(5)['x'].tolist()))
        trace.append(buf.can_add())
        buf.finish()
        trace.append(buf.can_add())
        return trace

    assert can_add_trace(buffers) == can_add_trace(jax_buffers)


def _encoded():
    columns = {'x': np.arange(12, dtype=np.float32).reshape(4, 3),
               'n': np.arange(4, dtype=np.int64),
               's': np.array(['a', 'b', 'c', 'd'], dtype=object),
               'r': [np.arange(i) for i in range(4)]}
    ipc, sidecar = serializers.encode_columnar(columns, 4, {'item_id': [0, 1]})
    return columns, ipc, sidecar


@pytest.mark.parametrize('writable', [True, False], ids=['writable', 'views'])
def test_decode_columnar_stats_and_writable(writable):
    columns, ipc, sidecar = _encoded()
    out = {}
    for name, m in BOTH.items():
        stats = (m.serializers._new_wire_stats() if name == 'jax'
                 else m.serializers.new_wire_stats())
        decoded, meta = m.serializers.decode_columnar(ipc_frame=ipc, sidecar_frame=sidecar,
                                                      writable=writable, stats=stats)
        out[name] = (decoded, meta, stats)
    (ours, our_meta, our_stats), (theirs, their_meta, their_stats) = out['port'], out['jax']
    assert our_meta == their_meta and our_stats == their_stats
    assert sorted(our_stats) == ['batches', 'bytes_copied', 'bytes_zero_copy',
                                 'sidecar_column_names', 'sidecar_columns']
    assert sorted(ours) == sorted(theirs) == sorted(columns)
    for key in ('x', 'n'):
        np.testing.assert_array_equal(ours[key], columns[key])
        assert ours[key].flags.writeable == theirs[key].flags.writeable == writable


@pytest.mark.parametrize('writable', [True, False], ids=['writable', 'views'])
def test_arrow_ipc_serializer_writable(writable):
    from petastorm_tpu.reader_worker import ColumnarBatch as JaxBatch
    from petastorm_tpu_torch.reader_worker import ColumnarBatch
    columns = {'x': np.arange(6, dtype=np.int32).reshape(3, 2),
               's': np.array(['a', 'b', 'c'], dtype=object)}
    flags, stats = {}, {}
    for name, batch_type in (('jax', JaxBatch), ('port', ColumnarBatch)):
        serializer = BOTH[name].serializers.ArrowIpcSerializer(writable=writable)
        assert serializer.writable is writable
        frames = serializer.serialize(batch_type(dict(columns), 3, item_id=(0, 1, 0)))
        back = serializer.deserialize(frames)
        np.testing.assert_array_equal(back.columns['x'], columns['x'])
        assert back.columns['s'].tolist() == ['a', 'b', 'c']
        flags[name] = back.columns['x'].flags.writeable
        stats[name] = dict(serializer.stats)
    assert flags['port'] == flags['jax'] == writable
    assert stats['port'] == stats['jax']
    assert stats['port']['sidecar_column_names'] == ['s']


@pytest.mark.parametrize('checksum', [True, False])
def test_shm_ring_writer_checksum_and_slot_range(checksum):
    ring = shm_ring.ShmRing(2, slots_per_worker=3, slot_bytes=4096)
    try:
        spec = ring.worker_spec()
        out = {}
        for worker_slot, (name, m) in enumerate(BOTH.items()):
            writer = m.shm_ring.ShmRingWriter(ring.name, worker_slot, 0,
                                              spec['slots_per_worker'], spec['slot_bytes'],
                                              spec['data_offset'], checksum=checksum)
            try:
                descriptor = writer.try_write([b'abc', b'defg'])
                views = ring.view(shm_ring.ShmSlotDescriptor.from_bytes(
                    descriptor.to_bytes()))
                payload = b''.join(bytes(v) for v in views)
                for view in views:
                    view.release()
                out[name] = (writer.slot_range(), descriptor.crc, payload)
            finally:
                writer.close()
    finally:
        ring.close_and_unlink()
    assert out['jax'][0] == (0, 3) and out['port'][0] == (3, 3)
    assert out['port'][1:] == out['jax'][1:]
    assert (out['port'][1] is None) == (not checksum)


def test_frame_aliases():
    from petastorm_tpu.workers import integrity as jax_integrity
    from petastorm_tpu_torch.workers import integrity
    assert integrity.Frame == jax_integrity.Frame
    assert serializers.Frame == jax_serializers.Frame


# ------------------------------------------------------------- store and reader

@pytest.fixture(scope='module')
def store(tmp_path_factory):
    from petastorm_tpu_torch.codecs import CompressedNdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    schema = unischema.Unischema('Surface', [
        unischema.UnischemaField('id', np.int64, (), ScalarCodec(), False),
        unischema.UnischemaField('m', np.float32, (2, 3), CompressedNdarrayCodec(), False)])
    rng = np.random.RandomState(2)
    rows = [{'id': i, 'm': rng.randn(2, 3).astype(np.float32)} for i in range(24)]
    url = 'file://' + str(tmp_path_factory.mktemp('surface') / 'store')
    write_rows(url, schema, rows, rowgroup_size_mb=1, n_files=2)
    return url, rows


def test_dataset_handle_schema_and_materialize_rowgroup_size(store, tmp_path):
    from petastorm_tpu.etl import dataset_metadata as jax_metadata
    from petastorm_tpu_torch.etl import dataset_metadata
    url, _ = store
    ours = dataset_metadata.open_dataset(url).schema
    theirs = jax_metadata.open_dataset(url).schema
    assert ours.equals(theirs) and ours.names == ['id', 'm']
    target = 'file://' + str(tmp_path / 'copy')
    schema = dataset_metadata.get_schema(dataset_metadata.open_dataset(url))
    dataset_metadata.write_rows(target, schema, [{'id': 1, 'm': np.zeros((2, 3), np.float32)}])
    with dataset_metadata.materialize_dataset(target, schema, rowgroup_size_mb=8):
        pass
    assert dataset_metadata.get_schema(dataset_metadata.open_dataset(target)) == schema


def test_caches_take_shards(tmp_path):
    from petastorm_tpu import cache as jax_cache
    from petastorm_tpu_torch import cache
    assert cache.MB == jax_cache.MB == 1 << 20
    for kind in ('LocalDiskCache', 'ArrowIpcDiskCache'):
        ours = getattr(cache, kind)(str(tmp_path / kind), 10 * cache.MB, shards=8)
        value = {'x': np.arange(5)}
        got = ours.get('k', lambda: value)
        again = ours.get('k', lambda: pytest.fail('a hit must not fill'))
        np.testing.assert_array_equal(got['x'], again['x'])


def _ndarray_blobs(codec_module, unischema_module):
    field = unischema_module.UnischemaField('m', np.float32, (None, 3), None, True)
    rng = np.random.RandomState(4)
    values = [rng.randn(2, 3).astype(np.float32), None,
              np.asfortranarray(rng.randn(4, 3).astype(np.float32)),
              rng.randn(1, 3).astype(np.float32)]
    encoded = [None if v is None else codec_module.CompressedNdarrayCodec().encode(field, v)
               for v in values]
    return field, values, encoded


def test_compressed_ndarray_decode_column_matches_jax():
    from petastorm_tpu import codecs as jax_codecs
    from petastorm_tpu_torch import codecs
    field, values, encoded = _ndarray_blobs(codecs, unischema)
    jax_field, _, _ = _ndarray_blobs(jax_codecs, jax_unischema)
    ours = codecs.CompressedNdarrayCodec().decode_column(field, encoded)
    theirs = jax_codecs.CompressedNdarrayCodec().decode_column(jax_field, encoded)
    assert len(ours) == len(theirs) == len(values)
    for got, want, value in zip(ours, theirs, values):
        if value is None:
            assert got is None and want is None
            continue
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, value)
        assert got.flags.writeable and got.flags.c_contiguous


@pytest.mark.parametrize('decode', [True, False])
def test_reader_takes_the_jax_keywords(store, decode):
    """``Reader(dataset_url_or_urls=)`` with no handle or schema opens the store
    and infers the schema from Arrow (the stored blobs stay bytes), as JAX's
    does; ``telemetry`` is the reader's registry; ``cleanup`` does nothing."""
    from petastorm_tpu.reader import Reader as JaxReader
    from petastorm_tpu_torch.reader import Reader
    from petastorm_tpu_torch.reader_worker import WorkerSetup
    url, rows = store
    read = {}
    for name, reader_type, pool in (('port', Reader, dummy_pool.DummyPool),
                                    ('jax', JaxReader, jax_dummy.DummyPool)):
        reader = reader_type(dataset_url_or_urls=url, reader_pool=pool(),
                             shuffle_row_groups=False, decode=decode)
        try:
            read[name] = [(row.id, bytes(row.m)) for row in reader]
            assert isinstance(reader.telemetry, BOTH[name].registry.MetricsRegistry)
            assert reader.telemetry.snapshot() == reader.telemetry.snapshot()
            reader.cleanup()
        finally:
            reader.stop()
            reader.join()
    assert read['port'] == read['jax'] and [i for i, _ in read['port']] == [
        r['id'] for r in rows]
    schema = unischema.Unischema('S', [unischema.UnischemaField('id', np.int64, (), None,
                                                                False)])
    assert WorkerSetup(lambda: None, schema, ['id'], decode=False).decode is False
    assert WorkerSetup(lambda: None, schema, ['id']).decode is True


def test_autotune_controller_event_logger(tmp_path):
    def run(m):
        values = {'decode_threads': 2.0}

        def apply(value):
            values['decode_threads'] = max(1.0, min(6.0, float(value)))
            return values['decode_threads']

        catalog = m.knobs.KnobCatalog([m.knobs.Knob(
            'decode_threads', 'scripted', minimum=1.0, maximum=6.0, step=1.0,
            cost='cheap', stages=('decode',), get=lambda: values['decode_threads'],
            apply=apply)])
        clock = [0.0]
        rows = [0.0]
        hist = {'unit': 1e-6, 'count': 10, 'sum': 0.0, 'max': 1.0}

        def snapshot():
            # decode dominates every window: the controller climbs decode_threads
            hist['sum'] += 3.0
            hist['count'] += 10
            wait = dict(hist, sum=hist['sum'] / 10)
            return {'histograms': {'decode': dict(hist), 'pool_wait': wait},
                    'counters': {}, 'gauges': {}}

        path = tmp_path / '{}.jsonl'.format(m.package.__name__)
        logger = m.export.JsonlEventLogger(str(path), interval_s=0.0)
        ctl = m.controller.AutotuneController(
            catalog, metric_fn=lambda: rows[0], snapshot_fn=snapshot,
            policy=m.policy.AutotunePolicy(window_s=1.0, warmup_windows=0, hold_windows=0,
                                           cooldown_windows=1),
            breaker_snapshot_fn=dict, clock=lambda: clock[0], event_logger=logger)
        for _ in range(8):
            ctl.step()
            clock[0] += 1.0
            rows[0] += 100.0 + 20.0 * values['decode_threads']
        events = [json.loads(line) for line in path.read_text().splitlines()]
        return [{k: v for k, v in e.items() if not k.startswith('ts') and k != 'pid'}
                for e in events], values['decode_threads']

    events, final = _same_in_both(run)
    assert [e['action'] for e in events] == ['propose', 'commit'] * 3 + ['propose']
    assert all(e['event'] == 'autotune_decision' for e in events) and final == 6.0


def test_sanitize_columns_device_put():
    from petastorm_tpu.parallel.loader import sanitize_columns as jax_sanitize
    from petastorm_tpu_torch.parallel.loader import sanitize_columns
    columns = {'s': np.array(['a', 'b'], dtype=object),
               't': np.array(['2020-01-01', '2021-01-01'], dtype='datetime64[D]')}
    for fn in (sanitize_columns, jax_sanitize):
        with pytest.raises(ValueError, match="'s'"):
            fn(dict(columns), {}, True)
    ours, theirs = sanitize_columns(dict(columns), {}, False), jax_sanitize(dict(columns), {},
                                                                             False)
    assert ours['s'] is columns['s'] and theirs['s'] is columns['s']
    np.testing.assert_array_equal(ours['t'], theirs['t'])
    assert ours['t'].dtype == np.int64


def test_host_batches_keep_string_columns_like_jax(tmp_path):
    """``TorchDataLoader(device_put=False)`` yields a string column as the
    JAX loader's host batches do (it raised before the port took
    ``sanitize_columns(device_put=)``)."""
    from petastorm_tpu.parallel.loader import JaxDataLoader
    from petastorm_tpu_torch import TorchDataLoader, make_reader
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    url = 'file://' + str(tmp_path / 'strings')
    schema = unischema.Unischema('S', [
        unischema.UnischemaField('s', np.str_, (), ScalarCodec(), False),
        unischema.UnischemaField('i', np.int64, (), ScalarCodec(), False)])
    write_rows(url, schema, [{'s': 'n{}'.format(i), 'i': i} for i in range(6)])
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=False)
    with make_reader(url, **kwargs) as reader:
        ours = list(TorchDataLoader(reader, batch_size=3, device='cpu', device_put=False))
    with jax_package.make_reader(url, **kwargs) as reader:
        theirs = list(JaxDataLoader(reader, batch_size=3, device_put=False))
    assert len(ours) == len(theirs) == 2
    for got, want in zip(ours, theirs):
        assert sorted(got) == sorted(want) == ['i', 's']
        assert got['s'].tolist() == want['s'].tolist()
        np.testing.assert_array_equal(got['i'], want['i'])
