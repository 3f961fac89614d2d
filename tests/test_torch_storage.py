"""The port's object-store ingest engine (``petastorm_tpu_torch.storage``)
against the JAX package's: policy resolution, range plans on the same footers,
``RowGroupSource`` tables equal to the JAX engine's and to
``fragment.to_table()``, hedging past a deterministic p99 tail, footer
sidecars shared between the packages, the reader wired to the engine (rows
and lineage digest equal to the JAX reader's), the ``storage_fetch_window``
knob, and the disk cache's bypass breaker with its two knobs."""

import glob
import os
import threading

import numpy as np
import pyarrow as pa
import pyarrow.dataset as pads
import pyarrow.fs as pafs
import pyarrow.parquet as pq
import pytest

import petastorm_tpu.storage as jax_storage
import petastorm_tpu.storage.engine as jax_engine
import petastorm_tpu.storage.metadata_cache as jax_mc
import petastorm_tpu.storage.range_planner as jax_rp
import petastorm_tpu.test_util.fault_injection as jax_fi
import petastorm_tpu_torch.storage as port_storage
import petastorm_tpu_torch.storage.engine as port_engine
import petastorm_tpu_torch.storage.metadata_cache as port_mc
import petastorm_tpu_torch.storage.range_planner as port_rp
import petastorm_tpu_torch.test_util.fault_injection as port_fi
from petastorm_tpu_torch import make_reader
from petastorm_tpu_torch.storage import StoragePolicy
from petastorm_tpu_torch.storage.fetcher import FETCH_WINDOW_ENV, RangeFetcher, fetch_window
from petastorm_tpu_torch.storage.range_planner import ByteRange, RangePlan

ROWS = 64


@pytest.fixture
def counters():
    """Telemetry on and a fresh storage registry in both packages; yields
    the port's counters."""
    from petastorm_tpu.telemetry.registry import set_telemetry_enabled as jax_set
    from petastorm_tpu_torch.telemetry.registry import (set_telemetry_enabled,
                                                        telemetry_enabled)
    was = telemetry_enabled()
    set_telemetry_enabled(True)
    jax_set(True)
    port_storage.reset_storage_metrics()
    jax_storage.reset_storage_metrics()
    try:
        yield lambda: port_storage.storage_metrics_snapshot().get('counters') or {}
    finally:
        set_telemetry_enabled(was)
        jax_set(was)
        port_storage.reset_storage_metrics()
        jax_storage.reset_storage_metrics()


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    """64 rows ``id``/``vec``/``label`` in 4 files, written by the JAX
    package."""
    from petastorm_tpu.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu.etl.dataset_metadata import write_rows
    from petastorm_tpu.unischema import Unischema, UnischemaField
    schema = Unischema('StorageProbe', [
        UnischemaField('id', np.int64, (), ScalarCodec(), False),
        UnischemaField('label', np.int32, (), ScalarCodec(), False),
        UnischemaField('vec', np.float32, (16,), NdarrayCodec(), False)])
    url = 'file://' + str(tmp_path_factory.mktemp('storage') / 'store')
    write_rows(url, schema, [{'id': i, 'label': i % 5, 'vec': np.full(16, i, np.float32)}
                             for i in range(ROWS)], n_files=4)
    return url


def _parquet(path, num_rows=120, row_group_size=40, columns=('a', 'b', 'c')):
    table = pa.table({name: np.arange(num_rows, dtype=np.int64) * (i + 1)
                      for i, name in enumerate(columns)})
    pq.write_table(table, path, row_group_size=row_group_size)
    return pq.read_metadata(path)


# ------------------------------------------------------------------- policy

@pytest.mark.parametrize('value, url', [
    (None, '/local/data'), (None, 'file:///local/data'), (None, 'hdfs://nn/data'),
    (None, 's3://bucket/data'), (None, 'gs://bucket/data'), (None, 'C:/data'),
    (None, ['s3://a/b', '/local']), (None, ['/local', 's3://a/b']),
    (True, '/local/data'), (False, 's3://bucket/data'),
])
def test_resolve_storage_policy_matches_jax(value, url):
    port = port_storage.resolve_storage_policy(value, url)
    jax = jax_storage.resolve_storage_policy(value, url)
    assert (port is None) == (jax is None)
    if port is not None:
        assert repr(port).split('(', 1)[1] == repr(jax).split('(', 1)[1]


def test_resolve_storage_policy_passes_instances_and_refuses_garbage():
    policy = StoragePolicy(max_in_flight=3)
    assert port_storage.resolve_storage_policy(policy, 's3://x') is policy
    for module in (port_storage, jax_storage):
        with pytest.raises(TypeError):
            module.resolve_storage_policy('yes', '/x')


# ------------------------------------------------------------------ planner

@pytest.mark.parametrize('ranges, gap', [
    ([], 0), ([(0, 10), (10, 20)], 0), ([(0, 10), (5, 30)], 0), ([(0, 100), (10, 20)], 0),
    ([(0, 10), (15, 20)], 5), ([(0, 10), (16, 20)], 5), ([(30, 40), (0, 10)], 100),
    ([(0, 10), (10, 12)], -4),
])
def test_coalesce_ranges_matches_jax(ranges, gap):
    port = port_rp.coalesce_ranges([port_rp.ByteRange(*r) for r in ranges], gap)
    jax = jax_rp.coalesce_ranges([jax_rp.ByteRange(*r) for r in ranges], gap)
    assert [tuple(r) for r in port] == [tuple(r) for r in jax]


@pytest.mark.parametrize('row_groups, columns, gap', [
    ([0, 1, 2], ['a', 'b', 'c'], 0), ([0, 1, 2], ['a', 'c'], 0),
    ([1], ['b'], 1 << 20), ([0, 2], ['a', 'b'], 64), ([0], [], 0),
])
def test_plan_ranges_equal_on_the_same_footer(tmp_path, row_groups, columns, gap):
    footer = _parquet(str(tmp_path / 'f.parquet'))
    port = port_rp.plan_ranges(footer, row_groups, columns, gap)
    jax = jax_rp.plan_ranges(footer, row_groups, columns, gap)
    assert [tuple(r) for r in port.ranges] == [tuple(r) for r in jax.ranges]
    assert (port.raw_ranges, port.total_bytes, port.columns, port.coalesced_away) == \
        (jax.raw_ranges, jax.total_bytes, jax.columns, jax.coalesced_away)


def test_planner_refuses_a_column_the_footer_lacks(tmp_path):
    from petastorm_tpu_torch.errors import MetadataError
    footer = _parquet(str(tmp_path / 'f.parquet'))
    with pytest.raises(MetadataError, match='nope'):
        port_rp.plan_ranges(footer, [0], ['a', 'nope'], 0)
    assert port_rp.plan_ranges(footer, [], ['nope'], 0).ranges == ()


# ------------------------------------------------------------------- engine

@pytest.mark.parametrize('row_group_id, columns', [(0, ['a', 'b']), (2, ['c']),
                                                   (None, ['a', 'c'])])
def test_row_group_source_equals_jax_engine_and_to_table(tmp_path, counters, row_group_id,
                                                         columns):
    path = str(tmp_path / 'f.parquet')
    _parquet(path)
    fs = pafs.LocalFileSystem()
    port = port_engine.RowGroupSource(path, fs, StoragePolicy(hedge_enabled=False),
                                      row_group_id, port_mc.MetadataCache())
    jax = jax_engine.RowGroupSource(path, fs, jax_storage.StoragePolicy(hedge_enabled=False),
                                    row_group_id, jax_mc.MetadataCache())
    row_groups = None if row_group_id is None else [row_group_id]
    plain = pads.ParquetFileFormat().make_fragment(path, fs, row_groups=row_groups) \
        .to_table(columns=columns)
    table = port.read_columns(columns)
    assert table.equals(jax.read_columns(columns)) and table.equals(plain)
    # a second call for columns already fetched plans and fetches nothing
    have = set(port._have)
    assert port.read_columns(columns[:1]).equals(plain.select(columns[:1]))
    assert port._have == have
    assert port.schema_arrow().names == ['a', 'b', 'c']


class _Handle(object):
    """A scripted read handle over a bytes buffer; ``wait_for`` stalls a
    read until released, ``corrupt`` returns 0xFF bytes."""

    def __init__(self, data, wait_for=None, corrupt=False):
        self._data, self._pos, self._wait_for, self._corrupt = data, 0, wait_for, corrupt

    def seek(self, pos):
        self._pos = pos

    def read(self, n):
        if self._wait_for is not None:
            self._wait_for.wait(timeout=10.0)
        chunk = self._data[self._pos:self._pos + n]
        return b'\xff' * len(chunk) if self._corrupt else chunk


DATA = bytes(range(256))


def test_hedge_wins_and_the_loser_is_dropped(counters):
    release = threading.Event()
    opened = []
    lock = threading.Lock()

    def open_fn():
        with lock:
            opened.append(True)
            first = len(opened) == 1
        # the primary straggles and would return corrupt bytes if committed
        return _Handle(DATA, wait_for=release, corrupt=True) if first else _Handle(DATA)

    fetcher = RangeFetcher(open_fn, StoragePolicy(hedge_min_s=0.02))
    plan = RangePlan(ranges=(ByteRange(10, 30),), raw_ranges=1, total_bytes=20, columns=())
    try:
        result = fetcher.fetch(plan)
    finally:
        release.set()
    assert result.segments[ByteRange(10, 30)] == DATA[10:30]
    assert (result.hedges_fired, result.hedges_won) == (1, 1)
    assert counters().get('storage_hedge_fired') == counters().get('storage_hedge_won') == 1
    assert result.trace_args() == {'bytes': 20, 'ranges': 1, 'hedges_fired': 1,
                                   'hedges_won': 1}


def test_hedging_beats_a_deterministic_p99_tail(tmp_path, counters):
    """Every 10th read of the file stalls 0.3 s (the fault-injecting
    filesystem's tail): hedged reads of all rowgroups finish faster than the
    unhedged ones and return the same tables."""
    import time
    path = str(tmp_path / 'f.parquet')
    _parquet(path, num_rows=400, row_group_size=20)

    def read_all(policy, name):
        fs = port_fi.fault_injecting_filesystem(port_fi.FaultSchedule(
            str(tmp_path / name), [port_fi.FaultRule('f.parquet', kind='latency',
                                                     latency_s=0.001, tail_latency_s=0.3,
                                                     tail_every_n=10)]))
        cache = port_mc.MetadataCache()
        start = time.perf_counter()
        tables = [port_engine.RowGroupSource(path, fs, policy, rg, cache)
                  .read_columns(['a', 'b', 'c']) for rg in range(20)]
        return tables, time.perf_counter() - start

    hedged, hedged_s = read_all(StoragePolicy(hedge_quantile=0.5, hedge_factor=2.0,
                                              hedge_min_s=0.02, coalesce_gap_bytes=0), 'h')
    fired = counters().get('storage_hedge_fired', 0)
    port_storage.reset_storage_metrics()
    plain, plain_s = read_all(StoragePolicy(hedge_enabled=False, coalesce_gap_bytes=0), 'p')
    assert fired > 0 and counters().get('storage_hedge_fired', 0) == 0
    assert all(a.equals(b) for a, b in zip(hedged, plain))
    assert hedged_s < plain_s


def test_fetch_window_env_override_and_clamp(monkeypatch):
    from petastorm_tpu.storage.fetcher import fetch_window as jax_fetch_window
    for raw in (None, '3', '0', '999', 'junk'):
        if raw is None:
            monkeypatch.delenv(FETCH_WINDOW_ENV, raising=False)
        else:
            monkeypatch.setenv(FETCH_WINDOW_ENV, raw)
        assert fetch_window(StoragePolicy(max_in_flight=5)) == \
            jax_fetch_window(jax_storage.StoragePolicy(max_in_flight=5))


class _CountingFs(object):
    """The local filesystem, counting opens: a footer served from a sidecar
    opens nothing."""

    def __init__(self):
        self._fs = pafs.LocalFileSystem()
        self.opens = 0

    def get_file_info(self, path):
        return self._fs.get_file_info(path)

    def open_input_file(self, path):
        self.opens += 1
        return self._fs.open_input_file(path)


@pytest.mark.parametrize('writer, reader', [(jax_mc, port_mc), (port_mc, jax_mc)])
def test_footer_sidecar_written_by_one_package_is_a_hit_in_the_other(tmp_path, counters,
                                                                      writer, reader):
    path = str(tmp_path / 'f.parquet')
    _parquet(path)
    warm = _CountingFs()
    writer.MetadataCache(disk_dir=str(tmp_path)).get(warm, path)
    assert warm.opens >= 1
    assert len(glob.glob(str(tmp_path / '_petastorm_tpu_footer_*.bin'))) == 1
    cold = _CountingFs()
    entry = reader.MetadataCache(disk_dir=str(tmp_path)).get(cold, path)
    assert cold.opens == 0 and entry.metadata.num_rows == 120
    # a rewrite (new size) invalidates the sidecar in both
    _parquet(path, num_rows=150)
    assert reader.MetadataCache(disk_dir=str(tmp_path)).get(cold, path) \
        .metadata.num_rows == 150 and cold.opens >= 1


def test_metadata_cache_lru_and_invalidation(tmp_path, counters):
    path = str(tmp_path / 'f.parquet')
    _parquet(path, num_rows=100)
    fs = pafs.LocalFileSystem()
    cache = port_mc.MetadataCache(capacity=1)
    assert cache.get(fs, path).metadata.num_rows == 100
    assert cache.get(fs, path).metadata.num_rows == 100
    assert counters().get('storage_footer_cache_hit') == 1
    _parquet(path, num_rows=150)
    assert cache.get(fs, path).metadata.num_rows == 150
    assert counters().get('storage_footer_cache_miss') == 2


# ------------------------------------------------------------------- reader

def _read(make, url, **kwargs):
    kwargs.setdefault('reader_pool_type', 'dummy')
    kwargs.setdefault('seed', 7)
    with make(url, **kwargs) as reader:
        rows = [(int(i), float(v[0])) for batch in reader.iter_columnar()
                for i, v in zip(batch.columns['id'], batch.columns['vec'])]
        return rows, reader.order_digest(), reader.diagnostics


@pytest.mark.parametrize('pool', ['dummy', 'thread'])
def test_engine_reader_equals_the_jax_reader(store, counters, pool):
    import petastorm_tpu as pt
    from petastorm_tpu.telemetry.lineage import LineagePolicy as JaxLineagePolicy
    from petastorm_tpu_torch.telemetry.lineage import LineagePolicy
    port_rows, port_digest, port_diag = _read(
        make_reader, store, reader_pool_type=pool, workers_count=2, storage_policy=True,
        lineage=LineagePolicy(manifest=False))
    jax_rows, jax_digest, _ = _read(pt.make_reader, store, storage_policy=True,
                                    lineage=JaxLineagePolicy(manifest=False))
    plain_rows, plain_digest, plain_diag = _read(make_reader, store, reader_pool_type=pool,
                                                 workers_count=2,
                                                 lineage=LineagePolicy(manifest=False))
    assert sorted(port_rows) == sorted(jax_rows) == sorted(plain_rows)
    assert port_digest == jax_digest == plain_digest
    assert 'storage' not in plain_diag
    storage = port_diag['storage']
    assert storage['footer_cache_misses'] >= 4 and storage['ranges_coalesced'] >= 4
    counters_seen = port_diag['telemetry']['counters']
    assert counters_seen['storage_footer_cache_miss'] == storage['footer_cache_misses']


def test_engine_predicate_reads_each_column_once(store, counters):
    import petastorm_tpu as pt
    from petastorm_tpu.predicates import in_set as jax_in_set
    from petastorm_tpu_torch.predicates import in_set
    port_rows, _, _ = _read(make_reader, store, storage_policy=True,
                            predicate=in_set([1, 3], 'label'))
    jax_rows, _, _ = _read(pt.make_reader, store, storage_policy=True,
                           predicate=jax_in_set([1, 3], 'label'))
    assert sorted(port_rows) == sorted(jax_rows)
    assert {i % 5 for i, _ in port_rows} == {1, 3} and len(port_rows) == 26


def test_hedged_epoch_is_rows_exact_under_a_tail(tmp_path, store, counters):
    def fs(name):
        return port_fi.fault_injecting_filesystem(port_fi.FaultSchedule(
            str(tmp_path / name), [port_fi.FaultRule('part_', kind='latency',
                                                     latency_s=0.002, tail_latency_s=0.2,
                                                     tail_every_n=4)]))
    truth, truth_digest, _ = _read(make_reader, store, shuffle_row_groups=False, lineage=True)
    hedged, hedged_digest, diag = _read(
        make_reader, store, shuffle_row_groups=False, lineage=True, filesystem=fs('h'),
        storage_policy=StoragePolicy(hedge_quantile=0.5, hedge_factor=2.0, hedge_min_s=0.02))
    assert hedged == truth and hedged_digest == truth_digest
    assert diag['storage']['hedges_fired'] > 0


def test_fetch_window_knob_only_when_armed(store, monkeypatch):
    from petastorm_tpu_torch.autotune.knobs import build_reader_knobs
    monkeypatch.delenv(FETCH_WINDOW_ENV, raising=False)
    with make_reader(store, reader_pool_type='dummy') as reader:
        assert 'storage_fetch_window' not in [k.knob_id for k in build_reader_knobs(reader)]
    with make_reader(store, reader_pool_type='dummy', storage_policy=True) as reader:
        knob = {k.knob_id: k for k in build_reader_knobs(reader)}['storage_fetch_window']
        assert knob.get() == float(StoragePolicy().max_in_flight)
        assert knob.apply(4.0) == 4.0 and os.environ[FETCH_WINDOW_ENV] == '4'
        knob.restore()
        assert FETCH_WINDOW_ENV not in os.environ


# ------------------------------------------------------------ cache breaker

def test_cache_breaker_opens_bypasses_and_recovers(tmp_path):
    """The walk of ``tests/test_cache.py``: repeated corruption opens the
    breaker, gets bypass the cache, the cooldown's probe closes it."""
    from petastorm_tpu_torch.cache import LocalDiskCache
    from petastorm_tpu_torch.resilience import CircuitBreaker
    clock = [0.0]
    breaker = CircuitBreaker('cache:test', failure_threshold=2, recovery_timeout_s=30.0,
                             clock=lambda: clock[0])
    cache = LocalDiskCache(str(tmp_path / 'c'), 10 << 20, breaker=breaker)
    fills = []

    def fill():
        fills.append(1)
        return 'v'

    cache.get('k', fill)
    for _ in range(2):
        (entry,) = glob.glob(str(tmp_path / 'c' / '*' / '*.pkl'))
        with open(entry, 'wb') as f:
            f.write(b'garbage')
        cache.get('k', fill)
    assert breaker.state == 'open'
    before = len(fills)
    cache.get('k', fill)   # bypassed: filled directly, nothing read or stored
    assert cache.stats['bypass_reads'] == 1 and len(fills) == before + 1
    clock[0] = 31.0        # cooldown over: the half-open probe hits the entry
    assert cache.get('k', fill) == 'v'
    assert breaker.state == 'closed' and len(fills) == before + 1


def test_forced_bypass_leaves_the_breaker_alone(tmp_path):
    from petastorm_tpu_torch.cache import ArrowIpcDiskCache
    from petastorm_tpu_torch.resilience import CircuitBreaker, default_board
    breaker = CircuitBreaker('cache:forced', failure_threshold=1)
    cache = ArrowIpcDiskCache(str(tmp_path / 'c'), 10 << 20, breaker=breaker)
    assert cache.set_bypass(True) is True and cache.bypass
    for _ in range(3):
        assert cache.get('k', lambda: {'x': np.arange(4)})['x'].sum() == 6
    assert cache.stats['bypass_reads'] == 3 and cache.stats['misses'] == 0
    assert breaker.state == 'closed' and breaker.as_dict()['failures'] == 0
    cache.set_bypass(False)
    cache.get('k', lambda: {'x': np.arange(4)})
    assert cache.stats['misses'] == 1
    # the default breaker is on the board, named by the path, and ships
    # without pickling (each process registers its own)
    import pickle
    plain = ArrowIpcDiskCache(str(tmp_path / 'd'), 10 << 20)
    assert 'cache:{}'.format(tmp_path / 'd') in default_board().snapshot()
    assert pickle.loads(pickle.dumps(plain)).stats['bypass_reads'] == 0


@pytest.mark.parametrize('kwargs, writable_knob', [
    ({}, True),
    ({'cache_extra_settings': {'writable_hits': True}}, False),
    ({'transform_spec': 'identity'}, False),
])
def test_cache_knobs_built_for_a_cache_armed_reader(tmp_path, store, kwargs, writable_knob):
    from petastorm_tpu_torch.autotune.knobs import build_reader_knobs
    from petastorm_tpu_torch.transform import TransformSpec
    if kwargs.get('transform_spec') == 'identity':
        kwargs = dict(kwargs, transform_spec=TransformSpec(lambda row: row))
    with make_reader(store, reader_pool_type='thread', workers_count=1,
                     cache_type='local-disk', cache_location=str(tmp_path / 'cache'),
                     cache_size_limit=1 << 30, **kwargs) as reader:
        knobs = {k.knob_id: k for k in build_reader_knobs(reader)}
        assert 'cache_bypass' in knobs
        assert ('cache_writable_hits' in knobs) == writable_knob
        assert knobs['cache_bypass'].apply(1.0) == 1.0 and reader._cache.bypass
        knobs['cache_bypass'].apply(0.0)
        rows = sum(batch.num_rows for batch in reader.iter_columnar())
    assert rows == ROWS
    with make_reader(store, reader_pool_type='thread', workers_count=1) as reader:
        assert 'cache_bypass' not in [k.knob_id for k in build_reader_knobs(reader)]
