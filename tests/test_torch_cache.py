"""The port's rowgroup cache against the JAX package's: both formats serve a
hit epoch equal to the filling epoch and to the JAX reader's rows, the
Arrow-IPC files have the JAX cache's byte layout, size-capped eviction drops
the same least recently touched entries, a predicate without a stable
identity bypasses the cache, and hits are writable under a transform."""

import os
import pickle

import numpy as np
import pytest

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu_torch import TransformSpec, make_batch_reader, make_reader
from petastorm_tpu_torch.cache import ArrowIpcDiskCache, LocalDiskCache

ROWS = 40
LIMIT = 1 << 30


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    """40 rows in 4 files of one rowgroup each: ``id``, a float32 (4,)
    ``vec`` and a ragged ``name`` string (a sidecar column in the cache)."""
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('Cached', [
        UnischemaField('id', np.int64, (), ScalarCodec(), False),
        UnischemaField('vec', np.float32, (4,), NdarrayCodec(), False),
        UnischemaField('name', np.str_, (), ScalarCodec(), False)])
    rng = np.random.RandomState(3)
    url = 'file://' + str(tmp_path_factory.mktemp('cache') / 'store')
    write_rows(url, schema, [{'id': i, 'vec': rng.randn(4).astype(np.float32),
                              'name': 'row{}'.format(i)} for i in range(ROWS)], n_files=4)
    return url


def _rows(reader):
    return [(row.id, row.vec.tolist(), row.name) for row in reader]


@pytest.mark.parametrize('cache_format', ['arrow-ipc', 'pickle'])
def test_the_hit_epoch_equals_the_filling_epoch_and_jax(store, tmp_path, cache_format):
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=True, shuffle_rows=True,
                  seed=5)
    cache = dict(cache_type='local-disk', cache_location=str(tmp_path / 'c'),
                 cache_size_limit=LIMIT, cache_format=cache_format)
    epochs = []
    for _ in range(2):
        with make_reader(store, **kwargs, **cache) as reader:
            epochs.append(_rows(reader))
            epochs.append(reader.diagnostics)
    with jax_make_reader(store, **kwargs) as reader:
        want = _rows(reader)
    fill, fill_diag, hit, hit_diag = epochs
    assert fill == hit == want and len(want) == ROWS
    assert (fill_diag['cache_misses'], fill_diag['cache_hits']) == (4, 0)
    assert (hit_diag['cache_hits'], hit_diag['cache_misses']) == (4, 0)
    hits_key = 'arrow_hits' if cache_format == 'arrow-ipc' else 'pickle_hits'
    assert hit_diag['cache'][hits_key] == 4


def test_arrow_entries_have_the_jax_byte_layout(tmp_path):
    from petastorm_tpu.cache import ArrowIpcDiskCache as JaxArrowIpcDiskCache
    value = {'id': np.arange(5), 'img': np.ones((5, 2, 3), np.uint8),
             'ragged': [np.arange(i) for i in range(5)]}
    ArrowIpcDiskCache(str(tmp_path), LIMIT).get('key', lambda: value)

    def refill():
        raise AssertionError('the JAX cache missed an entry the port wrote')

    got = JaxArrowIpcDiskCache(str(tmp_path), LIMIT).get('key', refill)
    assert sorted(got) == sorted(value)
    for name in ('id', 'img'):
        np.testing.assert_array_equal(got[name], value[name])
        assert got[name].dtype == value[name].dtype
    assert [r.tolist() for r in got['ragged']] == [r.tolist() for r in value['ragged']]


def test_hits_are_read_only_views_unless_writable(store, tmp_path):
    cache = dict(cache_type='local-disk', cache_location=str(tmp_path / 'c'),
                 cache_size_limit=LIMIT)
    for writable in (False, True):
        extra = {'writable_hits': True} if writable else None
        for _ in range(2):
            with make_reader(store, reader_pool_type='dummy', cache_extra_settings=extra,
                             **cache) as reader:
                batches = list(reader.iter_columnar())
        assert all(b.cache_hit for b in batches)
        assert all(b.columns['vec'].flags.writeable == writable for b in batches)


def _double_in_place(row):
    row['vec'] *= 2
    return row


def test_hits_are_writable_under_a_transform(store, tmp_path):
    """A transform that mutates its row in place works on the hit epoch too:
    with a transform_spec, hits are decoded writable by default."""
    cache = dict(cache_type='local-disk', cache_location=str(tmp_path / 'c'),
                 cache_size_limit=LIMIT)
    spec = TransformSpec(_double_in_place)
    epochs = []
    for _ in range(2):
        with make_reader(store, reader_pool_type='dummy', shuffle_row_groups=False,
                         transform_spec=spec, **cache) as reader:
            epochs.append(_rows(reader))
            diag = reader.diagnostics
    with jax_make_reader(store, reader_pool_type='dummy', shuffle_row_groups=False,
                         transform_spec=_jax_spec()) as reader:
        want = _rows(reader)
    assert epochs[0] == epochs[1] == want
    assert diag['cache_hits'] == 4


def _jax_spec():
    from petastorm_tpu.transform import TransformSpec as JaxTransformSpec
    return JaxTransformSpec(_double_in_place)


def _never_pickles(value):
    return value % 3 == 0


@pytest.mark.parametrize('factory', ['make_reader', 'make_batch_reader'])
def test_the_predicate_bypass(store, tmp_path, factory):
    """A predicate that does not pickle bypasses the cache (no entry, no hit
    or miss); a picklable one keys its own entries, so another predicate
    over the same cache is never served the first one's rows."""
    import petastorm_tpu_torch.predicates as predicates
    location = str(tmp_path / 'c')
    cache = dict(cache_type='local-disk', cache_location=location, cache_size_limit=LIMIT)
    make = make_reader if factory == 'make_reader' else make_batch_reader

    def ids(predicate):
        with make(store, reader_pool_type='dummy', predicate=predicate, **cache) as reader:
            if factory == 'make_reader':
                got = sorted(int(row.id) for row in reader)
            else:
                got = sorted(int(i) for batch in reader for i in batch.id)
            return got, reader.diagnostics

    unpicklable = predicates.in_lambda(['id'], lambda value: value % 3 == 0)
    with pytest.raises(Exception):
        pickle.dumps(unpicklable)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')   # make_batch_reader on a Unischema store
        got, diag = ids(unpicklable)
        assert got == [i for i in range(ROWS) if i % 3 == 0]
        assert (diag['cache_hits'], diag['cache_misses']) == (0, 0)
        assert not any(files for _, _, files in os.walk(location))
        thirds = predicates.in_lambda(['id'], _never_pickles)
        evens = predicates.in_set(set(range(0, ROWS, 2)), 'id')
        assert ids(thirds)[0] == got
        got_evens, diag = ids(evens)
        assert got_evens == list(range(0, ROWS, 2)) and diag['cache_misses'] == 4
        got_thirds, diag = ids(thirds)
        assert got_thirds == got and diag['cache_hits'] == 4


@pytest.mark.parametrize('cls', ['ArrowIpcDiskCache', 'LocalDiskCache'])
def test_eviction_drops_what_jax_drops(tmp_path, cls):
    """Stores past ``size_limit_bytes`` evict the least recently touched
    entries down to 90% of the limit, the same entries in both packages
    (entry names are the same hash of the key)."""
    import petastorm_tpu.cache as jax_cache
    import petastorm_tpu_torch.cache as port_cache
    value = {'x': np.arange(200, dtype=np.int64)}
    survivors = []
    for module, name in ((port_cache, 'port'), (jax_cache, 'jax')):
        path = str(tmp_path / name)
        cache = getattr(module, cls)(path, 8000)
        for i in range(12):
            cache.get('key{}'.format(i), lambda: value)
            for root, _, files in os.walk(path):
                for f in files:
                    full = os.path.join(root, f)
                    if os.path.getmtime(full) > 1e6:   # just written: age it by its order
                        os.utime(full, (1000 + i, 1000 + i))
        assert cache.size <= 8000
        survivors.append(sorted(f for _, _, files in os.walk(path) for f in files))
    assert survivors[0] == survivors[1] and 0 < len(survivors[0]) < 12
    hit = []
    port_cache_again = getattr(port_cache, cls)(str(tmp_path / 'port'), 8000)
    port_cache_again.get('key11', lambda: hit.append(1) or value)
    assert hit == []   # the newest entry survived


def test_a_corrupt_entry_is_served_as_a_miss(tmp_path):
    from petastorm_tpu_torch.resilience import BreakerBoard
    # a breaker of its own: the failure it records must not reach the
    # process's default board, which later readers in this process report
    cache = ArrowIpcDiskCache(str(tmp_path), LIMIT,
                              breaker=BreakerBoard().breaker('cache:corrupt-entry'))
    value = {'x': np.arange(10)}
    cache.get('k', lambda: value)
    (path,) = [os.path.join(r, f) for r, _, fs in os.walk(str(tmp_path)) for f in fs]
    with open(path, 'r+b') as f:
        f.truncate(os.path.getsize(path) - 3)
    got = cache.get('k', lambda: {'x': np.arange(10)})
    np.testing.assert_array_equal(got['x'], value['x'])
    assert cache.stats['corrupt_entries'] == 1 and cache.stats['misses'] == 2
    np.testing.assert_array_equal(cache.get('k', lambda: None)['x'], value['x'])


def test_local_disk_needs_a_location_and_a_limit(store, tmp_path):
    with pytest.raises(ValueError, match='cache_size_limit'):
        make_reader(store, cache_type='local-disk', cache_location=str(tmp_path))
    with pytest.raises(ValueError, match='cache_type'):
        make_reader(store, cache_type='memory')
    with pytest.raises(ValueError, match='cache_format'):
        make_reader(store, cache_type='local-disk', cache_location=str(tmp_path),
                    cache_size_limit=LIMIT, cache_format='json')
    assert isinstance(LocalDiskCache(str(tmp_path), LIMIT).get('k', lambda: 3), int)


def test_the_predicate_token_is_made_once_and_only_with_a_cache(store, tmp_path,
                                                                 monkeypatch):
    import petastorm_tpu_torch.predicates as predicates
    import petastorm_tpu_torch.reader_worker as reader_worker
    calls = []
    token = reader_worker._predicate_token
    monkeypatch.setattr(reader_worker, '_predicate_token',
                        lambda predicate: calls.append(1) or token(predicate))
    evens = predicates.in_set(set(range(0, ROWS, 2)), 'id')
    cache = dict(cache_type='local-disk', cache_location=str(tmp_path / 'c'),
                 cache_size_limit=LIMIT)
    for kwargs, want_calls in ((dict(), 0), (cache, 1)):
        calls.clear()
        with make_reader(store, reader_pool_type='dummy', predicate=evens,
                         **kwargs) as reader:
            assert sorted(int(row.id) for row in reader) == list(range(0, ROWS, 2))
        assert len(calls) == want_calls


def test_cache_counts_by_epoch(store, tmp_path):
    """``num_epochs=2`` in one reader: the first epoch fills every rowgroup's
    entry and the second is served from them (one thread, so each entry is
    stored before its second read)."""
    with make_reader(store, reader_pool_type='dummy', num_epochs=2,
                     cache_type='local-disk', cache_location=str(tmp_path / 'c'),
                     cache_size_limit=LIMIT) as reader:
        rows = _rows(reader)
        diag = reader.diagnostics
    assert sorted(rows) == sorted(rows[:ROWS] * 2) and len(rows) == 2 * ROWS
    assert diag['cache_by_epoch'] == {0: {'hits': 0, 'misses': 4},
                                      1: {'hits': 4, 'misses': 0}}
    assert (diag['cache_hits'], diag['cache_misses']) == (4, 4)


def _entries(path):
    return sorted(os.path.relpath(os.path.join(root, name), path)
                  for root, _, names in os.walk(path) for name in names)


@pytest.mark.parametrize('cache_format', ['arrow-ipc', 'pickle'])
@pytest.mark.parametrize('cleanup', [True, False])
def test_cleanup_removes_the_directory_as_jax_does(store, tmp_path, cache_format, cleanup):
    """cache_extra_settings={'cleanup': ...} reaches the cache's constructor in
    both packages; a read fills the same entries, and cleanup() removes the
    whole directory only when asked, as the JAX cache does. The base class
    and the null cache clean up nothing."""
    from petastorm_tpu import cache as jax_cache
    from petastorm_tpu import reader as jax_reader
    from petastorm_tpu_torch import cache as port_cache
    from petastorm_tpu_torch import reader as port_reader
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=False, cache_type='local-disk',
                  cache_size_limit=LIMIT, cache_format=cache_format,
                  cache_extra_settings={'cleanup': cleanup})
    found = []
    for make, module, name in ((make_reader, port_reader, 'port'),
                               (jax_make_reader, jax_reader, 'jax')):
        location = str(tmp_path / name)
        with make(store, cache_location=location, **kwargs) as reader:
            rows = _rows(reader)
        entries = _entries(location)
        cache = module._make_cache('local-disk', location, LIMIT, None, {'cleanup': cleanup},
                                   cache_format, False)
        cache.cleanup()
        found.append((rows, entries, os.path.exists(location)))
    assert found[0] == found[1]
    rows, entries, exists = found[0]
    assert len(rows) == ROWS and len(entries) == 4 and exists is not cleanup
    for module in (port_cache, jax_cache):
        assert module.CacheBase().cleanup() is None and module.NullCache().cleanup() is None
