"""NGram windows of the port against the JAX package's: the same windows in
the same order from ``next()`` and ``iter_columnar`` (overlap on and off,
gaps in the timestamps, regex field lists, offsets with a hole, drop
partitions), the same refusals, a JAX reader's NGram ``state_dict`` resuming
a port reader to the same next window, the loaders' window-major batches
equal to ``JaxDataLoader``'s and ``InMemJaxLoader``'s, and NGram readers
that share a rowgroup cache each getting their own windows."""

import numpy as np
import pytest

import petastorm_tpu.ngram as jax_ngram
import petastorm_tpu_torch.ngram as port_ngram
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu_torch import make_batch_reader, make_reader

ROWGROUPS = 3
ROWS_PER_ROWGROUP = 16


def _timestamps():
    """Per rowgroup: steps of 1 with a gap of 2 and one of 3."""
    steps = np.ones(ROWS_PER_ROWGROUP, np.int64)
    steps[[5, 11]] = [2, 3]
    return [100 * rg + np.cumsum(steps) for rg in range(ROWGROUPS)]


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('Sequences', [
        UnischemaField('ts', np.int64, (), ScalarCodec(), False),
        UnischemaField('sensor_a', np.int32, (), ScalarCodec(), False),
        UnischemaField('sensor_b', np.float32, (), ScalarCodec(), False),
        UnischemaField('frame', np.float32, (2, 3), NdarrayCodec(), False)])
    rng = np.random.RandomState(11)
    rows = [{'ts': int(t), 'sensor_a': np.int32(rng.randint(100)),
             'sensor_b': np.float32(rng.randn()),
             'frame': rng.randn(2, 3).astype(np.float32)}
            for stamps in _timestamps() for t in stamps]
    url = 'file://' + str(tmp_path_factory.mktemp('ngram') / 'store')
    write_rows(url, schema, rows, rows_per_file=ROWS_PER_ROWGROUP)
    return url


#: NGram specs: (fields by offset, delta_threshold, timestamp_overlap)
SPECS = {
    'overlap': ({0: ['ts', 'frame'], 1: ['ts', 'frame'], 2: ['ts', 'frame']}, 1, True),
    'no_overlap': ({0: ['ts', 'sensor_a'], 1: ['ts', 'sensor_a'], 2: ['ts']}, 1, False),
    'wide_gap': ({-1: ['ts', 'frame'], 0: ['sensor_a'], 1: ['ts']}, 3, True),
    'regex_hole': ({0: ['ts', 'sensor_.*'], 2: ['frame', 'sensor_b']}, 2, True),
}


def _ngram(module, name):
    fields, delta, overlap = SPECS[name]
    return module.NGram({k: list(v) for k, v in fields.items()}, delta_threshold=delta,
                        timestamp_field='ts', timestamp_overlap=overlap)


def _as_dicts(window):
    return {offset: {k: np.asarray(v).tolist() for k, v in step._asdict().items()}
            for offset, step in window.items()}


READS = {'in_order': dict(shuffle_row_groups=False),
         'shuffled': dict(shuffle_row_groups=True, shuffle_rows=True, seed=5),
         'drop_partitions': dict(shuffle_row_groups=True, seed=2,
                                 shuffle_row_drop_partitions=2)}


def _windows(factory, module, name, url, **kwargs):
    with factory(url, schema_fields=_ngram(module, name), reader_pool_type='dummy',
                 **kwargs) as reader:
        return [_as_dicts(window) for window in reader]


@pytest.mark.parametrize('name,read', [
    (name, read) for name in sorted(SPECS) for read in sorted(READS)
    # timestamp_overlap=False with drop partitions is refused (test_refusals_match_jax)
    if SPECS[name][2] or read != 'drop_partitions'])
def test_windows_match_jax(store, name, read):
    ours = _windows(make_reader, port_ngram, name, store, **READS[read])
    theirs = _windows(jax_make_reader, jax_ngram, name, store, **READS[read])
    assert len(ours) > ROWGROUPS and ours == theirs


@pytest.mark.parametrize('name', sorted(SPECS))
def test_iter_columnar_windows_match_jax(store, name):
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=True, seed=1)
    with make_reader(store, schema_fields=_ngram(port_ngram, name), **kwargs) as reader:
        ours = [(b.item_id, b.num_rows, b.columns) for b in reader.iter_columnar()]
    with jax_make_reader(store, schema_fields=_ngram(jax_ngram, name), **kwargs) as reader:
        theirs = [(b.item_id, b.num_rows, b.columns) for b in reader.iter_columnar()]
    assert [x[:2] for x in ours] == [x[:2] for x in theirs]
    length = _ngram(port_ngram, name).length
    for (_, n, got), (_, _, want) in zip(ours, theirs):
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].shape[:2] == (n, length)
            np.testing.assert_array_equal(got[key], want[key])


def test_no_overlap_windows_do_not_overlap(store):
    windows = _windows(make_reader, port_ngram, 'no_overlap', store,
                       shuffle_row_groups=False)
    ends = [(w[0]['ts'], w[2]['ts']) for w in windows]
    assert all(b[0] > a[1] for a, b in zip(ends, ends[1:]) if b[0] // 100 == a[0] // 100)


def _refusal(factory, module, **kwargs):
    try:
        factory(kwargs.pop('url'), schema_fields=_ngram(module, kwargs.pop('spec')),
                **kwargs).stop()
    except Exception as exc:  # noqa: BLE001 - the refusal's type is what is compared
        return type(exc).__name__
    return None


@pytest.mark.parametrize('case', ['predicate', 'overlap_and_drop', 'device_decode'])
def test_refusals_match_jax(store, case):
    import petastorm_tpu.predicates as jax_predicates
    import petastorm_tpu_torch.predicates as port_predicates
    args = {'predicate': ('overlap', lambda m: dict(predicate=m.in_set({1}, 'sensor_a'))),
            'overlap_and_drop': ('no_overlap', lambda m: dict(shuffle_row_drop_partitions=2)),
            'device_decode': ('overlap', lambda m: dict(device_decode_fields=['frame']))}
    spec, extra = args[case]
    ours = _refusal(make_reader, port_ngram, url=store, spec=spec, **extra(port_predicates))
    theirs = _refusal(jax_make_reader, jax_ngram, url=store, spec=spec,
                      **extra(jax_predicates))
    assert ours == theirs and ours in ('ValueError', 'NotImplementedError')


def test_make_batch_reader_refuses_an_ngram(store):
    with pytest.warns(UserWarning):
        with pytest.raises(ValueError, match='NGram'):
            make_batch_reader(store, schema_fields=_ngram(port_ngram, 'overlap'))


@pytest.mark.parametrize('taken', [0, 3, 9])
def test_a_jax_state_resumes_a_port_reader_to_the_same_window(store, taken):
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=True, shuffle_rows=True,
                  seed=9)
    with jax_make_reader(store, schema_fields=_ngram(jax_ngram, 'overlap'),
                         **kwargs) as reader:
        everything = [_as_dicts(w) for w in reader]
    reader = jax_make_reader(store, schema_fields=_ngram(jax_ngram, 'overlap'), **kwargs)
    with reader:
        for _ in range(taken):
            next(reader)
        state = reader.state_dict()
    if taken:
        assert 'row_cursor' in state
    with make_reader(store, schema_fields=_ngram(port_ngram, 'overlap'),
                     resume_state=state, **kwargs) as resumed:
        rest = [_as_dicts(w) for w in resumed]
        assert resumed.state_dict()['epochs_consumed'] == 1
    assert rest == everything[taken:]


def _jax_loader_batches(store, name, inmem, **loader_kwargs):
    from petastorm_tpu.parallel.inmem_loader import InMemJaxLoader
    from petastorm_tpu.parallel.loader import JaxDataLoader
    reader = jax_make_reader(store, schema_fields=_ngram(jax_ngram, name),
                             reader_pool_type='dummy', shuffle_row_groups=True, seed=3)
    with reader:
        if inmem:
            loader = InMemJaxLoader(reader, device_put=False, shuffle=False, **loader_kwargs)
        else:
            loader = JaxDataLoader(reader, device_put=False, **loader_kwargs)
        return [{k: np.asarray(v) for k, v in b.items()} for b in loader]


def _port_loader_batches(store, name, inmem, **loader_kwargs):
    from petastorm_tpu_torch import InMemTorchLoader, TorchDataLoader
    reader = make_reader(store, schema_fields=_ngram(port_ngram, name),
                         reader_pool_type='dummy', shuffle_row_groups=True, seed=3)
    with reader:
        if inmem:
            loader = InMemTorchLoader(reader, device='cpu', shuffle=False, **loader_kwargs)
        else:
            loader = TorchDataLoader(reader, device='cpu', **loader_kwargs)
        return [{k: v.numpy() for k, v in b.items()} for b in loader], loader


@pytest.mark.parametrize('inmem', [False, True])
@pytest.mark.parametrize('name', ['overlap', 'regex_hole'])
def test_loader_batches_match_jax(store, name, inmem):
    kwargs = dict(batch_size=4) if inmem else dict(batch_size=4, shuffling_queue_capacity=8,
                                                    seed=6)
    ours, loader = _port_loader_batches(store, name, inmem, **kwargs)
    theirs = _jax_loader_batches(store, name, inmem, **kwargs)
    length = _ngram(port_ngram, name).length
    assert len(ours) == len(theirs) >= 4
    for got, want in zip(ours, theirs):
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].shape[:2] == (4, length)
            np.testing.assert_array_equal(got[key], want[key].astype(got[key].dtype))
    if not inmem:
        # delivery accounting counts windows: every piece delivered, the
        # epoch closed
        assert loader.stats.rows == 4 * len(ours)


#: two NGrams over the same fields that form different windows
_STEPS = {0: ['ts', 'sensor_a'], 1: ['ts', 'sensor_a'], 2: ['ts']}
_CACHE_PAIRS = {
    'timestamp_overlap': [(_STEPS, 1, True), (_STEPS, 1, False)],
    'length': [({0: ['ts', 'sensor_a'], 1: ['ts']}, 1, True),
               ({0: ['ts', 'sensor_a'], 1: ['ts'], 2: ['ts']}, 1, True)],
}


@pytest.mark.parametrize('differ', sorted(_CACHE_PAIRS))
def test_ngram_readers_sharing_a_cache_get_their_own_windows(store, tmp_path, differ):
    """The NGram cache entry holds the windows its NGram formed, so two NGrams
    over the same fields and cache location key their own entries: each
    reader's windows are the JAX package's uncached ones, again on a second
    (hit) read."""
    cache = dict(cache_type='local-disk', cache_location=str(tmp_path / 'c'),
                 cache_size_limit=1 << 30)

    def windows(factory, module, spec, **kwargs):
        fields, delta, overlap = spec
        ngram = module.NGram({k: list(v) for k, v in fields.items()}, delta_threshold=delta,
                             timestamp_field='ts', timestamp_overlap=overlap)
        with factory(store, schema_fields=ngram, reader_pool_type='dummy',
                     shuffle_row_groups=False, **kwargs) as reader:
            return [_as_dicts(window) for window in reader]

    wants = [windows(jax_make_reader, jax_ngram, spec) for spec in _CACHE_PAIRS[differ]]
    assert wants[0] != wants[1]
    for _ in range(2):
        for spec, want in zip(_CACHE_PAIRS[differ], wants):
            assert windows(make_reader, port_ngram, spec, **cache) == want
