"""Mid-epoch checkpoint and resume of the port's reader and loader, against
the JAX package: the cases of ``tests/test_checkpoint.py`` that apply to the
port, ``Reader.state_dict()`` and ``TorchDataLoader.state_dict()`` equal to
``petastorm_tpu``'s dicts at the same point (apart from the ``lineage`` and
``topology`` blocks, armed in neither reader here), and a JAX state resuming
a port reader to exactly the rows the JAX reader's resume delivers."""

import time

import numpy as np
import pytest

from petastorm_tpu_torch import TorchDataLoader, make_batch_reader, make_reader

ROWS = 100
ROWGROUP_ROWS = 25


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    """100 rows ``id``/``matrix`` in 4 files of one 25-row rowgroup each."""
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('Resume', [
        UnischemaField('id', np.int64, (), ScalarCodec(), False),
        UnischemaField('matrix', np.float32, (4, 3), NdarrayCodec(), False)])
    url = 'file://' + str(tmp_path_factory.mktemp('resume') / 'store')
    write_rows(url, schema, [{'id': i, 'matrix': np.full((4, 3), i, np.float32)}
                             for i in range(ROWS)], n_files=4)
    return url


def _close(reader):
    reader.stop()
    reader.join()


def _columnar_ids(reader, limit_batches=None):
    ids = []
    for i, batch in enumerate(reader.iter_columnar()):
        ids.extend(np.asarray(batch.columns['id']).tolist())
        if limit_batches is not None and i + 1 >= limit_batches:
            break
    return ids


def _all_ids(reader):
    with reader:
        return _columnar_ids(reader)


@pytest.mark.parametrize('shuffle', [False, True])
def test_resume_mid_epoch_covers_exactly_once(store, shuffle):
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=shuffle, seed=7, num_epochs=1)
    reader = make_reader(store, **kwargs)
    first = _columnar_ids(reader, limit_batches=2)
    state = reader.state_dict()
    _close(reader)
    rest = _all_ids(make_reader(store, resume_state=state, **kwargs))
    assert sorted(first + rest) == list(range(ROWS))


def test_resume_multi_epoch_row_counts(store):
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=True, seed=3, num_epochs=3)
    reader = make_reader(store, **kwargs)
    it = reader.iter_columnar()
    seen = 0
    while seen < ROWS + 1:
        seen += next(it).num_rows
    state = reader.state_dict()
    assert state['epochs_consumed'] == 1
    _close(reader)
    with make_reader(store, resume_state=state, **kwargs) as resumed:
        rest = sum(b.num_rows for b in resumed.iter_columnar())
    assert seen + rest == 3 * ROWS


def test_resume_threaded_epoch_straddle(store):
    """A parallel pool interleaves results across epoch boundaries; the
    epoch-tagged accounting keeps the stitched total exact."""
    kwargs = dict(reader_pool_type='thread', workers_count=4, shuffle_row_groups=True,
                  seed=13, num_epochs=3)
    reader = make_reader(store, **kwargs)
    it = reader.iter_columnar()
    seen = 0
    while seen < int(1.5 * ROWS):
        seen += next(it).num_rows
    state = reader.state_dict()
    _close(reader)
    with make_reader(store, resume_state=state, **kwargs) as resumed:
        rest = sum(b.num_rows for b in resumed.iter_columnar())
    assert seen + rest == 3 * ROWS


@pytest.mark.parametrize('drop_partitions', [1, 2])
def test_resume_replays_seeded_epoch_order(store, drop_partitions):
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=True, seed=11, num_epochs=2,
                  shuffle_row_drop_partitions=drop_partitions)
    baseline = _all_ids(make_reader(store, **kwargs))
    reader = make_reader(store, **kwargs)
    first = _columnar_ids(reader, limit_batches=3)
    state = reader.state_dict()
    _close(reader)
    rest = _all_ids(make_reader(store, resume_state=state, **kwargs))
    assert first + rest == baseline
    assert state['items_per_epoch'] == 4 * drop_partitions


def _row_ids(reader, n=None):
    if n is None:
        return [row.id for row in reader]
    return [next(reader).id for _ in range(n)]


@pytest.mark.parametrize('n_first, num_epochs, cursor_row', [
    (30, 1, 5), (3, 1, 3), (ROWS + 7, 2, 7)], ids=['mid_batch', 'mid_first_batch',
                                                  'across_epochs'])
def test_row_path_resume_exact(store, n_first, num_epochs, cursor_row):
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=True, seed=21,
                  num_epochs=num_epochs, schema_fields=['id'])
    with make_reader(store, **kwargs) as baseline_reader:
        baseline = _row_ids(baseline_reader)
    reader = make_reader(store, **kwargs)
    first = _row_ids(reader, n_first)
    state = reader.state_dict()
    _close(reader)
    assert state['row_cursor']['next_row'] == cursor_row
    assert state['row_cursor']['epoch_offset'] == 0
    assert state['epochs_consumed'] == num_epochs - 1
    with make_reader(store, resume_state=state, **kwargs) as resumed:
        rest = _row_ids(resumed)
    assert first + rest == baseline


def test_row_path_resume_exact_threaded(store):
    kwargs = dict(reader_pool_type='thread', workers_count=4, shuffle_row_groups=True,
                  seed=17, num_epochs=1, schema_fields=['id'])
    reader = make_reader(store, **kwargs)
    first = _row_ids(reader, 37)
    state = reader.state_dict()
    _close(reader)
    with make_reader(store, resume_state=state, **kwargs) as resumed:
        rest = _row_ids(resumed)
    assert sorted(first + rest) == list(range(ROWS))


def test_row_cursor_honored_by_columnar_path(store):
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=False, num_epochs=1,
                  schema_fields=['id'])
    reader = make_reader(store, **kwargs)
    first = _row_ids(reader, 30)
    state = reader.state_dict()
    _close(reader)
    assert state['row_cursor']['next_row'] == 5
    rest = _all_ids(make_reader(store, resume_state=state, **kwargs))
    assert sorted(first + rest) == list(range(ROWS))


def test_resume_batch_reader_with_emptied_items(tmp_path):
    """A transform empties some items; accounting still converges (the empty
    batches carry their item ids)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from petastorm_tpu_torch import TransformSpec
    path = tmp_path / 'scalar'
    path.mkdir()
    pq.write_table(pa.table({'id': pa.array(range(50), pa.int64())}),
                   str(path / 'part_0.parquet'), row_group_size=10)

    def below_25(columns):
        return {'id': columns['id'][columns['id'] < 25]}

    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=False, num_epochs=1,
                  transform_spec=TransformSpec(below_25, batched=True))
    url = 'file://' + str(path)
    reader = make_batch_reader(url, **kwargs)
    first = _columnar_ids(reader, limit_batches=1)
    state = reader.state_dict()
    _close(reader)
    rest = _all_ids(make_batch_reader(url, resume_state=state, **kwargs))
    assert sorted(first + rest) == list(range(25))


def test_resume_state_mismatch_rejected(store):
    reader = make_reader(store, reader_pool_type='dummy', num_epochs=1)
    state = reader.state_dict()
    _close(reader)
    with pytest.raises(ValueError, match='work items per epoch'):
        make_reader(store, reader_pool_type='dummy', resume_state=dict(
            state, items_per_epoch=state['items_per_epoch'] + 5))
    with pytest.raises(ValueError, match='Unrecognized resume_state'):
        make_reader(store, reader_pool_type='dummy', resume_state={'version': 99})
    with pytest.raises(ValueError, match='shard config'):
        make_reader(store, reader_pool_type='dummy', cur_shard=0, shard_count=2,
                    resume_state=state)
    # a topology state resumes only a topology-armed reader, as in the JAX
    # package (cross-topology restore goes through merge_topology_states)
    with pytest.raises(ValueError, match='topology-armed reader .* static-sharded'):
        make_reader(store, reader_pool_type='dummy',
                    resume_state=dict(state, topology={'assignment': [0, 1]}))


def test_resume_all_epochs_consumed_rejected(store):
    with make_reader(store, reader_pool_type='dummy', num_epochs=1) as reader:
        for _ in reader.iter_columnar():
            pass
        state = reader.state_dict()
    assert state['epochs_consumed'] == 1
    with pytest.raises(ValueError, match='already consumed'):
        make_reader(store, reader_pool_type='dummy', num_epochs=1, resume_state=state)


def test_reset_after_resume_replays_full_num_epochs(store):
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=True, seed=9, num_epochs=2)
    reader = make_reader(store, **kwargs)
    it = reader.iter_columnar()
    seen = 0
    while seen < ROWS + 1:
        seen += next(it).num_rows
    state = reader.state_dict()
    _close(reader)
    with make_reader(store, resume_state=state, **kwargs) as resumed:
        rest = sum(b.num_rows for b in resumed.iter_columnar())
        assert seen + rest == 2 * ROWS
        resumed.reset()
        again = sum(b.num_rows for b in resumed.iter_columnar())
    assert again == 2 * ROWS


# ------------------------------------------------------------------ the loader

def _loader(reader, **kwargs):
    kwargs.setdefault('drop_last', False)
    return TorchDataLoader(reader, device='cpu', **kwargs)


def test_loader_state_dict_roundtrip(store):
    """Delivery-exact, at least once: no row is lost; only items partly
    delivered at the checkpoint are served again whole."""
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=True, seed=5, num_epochs=1)
    loader = _loader(make_reader(store, **kwargs), batch_size=10)
    it = iter(loader)
    first = [int(i) for _ in range(2) for i in next(it)['id']]
    state = loader.state_dict()
    loader.stop()
    loader.join()
    assert state['version'] == 1
    with _loader(make_reader(store, resume_state=state, **kwargs), batch_size=10) as resumed:
        rest = [int(i) for batch in resumed for i in batch['id']]
    # 20 rows of a 25-row rowgroup were delivered: no item is whole, so the
    # resume serves the partly delivered rowgroup again, whole
    assert state['consumed_by_epoch'] == {} and state['epochs_consumed'] == 0
    assert set(first) < set(rest) and sorted(rest) == list(range(ROWS))


@pytest.mark.parametrize('batch_size', [ROWGROUP_ROWS, 10])
def test_loader_resume_with_a_thread_pool(store, batch_size):
    """Two worker threads hand items over in the order they finish: the
    loader's position still names exactly the items whose rows were all
    yielded. Rows before the save and the resumed run's cover the epoch, no
    wholly delivered item is served again, and with batches aligned to the
    items every row comes exactly once."""
    kwargs = dict(reader_pool_type='thread', workers_count=2, shuffle_row_groups=True,
                  seed=3, num_epochs=1)
    loader = _loader(make_reader(store, **kwargs), batch_size=batch_size)
    it = iter(loader)
    first = [int(i) for _ in range(2) for i in next(it)['id']]
    state = loader.state_dict()
    loader.stop()
    loader.join()
    with _loader(make_reader(store, resume_state=state, **kwargs),
                 batch_size=batch_size) as resumed:
        rest = [int(i) for batch in resumed for i in batch['id']]
    whole = {i // ROWGROUP_ROWS for i in first
             if sum(j // ROWGROUP_ROWS == i // ROWGROUP_ROWS for j in first) == ROWGROUP_ROWS}
    assert len(state['consumed_by_epoch'].get(0, [])) == len(whole)
    assert set(first) | set(rest) == set(range(ROWS)) and len(set(rest)) == len(rest)
    assert not {i // ROWGROUP_ROWS for i in rest} & whole
    if batch_size == ROWGROUP_ROWS:
        assert len(whole) == 2 and sorted(first + rest) == list(range(ROWS))


def test_loader_stop_while_its_producer_waits_on_the_pool(store):
    """Stopping a loader to checkpoint it while its producer waits on a thread
    pool's results: the stopped pool ends the wait, so join returns at once
    (a stopped ventilator never completes, and the wait once ran on until
    join gave up after 30 s)."""
    from petastorm_tpu_torch import TransformSpec

    def slow(columns):
        time.sleep(0.5)
        return columns

    reader = make_reader(store, reader_pool_type='thread', workers_count=2,
                         shuffle_row_groups=False, num_epochs=None,
                         transform_spec=TransformSpec(slow, batched=True))
    loader = _loader(reader, batch_size=ROWGROUP_ROWS, prefetch=1)
    batches = iter(loader)
    next(batches)
    # the two workers finished their first items together: once the second
    # batch fills the queue, the producer waits on the pool for the third
    deadline = time.monotonic() + 30
    while not loader._queue.full() and time.monotonic() < deadline:
        time.sleep(0.01)
    loader.stop()
    start = time.monotonic()
    loader.join()
    assert time.monotonic() - start < 5
    assert not loader._producer.is_alive()
    batches.close()


def test_loader_state_exact_at_rowgroup_alignment(store):
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=False, num_epochs=1)
    loader = _loader(make_reader(store, **kwargs), batch_size=ROWGROUP_ROWS)
    first = [int(i) for i in next(iter(loader))['id']]
    state = loader.state_dict()
    loader.stop()
    loader.join()
    assert state['consumed_by_epoch'] == {0: [(0, 0)]}
    with _loader(make_reader(store, resume_state=state, **kwargs),
                 batch_size=ROWGROUP_ROWS) as resumed:
        rest = [int(i) for batch in resumed for i in batch['id']]
    assert first + rest == list(range(ROWS))


def test_loader_state_dict_with_shuffle_midstream_rejected(store):
    reader = make_reader(store, reader_pool_type='dummy', shuffle_row_groups=False)
    with _loader(reader, batch_size=10, shuffling_queue_capacity=40, seed=1) as loader:
        next(iter(loader))
        with pytest.raises(ValueError, match='shuffling buffer'):
            loader.state_dict()


def test_loader_state_dict_with_shuffle_at_stream_end(store):
    reader = make_reader(store, reader_pool_type='dummy', shuffle_row_groups=False)
    with _loader(reader, batch_size=10, shuffling_queue_capacity=40, seed=1) as loader:
        n = sum(len(b['id']) for b in loader)
        state = loader.state_dict()
    assert n == ROWS
    assert state['epochs_consumed'] == 1 and state['consumed_by_epoch'] == {}


def test_loader_state_dict_refused_after_scan_stream(store):
    reader = make_reader(store, reader_pool_type='dummy', shuffle_row_groups=False,
                         schema_fields=['id'])
    with _loader(reader, batch_size=10, drop_last=True) as loader:
        loader.scan_stream(lambda batch: batch['id'].sum(), chunk_batches=2)
        with pytest.raises(ValueError, match='scan_stream'):
            loader.state_dict()


def test_scan_stream_reads_around_the_delivery_fifo(store):
    """Only __iter__ feeds the delivery FIFO: a scan_stream pass over a
    whole epoch leaves it empty, and one __iter__ pass after a reset retires
    every entry it queued."""
    reader = make_reader(store, reader_pool_type='dummy', shuffle_row_groups=False,
                         schema_fields=['id'], num_epochs=1)
    with _loader(reader, batch_size=10, drop_last=True) as loader:
        sums = loader.scan_stream(lambda batch: batch['id'].sum(), chunk_batches=2)
        assert int(sum(int(s.sum()) for s in sums)) == sum(range(ROWS))
        assert len(loader._delivery_fifo) == 0
        reader.reset()
        assert sum(len(b['id']) for b in loader) == ROWS
        assert len(loader._delivery_fifo) == 0


class _RowsOnly(object):
    """A reader without the columnar path (rows only)."""

    num_epochs = 1

    def __init__(self, reader):
        self._reader = reader

    def __iter__(self):
        return iter(self._reader)

    def stop(self):
        self._reader.stop()

    def join(self):
        self._reader.join()


def test_loader_state_dict_refused_without_columnar_path(store):
    reader = make_reader(store, reader_pool_type='dummy', schema_fields=['id'])
    with _loader(_RowsOnly(reader), batch_size=10) as loader:
        with pytest.raises(ValueError, match='columnar'):
            loader.state_dict()


def test_loader_counts_a_batch_when_yielded_not_when_prefetched(store):
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=False, schema_fields=['id'])
    loader = _loader(make_reader(store, **kwargs), batch_size=ROWGROUP_ROWS, prefetch=3)
    it = iter(loader)
    next(it)
    # the producer runs ahead until its queue is full: the reader has then
    # consumed the whole epoch, while one batch was yielded
    deadline = time.monotonic() + 30
    while loader.reader.state_dict()['epochs_consumed'] < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert loader.reader.state_dict()['epochs_consumed'] == 1
    assert loader.state_dict()['epochs_consumed'] == 0
    assert loader.state_dict()['consumed_by_epoch'] == {0: [(0, 0)]}
    loader.stop()
    loader.join()


# ------------------------------------------------------- parity with the JAX package

def _jax_reader(store, **kwargs):
    import petastorm_tpu
    return petastorm_tpu.make_reader(store, **kwargs)


def _without_jax_only_blocks(state):
    return {key: value for key, value in state.items() if key not in ('lineage', 'topology')}


@pytest.mark.parametrize('mode', ['columnar', 'rows'])
def test_reader_state_dict_equals_jax(store, mode):
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=True, seed=19, num_epochs=2,
                  shuffle_row_drop_partitions=2, schema_fields=['id'])
    states = []
    for make in (make_reader, _jax_reader):
        reader = make(store, **kwargs)
        if mode == 'columnar':
            _columnar_ids(reader, limit_batches=11)
        else:
            _row_ids(reader, 120)
        states.append(reader.state_dict())
        _close(reader)
    ours, theirs = states
    assert ours == _without_jax_only_blocks(theirs)
    assert ours['epochs_consumed'] == 1
    if mode == 'rows':
        assert ours['row_cursor']['next_row'] > 0


def test_loader_state_dict_equals_jax(store):
    from petastorm_tpu.parallel.loader import JaxDataLoader
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=True, seed=23, num_epochs=2)
    ours_loader = _loader(make_reader(store, **kwargs), batch_size=20)
    theirs_loader = JaxDataLoader(_jax_reader(store, **kwargs), batch_size=20,
                                  device_put=False, drop_last=False)
    states = []
    for loader in (ours_loader, theirs_loader):
        it = iter(loader)
        for _ in range(7):
            next(it)
        states.append(loader.state_dict())
        loader.stop()
        loader.join()
    assert states[0] == states[1]
    # 140 rows: the first epoch and one whole rowgroup of the second
    assert states[0]['epochs_consumed'] == 1 and states[0]['consumed_by_epoch'] == {
        0: [(3, 0)]}


@pytest.mark.parametrize('mode', ['columnar', 'rows', 'loader'])
def test_jax_state_resumes_the_port_reader_to_the_same_rows(store, mode):
    from petastorm_tpu.parallel.loader import JaxDataLoader
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=True, seed=29, num_epochs=2,
                  schema_fields=['id'])
    reader = _jax_reader(store, **kwargs)
    if mode == 'columnar':
        _columnar_ids(reader, limit_batches=5)
        state = reader.state_dict()
    elif mode == 'rows':
        _row_ids(reader, 140)
        state = reader.state_dict()
    else:
        loader = JaxDataLoader(reader, batch_size=15, device_put=False, drop_last=False)
        it = iter(loader)
        for _ in range(9):
            next(it)
        state = loader.state_dict()
        loader.stop()
    _close(reader)
    theirs = _all_ids(_jax_reader(store, resume_state=state, **kwargs))
    ours = _all_ids(make_reader(store, resume_state=state, **kwargs))
    assert ours == theirs and len(ours) > 0
