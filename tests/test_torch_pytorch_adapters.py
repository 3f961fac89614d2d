"""The port's reference-API torch adapters (``petastorm_tpu_torch.pytorch``)
against ``petastorm_tpu.pytorch`` on the same stores, readers and seeds, with
``device='cpu'``: batch order, values and dtypes are equal, exactly, and the
guards behave alike."""

import collections
import datetime
import decimal
import os

import numpy as np
import pytest
import torch

FIELDS = ['id', 'matrix', 'python_primitive_uint8']


@pytest.fixture(scope='module')
def typed_store(tmp_path_factory):
    """A plain Parquet store with the dtypes the adapters sanitize: bool,
    uint16, uint32, timestamp and a float64, in 3 rowgroups of 20 rows."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    path = str(tmp_path_factory.mktemp('typed') / 'store')
    os.makedirs(path)
    n = 60
    start = np.datetime64('2024-01-01T00:00:00', 'us')
    table = pa.table({
        'id': np.arange(n, dtype=np.int64),
        'flag': np.arange(n) % 3 == 0,
        'u16': (np.arange(n) * 1000).astype(np.uint16),
        'u32': (np.arange(n) * 70000).astype(np.uint32),
        'when': pa.array(start + np.arange(n) * np.timedelta64(3, 's')),
        'x': np.linspace(0, 1, n),
    })
    pq.write_table(table, os.path.join(path, 'part_0.parquet'), row_group_size=20)
    return path


def _row_readers(url, fields):
    from petastorm_tpu import make_reader as jax_make_reader
    from petastorm_tpu_torch import make_reader
    kwargs = dict(schema_fields=fields, reader_pool_type='dummy', shuffle_row_groups=False,
                  num_epochs=2)
    return make_reader(url, **kwargs), jax_make_reader(url, **kwargs)


def _batch_readers(url, fields=None):
    from petastorm_tpu import make_batch_reader as jax_make_batch_reader
    from petastorm_tpu_torch import make_batch_reader
    kwargs = dict(schema_fields=fields, reader_pool_type='dummy', shuffle_row_groups=False,
                  num_epochs=2)
    return make_batch_reader(url, **kwargs), jax_make_batch_reader(url, **kwargs)


def _run(loader):
    with loader:
        return list(loader)


def _assert_batches_equal(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for got, want in zip(ours, theirs):
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name].device.type == 'cpu'
            assert got[name].dtype == want[name].dtype, name
            assert torch.equal(got[name], want[name]), name


ROW_CASES = {
    'plain': dict(batch_size=10),
    'shuffling_queue': dict(batch_size=16, shuffling_queue_capacity=50, seed=1),
}


@pytest.mark.parametrize('case', sorted(ROW_CASES))
def test_dataloader_equals_the_jax_adapter(synthetic_dataset, case):
    from petastorm_tpu.pytorch import DataLoader as JaxDataLoader
    from petastorm_tpu_torch.pytorch import DataLoader
    ours_reader, their_reader = _row_readers(synthetic_dataset.url, FIELDS)
    ours = _run(DataLoader(ours_reader, device='cpu', **ROW_CASES[case]))
    theirs = _run(JaxDataLoader(their_reader, **ROW_CASES[case]))
    _assert_batches_equal(ours, theirs)
    ids = torch.cat([b['id'] for b in ours]).tolist()
    assert sorted(ids) == sorted(list(synthetic_dataset.rows_by_id) * 2)


BATCHED_CASES = {
    'plain': dict(batch_size=16),
    'shuffled': dict(batch_size=7, shuffling_queue_capacity=40, seed=5),
}


@pytest.mark.parametrize('case', sorted(BATCHED_CASES))
@pytest.mark.parametrize('store', ['scalar', 'typed'])
def test_batched_dataloader_equals_the_jax_adapter(scalar_dataset, typed_store, store, case):
    from petastorm_tpu.pytorch import BatchedDataLoader as JaxBatched
    from petastorm_tpu_torch.pytorch import BatchedDataLoader
    url, fields = ((scalar_dataset.url, ['id', 'float64']) if store == 'scalar'
                   else (typed_store, None))
    ours_reader, their_reader = _batch_readers(url, fields)
    ours = _run(BatchedDataLoader(ours_reader, device='cpu', **BATCHED_CASES[case]))
    theirs = _run(JaxBatched(their_reader, **BATCHED_CASES[case]))
    _assert_batches_equal(ours, theirs)
    if store == 'typed':
        first = ours[0]
        assert (first['flag'].dtype, first['u16'].dtype, first['u32'].dtype,
                first['when'].dtype) == (torch.uint8, torch.int32, torch.int64, torch.int64)


@pytest.mark.parametrize('shuffle', [True, False])
def test_inmem_batched_dataloader_equals_the_jax_adapter(scalar_dataset, shuffle):
    from petastorm_tpu.pytorch import InMemBatchedDataLoader as JaxInMem
    from petastorm_tpu_torch.pytorch import InMemBatchedDataLoader
    kwargs = dict(batch_size=10, num_epochs=2, shuffle=shuffle, seed=7)
    ours_reader, their_reader = _batch_readers(scalar_dataset.url, ['id', 'float64'])
    ours = _run(InMemBatchedDataLoader(ours_reader, device='cpu', **kwargs))
    theirs = _run(JaxInMem(their_reader, **kwargs))
    _assert_batches_equal(ours, theirs)
    # the reader's 2 epochs fill 100 rows; each in-memory epoch serves 10 batches
    assert len(ours) == 20


def test_inmem_rows_capacity_equals_the_jax_adapter(scalar_dataset):
    from petastorm_tpu.pytorch import InMemBatchedDataLoader as JaxInMem
    from petastorm_tpu_torch.pytorch import InMemBatchedDataLoader
    ours_reader, their_reader = _batch_readers(scalar_dataset.url, ['id'])
    kwargs = dict(batch_size=10, rows_capacity=20, num_epochs=1)
    ours = _run(InMemBatchedDataLoader(ours_reader, device='cpu', **kwargs))
    _assert_batches_equal(ours, _run(JaxInMem(their_reader, **kwargs)))
    assert sum(len(b['id']) for b in ours) == 20


def _port_loader(kind, synthetic_dataset, scalar_dataset, fields=None, num_epochs=1):
    from petastorm_tpu_torch import make_batch_reader, make_reader
    from petastorm_tpu_torch.pytorch import BatchedDataLoader, DataLoader
    if kind == 'rows':
        reader = make_reader(synthetic_dataset.url, schema_fields=fields or ['id'],
                             reader_pool_type='dummy', num_epochs=num_epochs,
                             shuffle_row_groups=False)
        return DataLoader(reader, batch_size=4, device='cpu')
    reader = make_batch_reader(scalar_dataset.url, schema_fields=fields or ['id'],
                               reader_pool_type='dummy', num_epochs=num_epochs,
                               shuffle_row_groups=False)
    return BatchedDataLoader(reader, batch_size=4, device='cpu')


@pytest.mark.parametrize('kind', ['rows', 'batched'])
def test_guard_no_concurrent_iteration(synthetic_dataset, scalar_dataset, kind):
    with _port_loader(kind, synthetic_dataset, scalar_dataset, num_epochs=None) as loader:
        it = iter(loader)
        next(it)
        with pytest.raises(RuntimeError, match='Concurrent'):
            next(iter(loader))


@pytest.mark.parametrize('kind', ['rows', 'batched'])
def test_guard_reset_when_iterated_again(synthetic_dataset, scalar_dataset, kind):
    with _port_loader(kind, synthetic_dataset, scalar_dataset) as loader:
        first = sorted(int(i) for b in loader for i in b['id'])
        second = sorted(int(i) for b in loader for i in b['id'])
    assert first == second and len(first) in (50, 100)


@pytest.mark.parametrize('kind,field', [('rows', 'sensor_name'), ('batched', 'string')])
def test_guard_strings_refused_and_error_latched(synthetic_dataset, scalar_dataset, kind,
                                                 field):
    with _port_loader(kind, synthetic_dataset, scalar_dataset,
                      fields=['id', field]) as loader:
        with pytest.raises(TypeError, match=field):
            next(iter(loader))
        with pytest.raises(RuntimeError, match='previously failed'):
            next(iter(loader))


def test_batched_dataloader_requires_a_batch_reader(synthetic_dataset):
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.pytorch import BatchedDataLoader
    with make_reader(synthetic_dataset.url, reader_pool_type='dummy') as reader:
        with pytest.raises(ValueError, match='make_batch_reader'):
            BatchedDataLoader(reader, batch_size=4, device='cpu')


def test_default_device_is_the_card(scalar_dataset):
    """Without a card, the default device raises instead of running on the
    host."""
    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.pytorch import BatchedDataLoader
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device is valid')
    with make_batch_reader(scalar_dataset.url, reader_pool_type='dummy') as reader:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            BatchedDataLoader(reader, batch_size=4)


Pair = collections.namedtuple('Pair', ['d', 'x'])

COLLATE_CASES = {
    'dicts': [{'d': decimal.Decimal('1.5'), 'x': np.int64(1), 'b': True},
              {'d': decimal.Decimal('2.5'), 'x': np.int64(2), 'b': False}],
    'tuples': [(decimal.Decimal('0.25'), np.float32(1.0)),
               (decimal.Decimal('0.75'), np.float32(2.0))],
    'namedtuples': [Pair(decimal.Decimal('3'), np.uint16(7)),
                    Pair(decimal.Decimal('4'), np.uint16(9))],
    'datetimes': [{'t': np.datetime64('2024-01-01T00:00:01', 's')},
                  {'t': np.datetime64(datetime.datetime(2024, 1, 2), 'us')}],
}


def _flatten(value):
    if isinstance(value, dict):
        return [(k, t) for k in sorted(value) for t in _flatten(value[k])]
    if isinstance(value, tuple):
        return [(type(value).__name__, t) for v in value for t in _flatten(v)]
    return [value]


@pytest.mark.parametrize('case', sorted(COLLATE_CASES))
def test_decimal_friendly_collate_equals_the_jax_adapter(case):
    from petastorm_tpu.pytorch import decimal_friendly_collate as jax_collate
    from petastorm_tpu_torch.pytorch import decimal_friendly_collate
    rows = COLLATE_CASES[case]
    ours = decimal_friendly_collate(rows)
    theirs = jax_collate(rows)
    assert type(ours) is type(theirs)
    flat_ours, flat_theirs = _flatten(ours), _flatten(theirs)
    assert len(flat_ours) == len(flat_theirs)
    for got, want in zip(flat_ours, flat_theirs):
        got = got[-1] if isinstance(got, tuple) else got
        want = want[-1] if isinstance(want, tuple) else want
        assert got.dtype == want.dtype and torch.equal(got, want)


def _recording(seen):
    def transform(column):
        seen.append(len(column))
        return torch.as_tensor(column)
    return transform


def _centered(column):
    """Not row-wise: each rowgroup's column minus its mean."""
    tensor = torch.as_tensor(column).to(torch.float64)
    return tensor - tensor.mean()


@pytest.mark.parametrize('case', sorted(BATCHED_CASES))
def test_batched_dataloader_transforms_rowgroups_before_the_buffer(scalar_dataset, case):
    """transform_fn sees each rowgroup's columns, before the shuffling buffer,
    as in the JAX adapter: the row counts a recording transform sees, and
    the batches of a transform that is not row-wise, are the JAX adapter's."""
    from petastorm_tpu.pytorch import BatchedDataLoader as JaxBatched
    from petastorm_tpu_torch.pytorch import BatchedDataLoader
    kwargs = dict(BATCHED_CASES[case])
    ours_seen, their_seen = [], []
    ours_reader, their_reader = _batch_readers(scalar_dataset.url, ['id', 'float64'])
    ours = _run(BatchedDataLoader(ours_reader, device='cpu', transform_fn=_recording(ours_seen),
                                  **kwargs))
    theirs = _run(JaxBatched(their_reader, transform_fn=_recording(their_seen), **kwargs))
    _assert_batches_equal(ours, theirs)
    # rowgroups, not batches
    assert ours_seen == their_seen != [len(batch['id']) for batch in ours]

    ours_reader, their_reader = _batch_readers(scalar_dataset.url, ['id', 'float64'])
    ours = _run(BatchedDataLoader(ours_reader, device='cpu', transform_fn=_centered, **kwargs))
    theirs = _run(JaxBatched(their_reader, transform_fn=_centered, **kwargs))
    _assert_batches_equal(ours, theirs)
