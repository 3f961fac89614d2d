"""The port's make_batch_reader, TransformSpec and make_packing_transform
against the JAX package on the same plain Parquet stores (dummy pool, same
seed): the same columns and rows, the same transformed schemas and
refusals, and equal int32 bins from read-time packing. Also
make_torch_loader, distributed_shard_info and the fault repaired in
``Reader.iter_columnar`` (an item a transform emptied is still yielded to
delivery accounting)."""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from petastorm_tpu_torch.benchmark.lm_data import full_bin_rowgroups, write_ragged_store

SEQ = 64
ROWGROUPS = 6


@pytest.fixture(scope='module')
def ragged_store(tmp_path_factory):
    """6 rowgroups of ragged documents, each packing into exactly 2 bins of 64."""
    url = 'file://' + str(tmp_path_factory.mktemp('ragged') / 'store')
    rowgroups = full_bin_rowgroups(ROWGROUPS, 2, SEQ, 8, 32, 256, seed=4)
    write_ragged_store(url, rowgroups, n_files=2)
    return url, rowgroups


@pytest.fixture(scope='module')
def plain_store(tmp_path_factory):
    """50 rows of scalar, string and list columns in 5 rowgroups over 2 files."""
    path = tmp_path_factory.mktemp('plain') / 'store'
    os.makedirs(path)
    table = pa.table({
        'id': pa.array(range(50), pa.int64()),
        'float64': [i / 2.0 for i in range(50)],
        'string': ['value_{}'.format(i) for i in range(50)],
        'int_list': pa.array([[i, i + 1, i + 2][:1 + i % 3] for i in range(50)],
                             pa.list_(pa.int32())),
    })
    pq.write_table(table.slice(0, 30), str(path / 'part_0.parquet'), row_group_size=10)
    pq.write_table(table.slice(30), str(path / 'part_1.parquet'), row_group_size=10)
    return 'file://' + str(path)


def _batches(make, url, **kwargs):
    kwargs.setdefault('reader_pool_type', 'dummy')
    with make(url, **kwargs) as reader:
        return [{name: getattr(batch, name) for name in batch._fields} for batch in reader]


def _assert_columns_equal(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for got, want in zip(ours, theirs):
        assert list(got) == list(want)
        for name in want:
            if isinstance(want[name], list):
                # list columns: the port keeps the Arrow value type (int32),
                # the JAX package's rows come out int64 (a defined difference)
                assert len(got[name]) == len(want[name])
                for g, w in zip(got[name], want[name]):
                    np.testing.assert_array_equal(g, w)
            else:
                assert got[name].dtype == want[name].dtype, name
                np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize('kwargs', [
    dict(shuffle_row_groups=False),
    dict(seed=3, shuffle_row_groups=True, shuffle_rows=True),
    dict(seed=5, shuffle_row_groups=True, shuffle_row_drop_partitions=2, num_epochs=2),
    dict(seed=1, cur_shard=1, shard_count=2, schema_fields=['id', 'int_list']),
], ids=['ordered', 'shuffled', 'drop_partitions', 'shard'])
def test_batch_reader_matches_jax(plain_store, kwargs):
    import petastorm_tpu
    from petastorm_tpu_torch import make_batch_reader
    ours = _batches(make_batch_reader, plain_store, **kwargs)
    theirs = _batches(petastorm_tpu.make_batch_reader, plain_store, **kwargs)
    _assert_columns_equal(ours, theirs)


def test_list_int32_column_arrives_as_int32_arrays(ragged_store):
    from petastorm_tpu_torch import make_batch_reader
    url, rowgroups = ragged_store
    batches = _batches(make_batch_reader, url, shuffle_row_groups=False)
    assert [len(b['doc_id']) for b in batches] == [len(docs) for docs in rowgroups]
    for batch, docs in zip(batches, rowgroups):
        assert batch['doc_id'].dtype == np.int64
        assert all(t.dtype == np.int32 for t in batch['tokens'])
        for got, want in zip(batch['tokens'], docs):
            np.testing.assert_array_equal(got, want)


def test_packing_transform_matches_jax(ragged_store):
    import petastorm_tpu
    from petastorm_tpu.ops.packing import make_packing_transform as jax_packing
    from petastorm_tpu_torch import make_batch_reader, make_packing_transform
    url, _ = ragged_store
    kwargs = dict(seed=2, shuffle_row_groups=True)
    ours = _batches(make_batch_reader, url,
                    transform_spec=make_packing_transform('tokens', SEQ), **kwargs)
    theirs = _batches(petastorm_tpu.make_batch_reader, url,
                      transform_spec=jax_packing('tokens', SEQ), **kwargs)
    assert len(ours) == len(theirs) == ROWGROUPS
    for got, want in zip(ours, theirs):
        assert list(got) == list(want) == ['tokens', 'tokens_segments', 'tokens_positions']
        for name in want:
            assert got[name].dtype == want[name].dtype == np.int32
            assert got[name].shape == want[name].shape == (2, SEQ)
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        # the store's rowgroups fill both bins: no padding
        assert (got['tokens_segments'] > 0).all()


def test_packing_transform_refuses_encoded_bytes():
    from petastorm_tpu_torch import make_packing_transform
    spec = make_packing_transform('tokens', SEQ)
    with pytest.raises(ValueError, match='raw bytes'):
        spec.func({'tokens': [b'\x00\x01']})


# ------------------------------------------------------------------ transforms

def _double(frame):
    frame['float64'] = frame['float64'] * 2
    return frame


@pytest.mark.parametrize('make_spec', [
    lambda TransformSpec: TransformSpec(removed_fields=['string']),
    lambda TransformSpec: TransformSpec(selected_fields=['int_list', 'id']),
    lambda TransformSpec: TransformSpec(_double, edit_fields=[('float64', np.float64, (),
                                                               False)]),
], ids=['remove', 'select', 'pandas_func'])
def test_batch_reader_transforms_match_jax(plain_store, make_spec):
    import petastorm_tpu
    from petastorm_tpu.transform import TransformSpec as JaxSpec
    from petastorm_tpu_torch import TransformSpec, make_batch_reader
    ours = _batches(make_batch_reader, plain_store, seed=4,
                    transform_spec=make_spec(TransformSpec))
    theirs = _batches(petastorm_tpu.make_batch_reader, plain_store, seed=4,
                      transform_spec=make_spec(JaxSpec))
    _assert_columns_equal(ours, theirs)


def test_batch_reader_honours_batched_dict_func(plain_store):
    from petastorm_tpu_torch import TransformSpec, make_batch_reader
    seen = []

    def func(columns):
        seen.append(type(columns))
        return {'id': columns['id'] * 10, 'twice': columns['float64'] * 2}

    spec = TransformSpec(func, edit_fields=[('twice', np.float64, (), False)],
                         selected_fields=['id', 'twice'], batched=True)
    batches = _batches(make_batch_reader, plain_store, shuffle_row_groups=False,
                       transform_spec=spec)
    assert set(seen) == {dict}
    np.testing.assert_array_equal(np.concatenate([b['id'] for b in batches]),
                                  np.arange(50) * 10)
    np.testing.assert_array_equal(np.concatenate([b['twice'] for b in batches]),
                                  np.arange(50, dtype=np.float64))


def _row_store(tmp_path):
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('Rows', [UnischemaField('id', np.int64, (), ScalarCodec(), False),
                                UnischemaField('vec', np.float32, (3,), NdarrayCodec(), False)])
    url = 'file://' + str(tmp_path / 'rows')
    write_rows(url, schema, [{'id': i, 'vec': np.full(3, i, np.float32)} for i in range(20)],
               n_files=2)
    return url


def _add_sum(row):
    row['total'] = np.float32(row['vec'].sum() + row['id'])
    return row


def _add_sum_batched(columns):
    columns['total'] = (columns['vec'].sum(axis=1) + columns['id']).astype(np.float32)
    return columns


@pytest.mark.parametrize('batched', [False, True])
def test_row_reader_transform_matches_jax(tmp_path, batched):
    import petastorm_tpu
    from petastorm_tpu.transform import TransformSpec as JaxSpec
    from petastorm_tpu_torch import TransformSpec, make_reader
    url = _row_store(tmp_path)
    func = _add_sum_batched if batched else _add_sum
    kwargs = dict(reader_pool_type='dummy', seed=7, shuffle_rows=True)
    edit = [('total', np.float32, (), False)]
    with make_reader(url, transform_spec=TransformSpec(func, edit_fields=edit,
                                                       batched=batched), **kwargs) as reader:
        ours = [row._asdict() for row in reader]
    with petastorm_tpu.make_reader(url, transform_spec=JaxSpec(func, edit_fields=edit,
                                                               batched=batched),
                                   **kwargs) as reader:
        theirs = [row._asdict() for row in reader]
    assert len(ours) == len(theirs) == 20
    for got, want in zip(ours, theirs):
        assert list(got) == list(want) == ['id', 'vec', 'total']
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])


def test_transform_emptying_an_item_still_yields_it_to_accounting(plain_store):
    """Repaired fault: iter_columnar dropped empty batches, so an item a
    transform emptied never counted as consumed by a loader."""
    from petastorm_tpu_torch import TransformSpec, make_batch_reader

    def drop_low(columns):
        keep = columns['id'] >= 20
        return {'id': columns['id'][keep]}

    spec = TransformSpec(drop_low, selected_fields=['id'], batched=True)
    with make_batch_reader(plain_store, reader_pool_type='dummy', shuffle_row_groups=False,
                           transform_spec=spec) as reader:
        batches = list(reader.iter_columnar(include_empty=True))
        state = reader.state_dict()
    assert [b.num_rows for b in batches] == [0, 0, 10, 10, 10]
    assert [b.item_id for b in batches] == [(0, piece, 0) for piece in range(5)]
    assert state['epochs_consumed'] == 1


# --------------------------------------------------------- TransformSpec schema

def _schemas():
    from petastorm_tpu.codecs import NdarrayCodec as JaxNdarray, ScalarCodec as JaxScalar
    from petastorm_tpu.unischema import Unischema as JaxSchema, UnischemaField as JaxField
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    def build(schema_cls, field_cls, scalar, ndarray):
        return schema_cls('T', [field_cls('a', np.int64, (), scalar(), False),
                                field_cls('b', np.float32, (4,), ndarray(), False),
                                field_cls('c', np.str_, (), scalar(), False)])
    return (build(Unischema, UnischemaField, ScalarCodec, NdarrayCodec),
            build(JaxSchema, JaxField, JaxScalar, JaxNdarray))


@pytest.mark.parametrize('spec_kwargs', [
    dict(removed_fields=['b']),
    dict(edit_fields=[('b', np.float64, (2, 2), False)]),
    dict(edit_fields=[('new', np.int32, (), False)]),
    dict(selected_fields=['c', 'a']),
    dict(edit_fields=[('new', np.int8, (None,), True)], removed_fields=['a']),
], ids=['remove', 'edit_in_place', 'edit_adds', 'select_order', 'edit_and_remove'])
def test_transform_schema_matches_jax(spec_kwargs):
    from petastorm_tpu.transform import TransformSpec as JaxSpec
    from petastorm_tpu.transform import transform_schema as jax_transform_schema
    from petastorm_tpu_torch.transform import TransformSpec, transform_schema
    ours_in, theirs_in = _schemas()
    ours = transform_schema(ours_in, TransformSpec(**spec_kwargs))
    theirs = jax_transform_schema(theirs_in, JaxSpec(**spec_kwargs))
    assert ours.name == theirs.name == 'T_transformed'
    assert list(ours.fields) == list(theirs.fields)
    for name, field in theirs.fields.items():
        got = ours.fields[name]
        assert (np.dtype(got.numpy_dtype), got.shape, got.nullable) == (
            np.dtype(field.numpy_dtype), field.shape, field.nullable)


@pytest.mark.parametrize('spec_kwargs', [
    dict(removed_fields=['zz']), dict(selected_fields=['zz'])], ids=['removed', 'selected'])
def test_transform_schema_refuses_unknown_fields(spec_kwargs):
    from petastorm_tpu_torch.transform import TransformSpec, transform_schema
    with pytest.raises(ValueError, match='not present'):
        transform_schema(_schemas()[0], TransformSpec(**spec_kwargs))


def test_transform_spec_refuses_removed_and_selected():
    from petastorm_tpu_torch import TransformSpec
    with pytest.raises(ValueError, match='mutually exclusive'):
        TransformSpec(removed_fields=['a'], selected_fields=['b'])


def test_transform_schema_accepts_unischema_field():
    from petastorm_tpu_torch.transform import TransformSpec, transform_schema
    from petastorm_tpu_torch.unischema import UnischemaField
    new_field = UnischemaField('x', np.int8, (), None, True)
    out = transform_schema(_schemas()[0], TransformSpec(edit_fields=[new_field]))
    assert list(out.fields) == ['a', 'b', 'c', 'x'] and out.x == new_field


def test_from_arrow_schema_matches_jax(plain_store):
    import pyarrow.dataset as pads
    from petastorm_tpu.unischema import Unischema as JaxSchema
    from petastorm_tpu_torch.unischema import Unischema
    arrow_schema = pads.dataset(plain_store[len('file://'):], format='parquet').schema
    ours, theirs = Unischema.from_arrow_schema(arrow_schema), JaxSchema.from_arrow_schema(
        arrow_schema)
    assert [(f.name, np.dtype(f.numpy_dtype), f.shape) for f in ours] == [
        (f.name, np.dtype(f.numpy_dtype), f.shape) for f in theirs]


# ---------------------------------------------------- make_torch_loader, shards

def test_make_torch_loader_packs_to_cpu_tensors(ragged_store):
    from petastorm_tpu_torch import TorchDataLoader, make_packing_transform, make_torch_loader
    url, _ = ragged_store
    with make_torch_loader(url, batch_size=2, reader_pool_type='dummy', seed=1,
                           transform_spec=make_packing_transform('tokens', SEQ),
                           loader_kwargs={'device': 'cpu'}) as loader:
        assert isinstance(loader, TorchDataLoader)
        batches = list(loader)
    assert len(batches) == ROWGROUPS
    for batch in batches:
        assert sorted(batch) == ['tokens', 'tokens_positions', 'tokens_segments']
        assert all(t.device.type == 'cpu' and t.dtype == torch.int32
                   and tuple(t.shape) == (2, SEQ) for t in batch.values())


def test_make_torch_loader_defaults_to_cuda(ragged_store, monkeypatch):
    from petastorm_tpu_torch import make_torch_loader
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_torch_loader(ragged_store[0], batch_size=2, reader_pool_type='dummy')


def test_make_torch_loader_stops_its_reader_when_the_loader_is_refused(ragged_store,
                                                                       monkeypatch):
    from petastorm_tpu_torch import make_torch_loader
    from petastorm_tpu_torch.reader import Reader
    readers = []
    original_init = Reader.__init__

    def recording_init(self, *args, **kwargs):
        readers.append(self)
        original_init(self, *args, **kwargs)

    monkeypatch.setattr(Reader, '__init__', recording_init)
    with pytest.raises(ValueError, match='batch_size'):
        make_torch_loader(ragged_store[0], batch_size=0, reader_pool_type='dummy',
                          loader_kwargs={'device': 'cpu'})
    assert len(readers) == 1 and readers[0]._stopped


def test_make_torch_loader_reads_the_process_shard(plain_store, monkeypatch):
    from petastorm_tpu_torch import make_torch_loader
    monkeypatch.setenv('PETASTORM_TPU_PROCESS_INDEX', '1')
    monkeypatch.setenv('PETASTORM_TPU_PROCESS_COUNT', '2')
    with make_torch_loader(plain_store, batch_size=5, reader_pool_type='dummy',
                           shuffle_row_groups=False, schema_fields=['id'],
                           loader_kwargs={'device': 'cpu'}) as loader:
        ids = [int(i) for batch in loader for i in batch['id']]
        state = loader.state_dict()
    assert ids == list(range(10, 20)) + list(range(30, 40))
    assert loader.reader.state_dict()['shard_config'] == {
        'cur_shard': 1, 'shard_count': 2, 'shard_seed': None, 'topology': False}
    assert state['items_per_epoch'] == 2


@pytest.mark.parametrize('env, explicit, expected', [
    ({}, (0, 3), (0, 3)),
    ({'PETASTORM_TPU_PROCESS_INDEX': '2', 'PETASTORM_TPU_PROCESS_COUNT': '4',
      'HOROVOD_RANK': '1', 'HOROVOD_SIZE': '2'}, (None, None), (2, 4)),
    ({'HOROVOD_RANK': '1', 'HOROVOD_SIZE': '2'}, (None, None), (1, 2)),
    ({'OMPI_COMM_WORLD_RANK': '3', 'OMPI_COMM_WORLD_SIZE': '5'}, (None, None), (3, 5)),
    ({'PMI_RANK': '0', 'PMI_SIZE': '2'}, (None, None), (0, 2)),
    ({}, (None, None), (None, None)),
], ids=['explicit', 'env_pair_first', 'horovod', 'ompi', 'pmi', 'single'])
def test_distributed_shard_info_priority(monkeypatch, env, explicit, expected):
    from petastorm_tpu_torch.parallel.mesh import distributed_shard_info
    for name in ('PETASTORM_TPU_PROCESS_INDEX', 'PETASTORM_TPU_PROCESS_COUNT', 'HOROVOD_RANK',
                 'HOROVOD_SIZE', 'OMPI_COMM_WORLD_RANK', 'OMPI_COMM_WORLD_SIZE', 'PMI_RANK',
                 'PMI_SIZE'):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert distributed_shard_info(*explicit) == expected


def test_distributed_shard_info_reads_torch_distributed(monkeypatch):
    import torch.distributed as dist
    from petastorm_tpu_torch.parallel.mesh import distributed_shard_info
    monkeypatch.setenv('HOROVOD_RANK', '0')
    monkeypatch.setenv('HOROVOD_SIZE', '9')
    monkeypatch.setattr(dist, 'is_initialized', lambda: True)
    monkeypatch.setattr(dist, 'get_world_size', lambda group=None: 4)
    monkeypatch.setattr(dist, 'get_rank', lambda group=None: 3)
    assert distributed_shard_info() == (3, 4)
    with pytest.raises(ValueError, match='together'):
        distributed_shard_info(1, None)
