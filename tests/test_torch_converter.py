"""The port's converter against ``petastorm_tpu.converter`` on the same Arrow
tables: the same fingerprint directory, stores that read back equal through
the other package, the cache, the environment variable, ``delete``, partial
stores, refused inputs, the Spark branch, and loader batches equal to the JAX converter's. All
comparisons are exact."""

import os

import numpy as np
import pyarrow as pa
import pytest
import torch

from petastorm_tpu_torch import converter as port_converter
from petastorm_tpu_torch.converter import make_converter


def _table(n=60, seed=0):
    rng = np.random.RandomState(seed)
    return pa.table({'x': rng.randn(n).astype(np.float32),
                     'y': np.arange(n, dtype=np.int64) % 5,
                     'v': pa.array([rng.randint(0, 255, 6).astype(np.uint8).tolist()
                                    for _ in range(n)], type=pa.list_(pa.uint8()))})


@pytest.fixture
def cache_dir(tmp_path):
    return str(tmp_path / 'converter_cache')


def test_same_table_same_directory_in_both_packages(cache_dir):
    from petastorm_tpu.converter import make_converter as jax_make_converter
    table = _table()
    ours = make_converter(table, parent_cache_dir_url=cache_dir)
    theirs = jax_make_converter(table, parent_cache_dir_url=cache_dir)
    assert ours.cache_dir_url == theirs.cache_dir_url
    assert ours.file_urls == theirs.file_urls and len(ours) == len(theirs) == 60
    assert len(os.path.basename(ours.cache_dir_url)) == 24
    ours.delete()


def _read_all(make_batch_reader, files):
    with make_batch_reader(files, reader_pool_type='dummy', shuffle_row_groups=False) as r:
        batches = [b._asdict() for b in r]
    return {name: np.concatenate([np.asarray(list(b[name]) if isinstance(b[name], list)
                                             else b[name]) for b in batches])
            for name in batches[0]}


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_store_reads_back_equal_through_the_other_package(tmp_path, writer):
    from petastorm_tpu import make_batch_reader as jax_make_batch_reader
    from petastorm_tpu.converter import make_converter as jax_make_converter
    from petastorm_tpu_torch import make_batch_reader
    table = _table(seed=1)
    factory = make_converter if writer == 'port' else jax_make_converter
    converter = factory(table, parent_cache_dir_url=str(tmp_path / writer),
                        rows_per_file=25)
    assert len(converter.file_urls) == 3
    reader = jax_make_batch_reader if writer == 'port' else make_batch_reader
    got = _read_all(reader, converter.file_urls)
    for name in ('x', 'y'):
        np.testing.assert_array_equal(got[name], table.column(name).to_numpy())
    np.testing.assert_array_equal(np.stack(got['v']),
                                  np.array(table.column('v').to_pylist(), dtype=np.uint8))
    converter.delete()


def test_cache_hit_writes_nothing(cache_dir, monkeypatch):
    table = _table()
    first = make_converter(table, parent_cache_dir_url=cache_dir)
    from petastorm_tpu_torch.etl import dataset_metadata

    def refuse(*args, **kwargs):
        raise AssertionError('a cache hit wrote files')

    monkeypatch.setattr(dataset_metadata, 'write_table_files', refuse)
    second = make_converter(table, parent_cache_dir_url=cache_dir)
    assert second.cache_dir_url == first.cache_dir_url
    assert second.file_urls == first.file_urls
    monkeypatch.undo()
    other = make_converter(_table(61), parent_cache_dir_url=cache_dir)
    assert other.cache_dir_url != first.cache_dir_url
    for converter in (first, other):
        converter.delete()


def test_environment_variable_names_the_parent(cache_dir, monkeypatch):
    monkeypatch.setenv('PETASTORM_TPU_CONVERTER_CACHE_DIR', cache_dir)
    converter = make_converter(_table())
    assert converter.cache_dir_url.startswith(cache_dir)
    converter.delete()
    monkeypatch.delenv('PETASTORM_TPU_CONVERTER_CACHE_DIR')
    with pytest.raises(ValueError, match='cache dir'):
        make_converter(_table())


def test_delete_removes_the_store(cache_dir):
    converter = make_converter(_table(), parent_cache_dir_url=cache_dir)
    assert os.path.exists(os.path.join(converter.cache_dir_url, '_SUCCESS'))
    converter.delete()
    assert not os.path.exists(converter.cache_dir_url)
    assert converter.cache_dir_url not in port_converter._active_converters


def test_partial_store_is_removed(cache_dir):
    table = _table()
    path = os.path.join(cache_dir, port_converter._table_fingerprint(table))
    os.makedirs(path)
    with open(os.path.join(path, 'part_99999.parquet'), 'wb') as f:
        f.write(b'left over by a crashed conversion')
    converter = make_converter(table, parent_cache_dir_url=cache_dir)
    assert not os.path.exists(os.path.join(path, 'part_99999.parquet'))
    assert len(converter) == 60 and all(os.path.exists(p) for p in converter.file_urls)
    converter.delete()


def test_unknown_type_and_spark_frame_refused(cache_dir, monkeypatch):
    """An unknown type is refused; a Spark DataFrame (a stub of pyspark.sql
    whose writer writes real Parquet) now converts through the Spark branch,
    to a store with the metadata make_reader needs."""
    import sys
    import types
    with pytest.raises(TypeError, match='Unsupported dataframe type'):
        make_converter([1, 2, 3], parent_cache_dir_url=cache_dir)
    sql = types.ModuleType('pyspark.sql')
    sql.DataFrame = type('DataFrame', (), {})
    monkeypatch.setitem(sys.modules, 'pyspark.sql', sql)
    table = pa.table({'id': np.arange(12, dtype=np.int64)})

    class Writer(object):
        def option(self, key, value):
            return self

        def parquet(self, path):
            import pyarrow.parquet as pq
            os.makedirs(path)
            pq.write_table(table, os.path.join(path, 'part-0.parquet'))

    frame = type('Frame', (sql.DataFrame,), {'write': Writer(), 'count': lambda self: 12,
                                            'semanticHash': lambda self: 7})()
    converter = make_converter(frame, parent_cache_dir_url=cache_dir)
    try:
        assert len(converter) == 12
        assert make_converter(frame, parent_cache_dir_url=cache_dir) is converter
        from petastorm_tpu_torch import make_reader
        with make_reader(converter.cache_dir_url, reader_pool_type='dummy',
                         shuffle_row_groups=False) as reader:
            assert [int(row.id) for row in reader] == list(range(12))
    finally:
        converter.delete()
    assert 7 not in port_converter._spark_plan_converters


def test_pandas_frame_accepted(cache_dir):
    pd = pytest.importorskip('pandas')
    frame = pd.DataFrame({'a': np.arange(5, dtype=np.int64)})
    converter = make_converter(frame, parent_cache_dir_url=cache_dir)
    assert len(converter) == 5
    converter.delete()


def test_make_torch_loader_equals_make_jax_loader(cache_dir):
    from petastorm_tpu.converter import make_converter as jax_make_converter
    table = _table(64, seed=2).drop(['v'])
    ours = make_converter(table, parent_cache_dir_url=cache_dir, rows_per_file=16)
    theirs = jax_make_converter(table, parent_cache_dir_url=cache_dir, rows_per_file=16)
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=False, num_epochs=2)
    with ours.make_torch_loader(batch_size=12, loader_kwargs={'device': 'cpu'},
                                **kwargs) as loader:
        got = [{k: v.numpy() for k, v in b.items()} for b in loader]
    with theirs.make_jax_loader(batch_size=12, loader_kwargs={'device_put': False},
                                **kwargs) as loader:
        want = list(loader)
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ['x', 'y']
        for name in w:
            assert g[name].dtype == w[name].dtype
            np.testing.assert_array_equal(g[name], w[name])
    ours.delete()


@pytest.mark.parametrize('capacity', [0, 30])
def test_make_torch_dataloader_equals_the_jax_converters(cache_dir, capacity):
    from petastorm_tpu.converter import make_converter as jax_make_converter
    table = _table(50, seed=3)
    ours = make_converter(table, parent_cache_dir_url=cache_dir, rows_per_file=20)
    theirs = jax_make_converter(table, parent_cache_dir_url=cache_dir, rows_per_file=20)
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=False)
    with ours.make_torch_dataloader(batch_size=8, shuffling_queue_capacity=capacity,
                                    device='cpu', **kwargs) as loader:
        got = list(loader)
    with theirs.make_torch_dataloader(batch_size=8, shuffling_queue_capacity=capacity,
                                      **kwargs) as loader:
        want = list(loader)
    assert len(got) == len(want) == 7
    if capacity:
        # neither converter seeds its shuffling queue: the same rows, each once
        got = [{'x': torch.cat([b['x'] for b in got]).sort().values}]
        want = [{'x': torch.cat([b['x'] for b in want]).sort().values}]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for name in w:
            if name == 'v':
                # a list<uint8> column keeps its Arrow value type in the port;
                # the JAX batch reader's comes out int64 (a defined difference)
                assert (g[name].dtype, w[name].dtype) == (torch.uint8, torch.int64)
                assert torch.equal(g[name].long(), w[name])
            else:
                assert g[name].dtype == w[name].dtype and torch.equal(g[name], w[name])
    ours.delete()
