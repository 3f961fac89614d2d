"""The port's measurement tools held against the JAX package's:
``reader_throughput`` (the python and torch read methods, a spawned child, the
NGram and packing modes and their guards, ``profile_threads``) and its CLI,
``DummyReader`` and ``ReaderMock`` into the port's adapters, and
``decode_bench`` and ``wire_bench`` at small sizes, whose key sets equal the
JAX runs' (the ``*_zmq`` keys name the port's pipe, the ``pushdown_*`` keys its
compiled mask: the same names) and whose decode engine output equals the
per-cell fallback exactly."""

import logging

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from petastorm_tpu.benchmark import decode_bench as jax_decode_bench
from petastorm_tpu.benchmark import wire_bench as jax_wire_bench
from petastorm_tpu.test_util.reader_mock import ReaderMock as JaxReaderMock
from petastorm_tpu_torch.benchmark import decode_bench, wire_bench
from petastorm_tpu_torch.benchmark.cli import NOT_PORTED, SUBCOMMANDS
from petastorm_tpu_torch.benchmark.cli import main as cli_main
from petastorm_tpu_torch.benchmark.dummy_reader import DummyReader, measure_loader
from petastorm_tpu_torch.benchmark.throughput import (READ_PYTHON, READ_TORCH,
                                                      reader_throughput)
from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.etl.dataset_metadata import write_rows
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

Schema = Unischema('ThroughputSchema', [
    UnischemaField('id', np.int64, (), ScalarCodec(), False),
    UnischemaField('id2', np.int32, (), ScalarCodec(), False),
    UnischemaField('matrix', np.float32, (4, 3), NdarrayCodec(), False),
])


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('throughput') / 'store')
    rng = np.random.RandomState(0)
    write_rows(url, Schema, [{'id': i, 'id2': i % 5, 'matrix': rng.rand(4, 3).astype(
        np.float32)} for i in range(64)], rows_per_file=16)
    return url


@pytest.fixture(scope='module')
def ragged_store(tmp_path_factory):
    root = tmp_path_factory.mktemp('ragged')
    rng = np.random.RandomState(0)
    docs = [rng.randint(0, 99, size=rng.randint(4, 13)).astype(np.int32)
            for _ in range(200)]
    pq.write_table(pa.table({'doc_id': np.arange(200, dtype=np.int64),
                             'tokens': pa.array([d.tolist() for d in docs],
                                                type=pa.list_(pa.int32()))}),
                   str(root / 'part_0.parquet'), row_group_size=50)
    return 'file://' + str(root)


# ------------------------------------------------------------- throughput

@pytest.mark.parametrize('read_method', [READ_PYTHON, READ_TORCH])
def test_reader_throughput_read_methods(store, read_method):
    result = reader_throughput(store, field_regex=['id', 'matrix'], warmup_cycles_count=2,
                               measure_cycles_count=6, loaders_count=1,
                               read_method=read_method, torch_batch_size=8,
                               spawn_new_process=False, device='cpu')
    assert result.samples_per_second > 0 and result.memory_info.rss > 0
    assert 0 <= result.input_stall_fraction <= 1
    if read_method == READ_PYTHON:
        assert result.input_stall_fraction == 0.0


@pytest.mark.parametrize('pool_type', ['dummy', 'process'])
def test_reader_throughput_pools(store, pool_type):
    result = reader_throughput(store, field_regex=['id'], warmup_cycles_count=2,
                               measure_cycles_count=20, pool_type=pool_type,
                               loaders_count=1, spawn_new_process=False)
    assert result.samples_per_second > 0 and result.input_stall_fraction == 0.0


def test_reader_throughput_spawned_child(store):
    result = reader_throughput(store, field_regex=['id'], warmup_cycles_count=2,
                               measure_cycles_count=10, loaders_count=1)
    assert result.samples_per_second > 0 and result.memory_info.rss > 0


def test_profile_threads(store, caplog):
    with caplog.at_level(logging.INFO, logger='petastorm_tpu_torch.workers.thread_pool'):
        result = reader_throughput(store, field_regex=['id'], warmup_cycles_count=5,
                                   measure_cycles_count=10, loaders_count=2,
                                   profile_threads=True, spawn_new_process=False)
    assert result.samples_per_second > 0
    logs = [r for r in caplog.records if 'profile' in r.message.lower()]
    assert logs and 'cumulative' in logs[0].getMessage()


def test_ngram_and_packing_modes(store, ragged_store):
    windows = reader_throughput(store, field_regex=['id', 'id2'], warmup_cycles_count=5,
                                measure_cycles_count=20, loaders_count=1, ngram_length=3,
                                ngram_ts_field='id', spawn_new_process=False)
    assert windows.samples_per_second > 0
    bins = reader_throughput(ragged_store, warmup_cycles_count=2, measure_cycles_count=10,
                             loaders_count=1, pack_field='tokens', pack_seq_len=32,
                             spawn_new_process=False)
    assert bins.samples_per_second > 0


@pytest.mark.parametrize('kwargs,match', [
    (dict(pool_type='dummy', profile_threads=True), 'thread pool'),
    (dict(ngram_length=3), 'ngram_ts_field'),
    (dict(ngram_ts_field='id'), 'require ngram_length'),
    (dict(ngram_length=3, ngram_ts_field='id', read_method=READ_TORCH), 'python read'),
    (dict(pack_field='tokens'), 'together'),
    (dict(pack_field='tokens', pack_seq_len=8, ngram_length=3, ngram_ts_field='id'),
     'mutually exclusive'),
    (dict(pack_field='tokens', pack_seq_len=8, read_method=READ_TORCH), 'python read'),
    (dict(pack_field='tokens', pack_seq_len=8, profile_threads=True), 'profile_threads'),
    (dict(pack_field='tokens', pack_seq_len=8, field_regex=['tok']), 'does not match'),
    (dict(read_method='jax'), 'read_method'),
])
def test_guards_raise_in_the_caller(store, kwargs, match):
    with pytest.raises(ValueError, match=match):
        reader_throughput(store, **kwargs)


def test_cli_throughput_and_subcommands(store, capsys):
    assert cli_main([store, '-f', 'id', '-m', '5', '-n', '20', '-w', '1',
                     '--in-process']) == 0
    assert 'Throughput' in capsys.readouterr().out
    assert cli_main([store, '-f', 'id', 'matrix', '-m', '1', '-n', '4', '-w', '1',
                     '--in-process', '-d', 'torch', '--device', 'cpu',
                     '--torch-batch-size', '4']) == 0
    assert 'samples/sec' in capsys.readouterr().out
    for name, module in sorted(NOT_PORTED.items()):
        assert cli_main([name, 'x']) == 2
        assert module in capsys.readouterr().err
    assert set(NOT_PORTED) == {'chaos', 'pipecheck'}
    assert set(SUBCOMMANDS) == {'wire-bench', 'decode-bench', 'costs', 'analyze', 'trace',
                                'doctor', 'serve', 'lineage', 'autopsy', 'history'}
    # the ported planes' subcommands dispatch: a missing manifest or bundle is
    # their own error exit, not the not-ported 2 with a module name
    assert cli_main(['lineage', 'diff', '/nonexistent/a', '/nonexistent/b']) == 2
    assert 'lineage diff' in capsys.readouterr().out


# ------------------------------------------------------- adapters and mocks

def test_dummy_reader_into_the_adapters():
    from petastorm_tpu_torch.parallel.loader import TorchDataLoader
    from petastorm_tpu_torch.pytorch import DataLoader
    assert measure_loader(lambda: DataLoader(DummyReader(), batch_size=16, device='cpu'),
                          batches=5) > 0
    assert measure_loader(lambda: TorchDataLoader(DummyReader(), batch_size=16,
                                                  device='cpu'), batches=5) > 0
    batch = next(iter(TorchDataLoader(DummyReader(num_distinct_rows=4), batch_size=6,
                                      device='cpu')))
    assert batch['id'].tolist() == [0, 1, 2, 3, 0, 1]
    assert tuple(batch['value'].shape) == (6, 16)


def test_reader_mock_equals_jax_and_feeds_the_adapters():
    from test_common import TestSchema

    from petastorm_tpu_torch.parallel.loader import TorchDataLoader
    from petastorm_tpu_torch.pytorch import DataLoader
    from petastorm_tpu_torch.test_util import ReaderMock
    schema = Unischema.from_json_dict(TestSchema.to_json_dict())
    fields = ['id', 'id2', 'matrix', 'matrix_var', 'sensor_name', 'nullable_int']
    view = schema.create_schema_view(fields)
    mock = ReaderMock(view, num_rows=6)
    jax_mock = JaxReaderMock(TestSchema.create_schema_view(fields), num_rows=6)
    rows, jax_rows = list(mock), list(jax_mock)
    assert len(rows) == len(jax_rows) == 6 and mock.last_row_consumed
    for row, jax_row in zip(rows, jax_rows):
        for name in fields:
            got, want = getattr(row, name), getattr(jax_row, name)
            assert type(got) is type(want), name
            np.testing.assert_array_equal(got, want)
    mock.reset()
    assert not mock.last_row_consumed and mock.diagnostics == {}
    numeric = schema.create_schema_view(['id', 'matrix'])
    batches = list(DataLoader(ReaderMock(numeric, num_rows=20), batch_size=5, device='cpu'))
    assert len(batches) == 4 and tuple(batches[0]['matrix'].shape) == (5, 4, 3)
    loader = TorchDataLoader(ReaderMock(numeric, num_rows=20), batch_size=8, drop_last=False,
                             device='cpu')
    assert sum(int(b['id'].shape[0]) for b in loader) == 20


# ------------------------------------------------------ decode and wire benches

DECODE_SIZES = dict(rows=120, image_rows=12, ndarray_hw=8, image_hw=16)


def test_decode_bench_keys_equal_jax_and_engine_equals_fallback():
    result = decode_bench.run_decode_bench(**DECODE_SIZES)
    jax_result = jax_decode_bench.run_decode_bench(**DECODE_SIZES)
    assert set(result) == set(jax_result)
    assert all(np.isfinite(v) and v > 0 for v in result.values())
    import pyarrow as pa

    from petastorm_tpu_torch.codecs import FieldCodec
    from petastorm_tpu_torch.decode_engine import compile_decode_plan, stack_if_uniform
    for kind in ('scalar', 'ndarray', 'compressed_ndarray', 'image_png', 'image_jpeg'):
        field, column = decode_bench._make_codec_column(kind, 9, 8, 16)
        engine = compile_decode_plan(Unischema('D', [field]), [field.name]).execute(
            pa.table({field.name: column}))[field.name]
        fallback = stack_if_uniform(FieldCodec.decode_column(field.codec, field,
                                                             column.to_pylist()), field)
        assert isinstance(engine, np.ndarray) and engine.dtype == np.asarray(fallback).dtype
        np.testing.assert_array_equal(engine, np.asarray(fallback))


def test_decode_bench_cli_prints_one_json_line(capsys):
    import json
    assert cli_main(['decode-bench', '--rows', '40', '--image-rows', '4', '--ndarray-hw',
                     '4', '--image-hw', '8', '--no-pushdown']) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and 'scalar_speedup' in json.loads(lines[0])


def test_wire_bench_keys_equal_jax(tmp_path):
    sizes = dict(rows=32, cols=1, batches=2, workers=1, cache_rows=40)
    result = wire_bench.run_wire_bench(**sizes)
    jax_result = jax_wire_bench.run_wire_bench(**sizes)
    assert set(result) == set(jax_result)
    assert result['arrow_shm_shm_batches'] == 2 and result['pickle_zmq_shm_batches'] == 0
    assert result['arrow_shm_shm_fallback_batches'] == 0
    assert result['copy_reduction_vs_pickle_zmq'] > 1
    assert result['cache_cold_hits'] == 0 and result['cache_warm_hits'] > 0
    assert all(np.isfinite(v) for v in result.values())


def test_pickle_serializer_round_trip_and_pool_wire():
    from petastorm_tpu_torch.workers.serializers import ArrowIpcSerializer, PickleSerializer
    batch = wire_bench._make_batch(16, 2, seed=3)
    for serializer in (PickleSerializer(), ArrowIpcSerializer()):
        frames = serializer.serialize(batch)
        back = serializer.deserialize([memoryview(bytes(f)) for f in frames])
        assert back.item_id == batch.item_id and back.num_rows == 16
        for name, col in batch.columns.items():
            np.testing.assert_array_equal(back.columns[name], col)
            assert back.columns[name].flags.writeable
        assert serializer.stats['batches'] == 1 and serializer.stats['bytes_copied'] > 0
