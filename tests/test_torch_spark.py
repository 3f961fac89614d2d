"""The port's Spark adapters (``petastorm_tpu_torch.spark_utils``,
``tools/spark_session_cli`` and the converter's Spark branch) held against
the JAX package's under a stub pyspark, as ``tests/test_spark_stub.py``
drives the JAX ones (pyspark is not installed): the stub's ``Row``,
``DataFrame`` (whose writer writes real Parquet), ``read.parquet`` and
``rdd.map``. Both packages must build the same rows, stores, RDD records and
session builders."""

import os
import sys
import types

import numpy as np
import pyarrow as pa
import pytest

import petastorm_tpu.spark_utils as jax_spark
import petastorm_tpu.tools.spark_session_cli as jax_cli
import petastorm_tpu_torch.spark_utils as port_spark
import petastorm_tpu_torch.tools.spark_session_cli as port_cli


class StubRow(object):
    """``pyspark.sql.Row('a', 'b')`` makes an ordered row class whose call
    holds positional values."""

    def __init__(self, *names, values=None):
        self.names = list(names)
        self.values = values

    def __call__(self, *values):
        return StubRow(*self.names, values=list(values))


@pytest.fixture
def stub_pyspark(monkeypatch):
    pyspark = types.ModuleType('pyspark')
    sql = types.ModuleType('pyspark.sql')
    sql.Row = StubRow
    sql.DataFrame = type('DataFrame', (), {})
    pyspark.sql = sql
    monkeypatch.setitem(sys.modules, 'pyspark', pyspark)
    monkeypatch.setitem(sys.modules, 'pyspark.sql', sql)
    return pyspark


def _schemas():
    """The same schema in each package."""
    from petastorm_tpu.codecs import NdarrayCodec as JaxNdarray
    from petastorm_tpu.codecs import ScalarCodec as JaxScalar
    from petastorm_tpu.unischema import Unischema as JaxUnischema
    from petastorm_tpu.unischema import UnischemaField as JaxField
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    return {'port': Unischema('S', [UnischemaField('b', np.int64, (), ScalarCodec(), False),
                                    UnischemaField('a', np.float32, (2,), NdarrayCodec(),
                                                   False)]),
            'jax': JaxUnischema('S', [JaxField('b', np.int64, (), JaxScalar(), False),
                                      JaxField('a', np.float32, (2,), JaxNdarray(), False)])}


@pytest.mark.parametrize('row', [{'b': 3, 'a': np.zeros(2, np.float32)},
                                 {'b': -1, 'a': np.arange(2, dtype=np.float32)},
                                 {'b': None, 'a': np.zeros(2, np.float32)},
                                 {'b': 1, 'a': np.zeros(2, np.float32), 'extra': 2}])
def test_dict_to_spark_row_equals_jax(stub_pyspark, row):
    schemas = _schemas()

    def build(module, schema):
        try:
            built = module.dict_to_spark_row(schema, dict(row))
            return built.names, built.values
        except ValueError as exc:
            return str(exc)
    ours = build(port_spark, schemas['port'])
    assert ours == build(jax_spark, schemas['jax'])
    if 'extra' not in row and row['b'] is not None:
        assert ours[0] == ['b', 'a'] and isinstance(ours[1][1], bytes)


def test_adapters_require_pyspark(monkeypatch):
    monkeypatch.setitem(sys.modules, 'pyspark', None)
    monkeypatch.setitem(sys.modules, 'pyspark.sql', None)
    with pytest.raises(ImportError, match='write_rows'):
        port_spark.dict_to_spark_row(_schemas()['port'], {})
    with pytest.raises(ImportError, match='make_reader'):
        port_spark.dataset_as_rdd('/x', None)
    with pytest.raises(ImportError, match='pyspark'):
        port_cli.configure_spark(port_cli.add_configure_spark_arguments(
            __import__('argparse').ArgumentParser()).parse_args([]))


def _stub_frame(sql, table, plan_key=None):
    class Writer(object):
        options = {}

        def option(self, key, value):
            self.options[key] = value
            return self

        def parquet(self, path):
            import pyarrow.parquet as pq
            os.makedirs(path, exist_ok=True)
            pq.write_table(table, os.path.join(path, 'part-0.parquet'))

    attrs = {'write': Writer(), 'count': lambda self: table.num_rows,
             'semanticHash': lambda self: plan_key}
    return type('StubDataFrame', (sql.DataFrame,), attrs)()


def test_converter_spark_branch_equals_jax(stub_pyspark, tmp_path):
    from petastorm_tpu.converter import make_converter as jax_make_converter
    from petastorm_tpu_torch.converter import make_converter
    table = pa.table({'id': np.arange(20, dtype=np.int64),
                      'value': np.arange(20, dtype=np.float64) / 2})
    rows = {}
    for name, make, reader in (('port', make_converter, 'petastorm_tpu_torch'),
                               ('jax', jax_make_converter, 'petastorm_tpu')):
        frame = _stub_frame(stub_pyspark.sql, table, plan_key='plan-' + name)
        converter = make(frame, parent_cache_dir_url=str(tmp_path / name),
                         rowgroup_size_mb=4)
        try:
            assert len(converter) == 20 and converter.file_urls
            assert frame.write.options == {'parquet.block.size': 4 << 20}
            assert make(frame, parent_cache_dir_url=str(tmp_path / name)) is converter
            make_reader = __import__(reader, fromlist=['make_reader']).make_reader
            with make_reader(converter.cache_dir_url, reader_pool_type='dummy',
                             shuffle_row_groups=False) as r:
                rows[name] = [(int(row.id), float(row.value)) for row in r]
        finally:
            converter.delete()
        assert not os.path.exists(converter.cache_dir_url)
    assert rows['port'] == rows['jax'] == [(i, i / 2) for i in range(20)]


def test_dataset_as_rdd_equals_jax(stub_pyspark, tmp_path):
    from petastorm_tpu.etl.dataset_metadata import write_rows
    schema = _schemas()['jax']
    url = 'file://' + str(tmp_path / 'ds')
    write_rows(url, schema, [{'b': i, 'a': np.full(2, i, np.float32)} for i in range(8)],
               rows_per_file=8)

    class Read(object):
        def parquet(self, url):
            import pyarrow.parquet as pq
            self.table = pq.read_table(url[len('file://'):])
            return self

        def select(self, *names):
            self.names = list(names)
            return self

        @property
        def rdd(self):
            records = [types.SimpleNamespace(asDict=lambda r=r: dict(r))
                       for r in self.table.select(self.names).to_pylist()]
            return types.SimpleNamespace(map=lambda fn: [fn(r) for r in records])

    session = types.SimpleNamespace(read=Read())
    ours = port_spark.dataset_as_rdd(url, session, schema_fields=['a', 'b'])
    theirs = jax_spark.dataset_as_rdd(url, session, schema_fields=['a', 'b'])
    assert [(r.b, r.a.tolist()) for r in ours] == [(r.b, r.a.tolist()) for r in theirs]
    assert [r.b for r in ours] == list(range(8))


@pytest.mark.parametrize('argv', [[], ['--master', 'local[4]'],
                                  ['--spark-session-config', 'a=1', 'b=x=y'],
                                  ['--master', 'yarn', '--spark-session-config', 'k=v']])
def test_spark_session_cli_equals_jax(stub_pyspark, argv):
    calls = {}
    for name, module in (('port', port_cli), ('jax', jax_cli)):
        args = module.add_configure_spark_arguments(
            __import__('argparse').ArgumentParser()).parse_args(argv)
        log = []

        class Builder(object):
            def master(self, value):
                log.append(('master', value))
                return self

            def config(self, key, value):
                log.append(('config', key, value))
                return self

            def getOrCreate(self):
                return log

        stub_pyspark.sql.SparkSession = types.SimpleNamespace(builder=Builder())
        module.configure_spark(Builder(), args)
        module.configure_spark(args)
        calls[name] = log
        with pytest.raises(TypeError, match='args'):
            module.configure_spark(Builder())
    assert calls['port'] == calls['jax']
    with pytest.raises(SystemExit):
        port_cli.add_configure_spark_arguments(
            __import__('argparse').ArgumentParser()).parse_args(
                ['--spark-session-config', 'novalue'])
