"""The port's TensorFlow adapters (``petastorm_tpu_torch.tf_utils`` and
``DatasetConverter.make_tf_dataset``) held against the JAX package's on the
same stores and seeds: ``make_petastorm_dataset`` over row, batch and NGram
readers, ``tf_tensors`` in graph mode (rows, NGram windows, the shuffling
queue's named size op), the dtype sanitization, and the converter's
``tf.data`` pipeline, each giving equal tensors. TensorFlow runs on the CPU
only; it has no path to the card."""

import datetime
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pytest

tf = pytest.importorskip('tensorflow')

import petastorm_tpu as pt  # noqa: E402
import petastorm_tpu.tf_utils as jax_tf  # noqa: E402
import petastorm_tpu_torch.tf_utils as port_tf  # noqa: E402
from petastorm_tpu.ngram import NGram as JaxNGram  # noqa: E402
from petastorm_tpu_torch import NGram, make_batch_reader, make_reader  # noqa: E402

PACKAGES = {'port': (make_reader, make_batch_reader, port_tf, NGram),
            'jax': (pt.make_reader, pt.make_batch_reader, jax_tf, JaxNGram)}
ROWS = 24


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    """24 rows: ``ts`` int64, ``v`` float32 (2,), ``u`` uint16, ``name`` str, in
    4 files, written by the JAX package."""
    from petastorm_tpu.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu.etl.dataset_metadata import write_rows
    from petastorm_tpu.unischema import Unischema, UnischemaField
    schema = Unischema('TfProbe', [
        UnischemaField('ts', np.int64, (), ScalarCodec(), False),
        UnischemaField('v', np.float32, (2,), NdarrayCodec(), False),
        UnischemaField('u', np.uint16, (), ScalarCodec(pa.uint16()), False),
        UnischemaField('name', np.str_, (), ScalarCodec(pa.string()), False)])
    url = 'file://' + str(tmp_path_factory.mktemp('tf') / 'store')
    write_rows(url, schema, [{'ts': t, 'v': np.array([t, -t], np.float32), 'u': np.uint16(t),
                              'name': 'n{}'.format(t)} for t in range(ROWS)],
               rows_per_file=ROWS // 4)
    return url


def _numpy(structure):
    return tf.nest.map_structure(lambda t: np.asarray(t.numpy()).tolist(), structure)


@pytest.mark.parametrize('kind', ['row', 'batch', 'ngram'])
def test_make_petastorm_dataset_equals_jax(store, kind):
    results = {}
    for name, (row, batch, module, ngram_cls) in PACKAGES.items():
        kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=False)
        if kind == 'row':
            reader = row(store, **kwargs)
        elif kind == 'batch':
            reader = batch(store, schema_fields=['ts', 'u'], **kwargs)
        else:
            reader = row(store, schema_fields=ngram_cls({0: ['ts', 'v'], 1: ['ts']},
                                                        delta_threshold=1,
                                                        timestamp_field='ts'), **kwargs)
        with reader:
            elements = [_numpy(element) for element in module.make_petastorm_dataset(reader)]
        results[name] = [tf.nest.flatten(e) for e in elements]
    assert results['port'] == results['jax'] and results['port']


def test_dataset_regeneration_resets_the_reader(store):
    with make_reader(store, reader_pool_type='dummy', schema_fields=['ts']) as reader:
        dataset = port_tf.make_petastorm_dataset(reader)
        assert len(list(dataset)) == len(list(dataset)) == ROWS


@pytest.mark.parametrize('kind', ['row', 'ngram'])
def test_tf_tensors_graph_mode_equals_jax(store, kind):
    results = {}
    for name, (row, _, module, ngram_cls) in PACKAGES.items():
        fields = ['ts', 'v'] if kind == 'row' else ngram_cls(
            {0: ['ts', 'v'], 1: ['ts']}, delta_threshold=1, timestamp_field='ts')
        with row(store, reader_pool_type='dummy', schema_fields=fields,
                 shuffle_row_groups=False) as reader:
            with tf.Graph().as_default():
                tensors = module.tf_tensors(reader)
                with tf.compat.v1.Session() as session:
                    values = [session.run(tensors) for _ in range(8)]
        results[name] = [[np.asarray(x).tolist() for x in tf.nest.flatten(v)]
                         for v in values]
    assert results['port'] == results['jax']


def test_shuffling_queue_size_op_is_named(store):
    with make_reader(store, reader_pool_type='dummy', schema_fields=['ts'],
                     num_epochs=None) as reader:
        with tf.Graph().as_default() as graph:
            row = port_tf.tf_tensors(reader, shuffling_queue_capacity=8, min_after_dequeue=2)
            size = graph.get_tensor_by_name(port_tf.RANDOM_SHUFFLING_QUEUE_SIZE + ':0')
            with tf.compat.v1.Session() as session:
                coord = tf.train.Coordinator()
                threads = tf.compat.v1.train.start_queue_runners(session, coord)
                session.run(row)
                depth = session.run(size)
                coord.request_stop()
                coord.join(threads, stop_grace_period_secs=5)
    assert port_tf.RANDOM_SHUFFLING_QUEUE_SIZE == jax_tf.RANDOM_SHUFFLING_QUEUE_SIZE
    assert 0 <= int(depth) <= 8
    with make_batch_reader(store, reader_pool_type='dummy') as reader:
        with pytest.raises(ValueError, match='batched'):
            port_tf.tf_tensors(reader, shuffling_queue_capacity=4)


@pytest.mark.parametrize('value', [
    Decimal('1.25'), datetime.date(1970, 1, 2), np.uint16(7), np.uint32(7),
    np.array([1, 2], np.uint16), np.array([1, 2], np.uint32),
    np.array(['2020-01-01'], 'datetime64[D]'), 5, 'text'])
def test_sanitization_equals_jax(value):
    ours = port_tf._sanitize_field_value(value)
    theirs = jax_tf._sanitize_field_value(value)
    assert type(ours) is type(theirs)
    assert np.array_equal(np.asarray(ours), np.asarray(theirs))


def test_tf_dtypes_equal_jax():
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.unischema import UnischemaField
    for dtype in (np.str_, Decimal, np.uint16, np.uint32, np.int8, np.float64,
                  np.dtype('datetime64[ns]')):
        field = UnischemaField('f', dtype, (), ScalarCodec(), False)
        assert port_tf._tf_dtype_for_field(field) == jax_tf._tf_dtype_for_field(field)


def test_make_tf_dataset_equals_the_jax_converters(tmp_path):
    from petastorm_tpu.converter import make_converter as jax_make_converter
    from petastorm_tpu_torch.converter import make_converter
    table = pa.table({'x': np.arange(60, dtype=np.int64),
                      'y': np.linspace(0, 1, 60).astype(np.float32)})
    results = {}
    for name, make in (('port', make_converter), ('jax', jax_make_converter)):
        converter = make(table, parent_cache_dir_url=str(tmp_path / name), rows_per_file=15)
        try:
            with converter.make_tf_dataset(batch_size=16, reader_pool_type='dummy',
                                           shuffle_row_groups=False) as dataset:
                results[name] = [_numpy(batch) for batch in dataset]
        finally:
            converter.delete()
    assert [tf.nest.flatten(b) for b in results['port']] == \
        [tf.nest.flatten(b) for b in results['jax']]
    assert sum(len(b.x) for b in results['port']) == 60
