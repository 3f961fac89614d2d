"""The port's predicates against the JAX package's: every predicate class
gives the same answers on the same values, both factories keep the same rows
(the two-phase load, with the compiled pushdown and the per-row fallback),
a predicate on partition keys prunes rowgroups before any worker runs, and
``in_pseudorandom_split`` keeps the same ``idx`` set, bit for bit."""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import petastorm_tpu.predicates as jax_predicates
import petastorm_tpu_torch.predicates as port_predicates
from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu_torch import make_batch_reader, make_reader

ROWS = 60


def _id_is_even(value):
    return value % 2 == 0


#: one constructor per predicate case, taking the predicates module of a package
PREDICATES = {
    'in_set': lambda m: m.in_set({1, 3}, 'label'),
    'in_set_str': lambda m: m.in_set({'n3', 'n5', 'n8'}, 'name'),
    'in_intersection': lambda m: m.in_intersection({2, 7}, 'tags'),
    'in_lambda': lambda m: m.in_lambda(['id'], _id_is_even),
    'in_negate': lambda m: m.in_negate(m.in_set({0}, 'label')),
    'in_reduce_all': lambda m: m.in_reduce(
        [m.in_set({1, 2, 3}, 'label'), m.in_pseudorandom_split([0.5, 0.5], 1, 'id')], all),
    'in_reduce_any': lambda m: m.in_reduce(
        [m.in_set({4}, 'label'), m.in_lambda(['id'], _id_is_even)], any),
    'in_pseudorandom_split': lambda m: m.in_pseudorandom_split([0.3, 0.7], 0, 'id'),
}


def _rows():
    rng = np.random.RandomState(5)
    return [{'id': i, 'label': np.int32(rng.randint(5)), 'name': 'n{}'.format(rng.randint(10)),
             'tags': rng.randint(0, 10, size=3).astype(np.int32),
             'vec': rng.randn(3).astype(np.float32)} for i in range(ROWS)]


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    """60 rows in 3 files of one rowgroup each."""
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('Predicates', [
        UnischemaField('id', np.int64, (), ScalarCodec(), False),
        UnischemaField('label', np.int32, (), ScalarCodec(), False),
        UnischemaField('name', np.str_, (), ScalarCodec(), False),
        UnischemaField('tags', np.int32, (None,), None, False),
        UnischemaField('vec', np.float32, (3,), NdarrayCodec(), False)])
    url = 'file://' + str(tmp_path_factory.mktemp('predicates') / 'store')
    write_rows(url, schema, _rows(), n_files=3)
    return url


@pytest.mark.parametrize('name', sorted(PREDICATES))
def test_predicate_classes_agree_on_rows_and_columns(name):
    ours = PREDICATES[name](port_predicates)
    theirs = PREDICATES[name](jax_predicates)
    assert ours.get_fields() == theirs.get_fields()
    rows = _rows()
    for row in rows:
        assert bool(ours.do_include(row)) == bool(theirs.do_include(row))
    columns = {key: np.asarray([row[key] for row in rows]) for key in rows[0]}
    np.testing.assert_array_equal(ours.do_include(columns), theirs.do_include(columns))


READS = {'in_order': dict(shuffle_row_groups=False),
         'shuffled': dict(shuffle_row_groups=True, shuffle_rows=True, seed=3,
                          shuffle_row_drop_partitions=2)}


@pytest.mark.parametrize('read', sorted(READS))
@pytest.mark.parametrize('name', sorted(PREDICATES))
def test_make_reader_keeps_the_rows_jax_keeps(store, name, read):
    kwargs = dict(reader_pool_type='dummy', **READS[read])
    with make_reader(store, predicate=PREDICATES[name](port_predicates), **kwargs) as reader:
        ours = [(row.id, row.label, row.name, row.vec.tolist()) for row in reader]
    with jax_make_reader(store, predicate=PREDICATES[name](jax_predicates),
                         **kwargs) as reader:
        theirs = [(row.id, row.label, row.name, row.vec.tolist()) for row in reader]
    assert 0 < len(ours) < ROWS
    assert ours == theirs


@pytest.mark.parametrize('name', sorted(PREDICATES))
def test_make_batch_reader_keeps_the_rows_jax_keeps(store, name):
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=False)
    with pytest.warns(UserWarning):
        with make_batch_reader(store, predicate=PREDICATES[name](port_predicates),
                               **kwargs) as reader:
            ours = [int(i) for batch in reader for i in batch.id]
    with pytest.warns(UserWarning):
        with jax_make_batch_reader(store, predicate=PREDICATES[name](jax_predicates),
                                   **kwargs) as reader:
            theirs = [int(i) for batch in reader for i in batch.id]
    assert 0 < len(ours) < ROWS
    assert ours == theirs


def test_predicate_fields_outside_the_view_are_read(store):
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=False, schema_fields=['id'])
    with make_reader(store, predicate=port_predicates.in_set({2}, 'label'), **kwargs) as reader:
        ours = [tuple(row) for row in reader]
        fields = reader.result_schema.fields
    with jax_make_reader(store, predicate=jax_predicates.in_set({2}, 'label'),
                         **kwargs) as reader:
        theirs = [tuple(row) for row in reader]
    assert list(fields) == ['id', 'label']
    assert ours == theirs and all(label == 2 for _, label in ours)


def test_two_phase_load_decodes_only_the_rows_kept(store, monkeypatch):
    """The predicate's column is read first; the codec column is decoded
    only for the rows kept, and no value of it for a rowgroup with none."""
    from petastorm_tpu_torch.codecs import NdarrayCodec
    decoded = []
    original = NdarrayCodec.decode_arrow_column

    def counting(self, field, column):
        decoded.append(len(column))
        return original(self, field, column)

    monkeypatch.setattr(NdarrayCodec, 'decode_arrow_column', counting)
    want = sum(1 for row in _rows() if row['label'] in (1, 3))
    with make_reader(store, predicate=port_predicates.in_set({1, 3}, 'label'),
                     reader_pool_type='dummy') as reader:
        assert len(list(reader)) == want
    assert sum(decoded) == want and len(decoded) == 3
    decoded.clear()
    with make_reader(store, predicate=port_predicates.in_set({99}, 'label'),
                     reader_pool_type='dummy') as reader:
        assert list(reader) == []
    assert sum(decoded) == 0


@pytest.fixture(scope='module')
def partitioned_store(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('hive') / 'ds')
    table = pa.table({'id': np.arange(100, dtype=np.int64),
                      'val': np.arange(100, dtype=np.float64) / 2,
                      'city': pa.array(['nyc', 'sfo', 'ams', 'ber'] * 25)})
    pq.write_to_dataset(table, root, partition_cols=['city'])
    return 'file://' + root


def _is_sfo(city):
    return city == 'sfo'


def test_partition_key_predicate_prunes_rowgroups(partitioned_store):
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=False)
    with make_batch_reader(partitioned_store, workers_count=1, **kwargs) as reader:
        all_items = reader.items_per_epoch
    with make_batch_reader(partitioned_store, predicate=port_predicates.in_lambda(
            ['city'], _is_sfo), **kwargs) as reader:
        pruned_items = reader.items_per_epoch
        ours = [(int(i), str(c)) for b in reader for i, c in zip(b.id, b.city)]
    with jax_make_batch_reader(partitioned_store, predicate=jax_predicates.in_lambda(
            ['city'], _is_sfo), **kwargs) as reader:
        theirs = [(int(i), str(c)) for b in reader for i, c in zip(b.id, b.city)]
    assert all_items == 4 and pruned_items == 1
    assert len(ours) == 25 and all(i % 4 == 1 and c == 'sfo' for i, c in ours)
    assert ours == theirs


def test_pseudorandom_split_keeps_the_same_idx_set_as_jax(tmp_path):
    from petastorm_tpu_torch.benchmark.mnist_data import write_mnist_store
    url = 'file://' + str(tmp_path / 'mnist')
    write_mnist_store(url, 400, n_files=2)
    ours_pred = port_predicates.in_pseudorandom_split([0.8, 0.2], 0, 'idx')
    theirs_pred = jax_predicates.in_pseudorandom_split([0.8, 0.2], 0, 'idx')
    host = np.nonzero(ours_pred.do_include({'idx': np.arange(400)}))[0]
    np.testing.assert_array_equal(
        host, np.nonzero(theirs_pred.do_include({'idx': np.arange(400)}))[0])
    with make_reader(url, predicate=ours_pred, schema_fields=['idx'],
                     workers_count=2, seed=1) as reader:
        ours = sorted(int(row.idx) for row in reader)
    with jax_make_reader(url, predicate=theirs_pred, schema_fields=['idx'],
                         reader_pool_type='dummy') as reader:
        theirs = sorted(int(row.idx) for row in reader)
    assert ours == theirs == host.tolist()
    assert 0.7 < len(ours) / 400 < 0.9
