"""The port's Arrow predicate pushdown against the JAX package's:
``compile_predicate(...).evaluate`` on the same seeded Arrow tables gives the
JAX package's mask and the port's decoded-path mask
(``evaluate_predicate_mask``) for every compilable case; the same predicates
fail to compile in both packages; and the readers keep, with ``in_set``, the
rows the JAX readers keep and the rows their own ``in_lambda`` path keeps,
reading each storage column of a rowgroup once."""

import numpy as np
import pyarrow as pa
import pytest

import petastorm_tpu.codecs as jax_codecs
import petastorm_tpu.decode_engine as jax_engine
import petastorm_tpu.predicates as jax_predicates
import petastorm_tpu.unischema as jax_unischema
import petastorm_tpu_torch.codecs as port_codecs
import petastorm_tpu_torch.decode_engine as port_engine
import petastorm_tpu_torch.predicates as port_predicates
import petastorm_tpu_torch.unischema as port_unischema
from petastorm_tpu import make_batch_reader as jax_make_batch_reader
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu_torch import make_batch_reader, make_reader

PACKAGES = {'jax': (jax_unischema, jax_codecs, jax_predicates, jax_engine),
            'port': (port_unischema, port_codecs, port_predicates, port_engine)}


def _field(u, c, name, dtype, nullable=False):
    return u.UnischemaField(name, dtype, (), c.ScalarCodec(), nullable)


# ---------------------------------------------------------- mask parity

def _mixed(u, c):
    return u.Unischema('Mixed', [_field(u, c, 'id', np.int64), _field(u, c, 'key', np.str_),
                                 _field(u, c, 'score', np.float32),
                                 _field(u, c, 'blob', np.bytes_)])


def _mixed_table(n=64):
    rng = np.random.RandomState(7)
    return pa.table({
        'id': pa.array([int(v) for v in rng.randint(0, 20, size=n)], type=pa.int64()),
        'key': pa.array(['k_{}'.format(i % 9) for i in range(n)]),
        'score': pa.array([float(v) for v in rng.rand(n)], type=pa.float32()),
        'blob': pa.array([b'a', b'z', b'k_1'] * (n // 3) + [b'a'] * (n % 3),
                         type=pa.binary())})


def _narrow(u, c):
    return u.Unischema('Narrow', [_field(u, c, 'x', np.uint8)])


def _narrow_table():
    return pa.table({'x': pa.array([0, 255, 7, 2], type=pa.uint8())})


def _nullable(u, c):
    return u.Unischema('Nulls', [_field(u, c, 'id', np.int64, nullable=True)])


def _nullable_table():
    return pa.table({'id': pa.array([1, None, 5, None, 7], type=pa.int64())})


#: case -> (schema of a package's (unischema, codecs) modules, table, predicate
#: of a package's predicates module)
MASK_CASES = {
    'in_set_int': (_mixed, _mixed_table, lambda p: p.in_set({1, 5, 7, 19}, 'id')),
    'in_set_empty': (_mixed, _mixed_table, lambda p: p.in_set(set(), 'id')),
    'in_set_str': (_mixed, _mixed_table, lambda p: p.in_set({'k_2', 'k_8', 'no'}, 'key')),
    'in_set_bytes': (_mixed, _mixed_table, lambda p: p.in_set({b'a', b'q'}, 'blob')),
    'in_set_float': (_mixed, _mixed_table, lambda p: p.in_set({0.25, 0.5}, 'score')),
    'str_set_on_bytes': (_mixed, _mixed_table, lambda p: p.in_set({'a', 'k_1'}, 'blob')),
    'bytes_set_on_str': (_mixed, _mixed_table, lambda p: p.in_set({b'k_1'}, 'key')),
    'out_of_range_int': (_narrow, _narrow_table,
                         lambda p: p.in_set({-1, 255, 2 ** 70}, 'x')),
    'nulls': (_nullable, _nullable_table, lambda p: p.in_set({1, 5}, 'id')),
    'in_negate': (_mixed, _mixed_table, lambda p: p.in_negate(p.in_set({3, 4}, 'id'))),
    'in_reduce_all': (_mixed, _mixed_table, lambda p: p.in_reduce(
        [p.in_set(set(range(10)), 'id'), p.in_set({'k_1', 'k_2', 'k_3'}, 'key')], all)),
    'in_reduce_any': (_mixed, _mixed_table, lambda p: p.in_reduce(
        [p.in_set({1}, 'id'), p.in_negate(p.in_set({'k_0'}, 'key'))], any)),
    'split_str': (_mixed, _mixed_table,
                  lambda p: p.in_pseudorandom_split([0.3, 0.4, 0.3], 1, 'key')),
    'split_int': (_mixed, _mixed_table,
                  lambda p: p.in_pseudorandom_split([0.5, 0.5], 0, 'id')),
    'nested': (_mixed, _mixed_table, lambda p: p.in_negate(p.in_reduce(
        [p.in_pseudorandom_split([0.6, 0.4], 0, 'key'), p.in_set({2, 4, 6}, 'id')],
        any))),
}

#: masks some cases must give, whatever both packages say
EXPECTED = {'out_of_range_int': [False, True, False, False],
            'nulls': [True, False, True, False, False],
            'str_set_on_bytes': [False] * 64, 'bytes_set_on_str': [False] * 64}


def _masks(case, table):
    schema_fn, _, predicate_fn = MASK_CASES[case]
    out = {}
    for name, (u, c, p, engine) in PACKAGES.items():
        schema, predicate = schema_fn(u, c), predicate_fn(p)
        compiled = engine.compile_predicate(predicate, schema)
        assert compiled is not None, '{} did not compile {}'.format(name, case)
        assert isinstance(compiled, engine.CompiledPredicate)
        out[name] = compiled.evaluate(table)
        fields = sorted(predicate.get_fields())
        columns = engine.compile_decode_plan(schema, fields).execute(table)
        out[name + '_decoded'] = engine.evaluate_predicate_mask(predicate, columns,
                                                                table.num_rows)
    return out


@pytest.mark.parametrize('case', sorted(MASK_CASES))
def test_compiled_mask_equals_jax_and_the_decoded_path(case):
    table = MASK_CASES[case][1]()
    masks = _masks(case, table)
    assert masks['port'].dtype == np.bool_ and masks['port'].shape == (table.num_rows,)
    for other in ('jax', 'port_decoded', 'jax_decoded'):
        np.testing.assert_array_equal(masks['port'], masks[other], err_msg=other)
    if case in EXPECTED:
        np.testing.assert_array_equal(masks['port'], EXPECTED[case])


INTEGER_WIDTHS = ['int8', 'int16', 'int32', 'int64', 'uint8', 'uint16', 'uint32', 'uint64']


@pytest.mark.parametrize('width', INTEGER_WIDTHS)
def test_is_in_casts_every_native_integer_width(width):
    """``pyarrow.compute.is_in`` on a native column of each integer width (the
    batch reader keeps Arrow's types), a negative value included for the
    unsigned ones, which falls back inside the leaf."""
    dtype = np.dtype(width)
    values = np.arange(12, dtype=dtype)
    table = pa.table({'v': pa.array(values)})
    masks = []
    for u, c, p, engine in PACKAGES.values():
        schema = u.Unischema('W', [u.UnischemaField('v', dtype, (), None, False)])
        compiled = engine.compile_predicate(p.in_set({-1, 3, 7, 11}, 'v'), schema)
        assert compiled is not None
        masks.append(compiled.evaluate(table))
    want = np.isin(values, [3, 7, 11])
    for mask in masks:
        np.testing.assert_array_equal(mask, want)


def _flipped(p):
    class Flipped(p.in_set):
        def do_include(self, values):
            return not super().do_include(values)
    return Flipped({1}, 'id')


UNCOMPILABLE = {
    'in_lambda': lambda p: p.in_lambda(['id'], lambda v: v > 3),
    'custom_reduce': lambda p: p.in_reduce([p.in_set({1}, 'id')],
                                           lambda results: sum(results) > 0),
    'unknown_field': lambda p: p.in_set({1}, 'no_such_field'),
    'subclass': _flipped,
    'in_intersection': lambda p: p.in_intersection({1}, 'id'),
    'partition_field': lambda p: p.in_set({'k_0'}, 'key'),
    'tensor_field': lambda p: p.in_set({1}, 'vec'),
}


@pytest.mark.parametrize('case', sorted(UNCOMPILABLE))
def test_uncompilable_predicates_return_none_in_both(case):
    for u, c, p, engine in PACKAGES.values():
        schema = u.Unischema('U', [_field(u, c, 'id', np.int64), _field(u, c, 'key', np.str_),
                                   u.UnischemaField('vec', np.float32, (3,),
                                                    c.NdarrayCodec(), False)])
        partitions = {'key'} if case == 'partition_field' else ()
        assert engine.compile_predicate(UNCOMPILABLE[case](p), schema,
                                        partition_field_names=partitions) is None


# ---------------------------------------------------------- the readers

ROWS = 96


def _rows():
    rng = np.random.RandomState(11)
    return [{'id': i, 'label': int(rng.randint(6)), 'name': 'n{}'.format(rng.randint(7)),
             'vec': rng.randn(3).astype(np.float32)} for i in range(ROWS)]


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    """96 rows in 4 files of one rowgroup each."""
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    u, c = port_unischema, port_codecs
    schema = u.Unischema('Pushdown', [
        _field(u, c, 'id', np.int64), _field(u, c, 'label', np.int64),
        _field(u, c, 'name', np.str_),
        u.UnischemaField('vec', np.float32, (3,), c.NdarrayCodec(), False)])
    url = 'file://' + str(tmp_path_factory.mktemp('pushdown') / 'store')
    write_rows(url, schema, _rows(), n_files=4)
    return url


def _keep_label(value):
    # a scalar in make_reader, the whole column in make_batch_reader
    return np.isin(value, (1, 4))


def _read_ids(factory, url, predicate, **kwargs):
    if factory in (make_batch_reader, jax_make_batch_reader):
        with pytest.warns(UserWarning):
            with factory(url, predicate=predicate, **kwargs) as reader:
                return [int(i) for batch in reader for i in batch.id]
    with factory(url, predicate=predicate, **kwargs) as reader:
        return [int(row.id) for row in reader]


@pytest.mark.parametrize('storage', [False, True], ids=['fragment', 'storage_engine'])
@pytest.mark.parametrize('batched', [False, True], ids=['make_reader', 'make_batch_reader'])
def test_readers_keep_the_rows_of_jax_and_of_their_decoded_path(store, monkeypatch,
                                                                 batched, storage):
    ours_factory = make_batch_reader if batched else make_reader
    jax_factory = jax_make_batch_reader if batched else jax_make_reader
    compiled = []
    original = port_engine.compile_predicate

    def spy(*args, **kwargs):
        result = original(*args, **kwargs)
        compiled.append(result)
        return result

    monkeypatch.setattr(port_engine, 'compile_predicate', spy)
    kwargs = dict(reader_pool_type='thread', workers_count=1, shuffle_row_groups=True,
                  seed=5, storage_policy=storage)
    pushed = _read_ids(ours_factory, store, port_predicates.in_set({1, 4}, 'label'),
                       **kwargs)
    assert len(compiled) == 4
    assert all(isinstance(c, port_engine.CompiledPredicate) for c in compiled)
    compiled.clear()
    decoded = _read_ids(ours_factory, store,
                        port_predicates.in_lambda(['label'], _keep_label), **kwargs)
    assert compiled == [None] * 4
    theirs = _read_ids(jax_factory, store, jax_predicates.in_set({1, 4}, 'label'), **kwargs)
    want = {row['id'] for row in _rows() if row['label'] in (1, 4)}
    assert pushed == decoded == theirs
    assert sorted(pushed) == sorted(want)


def test_two_phase_load_reads_each_column_once_and_decodes_no_predicate(store,
                                                                        monkeypatch):
    from petastorm_tpu_torch.reader_worker import RowGroupWorker
    reads, decodes = [], []
    read_columns, decode_table = RowGroupWorker._read_columns, RowGroupWorker._decode_table

    def counting_read(self, source, fragment, columns):
        reads.append(tuple(columns))
        return read_columns(self, source, fragment, columns)

    def counting_decode(self, table, partition_keys, field_names, **kwargs):
        decodes.append(tuple(field_names))
        return decode_table(self, table, partition_keys, field_names, **kwargs)

    monkeypatch.setattr(RowGroupWorker, '_read_columns', counting_read)
    monkeypatch.setattr(RowGroupWorker, '_decode_table', counting_decode)
    with make_reader(store, predicate=port_predicates.in_set({1, 4}, 'label'),
                     reader_pool_type='dummy', shuffle_row_groups=False) as reader:
        rows = list(reader)
    want = [row for row in _rows() if row['label'] in (1, 4)]
    assert [r.id for r in rows] == [row['id'] for row in want]
    for got, row in zip(rows, want):
        np.testing.assert_array_equal(got.vec, row['vec'])
    # per rowgroup: the predicate's column, then the others, each once
    assert reads == [('label',), ('id', 'name', 'vec')] * 4
    # the predicate's column is never decoded apart from the output
    assert all(fields == ('id', 'label', 'name', 'vec') for fields in decodes)
