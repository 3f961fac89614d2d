"""Rowgroup indexes and selectors of the port against the JAX package's: an
index built by either package is read by the other to the same indexers,
every selector picks the same pieces, and ``make_reader(rowgroup_selector=)``
reads the same rows (the selection applied to the full rowgroup enumeration,
before sharding)."""

import numpy as np
import pytest

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu_torch import make_reader

ROWGROUPS = 6
ROWS_PER_ROWGROUP = 5


def _write_store(url):
    """One rowgroup a file: ``group`` takes two values a rowgroup, ``tag`` is
    shared by rowgroups, ``maybe`` is null in every third rowgroup."""
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('Indexed', [
        UnischemaField('id', np.int64, (), ScalarCodec(), False),
        UnischemaField('group', np.int64, (), ScalarCodec(), False),
        UnischemaField('tag', np.str_, (), ScalarCodec(), False),
        UnischemaField('maybe', np.int32, (), ScalarCodec(), True)])
    rows = [{'id': rg * ROWS_PER_ROWGROUP + i, 'group': rg + 10 * (i % 2),
             'tag': 'tag{}'.format(rg % 3), 'maybe': None if rg % 3 == 2 else i}
            for rg in range(ROWGROUPS) for i in range(ROWS_PER_ROWGROUP)]
    write_rows(url, schema, rows, rows_per_file=ROWS_PER_ROWGROUP)


def _indexers(package):
    if package == 'port':
        from petastorm_tpu_torch.etl.rowgroup_indexers import (FieldNotNullIndexer,
                                                               SingleFieldIndexer)
    else:
        from petastorm_tpu.etl.rowgroup_indexers import FieldNotNullIndexer, SingleFieldIndexer
    return [SingleFieldIndexer('by_group', 'group'), SingleFieldIndexer('by_tag', 'tag'),
            FieldNotNullIndexer('has_maybe', 'maybe')]


def _build(package, url):
    if package == 'port':
        from petastorm_tpu_torch.etl.rowgroup_indexing import build_rowgroup_index
    else:
        from petastorm_tpu.etl.rowgroup_indexing import build_rowgroup_index
    build_rowgroup_index(url, _indexers(package))


def _read(package, url):
    if package == 'port':
        from petastorm_tpu_torch.etl.dataset_metadata import open_dataset
        from petastorm_tpu_torch.etl.rowgroup_indexing import get_row_group_indexes
    else:
        from petastorm_tpu.etl.dataset_metadata import open_dataset
        from petastorm_tpu.etl.rowgroup_indexing import get_row_group_indexes
    return get_row_group_indexes(open_dataset(url))


@pytest.fixture(scope='module')
def indexed_store(tmp_path_factory):
    url = 'file://' + str(tmp_path_factory.mktemp('indexed') / 'store')
    _write_store(url)
    _build('port', url)
    return url


@pytest.mark.parametrize('maker,reader', [('port', 'jax'), ('jax', 'port')])
def test_an_index_built_by_one_package_reads_in_the_other(tmp_path, maker, reader):
    url = 'file://' + str(tmp_path / 'store')
    _write_store(url)
    _build(maker, url)
    got = {name: indexer.to_json_dict() for name, indexer in _read(reader, url).items()}
    want = {name: indexer.to_json_dict() for name, indexer in _read(maker, url).items()}
    assert got == want
    assert sorted(got) == ['by_group', 'by_tag', 'has_maybe']
    assert got['by_group']['data'] == {str(v): [v % 10] for v in
                                       list(range(ROWGROUPS)) + list(range(10, 10 + ROWGROUPS))}
    assert got['has_maybe']['data'] == [0, 1, 3, 4]


def _selectors(package):
    if package == 'port':
        from petastorm_tpu_torch import selectors
    else:
        from petastorm_tpu import selectors
    single = selectors.SingleIndexSelector
    return {
        'single': single('by_group', [1, 13, 99]),
        'single_str': single('by_tag', ['tag2']),
        'not_null': single('has_maybe', [None]),
        'intersect': selectors.IntersectIndexSelector(
            [single('by_tag', ['tag0', 'tag1']), single('by_group', [0, 4, 5])]),
        'union': selectors.UnionIndexSelector(
            [single('by_tag', ['tag2']), single('by_group', [10])]),
    }


@pytest.mark.parametrize('name', sorted(_selectors('port')))
def test_selectors_pick_the_same_pieces(indexed_store, name):
    ours = _selectors('port')[name].select_row_groups(_read('port', indexed_store))
    theirs = _selectors('jax')[name].select_row_groups(_read('jax', indexed_store))
    assert ours == theirs and 0 < len(ours) < ROWGROUPS


@pytest.mark.parametrize('shard', [None, 0, 1])
@pytest.mark.parametrize('name', sorted(_selectors('port')))
def test_make_reader_with_a_selector_reads_the_rows_jax_reads(indexed_store, name, shard):
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=True, seed=4)
    if shard is not None:
        kwargs.update(cur_shard=shard, shard_count=2)
    try:
        with make_reader(indexed_store, rowgroup_selector=_selectors('port')[name],
                         **kwargs) as reader:
            ours = [row.id for row in reader]
    except Exception as exc:  # noqa: BLE001 - the refusal must be JAX's too
        ours = type(exc).__name__
    try:
        with jax_make_reader(indexed_store, rowgroup_selector=_selectors('jax')[name],
                             **kwargs) as reader:
            theirs = [row.id for row in reader]
    except Exception as exc:  # noqa: BLE001
        theirs = type(exc).__name__
    assert ours == theirs
    if shard is None:
        pieces = _selectors('port')[name].select_row_groups(_read('port', indexed_store))
        assert sorted(ours) == sorted(p * ROWS_PER_ROWGROUP + i for p in pieces
                                      for i in range(ROWS_PER_ROWGROUP))


def test_a_store_without_an_index_is_refused(tmp_path):
    from petastorm_tpu_torch.selectors import SingleIndexSelector
    url = 'file://' + str(tmp_path / 'store')
    _write_store(url)
    with pytest.raises(ValueError, match='build_rowgroup_index'):
        make_reader(url, rowgroup_selector=SingleIndexSelector('by_group', [1]))
