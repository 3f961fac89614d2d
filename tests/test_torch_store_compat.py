"""Stores are interchangeable between petastorm_tpu and petastorm_tpu_torch:
each package reads what the other wrote, with equal rows and schema."""

import numpy as np
import pytest

import petastorm_tpu
from petastorm_tpu import codecs as jax_codecs
from petastorm_tpu import unischema as jax_unischema
from petastorm_tpu.etl import dataset_metadata as jax_metadata
import petastorm_tpu_torch
from petastorm_tpu_torch import codecs, unischema
from petastorm_tpu_torch.etl import dataset_metadata

ROWS = 20


def _schema(codec_mod, schema_mod):
    field = schema_mod.UnischemaField
    return schema_mod.Unischema('Compat', [
        field('idx', np.int64, (), codec_mod.ScalarCodec(), False),
        field('name', np.str_, (), codec_mod.ScalarCodec(), False),
        field('score', np.float64, (), None, False),
        field('mat', np.float32, (3, 4), codec_mod.NdarrayCodec(), False),
        field('vec', np.int16, (None,), codec_mod.CompressedNdarrayCodec(), False),
        field('img', np.uint8, (16, 8, 3), codec_mod.DctImageCodec(quality=85), False),
        field('maybe', np.int32, (), codec_mod.ScalarCodec(), True),
    ])


def _rows(seed=0):
    rng = np.random.RandomState(seed)
    return [{'idx': i, 'name': 'row-{}'.format(i), 'score': float(rng.rand()),
             'mat': rng.randn(3, 4).astype(np.float32),
             'vec': rng.randint(-9, 9, rng.randint(1, 6)).astype(np.int16),
             'img': rng.randint(0, 255, (16, 8, 3), dtype=np.uint8),
             'maybe': None if i % 3 == 0 else i}
            for i in range(ROWS)]


def _read_rows(make_reader, url):
    with make_reader(url, reader_pool_type='dummy', shuffle_row_groups=False) as reader:
        return sorted((row._asdict() for row in reader), key=lambda r: r['idx'])


def _assert_rows_equal(got, want):
    assert len(got) == len(want) == ROWS
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            if w[key] is None:
                assert g[key] is None, key
            elif isinstance(w[key], np.ndarray):
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            else:
                assert g[key] == w[key], key


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_each_package_reads_the_others_store(tmp_path, writer):
    url = 'file://' + str(tmp_path / 'store')
    if writer == 'jax':
        jax_metadata.write_rows(url, _schema(jax_codecs, jax_unischema), _rows(),
                                rowgroup_size_mb=1, n_files=2)
    else:
        dataset_metadata.write_rows(url, _schema(codecs, unischema), _rows(),
                                    rowgroup_size_mb=1, n_files=2)
    port_rows = _read_rows(petastorm_tpu_torch.make_reader, url)
    jax_rows = _read_rows(petastorm_tpu.make_reader, url)
    _assert_rows_equal(port_rows, jax_rows)
    # the DCT image decodes through the same numpy math on both sides
    assert port_rows[1]['img'].shape == (16, 8, 3)
    port_schema = dataset_metadata.get_schema(dataset_metadata.open_dataset(url))
    jax_schema = jax_metadata.get_schema(jax_metadata.open_dataset(url))
    assert port_schema.to_json_dict() == jax_schema.to_json_dict()
    assert port_schema == _schema(codecs, unischema)


def test_rowgroup_index_matches(tmp_path):
    url = 'file://' + str(tmp_path / 'store')
    dataset_metadata.write_rows(url, _schema(codecs, unischema), _rows(),
                                rowgroup_size_mb=1, n_files=3)
    port = dataset_metadata.load_row_groups(dataset_metadata.open_dataset(url))
    jax = jax_metadata.load_row_groups(jax_metadata.open_dataset(url))
    assert [(r.fragment_path, r.row_group_id, r.row_group_num_rows) for r in port] == \
        [(r.fragment_path, r.row_group_id, r.row_group_num_rows) for r in jax]
    port_md = dataset_metadata.read_metadata_dict(dataset_metadata.open_dataset(url))
    for key in (jax_metadata.UNISCHEMA_JSON_KEY, jax_metadata.ROW_GROUPS_JSON_KEY):
        assert key in port_md


def test_level0_container_decodes_in_both_packages():
    """A level-0 CompressedNdarrayCodec cell is an ordinary zip deflate member:
    both packages' codecs decode it, and its raw member parses as all-stored."""
    from petastorm_tpu_torch.ops.raw_decode import parse_stored_deflate_layout
    value = np.random.RandomState(1).randn(2048).astype(np.float32)
    port_field = unischema.UnischemaField('e', np.float32, (2048,),
                                          codecs.CompressedNdarrayCodec(stored=True))
    blob = port_field.codec.encode(port_field, value)
    jax_field = jax_unischema.UnischemaField('e', np.float32, (2048,),
                                             jax_codecs.CompressedNdarrayCodec())
    np.testing.assert_array_equal(jax_field.codec.decode(jax_field, blob), value)
    np.testing.assert_array_equal(port_field.codec.decode(port_field, blob), value)
    method, body = codecs._npz_raw_member(blob)
    assert method == 8 and parse_stored_deflate_layout(body) is not None
    assert port_field.codec == codecs.CompressedNdarrayCodec()
