"""Stores written by the reference petastorm read through the port as they
read through ``petastorm_tpu``: the seven vendored legacy stores' schemas
(field names, numpy dtypes, shapes, codec names, nullability) and rows (PNG
images included) are equal in both packages, exactly. ``CompressedImageCodec``
encodes to the JAX codec's bytes and decodes to its arrays, png and jpeg.
"""

import os
from decimal import Decimal

import numpy as np
import pytest

LEGACY = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data', 'legacy')
VERSIONS = ['0.4.0', '0.4.3', '0.5.1', '0.6.0', '0.7.0', '0.7.6', 'prehistoric']


def _url(version):
    return 'file://' + os.path.join(LEGACY, version)


def _field_summary(schema):
    def dtype(numpy_dtype):
        return 'Decimal' if numpy_dtype is Decimal else np.dtype(numpy_dtype).str
    return {name: (dtype(f.numpy_dtype), tuple(f.shape),
                   None if f.codec is None else f.codec.codec_name,
                   None if f.codec is None else f.codec.to_config(), bool(f.nullable))
            for name, f in schema.fields.items()}


@pytest.mark.parametrize('version', VERSIONS)
def test_legacy_schema_equals_the_jax_packages(version):
    from petastorm_tpu.etl import dataset_metadata as jax_metadata
    from petastorm_tpu_torch.etl import dataset_metadata
    ours = dataset_metadata.get_schema_from_dataset_url(_url(version))
    theirs = jax_metadata.get_schema_from_dataset_url(_url(version))
    assert list(ours.fields) == list(theirs.fields)
    assert _field_summary(ours) == _field_summary(theirs)
    assert 'image_png' in ours.fields
    assert ours.fields['image_png'].codec.codec_name == 'compressed_image'
    handle = dataset_metadata.open_dataset(_url(version))
    assert _field_summary(dataset_metadata.infer_or_load_unischema(handle)) == \
        _field_summary(theirs)


def _rows(make_reader, version):
    with make_reader(_url(version), reader_pool_type='dummy', num_epochs=1,
                     shuffle_row_groups=False) as reader:
        return {int(row.id): row._asdict() for row in reader}


@pytest.mark.parametrize('version', VERSIONS)
def test_legacy_rows_equal_the_jax_packages(version):
    from petastorm_tpu import make_reader as jax_make_reader
    from petastorm_tpu_torch import make_reader
    ours = _rows(make_reader, version)
    theirs = _rows(jax_make_reader, version)
    assert sorted(ours) == sorted(theirs) == list(range(100))
    for row_id, want in theirs.items():
        got = ours[row_id]
        assert sorted(got) == sorted(want)
        for name, value in want.items():
            if isinstance(value, np.ndarray):
                assert got[name].dtype == value.dtype and got[name].shape == value.shape
                np.testing.assert_array_equal(got[name], value)
            else:
                assert type(got[name]) is type(value) and got[name] == value, name
    assert ours[0]['image_png'].shape == (32, 16, 3)
    assert isinstance(ours[0]['decimal'], Decimal)


def test_legacy_get_schema_refuses_a_forbidden_global():
    import pickle

    from petastorm_tpu_torch.etl.legacy import depickle_legacy_unischema
    blob = pickle.dumps(eval, protocol=0)
    with pytest.raises(pickle.UnpicklingError, match='forbidden'):
        depickle_legacy_unischema(blob)


IMAGES = {
    'rgb': np.random.RandomState(0).randint(0, 255, (20, 24, 3), dtype=np.uint8),
    'gray': np.random.RandomState(1).randint(0, 255, (20, 24), dtype=np.uint8),
    'rgb16': np.random.RandomState(2).randint(0, 65535, (8, 10, 3), dtype=np.uint16),
}


@pytest.mark.parametrize('image_codec,quality,image', [
    ('png', 80, 'rgb'), ('png', 80, 'gray'), ('png', 80, 'rgb16'),
    ('jpeg', 90, 'rgb'), ('jpeg', 50, 'gray')])
def test_compressed_image_codec_bytes_and_arrays_equal_the_jax_codec(image_codec, quality,
                                                                     image):
    pytest.importorskip('cv2')
    from petastorm_tpu.codecs import CompressedImageCodec as JaxCodec
    from petastorm_tpu.unischema import UnischemaField as JaxField
    from petastorm_tpu_torch.codecs import CompressedImageCodec, codec_from_config
    from petastorm_tpu_torch.unischema import UnischemaField
    value = IMAGES[image]
    shape = (None, None) + value.shape[2:]
    ours = CompressedImageCodec(image_codec, quality)
    theirs = JaxCodec(image_codec, quality)
    field = UnischemaField('im', value.dtype.type, shape, ours, False)
    jax_field = JaxField('im', value.dtype.type, shape, theirs, False)
    blob = ours.encode(field, value)
    assert blob == theirs.encode(jax_field, value)
    decoded = ours.decode(field, blob)
    want = theirs.decode(jax_field, blob)
    assert decoded.dtype == want.dtype and decoded.shape == want.shape == value.shape
    np.testing.assert_array_equal(decoded, want)
    if image_codec == 'png':
        np.testing.assert_array_equal(decoded, value)
    assert ours.to_config() == theirs.to_config()
    assert codec_from_config(ours.to_config()) == ours


def test_compressed_image_store_reads_in_both_packages(tmp_path):
    """A port-written store of png and jpeg images reads back equal through the
    JAX package's make_reader."""
    pytest.importorskip('cv2')
    from petastorm_tpu import make_reader as jax_make_reader
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('Images', [
        UnischemaField('id', np.int64, (), ScalarCodec(), False),
        UnischemaField('png', np.uint8, (16, 12, 3), CompressedImageCodec('png'), False),
        UnischemaField('jpeg', np.uint8, (16, 12, 3), CompressedImageCodec('jpeg', 85),
                       False)])
    rng = np.random.RandomState(4)
    rows = [{'id': i, 'png': rng.randint(0, 255, (16, 12, 3), dtype=np.uint8),
             'jpeg': rng.randint(0, 255, (16, 12, 3), dtype=np.uint8)} for i in range(6)]
    url = 'file://' + str(tmp_path / 'images')
    write_rows(url, schema, rows)
    for factory in (make_reader, jax_make_reader):
        with factory(url, reader_pool_type='dummy', shuffle_row_groups=False) as reader:
            got = {int(r.id): r for r in reader}
        for row in rows:
            np.testing.assert_array_equal(got[row['id']].png, row['png'])
        if factory is make_reader:
            ours = got
    for i, row in got.items():
        np.testing.assert_array_equal(ours[i].jpeg, row.jpeg)
