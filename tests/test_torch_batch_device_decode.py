"""``make_batch_reader(device_decode_fields=...)`` into the device decode tail
on the CPU (the plain versions of K1 and J1), against the JAX package's
``make_batch_reader(device_decode_fields=...)`` plus ``JaxDataLoader`` on its
device path (``PETASTORM_TPU_DEVICE_DECODE_FORCE=1``), and against the port's
``make_reader`` path. The tolerance is the ``make_reader`` device-decode parity
test's (``test_torch_device_stage.py``): npy and stored-deflate fields
bit-exact, DCT images within +-1 of JAX's; the port's two readers agree
exactly. Also the cases that raise, and ``coalesce_fields``."""

import os
import warnings

import numpy as np
import pytest

from test_torch_device_stage import DEVICE_FIELDS, to_numpy, write_device_decode_store

LEGACY_0_7_6 = 'file://' + os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                        'data', 'legacy', '0.7.6')


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    return write_device_decode_store(tmp_path_factory.mktemp('batch_decode') / 'store',
                                     rows=24)


def port_batches(url, factory='batch', reader_kwargs=None, **loader_kwargs):
    from petastorm_tpu_torch import TorchDataLoader, make_batch_reader, make_reader
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=False,
                  device_decode_fields=DEVICE_FIELDS)
    kwargs.update(reader_kwargs or {})
    loader_kwargs.setdefault('device', 'cpu')
    make = make_batch_reader if factory == 'batch' else make_reader
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')   # "written with a Unischema"
        reader = make(url, **kwargs)
    with reader:
        loader = TorchDataLoader(reader, batch_size=8, **loader_kwargs)
        return [to_numpy(b) for b in loader], loader.stats.as_dict()


def test_batch_reader_device_path_matches_jax(store, monkeypatch):
    monkeypatch.setenv('PETASTORM_TPU_DEVICE_DECODE_FORCE', '1')
    from petastorm_tpu import make_batch_reader as jax_make_batch_reader
    from petastorm_tpu.parallel.loader import JaxDataLoader
    ours, stats = port_batches(store)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        reader = jax_make_batch_reader(store, reader_pool_type='dummy',
                                       shuffle_row_groups=False,
                                       device_decode_fields=DEVICE_FIELDS)
    with reader:
        jax_loader = JaxDataLoader(reader, batch_size=8)
        theirs = [{k: np.asarray(v) for k, v in b.items()} for b in jax_loader]
    assert stats['device_stored_batches'] == stats['device_decode_batches'] == 3
    assert stats['device_fallback_batches'] == 0
    assert len(ours) == len(theirs) == 3
    for got, want in zip(ours, theirs):
        assert sorted(got) == sorted(want) == ['idx', 'img', 'label', 'mat', 'vec']
        for key in ('vec', 'mat', 'label'):
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        # JAX under x32 delivers int64 as its low word; the port keeps int64
        assert got['idx'].dtype == np.int64
        np.testing.assert_array_equal(got['idx'], want['idx'].astype(np.int64))
        assert got['img'].dtype == want['img'].dtype == np.uint8
        assert got['img'].shape == want['img'].shape == (8, 16, 24, 3)
        assert np.abs(got['img'].astype(int) - want['img'].astype(int)).max() <= 1


def test_batch_reader_equals_make_reader_exactly(store):
    ours, stats = port_batches(store)
    rows, _ = port_batches(store, factory='rows')
    assert stats['device_stored_batches'] == 3
    assert len(ours) == len(rows) == 3
    for got, want in zip(ours, rows):
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize('coalesce', [True, False])
def test_coalesce_fields_gives_equal_batches(store, coalesce):
    default, default_stats = port_batches(store)
    chosen, stats = port_batches(store, coalesce_fields=coalesce)
    # on the CPU the default uploads field by field
    assert default_stats['coalesced_uploads'] == 0
    assert default_stats['per_field_uploads'] == 3
    assert stats['coalesced_uploads' if coalesce else 'per_field_uploads'] == 3
    assert stats['per_field_uploads' if coalesce else 'coalesced_uploads'] == 0
    for got, want in zip(chosen, default):
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


def test_a_batch_that_cannot_pack_goes_field_by_field():
    import torch

    from petastorm_tpu_torch.parallel.loader import coalescible, upload_fields
    big_endian = {'a': np.arange(4, dtype='>i4'), 'b': np.ones(4, np.float32)}
    assert not coalescible(big_endian)
    assert coalescible({'b': np.ones(4, np.float32), 'c': np.zeros((4, 2), bool)})
    out = upload_fields(big_endian, torch.device('cpu'))
    assert out['a'].dtype == torch.int32 and out['a'].tolist() == [0, 1, 2, 3]


RAISING = {
    'plain_store': (None, 'requires a Unischema store'),
    'transform_spec': ({'transform_spec': 'spec'}, 'mutually exclusive'),
    'unknown_field': ({'device_decode_fields': ['img', 'nope']}, 'not in this read'),
    'partition_field': ({'device_decode_fields': ['partition_key']},
                        'cannot name partition keys'),
}


@pytest.mark.parametrize('case', sorted(RAISING))
def test_batch_reader_raises_where_jax_raises(store, scalar_dataset, case):
    from petastorm_tpu import make_batch_reader as jax_make_batch_reader
    from petastorm_tpu.transform import TransformSpec as JaxSpec
    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.transform import TransformSpec
    extra, message = RAISING[case]
    url = {'plain_store': scalar_dataset.url,
           'partition_field': LEGACY_0_7_6}.get(case, store)
    for factory, spec_cls in ((make_batch_reader, TransformSpec),
                              (jax_make_batch_reader, JaxSpec)):
        kwargs = {'device_decode_fields': DEVICE_FIELDS, 'reader_pool_type': 'dummy'}
        kwargs.update(extra or {})
        if kwargs.get('transform_spec') == 'spec':
            kwargs['transform_spec'] = spec_cls(lambda frame: frame)
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            with pytest.raises(ValueError, match=message):
                factory(url, **kwargs)
