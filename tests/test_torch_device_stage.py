"""The port's device decode tail, run on the CPU through the kernels' plain
versions, against petastorm_tpu's JaxDataLoader on its device path
(PETASTORM_TPU_DEVICE_DECODE_FORCE=1): npy and stored-deflate fields bit-exact,
DCT images within +-1, and the stored-inflate path taken on both sides.

The store writer and loader runners here are shared with test_torch_loader and
test_torch_slice. Stores are written through the port's codecs with a
``CompressedNdarrayCodec(stored=True)`` field, so its cells are all-stored
deflate frames (the form the stored-inflate kernel takes); both packages read
them."""

import numpy as np
import pytest

from petastorm_tpu_torch.codecs import (CompressedNdarrayCodec, DctImageCodec,
                                        NdarrayCodec, ScalarCodec)
from petastorm_tpu_torch.etl.dataset_metadata import write_rows
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

DEVICE_FIELDS = ['img', 'vec', 'mat']


def device_decode_schema(hw=(16, 24), vec_len=17):
    return Unischema('TorchPortDecode', [
        UnischemaField('idx', np.int64, (), ScalarCodec(), False),
        UnischemaField('label', np.int32, (), ScalarCodec(), False),
        UnischemaField('img', np.uint8, tuple(hw) + (3,), DctImageCodec(quality=80), False),
        UnischemaField('vec', np.float32, (vec_len,),
                       CompressedNdarrayCodec(stored=True), False),
        UnischemaField('mat', np.int16, (4, 5), NdarrayCodec(), False),
    ])


def write_device_decode_store(path, rows=24, hw=(16, 24), vec_len=17, files=2, seed=0,
                              smooth_images=False):
    """A store with a DCT image, a level-0 compressed vector, an npy matrix and
    two scalars; returns its ``file://`` URL."""
    url = 'file://' + str(path)
    rng = np.random.RandomState(seed)
    data = []
    for i in range(rows):
        if smooth_images:
            coarse = rng.randint(0, 255, (hw[0] // 8, hw[1] // 8, 3)).astype(np.float32)
            img = np.kron(coarse, np.ones((8, 8, 1), np.float32))
            img = np.clip(img + rng.randn(*img.shape) * 4.0, 0, 255).astype(np.uint8)
        else:
            img = rng.randint(0, 255, tuple(hw) + (3,), dtype=np.uint8)
        data.append({'idx': i, 'label': int(rng.randint(10)), 'img': img,
                     'vec': rng.randn(vec_len).astype(np.float32),
                     'mat': rng.randint(-5, 5, (4, 5)).astype(np.int16)})
    write_rows(url, device_decode_schema(hw, vec_len), data, rowgroup_size_mb=1,
               n_files=files)
    return url


def to_numpy(batch):
    """A batch dict of tensors or arrays (torch or JAX) -> dict of numpy arrays."""
    import torch
    out = {}
    for name, value in batch.items():
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu()
            # numpy has no bfloat16: widen exactly to float32
            value = (value.float() if value.dtype == torch.bfloat16 else value).numpy()
        out[name] = np.asarray(value)
    return out


def port_batches(url, reader_kwargs=None, **loader_kwargs):
    """Every batch of a port ``TorchDataLoader`` on the CPU, as numpy, plus its stats."""
    from petastorm_tpu_torch import TorchDataLoader, make_reader
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=False)
    kwargs.update(reader_kwargs or {})
    loader_kwargs.setdefault('device', 'cpu')
    with make_reader(url, **kwargs) as reader:
        loader = TorchDataLoader(reader, **loader_kwargs)
        batches = [to_numpy(b) for b in loader]
        return batches, loader.stats.as_dict()


def jax_batches(url, reader_kwargs=None, **loader_kwargs):
    """Every batch of a ``petastorm_tpu`` ``JaxDataLoader``, as numpy, plus the loader."""
    from petastorm_tpu import make_reader
    from petastorm_tpu.parallel.loader import JaxDataLoader
    kwargs = dict(reader_pool_type='dummy', shuffle_row_groups=False)
    kwargs.update(reader_kwargs or {})
    with make_reader(url, **kwargs) as reader:
        loader = JaxDataLoader(reader, **loader_kwargs)
        batches = [{k: np.asarray(v) for k, v in b.items()} for b in loader]
        return batches, loader


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    return write_device_decode_store(tmp_path_factory.mktemp('stage') / 'store', rows=24)


def test_device_path_matches_jax_device_path(store, monkeypatch):
    monkeypatch.setenv('PETASTORM_TPU_DEVICE_DECODE_FORCE', '1')
    reader_kwargs = {'device_decode_fields': DEVICE_FIELDS}
    ours, stats = port_batches(store, reader_kwargs, batch_size=8)
    theirs, jax_loader = jax_batches(store, reader_kwargs, batch_size=8)
    # the stored-inflate path ran on both sides
    assert stats['device_stored_batches'] == stats['device_decode_batches'] == 3
    assert stats['device_fallback_batches'] == 0
    jax_recipes = list(jax_loader._device_stage._programs)
    assert jax_recipes and all(any(entry[0] == 'stored' for entry in recipe)
                               for recipe in jax_recipes)
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


def test_device_path_matches_host_decode(store):
    """Device path (plain kernels) vs the port's host mode, which decodes
    through the codecs' numpy math: bit-exact except DCT rounding (+-1)."""
    reader_kwargs = {'device_decode_fields': DEVICE_FIELDS}
    device, _ = port_batches(store, reader_kwargs, batch_size=8)
    host, host_stats = port_batches(store, reader_kwargs, batch_size=8, host_decode=True)
    plain, _ = port_batches(store, None, batch_size=8)
    assert host_stats['device_fallback_batches'] == 2  # one per rowgroup chunk
    for d, h, p in zip(device, host, plain):
        for key in ('vec', 'mat', 'idx'):
            np.testing.assert_array_equal(d[key], h[key])
            np.testing.assert_array_equal(h[key], p[key])
        np.testing.assert_array_equal(h['img'], p['img'])
        assert np.abs(d['img'].astype(int) - h['img'].astype(int)).max() <= 1


def test_huffman_frames_inflate_on_host(tmp_path):
    """Default-level containers carry Huffman blocks: the stage inflates them on
    the producer thread and the batch still matches the host decode exactly."""
    from petastorm_tpu_torch.codecs import CompressedNdarrayCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    url = 'file://' + str(tmp_path / 'huff')
    schema = Unischema('H', [UnischemaField('v', np.float32, (32,),
                                            CompressedNdarrayCodec(), False)])
    rows = [{'v': np.full(32, i, np.float32)} for i in range(8)]
    write_rows(url, schema, rows)
    device, stats = port_batches(url, {'device_decode_fields': ['v']}, batch_size=4)
    assert stats['device_decode_batches'] == 2 and stats['device_stored_batches'] == 0
    np.testing.assert_array_equal(np.concatenate([b['v'] for b in device]),
                                  np.stack([r['v'] for r in rows]))


def test_transforms_crop_flip_normalize_on_device_path(store):
    from petastorm_tpu_torch import DeviceTransform
    transform = DeviceTransform(crop=(8, 8), random_flip=True, seed=3,
                                normalize=((0.5, 0.5, 0.5), (0.25, 0.25, 0.25)),
                                normalize_dtype='bfloat16')
    kwargs = dict(batch_size=8, device_transforms={'img': transform})
    first, _ = port_batches(store, {'device_decode_fields': DEVICE_FIELDS}, **kwargs)
    again, _ = port_batches(store, {'device_decode_fields': DEVICE_FIELDS}, **kwargs)
    assert first[0]['img'].shape == (8, 8, 8, 3)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a['img'], b['img'])   # seeded replay
    assert not np.array_equal(first[0]['img'], first[1]['img'])


def test_stage_rejects_bad_configurations(store):
    from petastorm_tpu_torch import DeviceTransform, TorchDataLoader, make_reader
    with make_reader(store, reader_pool_type='dummy',
                     device_decode_fields=DEVICE_FIELDS) as reader:
        with pytest.raises(ValueError, match='DctImageCodec image fields only'):
            TorchDataLoader(reader, 4, device='cpu',
                            device_transforms={'vec': DeviceTransform()})
        with pytest.raises(ValueError, match='without host_decode'):
            TorchDataLoader(reader, 4, device='cpu', host_decode=True,
                            device_transforms={'img': DeviceTransform()})
    with pytest.raises(ValueError, match='requires crop'):
        DeviceTransform(random_flip=True)


def test_multi_block_stored_field_matches_jax_stage(tmp_path, monkeypatch):
    """A float32 (131072,) stored field, each frame several stored blocks
    whose sources drift in alignment: the port's stage (the header-skipping
    table, the plain K1 and a bitcast view) equals the JAX stage's device
    path, and the loader-private segment table never reaches the batch."""
    monkeypatch.setenv('PETASTORM_TPU_DEVICE_DECODE_FORCE', '1')
    from petastorm_tpu_torch.codecs import _npz_raw_member
    from petastorm_tpu_torch.ops import raw_decode
    codec = CompressedNdarrayCodec(stored=True)
    schema = Unischema('Wide', [UnischemaField('idx', np.int64, (), ScalarCodec(), False),
                                UnischemaField('v', np.float32, (131072,), codec, False)])
    rng = np.random.RandomState(5)
    rows = [{'idx': i, 'v': rng.randn(131072).astype(np.float32)} for i in range(4)]
    frame = _npz_raw_member(codec.encode(schema.fields['v'], rows[0]['v']))[1]
    assert len(raw_decode.parse_stored_deflate_layout(frame)) > 2
    url = 'file://' + str(tmp_path / 'wide')
    write_rows(url, schema, rows, rowgroup_size_mb=64)
    from petastorm_tpu_torch.parallel import loader as loader_module
    uploaded = []
    upload = loader_module.upload_columns

    def spy(columns, device):
        uploaded.append(sorted(columns))
        return upload(columns, device)

    monkeypatch.setattr(loader_module, 'upload_columns', spy)
    reader_kwargs = {'device_decode_fields': ['v']}
    ours, stats = port_batches(url, reader_kwargs, batch_size=2)
    theirs, jax_loader = jax_batches(url, reader_kwargs, batch_size=2)
    assert stats['device_stored_batches'] == 2
    # the table rode in the batch's one upload, as in the JAX stage
    assert uploaded == [['idx', 'v', 'v__segs']] * 2
    assert all(entry[0] == 'stored' for recipe in jax_loader._device_stage._programs
               for entry in recipe)
    assert len(ours) == len(theirs) == 2
    for got, want in zip(ours, theirs):
        assert sorted(got) == sorted(want) == ['idx', 'v']
        assert got['v'].dtype == want['v'].dtype == np.float32
        np.testing.assert_array_equal(got['v'], want['v'])
        np.testing.assert_array_equal(got['v'], np.stack([rows[i]['v'] for i in got['idx']]))


@pytest.mark.parametrize('length', [2048, 20000])
def test_stored_plan_benchmark_plans_a_dense_matrix(length):
    """The planner-time script's batch plans as the decode tail plans it:
    one table row per stored block, each frame's npy header skipped, and
    the plain K1 on that table gives the rows' float32 values."""
    import torch
    from petastorm_tpu_torch.benchmark.stored_plan import plan_ms, stored_frames
    from petastorm_tpu_torch.ops import raw_decode
    values = np.random.RandomState(3).randn(4, length).astype(np.float32)
    frames = stored_frames(length, 4, seed=0, values=lambda i: values[i])
    plan, ms = plan_ms(frames, runs=2)
    assert ms > 0
    src, segs, n, row_bytes, dtype_str, row_shape = plan
    assert (n, row_bytes, row_shape) == (4, 4 * length, (length,))
    assert len(segs) == sum(len(raw_decode.parse_stored_deflate_layout(f)) for f in frames)
    out = raw_decode.stored_inflate(torch.from_numpy(src), segs, n * row_bytes)
    np.testing.assert_array_equal(out.numpy().view(np.dtype(dtype_str)).reshape(n, length),
                                  values)
