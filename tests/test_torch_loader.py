"""The port's TorchDataLoader emits the same batch sequence as petastorm_tpu's
JaxDataLoader(device_put=False) for the same store, seed and dummy pool, and
keeps the loader surface (drop_last, stats, prefetch knobs)."""

import numpy as np
import pytest
import torch

from test_torch_device_stage import jax_batches, port_batches, write_device_decode_store

NUMERIC = ['idx', 'label', 'mat']


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    return write_device_decode_store(tmp_path_factory.mktemp('loader') / 'store',
                                     rows=40, files=3)


@pytest.mark.parametrize('capacity,drop_last,shuffle_rows', [
    (0, True, False), (16, True, True), (16, False, True), (0, False, True)])
def test_batch_sequence_matches_jax(store, capacity, drop_last, shuffle_rows):
    reader_kwargs = dict(schema_fields=NUMERIC, seed=5, shuffle_row_groups=True,
                         shuffle_rows=shuffle_rows)
    loader_kwargs = dict(batch_size=6, shuffling_queue_capacity=capacity, seed=9,
                         drop_last=drop_last)
    ours, stats = port_batches(store, reader_kwargs, **loader_kwargs)
    theirs, _ = jax_batches(store, reader_kwargs, device_put=False, **loader_kwargs)
    assert len(ours) == len(theirs) == (40 // 6 if drop_last else -(-40 // 6))
    for got, want in zip(ours, theirs):
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert stats['batches'] == len(ours)
    assert stats['rows'] == sum(len(b['idx']) for b in ours)
    assert 0.0 <= stats['input_stall_fraction'] <= 1.0


@pytest.fixture(scope='module')
def ragged_store(tmp_path_factory):
    """Two ragged NdarrayCodec fields, (None,) int32 and (None, 3) float32."""
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    url = 'file://' + str(tmp_path_factory.mktemp('ragged') / 'store')
    schema = Unischema('Ragged', [
        UnischemaField('idx', np.int64, (), ScalarCodec(), False),
        UnischemaField('ids', np.int32, (None,), NdarrayCodec(), False),
        UnischemaField('points', np.float32, (None, 3), NdarrayCodec(), False)])
    rng = np.random.RandomState(2)
    rows = []
    for i in range(30):
        n, m = rng.randint(1, 9), rng.randint(1, 6)
        rows.append({'idx': i, 'ids': rng.randint(0, 1000, n).astype(np.int32),
                     'points': rng.randn(m, 3).astype(np.float32)})
    write_rows(url, schema, rows, n_files=3)
    return url


@pytest.mark.parametrize('capacity', [0, 10])
def test_pad_ragged_matches_jax(ragged_store, capacity):
    pad = {'ids': (8,), 'points': (5, 3)}
    reader_kwargs = dict(seed=4, shuffle_row_groups=True)
    loader_kwargs = dict(batch_size=7, shuffling_queue_capacity=capacity, seed=6,
                         drop_last=False, pad_ragged=pad)
    ours, _ = port_batches(ragged_store, reader_kwargs, **loader_kwargs)
    theirs, _ = jax_batches(ragged_store, reader_kwargs, device_put=False, **loader_kwargs)
    assert len(ours) == len(theirs) == -(-30 // 7)
    for got, want in zip(ours, theirs):
        assert sorted(got) == sorted(want) == ['ids', 'ids_len', 'idx', 'points', 'points_len']
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert sorted(np.concatenate([b['idx'] for b in ours]).tolist()) == list(range(30))


@pytest.mark.parametrize('cur_shard', [0, 1])
def test_shard_matches_jax(store, cur_shard):
    reader_kwargs = dict(schema_fields=NUMERIC, seed=3, cur_shard=cur_shard, shard_count=2)
    ours, _ = port_batches(store, reader_kwargs, batch_size=4, drop_last=False)
    theirs, _ = jax_batches(store, reader_kwargs, device_put=False, batch_size=4,
                            drop_last=False)
    assert len(ours) == len(theirs) > 0
    for got, want in zip(ours, theirs):
        np.testing.assert_array_equal(got['idx'], want['idx'])


def test_thread_pool_serves_every_row_once(store):
    batches, _ = port_batches(store, dict(schema_fields=NUMERIC, reader_pool_type='thread',
                                          workers_count=3), batch_size=7, drop_last=False)
    ids = np.concatenate([b['idx'] for b in batches])
    assert sorted(ids.tolist()) == list(range(40))


def test_loader_yields_tensors_and_reiterates(store):
    from petastorm_tpu_torch import TorchDataLoader, make_reader
    with make_reader(store, schema_fields=NUMERIC, reader_pool_type='dummy',
                     num_epochs=1) as reader:
        loader = TorchDataLoader(reader, batch_size=8, device='cpu', prefetch=1)
        assert loader.set_prefetch(3) == 3 and loader.prefetch == 3
        assert loader.set_device_buffer_depth(4) == loader.device_buffer_depth == 4
        first = list(loader)
        second = list(loader)
    assert len(first) == len(second) == 5
    assert all(isinstance(v, torch.Tensor) and v.device.type == 'cpu'
               for b in first for v in b.values())
    assert first[0]['mat'].dtype == torch.int16 and first[0]['mat'].shape == (8, 4, 5)
    assert first[0]['idx'].dtype == torch.int64
    assert loader.stats.batches == 10


def test_loader_rejects_strings_and_missing_card(tmp_path):
    from petastorm_tpu_torch import TorchDataLoader, make_reader
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    url = 'file://' + str(tmp_path / 's')
    schema = Unischema('S', [UnischemaField('s', np.str_, (), ScalarCodec(), False)])
    write_rows(url, schema, [{'s': 'a'}, {'s': 'b'}])
    with make_reader(url, reader_pool_type='dummy') as reader:
        with pytest.raises(ValueError, match='no tensor'):
            list(TorchDataLoader(reader, batch_size=2, device='cpu'))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match='cuda'):
                TorchDataLoader(reader, batch_size=2)
