"""TorchDataLoader.scan_stream on the CPU against the JAX package's
JaxDataLoader.scan_stream over the same MNIST-shaped store: the same rows in
every chunk (the within-chunk shuffle is the same numpy permutation), the
same trailing smaller chunk and dropped remainder, and the same losses of
MnistCNN trained with the bench's step from the same weights (within
``SLICE_RTOL`` of ``test_torch_inmem_loader.py``); then each refusal."""

import numpy as np
import pytest
import torch

from test_torch_inmem_loader import (SLICE_RTOL, flax_mnist, jax_bench_step, port_mnist_step,
                                     write_mnist_store)

ROWS = 300
BATCH = 32
CHUNK = 4   # 128-row chunks: two full, a trailing chunk of one batch, 12 rows dropped


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    return write_mnist_store(tmp_path_factory.mktemp('stream') / 'mnist', rows=ROWS,
                             files=3, seed=2)


def port_stream_loader(url, reader_kwargs=None, **kwargs):
    from petastorm_tpu_torch import TorchDataLoader, make_reader
    reader = make_reader(url, **dict(dict(reader_pool_type='dummy', shuffle_row_groups=False,
                                          num_epochs=1), **(reader_kwargs or {})))
    kwargs.setdefault('device', 'cpu')
    return TorchDataLoader(reader, batch_size=BATCH, **kwargs)


def jax_stream_loader(url):
    from petastorm_tpu import make_reader
    from petastorm_tpu.parallel.loader import JaxDataLoader
    reader = make_reader(url, reader_pool_type='dummy', shuffle_row_groups=False,
                         num_epochs=1)
    return JaxDataLoader(reader, batch_size=BATCH)


@pytest.mark.parametrize('seed', [None, 3])
def test_chunks_match_jax(store, seed):
    loader = port_stream_loader(store)
    ours = loader.scan_stream(lambda batch: batch['idx'], chunk_batches=CHUNK, seed=seed)
    _, theirs = jax_stream_loader(store).scan_stream(
        lambda carry, batch: (carry, batch['idx']), None, chunk_batches=CHUNK, seed=seed)
    assert [tuple(a.shape) for a in ours] == [(4, BATCH), (4, BATCH), (1, BATCH)]
    for got, want in zip(ours, theirs):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    ids = torch.cat([a.view(-1) for a in ours]).tolist()
    assert len(set(ids)) == len(ids) == 9 * BATCH
    if seed is None:
        assert ids == sorted(ids)
    assert loader.stats.batches == 9 and loader.stats.rows == 9 * BATCH
    # a trailing chunk of another size is a program of its own
    assert len(loader._scan_stream_programs) == 2
    # the consumed reader resets for the next pass, which reuses the programs
    again = loader.scan_stream(lambda batch: batch['idx'], chunk_batches=CHUNK, seed=seed)
    assert [tuple(a.shape) for a in again] == [(4, BATCH), (4, BATCH), (1, BATCH)]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_slice_losses_match_jax(store, dtype):
    model, variables = flax_mnist(dtype, seed=1)
    optimizer, train_step = jax_bench_step(model)

    def jax_step(carry, batch):
        params, opt_state = carry
        params, opt_state, loss = train_step(params, opt_state, batch['image'],
                                             batch['digit'])
        return (params, opt_state), loss

    _, want = jax_stream_loader(store).scan_stream(
        jax_step, (variables, optimizer.init(variables)), chunk_batches=CHUNK, seed=5)
    step, model, opt = port_mnist_step(variables, dtype)
    got = port_stream_loader(store).scan_stream(step, chunk_batches=CHUNK, seed=5,
                                                state=(model, opt))
    got = torch.cat(got).numpy()
    want = np.concatenate([np.asarray(w) for w in want])
    assert got.shape == want.shape == (9,)
    np.testing.assert_allclose(got, want, rtol=SLICE_RTOL[dtype])
    assert got[0] != got[-1]


def test_abandoned_iteration_is_stopped(store):
    loader = port_stream_loader(store)
    batches = iter(loader)
    next(batches)
    with pytest.raises(RuntimeError, match='__iter__ is active'):
        loader.scan_stream(lambda batch: None)
    batches.close()   # abandoned: its producer may still be prefetching
    aux = loader.scan_stream(lambda batch: batch['idx'], chunk_batches=CHUNK)
    assert sum(a.shape[0] for a in aux) >= 1


def test_refusals(store, tmp_path):
    from petastorm_tpu_torch import DeviceTransform, TorchDataLoader, make_reader
    from test_torch_device_stage import write_device_decode_store
    step = lambda batch: None  # noqa: E731
    with pytest.raises(ValueError, match='shuffling_queue_capacity=0'):
        port_stream_loader(store, shuffling_queue_capacity=8).scan_stream(step)
    with pytest.raises(ValueError, match='chunk_batches'):
        port_stream_loader(store).scan_stream(step, chunk_batches=0)
    with pytest.raises(ValueError, match='drop_last=True'):
        port_stream_loader(store, drop_last=False).scan_stream(step)
    with pytest.raises(ValueError, match='infinite reader'):
        port_stream_loader(store, dict(num_epochs=None)).scan_stream(step)
    url = write_device_decode_store(tmp_path / 'stage', rows=8)
    for kwargs in ({}, {'device_transforms': {'img': DeviceTransform(crop=(8, 8))}}):
        with make_reader(url, reader_pool_type='dummy',
                         device_decode_fields=['img', 'mat']) as reader:
            loader = TorchDataLoader(reader, batch_size=4, device='cpu', **kwargs)
            with pytest.raises(ValueError, match='device_decode_fields'):
                loader.scan_stream(step)
    # decoded on the host (host_decode), the raw fields are plain columns
    with make_reader(url, reader_pool_type='dummy', device_decode_fields=['mat']) as reader:
        loader = TorchDataLoader(reader, batch_size=4, device='cpu', host_decode=True)
        aux = loader.scan_stream(lambda batch: batch['mat'], chunk_batches=2)
        assert sum(a.shape[0] for a in aux) == 2
