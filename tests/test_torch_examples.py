"""The example twins (``examples/**/torch_*.py``) on the CPU at a tiny size:
each ``main(argv)`` ends with a finite loss, and the MNIST and long-context
twins' first loader batch equals the JAX example's loader's on the same store
and seed, exactly."""

import math
import os

import numpy as np
import pytest


def _finite(loss):
    return loss is not None and math.isfinite(loss)


def test_converter_twin_trains(tmp_path):
    from examples.converter import torch_converter_example
    loss = torch_converter_example.main(['--device', 'cpu', '--cache-dir', str(tmp_path),
                                         '--rows', '256', '--steps', '6',
                                         '--batch-size', '32'])
    assert _finite(loss)
    assert os.listdir(str(tmp_path)) == []   # the converter deleted its store


@pytest.fixture(scope='module')
def mnist_store(tmp_path_factory):
    from examples.mnist import torch_example
    url = 'file://' + str(tmp_path_factory.mktemp('mnist_twin') / 'mnist')
    torch_example.generate_store(url, train_count=200, test_count=40)
    return url


def test_mnist_twin_store_is_the_synthetic_generators(mnist_store):
    from examples.mnist.generate_petastorm_mnist import synthetic_mnist_rows
    from petastorm_tpu import make_reader as jax_make_reader
    want = {row['idx']: row for row in synthetic_mnist_rows(200, seed=0)}
    with jax_make_reader(mnist_store + '/train', reader_pool_type='dummy') as reader:
        rows = list(reader)
    assert len(rows) == 200
    for row in rows:
        assert row.digit == want[row.idx]['digit']
        np.testing.assert_array_equal(row.image, want[row.idx]['image'])


@pytest.mark.parametrize('mode', [[], ['--inmem'], ['--scan-stream', '--chunk-batches', '2'],
                                  ['--reference-loader']])
def test_mnist_twin_trains(mnist_store, mode):
    from examples.mnist import torch_example
    loss = torch_example.main(['--dataset-url', mnist_store, '--device', 'cpu',
                               '--batch-size', '32'] + mode)
    assert _finite(loss)


def test_mnist_twin_checkpoint_resumes(mnist_store, tmp_path, capsys):
    from examples.mnist import torch_example
    argv = ['--dataset-url', mnist_store, '--device', 'cpu', '--batch-size', '32',
            '--checkpoint-dir', str(tmp_path / 'ckpt'), '--save-every', '1',
            '--max-steps', '2']
    assert _finite(torch_example.main(argv))
    assert _finite(torch_example.main(argv))
    assert 'resuming from step 2' in capsys.readouterr().out


def test_mnist_twin_first_batch_equals_the_jax_examples(mnist_store):
    from examples.mnist import jax_example
    from examples.mnist import torch_example
    from petastorm_tpu import make_reader as jax_make_reader
    from petastorm_tpu.parallel.loader import JaxDataLoader
    with torch_example.train_reader(mnist_store, 1) as reader:
        loader = torch_example.train_loader(reader, 32, 1024, 'cpu')
        ours = {k: v.numpy() for k, v in next(iter(loader)).items()}
    with jax_make_reader(mnist_store + '/train', num_epochs=1,
                         transform_spec=jax_example.TRANSFORM, shuffle_rows=True,
                         seed=42) as reader:
        loader = JaxDataLoader(reader, batch_size=32, shuffling_queue_capacity=1024,
                               seed=42, device_put=False)
        theirs = next(iter(loader))
    assert sorted(ours) == sorted(theirs) == ['digit', 'idx', 'image']
    for name in theirs:
        assert ours[name].dtype == theirs[name].dtype
        np.testing.assert_array_equal(ours[name], theirs[name])


@pytest.mark.parametrize('mode', ['png', 'on_chip_decode', 'scan_chunk'])
def test_imagenet_twin_trains(tmp_path, mode):
    if mode == 'png':
        pytest.importorskip('cv2')
    from examples.imagenet import torch_example
    argv = ['--dataset-url', 'file://' + str(tmp_path / 'imagenet'), '--device', 'cpu',
            '--batch-size', '4', '--image-hw', '32', '--num-filters', '8',
            '--workers', '1']
    if mode != 'png':
        argv += ['--on-chip-decode']
    if mode == 'scan_chunk':
        argv += ['--scan-chunk', '2']
    assert _finite(torch_example.main(argv))


LONG_CONTEXT = {
    'docs': ['--seq-len', '64', '--num-docs', '32'],
    'ngram': ['--seq-len', '64', '--num-docs', '64', '--ngram-frames', '4'],
    'packed': ['--packed', '--seq-len', '64', '--num-docs', '64', '--batch-size', '2'],
}


@pytest.mark.parametrize('mode', sorted(LONG_CONTEXT))
def test_long_context_twin_trains(tmp_path, mode):
    from examples.long_context import torch_example
    url = str(tmp_path / mode)
    args = LONG_CONTEXT[mode]
    num_docs = int(args[args.index('--num-docs') + 1])
    if mode == 'packed':
        torch_example.build_ragged_dataset(url, num_docs=num_docs)
    elif mode == 'ngram':
        torch_example.build_frame_dataset(url, num_frames=num_docs, frame_len=16)
    else:
        torch_example.build_dataset(url, num_docs=num_docs, seq_len=64)
    loss = torch_example.main(['--dataset-url', url, '--device', 'cpu', '--epochs', '1',
                               '--max-steps', '2'] + args)
    assert _finite(loss)


@pytest.mark.parametrize('mode', ['docs', 'packed'])
def test_long_context_twin_first_batch_equals_the_jax_examples(tmp_path, mode):
    from examples.long_context import jax_example
    from examples.long_context import torch_example
    from petastorm_tpu import make_batch_reader as jax_make_batch_reader
    from petastorm_tpu import make_reader as jax_make_reader
    from petastorm_tpu.ops.packing import make_packing_transform as jax_packing
    from petastorm_tpu.parallel.loader import JaxDataLoader
    from petastorm_tpu_torch import TorchDataLoader
    url = str(tmp_path / mode)
    batch_size = 2 if mode == 'packed' else 8
    if mode == 'packed':
        jax_example.build_ragged_dataset(url, num_docs=64)
        jax_reader = jax_make_batch_reader(url, transform_spec=jax_packing('tokens', 64),
                                           num_epochs=1, shuffle_row_groups=True, seed=7,
                                           reader_pool_type='dummy')
    else:
        jax_example.build_dataset(url, num_docs=32, seq_len=64)
        jax_reader = jax_make_reader(url, schema_fields=['tokens'], num_epochs=1,
                                     shuffle_row_groups=True, seed=7,
                                     reader_pool_type='dummy')
    with jax_reader:
        theirs = next(iter(JaxDataLoader(jax_reader, batch_size=batch_size,
                                         device_put=False)))
    with torch_example.make_reader_for(url, mode, 64, epochs=1,
                                       reader_pool_type='dummy') as reader:
        ours = next(iter(TorchDataLoader(reader, batch_size=batch_size, device='cpu')))
    assert sorted(ours) == sorted(theirs)
    for name in theirs:
        assert ours[name].numpy().dtype == theirs[name].dtype
        np.testing.assert_array_equal(ours[name].numpy(), theirs[name])


# ------------------------------------------------ the TensorFlow twins

def test_hello_world_tensorflow_twin(tmp_path):
    pytest.importorskip('tensorflow')
    from examples.hello_world.petastorm_dataset import torch_generate_petastorm_dataset
    from examples.hello_world.petastorm_dataset.torch_tensorflow_hello_world import main
    url = 'file://' + str(tmp_path / 'hello_world')
    torch_generate_petastorm_dataset.main(['-o', url, '-n', '6'])
    ids = main(['-d', url])
    assert len(ids) == len(set(ids)) == 3 and set(ids) <= set(range(6))


def test_external_tensorflow_twin(tmp_path):
    pytest.importorskip('tensorflow')
    from examples.hello_world.external_dataset.torch_generate_external_dataset import (
        generate_external_dataset)
    from examples.hello_world.external_dataset.torch_tensorflow_hello_world import main
    url = 'file://' + str(tmp_path / 'external')
    generate_external_dataset(url, 40)
    ids = np.concatenate(main(['-d', url])).tolist()
    assert len(ids) == len(set(ids)) > 0 and set(ids) <= set(range(40))


def test_mnist_tensorflow_twin_trains(mnist_store):
    pytest.importorskip('tensorflow')
    from examples.mnist import torch_tf_example
    metrics = torch_tf_example.main(['--dataset-url', mnist_store, '--batch-size', '32',
                                     '--steps', '6'])
    assert np.isfinite(metrics).all()


def test_converter_tensorflow_twin_trains(tmp_path):
    pytest.importorskip('tensorflow')
    from examples.converter import torch_tensorflow_converter_example
    loss = torch_tensorflow_converter_example.main(['--cache-dir', str(tmp_path),
                                                    '--steps', '5'])
    assert _finite(loss)
    assert os.listdir(str(tmp_path)) == []   # the converter deleted its store
