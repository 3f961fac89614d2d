"""The ``examples/hello_world`` twins of petastorm_tpu_torch run end to end on
the CPU (``--device cpu``) and agree with the JAX package's hello worlds: the
twin's store reads in the JAX package to the same rows, and the JAX
generator's store reads in the twins to the same ids."""

import importlib

import numpy as np
import pytest

PETASTORM = 'examples.hello_world.petastorm_dataset.'
EXTERNAL = 'examples.hello_world.external_dataset.'


def _twin(module):
    return importlib.import_module(module)


def test_petastorm_dataset_twins(tmp_path, capsys):
    from petastorm_tpu import make_reader as jax_make_reader
    url = 'file://' + str(tmp_path / 'hello_world')
    _twin(PETASTORM + 'torch_generate_petastorm_dataset').main(['-o', url, '-n', '6'])
    assert sorted(_twin(PETASTORM + 'torch_python_hello_world').main(['-d', url])) == \
        list(range(6))
    batch = _twin(PETASTORM + 'torch_pytorch_hello_world').main(['-d', url, '--device',
                                                                 'cpu'])
    assert batch['id'].device.type == 'cpu' and batch['id'].shape == (1,)
    ids = _twin(PETASTORM + 'torch_hello_world').main(['-d', url, '--device', 'cpu'])
    assert sorted(ids) == list(range(6))
    assert 'image batch shape (2, 128, 256, 3) on cpu' in capsys.readouterr().out
    # the twin's store, read by the JAX package: the same rows
    from examples.hello_world.petastorm_dataset.torch_generate_petastorm_dataset import \
        row_generator
    rng = np.random.RandomState(0)
    want = {x: row_generator(x, rng) for x in range(6)}
    with jax_make_reader(url, reader_pool_type='dummy') as reader:
        rows = {int(row.id): row for row in reader}
    assert sorted(rows) == list(range(6))
    for x, row in rows.items():
        np.testing.assert_array_equal(row.image1, want[x]['image1'])
        np.testing.assert_array_equal(row.array_4d, want[x]['array_4d'])


def test_the_jax_generators_store_reads_in_the_twins(tmp_path):
    from examples.hello_world.petastorm_dataset.generate_petastorm_dataset import \
        generate_petastorm_dataset
    url = 'file://' + str(tmp_path / 'jax_hello_world')
    generate_petastorm_dataset(url, rows_count=4)
    assert sorted(_twin(PETASTORM + 'torch_python_hello_world').main(['-d', url])) == \
        list(range(4))
    assert sorted(_twin(PETASTORM + 'torch_hello_world').main(
        ['-d', url, '--device', 'cpu'])) == list(range(4))


@pytest.mark.parametrize('generator', ['torch_generate_external_dataset',
                                       'generate_external_dataset'])
def test_external_dataset_twins(tmp_path, generator):
    from petastorm_tpu import make_batch_reader as jax_make_batch_reader
    url = 'file://' + str(tmp_path / 'external')
    importlib.import_module(EXTERNAL + generator).generate_external_dataset(url, 40)
    ids = _twin(EXTERNAL + 'torch_python_hello_world').main(['-d', url])
    with jax_make_batch_reader(url, reader_pool_type='dummy') as reader:
        jax_ids = [int(i) for batch in reader for i in batch.id]
    assert sorted(ids) == sorted(jax_ids) == list(range(40))
    batch = _twin(EXTERNAL + 'torch_pytorch_hello_world').main(['-d', url, '--device',
                                                                'cpu'])
    assert tuple(batch['id'].shape) == (4, 10) and batch['id'].device.type == 'cpu'
    loader_ids = _twin(EXTERNAL + 'torch_hello_world').main(['-d', url, '--device', 'cpu'])
    assert sorted(loader_ids) == list(range(40))
