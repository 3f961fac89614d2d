"""InMemTorchLoader on the CPU against the JAX package's InMemJaxLoader over
the same MNIST-shaped store (``bench.py``'s schema at a few hundred rows).

With the port's epoch round keys patched to JAX's (``fold_in(PRNGKey(seed),
epoch)``, then ``randint``), the two loaders yield the same batches, batch for
batch, exactly, shuffled and unshuffled, through iteration and through
``scan_epochs``. Then the JAX loader's single-device behaviours
(``tests/test_inmem_loader.py``) and the slice: four SGD steps of MnistCNN
through both ``scan_epochs`` from the same weights, with the bench's step.

Slice tolerance: losses within 1e-4 relative in float32 (the two differ by
summation order), 1e-2 in bfloat16, the bench's dtype (the frameworks round
the bf16 products at other places; the logits then differ by up to ~2e-2 of
their largest, ``test_torch_mnist.py``, which moves a mean cross-entropy of
~2.3 by well under 1%)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu_torch.parallel import inmem_loader as port_inmem
from test_torch_index_shuffle import jax_round_keys

ROWS = 200
LR = 0.01
SLICE_RTOL = {'float32': 1e-4, 'bfloat16': 1e-2}


def write_mnist_store(path, rows=ROWS, files=4, seed=0):
    """``bench.py``'s MNIST store at ``rows`` rows; returns its url."""
    from petastorm_tpu_torch.benchmark.mnist_data import write_mnist_store as write
    url = 'file://' + str(path)
    write(url, rows, n_files=files, seed=seed)
    return url


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    return write_mnist_store(tmp_path_factory.mktemp('inmem') / 'mnist')


@pytest.fixture
def jax_keys(monkeypatch):
    """The port's loader draws JAX's round keys."""
    monkeypatch.setattr(port_inmem, 'epoch_round_keys', jax_round_keys)


def port_loader(url, reader_kwargs=None, **kwargs):
    from petastorm_tpu_torch import make_reader
    reader = make_reader(url, **dict(dict(reader_pool_type='dummy', shuffle_row_groups=False,
                                          num_epochs=1), **(reader_kwargs or {})))
    kwargs.setdefault('device', 'cpu')
    return port_inmem.InMemTorchLoader(reader, **kwargs)


def jax_loader(url, **kwargs):
    from petastorm_tpu import make_reader
    from petastorm_tpu.parallel import InMemJaxLoader
    reader = make_reader(url, reader_pool_type='dummy', shuffle_row_groups=False,
                         num_epochs=1)
    return InMemJaxLoader(reader, **kwargs)


def _numpy(batch):
    return {name: np.asarray(value) for name, value in batch.items()}


@pytest.mark.parametrize('shuffle', [True, False])
def test_batches_match_inmem_jax_loader(store, jax_keys, shuffle):
    kwargs = dict(batch_size=32, num_epochs=2, shuffle=shuffle, seed=5)
    ours = [_numpy(b) for b in port_loader(store, **kwargs)]
    theirs = [_numpy(b) for b in jax_loader(store, **kwargs)]
    assert len(ours) == len(theirs) == 2 * (ROWS // 32)
    for got, want in zip(ours, theirs):
        assert sorted(got) == sorted(want) == ['digit', 'idx', 'image']
        assert got['image'].dtype == want['image'].dtype == np.uint8
        np.testing.assert_array_equal(got['image'], want['image'])
        for name in ('idx', 'digit'):   # int64: JAX under x32 keeps the low word
            assert got[name].dtype == np.int64
            np.testing.assert_array_equal(got[name], want[name].astype(np.int64))
    if shuffle:
        assert ours[0]['idx'].tolist() != sorted(ours[0]['idx'].tolist())


def test_scan_epochs_batches_match_jax(store, jax_keys):
    loader = port_loader(store, batch_size=40, seed=9)
    ours = loader.scan_epochs(lambda batch: batch['idx'], num_epochs=2)
    theirs = jax_loader(store, batch_size=40, seed=9).scan_epochs(
        lambda carry, batch: (carry, batch['idx']), None, num_epochs=2)[1]
    assert [a.shape for a in ours] == [(5, 40)] * 2
    for got, want in zip(ours, theirs):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def _ids(batches):
    return [int(i) for b in batches for i in b['idx']]


def test_epochs_cover_dataset(store):
    loader = port_loader(store, batch_size=20, num_epochs=2, seed=4)
    assert loader.num_rows == ROWS and len(loader) == ROWS // 20
    batches = list(loader)
    assert all(isinstance(b['image'], torch.Tensor) and b['image'].shape == (20, 28, 28)
               for b in batches)
    first, second = _ids(batches[:10]), _ids(batches[10:])
    assert sorted(first) == sorted(second) == list(range(ROWS))
    assert first != second


def test_seeded_reproducible(store):
    def run(seed):
        return _ids(port_loader(store, batch_size=10, seed=seed))
    assert run(123) == run(123) != run(124)


def test_rows_capacity_and_infinite_reader(store):
    loader = port_loader(store, dict(num_epochs=None), batch_size=10, rows_capacity=30)
    assert loader.num_rows == 30 and len(_ids(loader)) == 30
    with pytest.raises(ValueError, match='rows_capacity'):
        port_loader(store, dict(num_epochs=None), batch_size=10)


def test_drop_last_false_serves_tail(store):
    loader = port_loader(store, batch_size=60, drop_last=False, shuffle=False)
    assert [len(b['idx']) for b in loader] == [60, 60, 60, 20]
    assert len(loader) == 4


def test_scan_epochs_cover_dataset_and_advance(store):
    loader = port_loader(store, batch_size=20, seed=2)
    step = lambda batch: batch['idx']  # noqa: E731
    first, second = loader.scan_epochs(step, num_epochs=2)
    assert first.shape == (10, 20)
    assert sorted(first.view(-1).tolist()) == sorted(second.view(-1).tolist()) == list(
        range(ROWS))
    assert not torch.equal(first, second)
    (third,) = loader.scan_epochs(step)
    (pinned,) = loader.scan_epochs(step, epoch_offset=0)
    (fourth,) = loader.scan_epochs(step)
    assert torch.equal(pinned, first)          # an offset replays epoch 0 ...
    assert not torch.equal(fourth, third)      # ... and leaves the cursor at 3
    assert not torch.equal(fourth, first) and not torch.equal(fourth, second)
    # the iterator still works on the resident data, and its epoch 0 is scan's
    assert _ids(list(loader)[:10]) == first.view(-1).tolist()


def test_shuffle_override_per_call(store):
    loader = port_loader(store, batch_size=25, seed=1)
    step = lambda batch: batch['idx']  # noqa: E731
    (sequential,) = loader.scan_epochs(step, shuffle=False)
    (shuffled,) = loader.scan_epochs(step)
    assert sequential.view(-1).tolist() == list(range(ROWS))
    assert sorted(shuffled.view(-1).tolist()) == list(range(ROWS))
    assert shuffled.view(-1).tolist() != list(range(ROWS))
    assert len(loader._scan_cache) == 2        # one program per (step_fn, shuffle)


def test_scan_epochs_refusals(store):
    loader = port_loader(store, batch_size=30, drop_last=False)
    with pytest.raises(ValueError, match='partial batch'):
        loader.scan_epochs(lambda batch: None)
    # refused before the upload: the loader still iterates from the host copy
    assert loader._data is None and len(_ids(loader)) == ROWS
    with pytest.raises(ValueError, match='batch_size'):
        port_loader(store, batch_size=ROWS + 1)


def test_program_cache_evicts_and_warns_once(store):
    loader = port_loader(store, batch_size=100, shuffle=False)
    with pytest.warns(UserWarning, match='stable step_fn') as record:
        for i in range(10):
            loader.scan_epochs(lambda batch, i=i: batch['idx'] + i)
    assert len([w for w in record if 'stable step_fn' in str(w.message)]) == 1
    assert len(loader._scan_cache) == 8 and loader._scan_cache.built == 10


def test_rejects_device_decode_fields_and_missing_card(tmp_path):
    from petastorm_tpu_torch import make_reader
    from test_torch_device_stage import write_device_decode_store
    url = write_device_decode_store(tmp_path / 'stage', rows=8)
    with make_reader(url, reader_pool_type='dummy', device_decode_fields=['mat']) as reader:
        with pytest.raises(ValueError, match='device_decode_fields'):
            port_inmem.InMemTorchLoader(reader, batch_size=4, device='cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='cuda'):
            port_loader(url, batch_size=4, device=None)


# ------------------------------------------------------------------ the slice

def flax_mnist(dtype_name, seed=0):
    """(flax MnistCNN, its variables as numpy)."""
    from petastorm_tpu.models.mnist import MnistCNN
    model = MnistCNN(dtype=getattr(jnp, dtype_name))
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 28, 28, 1)))
    return model, jax.tree_util.tree_map(np.asarray, variables)


def jax_bench_step(model):
    """``bench.py``'s jitted MNIST train step (normalize, softmax cross-entropy
    with integer labels, SGD)."""
    import optax
    from petastorm_tpu.ops.image import normalize_image
    optimizer = optax.sgd(LR)
    dtype = model.dtype

    @jax.jit
    def train_step(params, opt_state, images_u8, labels):
        images = normalize_image(images_u8[..., None], mean=[0.1307], std=[0.3081],
                                 dtype=dtype)

        def loss_fn(p):
            logits = model.apply(p, images)
            return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return optimizer, train_step


def port_mnist_step(variables, dtype_name, device='cpu'):
    """(step_fn, model, optimizer): the port's counterpart of the bench step,
    from the flax weights."""
    from petastorm_tpu_torch.convert import mnist_state_dict_from_flax
    from petastorm_tpu_torch.models.mnist import MnistCNN
    from petastorm_tpu_torch.ops.image import normalize_image
    dtype = getattr(torch, dtype_name)
    model = MnistCNN(dtype=dtype, device=device)
    model.load_state_dict(mnist_state_dict_from_flax(variables))
    optimizer = torch.optim.SGD(model.parameters(), lr=LR)

    def step(batch):
        images = normalize_image(batch['image'][..., None], mean=[0.1307], std=[0.3081],
                                 dtype=dtype)
        loss = torch.nn.functional.cross_entropy(model(images), batch['digit'])
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step, model, optimizer


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_slice_scan_epochs_losses_match_jax(tmp_path, jax_keys, dtype):
    url = write_mnist_store(tmp_path / 'mnist', rows=256, files=2, seed=1)
    model, variables = flax_mnist(dtype)
    optimizer, train_step = jax_bench_step(model)

    def jax_step(carry, batch):
        params, opt_state = carry
        params, opt_state, loss = train_step(params, opt_state, batch['image'],
                                             batch['digit'])
        return (params, opt_state), loss

    _, want = jax_loader(url, batch_size=64, seed=7).scan_epochs(
        jax_step, (variables, optimizer.init(variables)), num_epochs=1)
    step, _, opt = port_mnist_step(variables, dtype)
    got = port_loader(url, batch_size=64, seed=7).scan_epochs(step, state=(opt,))
    assert got[0].shape == (4,) and got[0].dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=SLICE_RTOL[dtype])
    assert got[0][0] != got[0][-1]   # the steps moved the weights
