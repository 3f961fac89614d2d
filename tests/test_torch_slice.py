"""The whole ported slice on the CPU at a tiny size, against the JAX package:
store -> reader -> loader -> device decode tail (stored inflate, DCT decode,
normalize) -> small ResNet, two SGD steps from the same carried weights. The
per-step losses agree within 1e-3 relative (the decoded images may differ by
+-1 where the two IDCTs round differently)."""

import numpy as np

from test_torch_device_stage import write_device_decode_store

CONFIG = dict(stage_sizes=[1, 1], num_filters=8, num_classes=10)
MEAN_STD = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
LR = 0.1
STEPS = 2


def _jax_losses(url, monkeypatch):
    import jax
    import jax.numpy as jnp
    import optax
    from petastorm_tpu import make_reader
    from petastorm_tpu.models.resnet import ResNet
    from petastorm_tpu.parallel.device_stage import DeviceTransform
    from petastorm_tpu.parallel.loader import JaxDataLoader
    monkeypatch.setenv('PETASTORM_TPU_DEVICE_DECODE_FORCE', '1')
    model = ResNet(dtype=jnp.float32, **CONFIG)
    variables = jax.jit(lambda key, x: model.init(key, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((2, 16, 24, 3)))
    initial = jax.tree_util.tree_map(np.asarray, variables)
    tx = optax.sgd(LR)
    params, batch_stats = variables['params'], variables['batch_stats']
    opt_state = tx.init(params)

    @jax.jit
    def step(params, batch_stats, opt_state, images, labels):
        def loss_fn(p):
            logits, updates = model.apply({'params': p, 'batch_stats': batch_stats},
                                          images, train=True, mutable=['batch_stats'])
            loss = optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
            return loss, updates['batch_stats']
        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), new_stats, opt_state, loss

    losses = []
    with make_reader(url, reader_pool_type='dummy', shuffle_row_groups=False,
                     device_decode_fields=['img', 'vec', 'mat']) as reader:
        loader = JaxDataLoader(reader, batch_size=8, device_transforms={
            'img': DeviceTransform(normalize=MEAN_STD)})
        for batch, _ in zip(loader, range(STEPS)):
            params, batch_stats, opt_state, loss = step(
                params, batch_stats, opt_state, batch['img'], batch['label'])
            losses.append(float(loss))
    return initial, losses


def _port_losses(url, initial):
    import torch
    from petastorm_tpu_torch import DeviceTransform, TorchDataLoader, make_reader
    from petastorm_tpu_torch.convert import resnet_state_dict_from_flax
    from petastorm_tpu_torch.models.resnet import ResNet
    model = ResNet(dtype=torch.float32, device='cpu', **CONFIG)
    model.load_state_dict(resnet_state_dict_from_flax(initial))
    model.train()
    optimizer = torch.optim.SGD(model.parameters(), lr=LR)
    losses = []
    with make_reader(url, reader_pool_type='dummy', shuffle_row_groups=False,
                     device_decode_fields=['img', 'vec', 'mat']) as reader:
        loader = TorchDataLoader(reader, batch_size=8, device='cpu', device_transforms={
            'img': DeviceTransform(normalize=MEAN_STD)})
        for batch, _ in zip(loader, range(STEPS)):
            assert batch['img'].dtype == torch.float32
            assert batch['img'].shape == (8, 16, 24, 3)
            optimizer.zero_grad()
            loss = torch.nn.functional.cross_entropy(model(batch['img']),
                                                     batch['label'].long())
            loss.backward()
            optimizer.step()
            losses.append(loss.item())
        assert loader.stats.device_stored_batches >= STEPS
    return losses


def test_slice_losses_match_jax(tmp_path, monkeypatch):
    url = write_device_decode_store(tmp_path / 'store', rows=24, smooth_images=True)
    initial, want = _jax_losses(url, monkeypatch)
    got = _port_losses(url, initial)
    assert len(got) == len(want) == STEPS
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[0] != got[1]  # the first step moved the weights
