"""The port's ResNet against petastorm_tpu's flax ResNet with the same weights
(carried over by petastorm_tpu_torch.convert): train-mode logits within
rtol/atol 1e-4, updated batch statistics within 1e-5, the first conv's loss
gradient within 1e-3 relative; all in float32 on the CPU."""

import numpy as np
import pytest
import torch

from petastorm_tpu_torch.convert import resnet_state_dict_from_flax
from petastorm_tpu_torch.models.resnet import ResNet

CONFIG = dict(stage_sizes=[1, 1], num_filters=8, num_classes=10)


def _flax_model_and_variables(size, seed=0):
    """The flax model with random weights AND random batch statistics (nonzero
    last-BN scales included, so every path carries signal)."""
    import jax
    import jax.numpy as jnp
    from petastorm_tpu.models.resnet import ResNet as FlaxResNet
    model = FlaxResNet(dtype=jnp.float32, **CONFIG)
    variables = jax.jit(lambda key, x: model.init(key, x, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros((2, size, size, 3)))
    rng = np.random.RandomState(seed)

    def randomize(tree, kind):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict) or hasattr(value, 'items'):
                out[key] = randomize(value, kind)
                continue
            shape = np.shape(value)
            if kind == 'batch_stats' and key == 'var':
                out[key] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
            elif key in ('scale',):
                out[key] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
            else:
                scale = 0.1 if key in ('bias', 'mean') else np.sqrt(
                    1.0 / max(1, int(np.prod(shape[:-1]))))
                out[key] = (rng.randn(*shape) * scale).astype(np.float32)
        return out

    return model, {'params': randomize(variables['params'], 'params'),
                   'batch_stats': randomize(variables['batch_stats'], 'batch_stats')}


def _port_model(variables):
    model = ResNet(dtype=torch.float32, device='cpu', **CONFIG)
    missing, unexpected = model.load_state_dict(resnet_state_dict_from_flax(variables),
                                                strict=True)
    assert not missing and not unexpected
    return model


@pytest.mark.parametrize('size', [32, 29])
def test_train_mode_logits_and_batch_stats_match_flax(size):
    import jax
    flax_model, variables = _flax_model_and_variables(size)
    images = np.random.RandomState(1).randn(4, size, size, 3).astype(np.float32)
    want, updates = jax.jit(lambda v, x: flax_model.apply(
        v, x, train=True, mutable=['batch_stats']))(variables, images)
    model = _port_model(variables)
    model.train()
    got = model(torch.from_numpy(images))
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    carried = resnet_state_dict_from_flax(
        {'params': variables['params'],
         'batch_stats': jax.tree_util.tree_map(np.asarray, updates['batch_stats'])})
    state = model.state_dict()
    for name, value in carried.items():
        if name.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(state[name].numpy(), value.numpy(), rtol=0,
                                       atol=1e-5, err_msg=name)


def test_eval_mode_logits_match_flax():
    flax_model, variables = _flax_model_and_variables(32, seed=2)
    images = np.random.RandomState(3).randn(3, 32, 32, 3).astype(np.float32)
    want = flax_model.apply(variables, images, train=False)
    model = _port_model(variables).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_first_conv_gradient_matches_flax():
    import jax
    import optax
    # Near-ties in a max-pool window are decided by last-bit rounding, and the
    # two frameworks round differently, so the gradient can be routed to a
    # different input; this seed and batch hold no such near-tie.
    flax_model, variables = _flax_model_and_variables(32, seed=0)
    images = np.random.RandomState(5).randn(8, 32, 32, 3).astype(np.float32)
    labels = np.arange(8) % 10

    def loss_fn(params):
        logits, _ = flax_model.apply({'params': params,
                                      'batch_stats': variables['batch_stats']},
                                     images, train=True, mutable=['batch_stats'])
        return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()

    grads = jax.jit(jax.grad(loss_fn))(variables['params'])
    want = np.transpose(np.asarray(grads['conv_init']['kernel']), (3, 2, 0, 1))
    model = _port_model(variables).train()
    loss = torch.nn.functional.cross_entropy(model(torch.from_numpy(images)),
                                             torch.from_numpy(labels))
    loss.backward()
    got = model.conv_init.weight.grad.numpy()
    assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want)


def test_same_padding_is_asymmetric_like_xla():
    """A stride-2 3x3 SAME window on an even input pads 0 before, 1 after."""
    from petastorm_tpu_torch.models.resnet import _same_pad
    x = torch.arange(16, dtype=torch.float32).reshape(1, 1, 4, 4)
    padded = _same_pad(x, 3, 2)
    assert padded.shape == (1, 1, 5, 5)
    assert torch.equal(padded[0, 0, :4, :4], x[0, 0])
    assert _same_pad(x, 1, 1) is x


def test_resnet50_shapes_and_zero_scale_init():
    from petastorm_tpu_torch.models.resnet import ResNet50
    model = ResNet50(num_classes=12, num_filters=8, device='cpu')
    assert len(model.blocks) == 16
    assert all(not block.bn3.weight.detach().any() for block in model.blocks)
    out = model.eval()(torch.zeros(1, 64, 64, 3))
    assert out.shape == (1, 12) and out.dtype == torch.float32


def test_model_defaults_to_cuda_and_never_falls_back_to_cpu(monkeypatch):
    """Without device='cpu' the model asks for the card; with none it raises."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ResNet(**CONFIG)
    model = ResNet(device='cpu', **CONFIG)
    assert {p.device.type for p in model.parameters()} == {'cpu'}
    assert {b.device.type for b in model.buffers()} == {'cpu'}
