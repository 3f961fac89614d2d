"""The port's MnistCNN against petastorm_tpu's flax MnistCNN with the same
weights (carried over by ``mnist_state_dict_from_flax``), on the CPU.

float32: logits within rtol/atol 1e-4 and the first conv's loss gradient
within 1e-3 relative (``test_torch_resnet.py``'s limits). bfloat16 (the
model's default, the bench's configuration): logits within 2e-2 of the
largest logit, about five bf16 units of 2^-8, as the two frameworks round
the bf16 convolutions and dense products at other places. The bf16 gradient
of the first conv sits at the end of a backward pass in bf16, where rounding
moves each framework's own gradient ~10% from its float32 one; the port's
must lie no farther from flax's than 1.5 times the larger of those two
distances."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from petastorm_tpu_torch.convert import mnist_state_dict_from_flax
from petastorm_tpu_torch.models.mnist import MnistCNN

#: dtype name -> (logits rtol, logits atol as a share of the largest logit)
TOLERANCES = {'float32': (1e-4, 1e-4), 'bfloat16': (0.0, 2e-2)}
#: float32 first-conv gradient: relative norm of the difference
GRAD_RTOL_F32 = 1e-3
#: bf16 first-conv gradient: multiple of bf16's own distance from float32
GRAD_BF16_ROUNDING_FACTOR = 1.5


def flax_variables(seed=0):
    """MnistCNN's flax variables with random biases (flax starts them at 0,
    which would leave the bias path untested), as numpy."""
    from petastorm_tpu.models.mnist import MnistCNN as FlaxMnist
    variables = FlaxMnist().init(jax.random.PRNGKey(seed), jnp.zeros((1, 28, 28, 1)))
    rng = np.random.RandomState(seed)
    params = {}
    for layer, leaves in variables['params'].items():
        params[layer] = {name: np.asarray(value) for name, value in leaves.items()}
        params[layer]['bias'] = (rng.randn(*params[layer]['bias'].shape) * 0.1).astype(
            np.float32)
    return {'params': params}


def port_model(variables, dtype):
    model = MnistCNN(dtype=dtype, device='cpu')
    missing, unexpected = model.load_state_dict(mnist_state_dict_from_flax(variables),
                                                strict=True)
    assert not missing and not unexpected
    return model


def _images(seed, batch=8):
    return np.random.RandomState(seed).randn(batch, 28, 28, 1).astype(np.float32)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_logits_match_flax(dtype):
    from petastorm_tpu.models.mnist import MnistCNN as FlaxMnist
    variables = flax_variables()
    images = _images(1)
    want = np.asarray(FlaxMnist(dtype=getattr(jnp, dtype)).apply(variables, images))
    with torch.no_grad():
        got = port_model(variables, getattr(torch, dtype))(torch.from_numpy(images))
    assert got.dtype == torch.float32 and got.shape == (8, 10)
    rtol, atol = TOLERANCES[dtype]
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=atol * np.abs(want).max())


def _first_conv_gradients(variables, dtype_name, images, labels):
    """(flax's, the port's) loss gradient of the first conv, OIHW."""
    from petastorm_tpu.models.mnist import MnistCNN as FlaxMnist
    flax_model = FlaxMnist(dtype=getattr(jnp, dtype_name))

    def loss_fn(params):
        logits = flax_model.apply({'params': params}, images)
        return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()

    grads = jax.jit(jax.grad(loss_fn))(variables['params'])
    want = np.transpose(np.asarray(grads['Conv_0']['kernel']), (3, 2, 0, 1))
    model = port_model(variables, getattr(torch, dtype_name))
    loss = torch.nn.functional.cross_entropy(model(torch.from_numpy(images)),
                                             torch.from_numpy(labels))
    loss.backward()
    return want, model.conv1.weight.grad.numpy()


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_first_conv_gradient_matches_flax(dtype):
    variables = flax_variables(seed=3)
    images = _images(4, batch=16)
    labels = np.arange(16) % 10
    want32, got32 = _first_conv_gradients(variables, 'float32', images, labels)
    assert np.linalg.norm(got32 - want32) <= GRAD_RTOL_F32 * np.linalg.norm(want32)
    if dtype == 'bfloat16':
        want, got = _first_conv_gradients(variables, dtype, images, labels)
        rounding = max(np.linalg.norm(want - want32), np.linalg.norm(got - got32))
        assert 0 < np.linalg.norm(got - want) <= GRAD_BF16_ROUNDING_FACTOR * rounding


def test_defaults_follow_flax():
    model = MnistCNN(device='cpu')
    assert model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.asarray(leaf).size for leaf in jax.tree_util.tree_leaves(flax_variables()))
    assert all(float(layer.bias.detach().abs().max()) == 0.0
               for layer in (model.conv1, model.conv2, model.fc1, model.fc2))
    # lecun-normal: variance 1 / fan_in
    assert abs(float(model.fc1.weight.detach().std()) - (1 / 3136) ** 0.5) < 0.1 * (1 / 3136) ** 0.5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='cuda'):
            MnistCNN()
