"""The port's ResNet against petastorm_tpu's flax ResNet with the same weights
(carried over by petastorm_tpu_torch.convert): train-mode logits within
rtol/atol 1e-4, updated batch statistics within 1e-5, the first conv's loss
gradient within 1e-3 relative; all in float32 on the CPU.

On a card (marked ``cuda``; those tests import nothing of JAX, so there the
file runs as ``python -m pytest --noconftest -m cuda
tests/test_torch_resnet.py``), the training forward and backward as CUDA
graph replays (``ResNet.graphs``) against :meth:`ResNet.forward_eager` from
the same weights: the same kernels in the same order, so losses, logits,
gradients, parameters and running statistics are equal bit for bit."""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

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


# ------------------------------------------------------------ the card's graphs

#: the small ResNet-50 of the card tests: every block kind, a few seconds
CARD_BATCH, CARD_IMAGE, CARD_CLASSES = 16, 64, 10


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (CUDA graphs have no CPU mode)')
    return torch.device('cuda')


def _card_model(seed=0):
    from petastorm_tpu_torch.models.resnet import ResNet50
    torch.manual_seed(seed)
    return ResNet50(num_classes=CARD_CLASSES).train()


def _card_batch(card, seed, batch=CARD_BATCH, image=CARD_IMAGE):
    gen = torch.Generator(device=card).manual_seed(seed)
    images = torch.randn(batch, image, image, 3, device=card, generator=gen)
    labels = torch.randint(0, CARD_CLASSES, (batch,), device=card, generator=gen)
    return images.to(torch.bfloat16), labels


def _counters(model):
    counters = model.graphs.telemetry.snapshot()['counters']
    return {name: counters.get('model_graph_' + name, 0)
            for name in ('capture', 'replay', 'eager_on_card')}


def _sgd_steps(model, forward, batches):
    """SGD steps as the benchmark's task takes them; each step's loss,
    logits and gradients, then the parameters and buffers."""
    optimizer = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
    seen = []
    for images, labels in batches:
        logits = forward(images)
        loss = F.cross_entropy(logits, labels)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        seen.append({'loss': loss.detach().clone(), 'logits': logits.detach().clone(),
                     'grads': [p.grad.clone() for p in model.parameters()]})
        optimizer.step()
    torch.cuda.synchronize()
    return seen, [t.detach().clone() for t in model.state_dict().values()]


@pytest.mark.cuda
def test_graphed_sgd_steps_equal_eager_bit_for_bit(card):
    graphed = _card_model()
    eager = copy.deepcopy(graphed)
    batches = [_card_batch(card, seed) for seed in range(3)]
    got, got_state = _sgd_steps(graphed, graphed, batches)
    want, want_state = _sgd_steps(eager, eager.forward_eager, batches)
    assert _counters(graphed) == {'capture': 1, 'replay': 3, 'eager_on_card': 0}
    assert _counters(eager) == {'capture': 0, 'replay': 0, 'eager_on_card': 0}
    for step, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g['loss'], w['loss']), step
        assert torch.equal(g['logits'], w['logits']), step
        assert all(torch.equal(a, b) for a, b in zip(g['grads'], w['grads'])), step
    names = list(graphed.state_dict())
    assert [n for n, a, b in zip(names, got_state, want_state) if not torch.equal(a, b)] == []


@pytest.mark.cuda
def test_the_capture_warm_up_leaves_no_trace(card):
    """The first graphed call warms up, captures and replays: the running
    statistics have moved once, as one eager forward moves them, and the
    parameters and their gradients are untouched."""
    graphed = _card_model()
    eager = copy.deepcopy(graphed)
    grads = [torch.full_like(p, 0.5) for p in graphed.parameters()]
    for p, g in zip(graphed.parameters(), grads):
        p.grad = g.clone()
    images, _ = _card_batch(card, 7)
    graphed(images)
    eager.forward_eager(images)
    torch.cuda.synchronize()
    assert _counters(graphed) == {'capture': 1, 'replay': 1, 'eager_on_card': 0}
    for (name, a), b in zip(graphed.state_dict().items(), eager.state_dict().values()):
        assert torch.equal(a, b), name
    assert all(torch.equal(p.grad, g) for p, g in zip(graphed.parameters(), grads))


@pytest.mark.cuda
def test_a_new_input_shape_captures_again(card):
    model = _card_model()
    for images, labels in (_card_batch(card, 0), _card_batch(card, 1, batch=8),
                           _card_batch(card, 2)):
        F.cross_entropy(model(images), labels).backward()
    torch.cuda.synchronize()
    assert _counters(model) == {'capture': 2, 'replay': 3, 'eager_on_card': 0}
    assert len(model.graphs._programs) == 2


@pytest.mark.cuda
def test_two_forwards_before_one_backward_run_the_second_eagerly(card):
    """A replay's activations live in the graph's pool, so a call made while
    the last replay's backward is still to come runs eagerly, and the
    gradients are an eager model's."""
    graphed = _card_model()
    eager = copy.deepcopy(graphed)
    (a, la), (b, lb) = _card_batch(card, 0), _card_batch(card, 1)
    graphed(a).sum().backward()   # the capture, out of the way
    eager.forward_eager(a).sum().backward()
    for model in (graphed, eager):
        model.zero_grad(set_to_none=True)
    forward = {id(graphed): graphed, id(eager): eager.forward_eager}
    for model in (graphed, eager):
        run = forward[id(model)]
        (F.cross_entropy(run(a), la) + F.cross_entropy(run(b), lb)).backward()
    torch.cuda.synchronize()
    assert _counters(graphed) == {'capture': 1, 'replay': 2, 'eager_on_card': 1}
    assert all(torch.equal(p.grad, q.grad)
               for p, q in zip(graphed.parameters(), eager.parameters()))
    # a replay's backward after a later replay refuses
    first = F.cross_entropy(graphed(a), la)
    first.backward(retain_graph=True)
    F.cross_entropy(graphed(b), lb).backward()
    with pytest.raises(RuntimeError, match='later replay'):
        first.backward()


@pytest.mark.cuda
def test_a_step_program_around_the_model_captures_it_eagerly(card):
    """A StepProgram that captures the whole step calls the model inside its
    own warm-up and capture: those calls run eagerly (counted as such) and
    the program's losses are an eager run's."""
    from petastorm_tpu_torch.parallel.graphs import WARMUP_STEPS, StepProgram
    model = _card_model()
    eager = copy.deepcopy(model)
    batches = [_card_batch(card, seed) for seed in range(2)]
    static = [(images.clone(), labels.clone()) for images, labels in batches]

    def make_step(forward, optimizer):
        def step(batch):
            loss = F.cross_entropy(forward(batch[0]), batch[1])
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
            return loss.detach()
        return step

    optimizer = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
    program = StepProgram(make_step(model, optimizer), lambda i: static[i], 2,
                          (model, optimizer), card)
    got = program.run()
    assert program.replays == 1
    assert _counters(model) == {'capture': 0, 'replay': 0, 'eager_on_card': WARMUP_STEPS + 2}
    eager_step = make_step(eager.forward_eager,
                           torch.optim.SGD(eager.parameters(), lr=0.05, momentum=0.9))
    want = torch.stack([eager_step(batch) for batch in batches])
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=1e-5)


@pytest.mark.cuda
def test_eval_and_no_grad_calls_run_eagerly(card):
    model = _card_model()
    images, _ = _card_batch(card, 0)
    with torch.no_grad():
        model.eval()(images)
        assert _counters(model) == {'capture': 0, 'replay': 0, 'eager_on_card': 0}
        model.train()(images)
    assert _counters(model) == {'capture': 0, 'replay': 0, 'eager_on_card': 1}
    assert len(model.graphs._programs) == 0


@pytest.mark.cuda
def test_ten_steps_count_one_capture_and_ten_replays(card):
    """The telemetry over a 10-step loop, and the batch norm's passes: the
    capture's warm-up launches them eagerly, the capture records them once,
    and the replays launch nothing through the wrappers."""
    from petastorm_tpu_torch.ops import batch_norm as bn
    from petastorm_tpu_torch.parallel.graphs import WARMUP_STEPS
    model = _card_model()
    optimizer = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
    launched, captured = dict(bn.batch_norm.launches), dict(bn.batch_norm.captured)
    per_step = {'stats': 53, 'apply': 49, 'backward': 49}
    for step in range(10):
        images, labels = _card_batch(card, step)
        loss = F.cross_entropy(model(images), labels)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        if step == 0:
            torch.cuda.synchronize()
            assert {k: bn.batch_norm.captured[k] - captured[k] for k in captured} == per_step
            assert {k: bn.batch_norm.launches[k] - launched[k] for k in launched} == {
                k: WARMUP_STEPS * n for k, n in per_step.items()}
            launched = dict(bn.batch_norm.launches)
    torch.cuda.synchronize()
    assert bn.batch_norm.launches == launched
    assert _counters(model) == {'capture': 1, 'replay': 10, 'eager_on_card': 0}
    span = model.graphs.telemetry.snapshot()['histograms']['graph_capture']
    assert span['count'] == 1 and span['sum'] > 0
