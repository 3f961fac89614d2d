"""The batch norm of the port's ResNet (``ops/batch_norm.py``).

On the CPU: its plain version, for each variant the ResNet calls (ReLU to
float32 or bfloat16; the block's last with an identity or a projected
shortcut, added before the ReLU), equals the unfused composition the model
ran before (its float32 ``BatchNorm``, ``F.relu`` and the add) bit for bit,
with gradients and running averages; ``batch_norm_calls`` lists what one
forward calls; the state_dict keys stay the ones the flax conversion writes.

On a card (marked ``cuda``; this file imports nothing of JAX, so there it
runs alone)::

    python -m pytest --noconftest -m cuda tests/test_torch_batch_norm.py

the kernels against the plain version at every distinct (C, H*W, variant) of
ResNet-50's 53 batch norms (``batch_norm_check``: one bf16 step or 1e-5 of a
float32 sum in another order, the backward under the kernel's own ReLU
mask), bit-equal reruns, the wrapper's refusals, and one ResNet-50 training
step counting 53 statistics passes, 49 apply passes and 49 backward passes.
"""

from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from petastorm_tpu_torch.models import resnet
from petastorm_tpu_torch.models.resnet import BatchNorm, ResNet, ResNet50, batch_norm_calls
from petastorm_tpu_torch.ops import batch_norm as bn


def _unfused_bn(x, norm):
    """The model's float32 batch norm as it was before the fused calls."""
    x = x.to(torch.float32)
    if norm.training:
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            norm.running_mean.mul_(norm.momentum).add_((1 - norm.momentum) * mean)
            norm.running_var.mul_(norm.momentum).add_((1 - norm.momentum) * var)
    else:
        mean, var = norm.running_mean, norm.running_var
    mul = torch.rsqrt(var + norm.eps) * norm.weight
    return (x - mean[:, None, None]) * mul[:, None, None] + norm.bias[:, None, None]


def _norm(c, seed, device='cpu', training=True):
    g = torch.Generator().manual_seed(seed)
    norm = BatchNorm(c)
    with torch.no_grad():
        norm.weight.copy_(torch.rand(c, generator=g) + 0.5)
        norm.bias.copy_(torch.randn(c, generator=g) * 0.1)
        norm.running_mean.copy_(torch.randn(c, generator=g) * 0.1)
        norm.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    return norm.to(device).train(training)


def _activation(n, c, h, w, seed, dtype, device='cpu'):
    """Channels-last ``[n, c, h, w]`` with per-channel offsets and scales."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(n, h, w, c, generator=g) * (torch.rand(c, generator=g) * 2 + 0.25)
         + torch.randn(c, generator=g) * 0.5)
    return x.permute(0, 3, 1, 2).to(device=device, dtype=dtype)


def _run(fn, leaves, grad):
    leaves = [t.detach().clone().requires_grad_() for t in leaves]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, grad)


VARIANTS = ('relu', 'residual', 'shortcut', 'plain')


def _bound(weight, bias, buffers, training):
    """A batch norm over these leaves (the gradients go to them) and running
    averages (moved in place)."""
    return SimpleNamespace(weight=weight, bias=bias, running_mean=buffers[0],
                           running_var=buffers[1], momentum=0.9, eps=1e-5, training=training)


def _variant(variant, c, seed, dtype, out_dtype, training):
    """(fused, unfused, leaves, buffers) for one variant on the CPU: each fn
    takes the leaves (x, weight, bias[, residual | x2, weight2, bias2])."""
    x = _activation(4, c, 5, 6, seed, dtype)
    first, second = _norm(c, seed + 1), _norm(c, seed + 2)
    buffers = [(n.running_mean, n.running_var) for n in (first, second)]
    leaves = [x, first.weight.detach(), first.bias.detach()]
    if variant == 'residual':
        leaves.append(_activation(4, c, 5, 6, seed + 3, torch.float32))
    if variant == 'shortcut':
        leaves += [_activation(4, c, 5, 6, seed + 3, dtype), second.weight.detach(),
                   second.bias.detach()]

    def norms(w, b, w2=None, b2=None):
        return (_bound(w, b, buffers[0], training), _bound(w2, b2, buffers[1], training))

    if variant in ('plain', 'relu'):
        relu = variant == 'relu'

        def fused(x, w, b):
            return bn.batch_norm(x, norms(w, b)[0], relu=relu, out_dtype=out_dtype)

        def unfused(x, w, b):
            y = _unfused_bn(x, norms(w, b)[0])
            return (F.relu(y) if relu else y).to(out_dtype)
    elif variant == 'residual':
        def fused(x, w, b, r):
            return bn.batch_norm(x, norms(w, b)[0], relu=True, residual=r)

        def unfused(x, w, b, r):
            return F.relu(r + _unfused_bn(x, norms(w, b)[0]))
    else:
        def fused(x, w, b, x2, w2, b2):
            norm, norm2 = norms(w, b, w2, b2)
            return bn.batch_norm(x, norm, relu=True, shortcut=(x2, norm2))

        def unfused(x, w, b, x2, w2, b2):
            norm, norm2 = norms(w, b, w2, b2)
            return F.relu(_unfused_bn(x2, norm2) + _unfused_bn(x, norm))
    return fused, unfused, leaves, [t for pair in buffers for t in pair]


@pytest.mark.parametrize('training', [True, False], ids=['train', 'eval'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['f32', 'bf16'])
@pytest.mark.parametrize('variant', VARIANTS)
def test_plain_fused_variant_equals_unfused_composition(variant, dtype, training):
    """Bit for bit: output, every gradient and the running averages."""
    out_dtype = dtype if variant in ('relu', 'plain') else torch.float32
    fused, unfused, leaves, buffers = _variant(variant, 16, 7, dtype, out_dtype, training)
    start = [t.clone() for t in buffers]
    grad = torch.randn(4, 16, 5, 6, generator=torch.Generator().manual_seed(9)).to(out_dtype)
    got, got_grads = _run(fused, leaves, grad)
    got_state = [t.clone() for t in buffers]
    with torch.no_grad():
        for t, s in zip(buffers, start):
            t.copy_(s)
    want, want_grads = _run(unfused, leaves, grad)
    assert got.dtype == want.dtype == out_dtype
    assert torch.equal(got, want)
    assert len(got_grads) == len(leaves)
    for g, w in zip(got_grads, want_grads):
        assert g.dtype == w.dtype and torch.equal(g, w)
    for g, t in zip(got_state, buffers):
        assert torch.equal(g, t)
    moved = [not torch.equal(g, s) for g, s in zip(got_state, start)]
    assert any(moved) == training


def test_batch_norm_refuses_a_shortcut_without_relu_or_two_shortcuts():
    x = _activation(2, 8, 3, 3, 0, torch.float32)
    norm = _norm(8, 1)
    with pytest.raises(ValueError, match='relu=True'):
        bn.batch_norm(x, norm, residual=x)
    with pytest.raises(ValueError, match='not both'):
        bn.batch_norm(x, norm, relu=True, residual=x, shortcut=(x, norm))


@pytest.mark.parametrize('variant', VARIANTS)
def test_batch_norm_check_holds_the_plain_version_against_itself(variant):
    """The card's check, run on the CPU where both sides are the plain
    version: every reading within its tolerance, with no error at all."""
    x = _activation(3, 16, 4, 5, 2, torch.bfloat16)
    norm = _norm(16, 3)
    kwargs = {'relu': variant != 'plain',
              'out_dtype': torch.bfloat16 if variant in ('relu', 'plain') else torch.float32}
    if variant == 'residual':
        kwargs['residual'] = _activation(3, 16, 4, 5, 4, torch.float32)
    if variant == 'shortcut':
        kwargs['shortcut'] = (_activation(3, 16, 4, 5, 5, torch.bfloat16), _norm(16, 6))
    grad = torch.randn(3, 4, 5, 16).to(kwargs['out_dtype']).permute(0, 3, 1, 2)
    before = norm.running_mean.clone()
    result = bn.batch_norm_check(x, norm, grad, **kwargs)
    assert result['ok'] and result['mask_flips'] == 0
    assert all(v['max_abs_err'] == 0 for v in result.values() if isinstance(v, dict))
    assert torch.equal(norm.running_mean, before)   # the check restores the state


def test_batch_norm_calls_are_what_the_model_calls(monkeypatch):
    """``batch_norm_calls`` lists the forward's calls of ``batch_norm`` in
    order, with their shapes, variants and output dtypes."""
    seen = []

    def record(x, norm, relu=False, residual=None, shortcut=None, out_dtype=torch.float32):
        mode = bn._mode(relu, residual, shortcut)
        seen.append((x.shape[1], x.shape[2], x.shape[3], mode, out_dtype))
        return bn.batch_norm(x, norm, relu, residual, shortcut, out_dtype)

    monkeypatch.setattr(resnet, 'batch_norm', record)
    for stages, image in (([1, 1], 32), ([2, 1, 1], 29)):
        seen.clear()
        model = ResNet(stage_sizes=stages, num_classes=5, num_filters=8, device='cpu')
        model.train()(torch.randn(2, image, image, 3))
        assert seen == batch_norm_calls(stages, 8, image)
    calls = batch_norm_calls([3, 4, 6, 3])
    assert len(calls) == 49
    assert sum(2 if call[3] == bn.NORM_ADD_RELU else 1 for call in calls) == 53
    assert sum(128 * c * h * w * (2 if mode == bn.NORM_ADD_RELU else 1)
               for c, h, w, mode, _ in calls) == 1_422_589_952


def test_resnet_state_dict_keys_are_unchanged():
    """The names the flax conversion and the benchmark's init rules use."""
    model = ResNet(stage_sizes=[1, 1], num_classes=10, num_filters=8, device='cpu')
    norm = ['weight', 'bias', 'running_mean', 'running_var']
    want = ['conv_init.weight'] + ['bn_init.' + k for k in norm]
    for i in range(2):
        for layer in ('1', '2', '3'):
            want.append('blocks.{}.conv{}.weight'.format(i, layer))
            want += ['blocks.{}.bn{}.{}'.format(i, layer, k) for k in norm]
        want.append('blocks.{}.conv_proj.weight'.format(i))
        want += ['blocks.{}.norm_proj.{}'.format(i, k) for k in norm]
    want += ['head.weight', 'head.bias']
    assert sorted(model.state_dict()) == sorted(want)


def test_partial_rows_fill_the_card_and_keep_each_thread_busy(monkeypatch):
    """At every ResNet-50 shape at batch 128 on a 132-SM card: at most 4
    reduction blocks a SM, and each thread sums at least 8 rows (or all
    the rows there are)."""
    monkeypatch.setitem(bn._sm_counts, 0, 132)
    for c, h, w, _, _ in batch_norm_calls([3, 4, 6, 3]):
        m = 128 * h * w
        p = bn._partial_rows(m, c, 0)
        rows_per_block = 256 // min(c // 8, 256)
        assert 1 <= p <= 4 * 132
        assert m / (p * rows_per_block) >= 8
    assert bn._partial_rows(1, 8, 0) == 1


# ----------------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (the batch-norm kernels have no CPU mode)')
    return torch.device('cuda')


def _distinct_cases():
    seen = []
    for c, h, w, mode, out_dtype in batch_norm_calls([3, 4, 6, 3]):
        if (c, h * w, mode) not in [(s[0], s[1] * s[2], s[3]) for s in seen]:
            seen.append((c, h, w, mode, out_dtype))
    return seen


_MODE_NAMES = {bn.PLAIN: 'plain', bn.RELU: 'relu', bn.ADD_RELU: 'residual',
               bn.NORM_ADD_RELU: 'shortcut'}
CASES = _distinct_cases()


def _case_inputs(card, batch, c, h, w, mode, out_dtype, training=True, seed=0):
    x = _activation(batch, c, h, w, seed, torch.bfloat16, card)
    norm = _norm(c, seed + 1, card, training)
    kwargs = {'relu': mode != bn.PLAIN, 'out_dtype': out_dtype}
    if mode == bn.ADD_RELU:
        kwargs['residual'] = _activation(batch, c, h, w, seed + 2, torch.float32, card)
    if mode == bn.NORM_ADD_RELU:
        kwargs['shortcut'] = (_activation(batch, c, h, w, seed + 3, torch.bfloat16, card),
                              _norm(c, seed + 4, card, training))
    g = torch.Generator(device=card).manual_seed(seed + 5)
    grad = torch.randn(batch, h, w, c, device=card, generator=g).to(out_dtype)
    grad = grad.permute(0, 3, 1, 2)
    return x, norm, grad, kwargs


@pytest.mark.cuda
@pytest.mark.parametrize('case', CASES, ids=['C{}_{}x{}_{}'.format(c, h, w, _MODE_NAMES[m])
                                             for c, h, w, m, _ in CASES])
def test_kernels_match_plain_at_resnet50_shapes(card, case):
    """Every distinct (C, H*W, variant) of ResNet-50 at batch 8."""
    x, norm, grad, kwargs = _case_inputs(card, 8, *case)
    result = bn.batch_norm_check(x, norm, grad, **kwargs)
    assert result['ok'], result


@pytest.mark.cuda
@pytest.mark.parametrize('case', [CASES[0], CASES[-1]], ids=['stem', 'last'])
def test_kernels_match_plain_at_batch_128(card, case):
    """The stem's 1.6M rows of 64 channels and the last block's 6,272 rows
    of 2048, at the main path's batch."""
    x, norm, grad, kwargs = _case_inputs(card, 128, *case)
    result = bn.batch_norm_check(x, norm, grad, **kwargs)
    assert result['ok'], result


@pytest.mark.cuda
@pytest.mark.parametrize('mode', [bn.PLAIN, bn.RELU, bn.ADD_RELU, bn.NORM_ADD_RELU],
                         ids=['plain', 'relu', 'residual', 'shortcut'])
@pytest.mark.parametrize('training', [True, False], ids=['train', 'eval'])
def test_kernels_match_plain_in_every_mode(card, mode, training):
    """Each variant in training and evaluation, at 24 channels (three
    8-channel vectors) and at 2056 (a second block along the channels)."""
    out_dtype = torch.bfloat16 if mode == bn.RELU else torch.float32
    for c, h, w in ((24, 7, 9), (2056, 3, 3)):
        x, norm, grad, kwargs = _case_inputs(card, 3, c, h, w, mode, out_dtype, training)
        result = bn.batch_norm_check(x, norm, grad, **kwargs)
        assert result['ok'], (c, result)


@pytest.mark.cuda
def test_kernels_give_the_same_bits_on_every_run(card):
    c, h, w, mode, out_dtype = next(case for case in CASES if case[3] == bn.NORM_ADD_RELU)
    x, norm, grad, kwargs = _case_inputs(card, 16, c, h, w, mode, out_dtype)
    x2, norm2 = kwargs['shortcut']
    start = [t.clone() for t in (norm.running_mean, norm.running_var,
                                 norm2.running_mean, norm2.running_var)]
    runs = []
    for _ in range(2):
        with torch.no_grad():
            for t, s in zip((norm.running_mean, norm.running_var, norm2.running_mean,
                             norm2.running_var), start):
                t.copy_(s)
        leaves = [x.detach().requires_grad_(), x2.detach().requires_grad_(), norm.weight,
                  norm.bias, norm2.weight, norm2.bias]
        out = bn.batch_norm(leaves[0], norm, relu=True, shortcut=(leaves[1], norm2))
        runs.append([out] + list(torch.autograd.grad(out, leaves, grad))
                    + [norm.running_mean.clone(), norm.running_var.clone()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernels_do_not_take(card):
    x = _activation(2, 16, 4, 4, 0, torch.bfloat16, card)
    norm = _norm(16, 1, card)
    with pytest.raises(ValueError, match='weight'):
        bn.batch_norm(x, _norm(16, 1, 'cpu'))                     # CPU parameters
    with pytest.raises(ValueError, match='bfloat16'):
        bn.batch_norm(x.float(), norm)                            # float32 input
    with pytest.raises(ValueError, match='bfloat16'):
        bn.batch_norm(x.half(), norm)
    with pytest.raises(ValueError, match='channels-last'):
        bn.batch_norm(x.contiguous(), norm)                       # NCHW memory
    with pytest.raises(ValueError, match='multiple of 8'):
        bn.batch_norm(_activation(2, 12, 4, 4, 0, torch.bfloat16, card), _norm(12, 1, card))
    with pytest.raises(ValueError, match='residual'):
        bn.batch_norm(x, norm, relu=True, residual=x.float().cpu())
    with pytest.raises(ValueError, match='float32'):
        bn.batch_norm(x, norm, relu=True, residual=x.float().contiguous(
            memory_format=torch.channels_last), out_dtype=torch.bfloat16)


@pytest.mark.cuda
def test_kernels_replay_in_a_cuda_graph(card):
    """A captured call records its passes (counted as captured, not
    launched) and a replay writes what an eager call writes."""
    x, norm, _, kwargs = _case_inputs(card, 4, 64, 8, 8, bn.NORM_ADD_RELU, torch.float32)
    with torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            bn.batch_norm(x, norm, **kwargs)
        torch.cuda.current_stream().wait_stream(side)
        want = bn.batch_norm(x, norm, **kwargs)
        launched, captured = dict(bn.batch_norm.launches), dict(bn.batch_norm.captured)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = bn.batch_norm(x, norm, **kwargs)
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert bn.batch_norm.launches == launched
    assert {k: bn.batch_norm.captured[k] - captured[k] for k in captured} == {
        'stats': 2, 'apply': 1, 'backward': 0}


@pytest.mark.cuda
def test_resnet50_step_runs_every_batch_norm_through_the_kernels(card):
    """One training step: 53 statistics passes, 49 apply and 49 backward,
    launched once for each of the CUDA graphs' warm-up steps and recorded
    once by their capture (the step itself is the first replay)."""
    from petastorm_tpu_torch.parallel.graphs import WARMUP_STEPS
    torch.manual_seed(0)
    model = ResNet50(num_classes=10).train()
    images = torch.randn(4, 64, 64, 3, device=card).to(torch.bfloat16)
    for counts in (bn.batch_norm.launches, bn.batch_norm.captured):
        for name in counts:
            counts[name] = 0
    loss = F.cross_entropy(model(images), torch.zeros(4, dtype=torch.int64, device=card))
    loss.backward()
    torch.cuda.synchronize()
    per_step = {'stats': 53, 'apply': 49, 'backward': 49}
    assert bn.batch_norm.captured == per_step
    assert bn.batch_norm.launches == {k: WARMUP_STEPS * n for k, n in per_step.items()}
    assert torch.isfinite(loss)
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())
