"""What the training tasks share: the program's readings of its first steps,
taken through its own optimizer's state, and the comparison of those
readings with the reference's."""

import contextlib
import math
import statistics

import torch

from portbench import weights

#: a leaf whose gradient in the reference is under this share of the median
#: leaf's on every followed step moves under the optimizer by rounding alone:
#: it is left out of the change
STILL_LEAF_SHARE = 1e-3


def first_grad_norms(model, optimizer, settings):
    """Each leaf's first gradient as the optimizer received it, worked out
    from its state after one step: SGD's momentum buffer is the gradient,
    Adam's first moment is ``(1 - beta1)`` times it; no state reads 0."""
    key, scale = (('momentum_buffer', 1.0) if settings['name'] == 'sgd'
                  else ('exp_avg', 1.0 / (1.0 - settings['betas'][0])))
    norms = {}
    for name, leaf in model.named_parameters():
        # an optimizer that kept no state received no gradient
        grad = optimizer.state.get(leaf, {}).get(key)
        norms[name] = 0.0 if grad is None else float(grad.double().norm()) * scale
    return norms


@torch.no_grad()
def change_norms(model, rules, seed):
    """Each leaf's distance from its initial value, made again from the seed."""
    return {name: float((leaf.double() - weights.initial(
        name, tuple(leaf.shape), rules, seed, leaf.device).double()).norm())
        for name, leaf in model.named_parameters()}


@contextlib.contextmanager
def exact_float32():
    """Float32 products without TF32, as the references compute."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def make_optimizer(parameters, settings):
    if settings['name'] == 'sgd':
        return torch.optim.SGD(parameters, lr=settings['lr'], momentum=settings['momentum'])
    if settings['name'] == 'adam':
        return torch.optim.Adam(parameters, lr=settings['lr'], betas=tuple(settings['betas']),
                                eps=settings['eps'])
    raise ValueError('unknown optimizer {!r}'.format(settings['name']))


def _median_nonzero(values):
    values = [v for v in values if v > 0]
    return statistics.median(values) if values else 0.0


def _gap(got, want, scale):
    """``|got - want| / scale``, infinite where it is not a finite number."""
    gap = abs(got - want)
    if gap == 0:
        return 0.0
    value = gap / scale if scale > 0 else float('inf')
    return value if math.isfinite(value) else float('inf')


def worst_leaf(program, reference, names):
    """The largest gap between the program's and the reference's norm of a
    leaf, over the larger of the reference's norm of that leaf and the
    median leaf's."""
    median = _median_nonzero([reference[name] for name in names])
    return max([_gap(program[name], reference[name], max(reference[name], median))
                for name in names] or [0.0])


def logit_gap(got, want):
    """The largest gap between the program's logits and the reference's,
    over the root mean square of the reference's."""
    got = got.to(want.device, torch.float32)
    return float((got - want).abs().max() / want.pow(2).mean().sqrt())


def training_gaps(program, reference):
    """The program's readings of its first steps against the reference's
    (``losses``, ``grad_norms``, ``change_norms``): the largest relative gap
    of a step's loss (``loss_gap``), and the worst leaf's gap of the first
    gradient (``grad_gap``) and of the change over the steps
    (``change_gap``)."""
    losses = [_gap(p, r, abs(r)) for p, r in zip(program['losses'], reference['losses'])]
    if len(program['losses']) != len(reference['losses']):
        losses.append(float('inf'))
    names = sorted(reference['grad_norms'])
    moving = set()
    for step in reference['step_grad_norms']:
        median = _median_nonzero(step.values())
        moving.update(name for name in names if step[name] >= STILL_LEAF_SHARE * median)
    moving = sorted(moving)
    return {'loss_gap': max(losses),
            'grad_gap': worst_leaf(program['grad_norms'], reference['grad_norms'], names),
            'change_gap': worst_leaf(program['change_norms'], reference['change_norms'],
                                     moving)}
