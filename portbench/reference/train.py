"""The first steps of training, followed in plain PyTorch: each step's loss,
the gradient of the first step and the change of the weights over them, per
weight tensor (leaf), on float32 weights with the optimizers written out."""

import torch


def sgd_momentum(settings):
    """SGD with heavy-ball momentum, no dampening, no weight decay:
    ``buf = momentum * buf + g`` (``buf = g`` on the first step),
    ``w -= lr * buf``."""
    lr, momentum = settings['lr'], settings['momentum']
    state = {}

    def step(name, weight, grad):
        buf = state.get(name)
        buf = grad.clone() if buf is None else buf.mul_(momentum).add_(grad)
        state[name] = buf
        weight.sub_(lr * buf)
    return step


def adam(settings):
    """Adam (Kingma and Ba, 2015) without weight decay:
    ``w -= lr * m_hat / (sqrt(v_hat) + eps)``."""
    lr, eps = settings['lr'], settings['eps']
    beta1, beta2 = settings['betas']
    state = {}

    def step(name, weight, grad):
        m, v, t = state.get(name, (torch.zeros_like(weight), torch.zeros_like(weight), 0))
        t += 1
        m.mul_(beta1).add_(grad, alpha=1 - beta1)
        v.mul_(beta2).addcmul_(grad, grad, value=1 - beta2)
        state[name] = (m, v, t)
        denom = (v / (1 - beta2 ** t)).sqrt_().add_(eps)
        weight.addcdiv_(m, denom, value=-lr / (1 - beta1 ** t))
    return step


OPTIMIZERS = {'sgd': sgd_momentum, 'adam': adam}


def follow(loss_fn, params, batches, optimizer):
    """Train ``params`` (a dict of float32 leaves, changed in place) one step
    a batch of ``batches`` with ``loss_fn(params, batch)``.

    :returns: ``{'losses': [float], 'grad_norms': {name: float} of the first
        step's gradient, 'step_grad_norms': [{name: float}] of every step's,
        'change_norms': {name: float} of the weights' change over all the
        steps}``."""
    step = OPTIMIZERS[optimizer['name']](optimizer)
    initial = {name: w.detach().clone() for name, w in params.items()}
    losses, step_grad_norms = [], []
    for batch in batches:
        for w in params.values():
            w.requires_grad_(True)
            w.grad = None
        value = loss_fn(params, batch)
        value.backward()
        losses.append(float(value.detach()))
        grads = {name: torch.zeros_like(w) if w.grad is None else w.grad
                 for name, w in params.items()}
        step_grad_norms.append({name: float(g.double().norm()) for name, g in grads.items()})
        with torch.no_grad():
            for name, w in params.items():
                step(name, w, grads[name])
                w.grad = None
    change_norms = {}
    with torch.no_grad():
        for name, w in params.items():
            w.requires_grad_(False)
            change_norms[name] = float((w.double() - initial.pop(name).double()).norm())
    return {'losses': losses, 'grad_norms': step_grad_norms[0],
            'step_grad_norms': step_grad_norms, 'change_norms': change_norms}
