"""Weights made on the card from ``--seed``.

A configuration lists rules (``run.init``), each a regular expression over
the weight's name and how that weight starts: ``zeros``, ``ones``,
``normal_fan_in`` (normal with standard deviation ``1 / sqrt(fan_in)``,
``fan_in`` the product of every dimension after the first) or
``normal_last`` (``1 / sqrt`` of the last dimension, as an embedding table's
rows). The first rule that matches a name applies. Each weight draws from a
generator on the card seeded by the run's seed and the weight's name, so any
one weight can be made again alone: the reference makes its own copy of the
initial weights after the program's are gone.
"""

import hashlib
import re

import torch


def leaf_seed(seed, name):
    digest = hashlib.sha256('{}/{}'.format(int(seed), name).encode()).digest()
    return int.from_bytes(digest[:8], 'little') >> 1


def rule_of(name, rules):
    for rule in rules:
        if re.search(rule['match'], name):
            return rule['init']
    raise ValueError('no init rule matches weight {!r}'.format(name))


def initial(name, shape, rules, seed, device):
    """The float32 initial value of weight ``name`` of ``shape``."""
    kind = rule_of(name, rules)
    if kind == 'zeros':
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if kind == 'ones':
        return torch.ones(shape, dtype=torch.float32, device=device)
    if kind == 'normal_fan_in':
        fan = 1
        for size in shape[1:]:
            fan *= size
    elif kind == 'normal_last':
        fan = shape[-1]
    else:
        raise ValueError('unknown init {!r} for weight {!r}'.format(kind, name))
    generator = torch.Generator(device=device)
    generator.manual_seed(leaf_seed(seed, name))
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device) * fan ** -0.5


@torch.no_grad()
def load(module, rules, seed):
    """Set every parameter and buffer of ``module`` from the rules."""
    for name, tensor in list(module.named_parameters()) + list(module.named_buffers()):
        tensor.copy_(initial(name, tuple(tensor.shape), rules, seed, tensor.device))


def parameters(shapes, rules, seed, device):
    """``{name: float32 leaf}`` for ``shapes`` (``{name: shape}``)."""
    return {name: initial(name, shape, rules, seed, device) for name, shape in shapes.items()}
