"""MnistCNN as an ``nn.Module`` that computes what
``petastorm_tpu.models.mnist.MnistCNN`` (flax) computes, so weights carry over
(:func:`petastorm_tpu_torch.convert.mnist_state_dict_from_flax`).

Matching flax, not torch defaults:

- Inputs are NHWC ``[B, 28, 28, 1]`` like the JAX model.
- ``nn.Conv`` is 3x3 with ``padding='SAME'`` (1 on each side at stride 1)
  and a bias; ``max_pool`` is 2x2, stride 2, VALID.
- The two convolutions and the first dense layer compute in ``dtype``
  (bfloat16 by default) on float32 weights cast with the input; the last
  dense layer computes in float32 and returns float32 logits.
- The flatten runs in flax's ``(h, w, c)`` order: the activations are
  permuted back to NHWC before it, so ``Dense_0``'s kernel carries over as it
  is (transposed to ``(out, in)``).
- Weights start as flax's defaults: lecun-normal kernels, zero biases.

Like every entry point of the port, the model lives on CUDA unless the caller
passes ``device='cpu'``; weights are drawn on the CPU from torch's default
generator, then moved, so a seed gives the same model on either device.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from petastorm_tpu_torch.parallel.loader import resolve_device


def _lecun_normal_(weight, fan_in):
    # flax's default kernel init: truncated normal with variance 1 / fan_in
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std)


class MnistCNN(nn.Module):
    """Two conv blocks and two dense layers over NHWC ``[B, 28, 28, 1]``
    images; returns float32 ``[B, num_classes]`` logits. Parameters live on
    ``device`` (CUDA unless ``'cpu'`` is passed)."""

    def __init__(self, num_classes=10, dtype=torch.bfloat16, device=None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.conv1 = nn.Conv2d(1, 32, 3, padding=1)
        self.conv2 = nn.Conv2d(32, 64, 3, padding=1)
        self.fc1 = nn.Linear(7 * 7 * 64, 128)
        self.fc2 = nn.Linear(128, num_classes)
        for layer in (self.conv1, self.conv2, self.fc1, self.fc2):
            _lecun_normal_(layer.weight, layer.weight[0].numel())
            nn.init.zeros_(layer.bias)
        self.to(device)

    def _conv(self, layer, x):
        return F.conv2d(x, layer.weight.to(self.dtype), layer.bias.to(self.dtype), padding=1)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self._conv(self.conv1, x)), 2, 2)
        x = F.max_pool2d(F.relu(self._conv(self.conv2, x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(F.linear(x, self.fc1.weight.to(self.dtype), self.fc1.bias.to(self.dtype)))
        return self.fc2(x.to(torch.float32))
