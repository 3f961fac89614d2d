"""ResNet (ResNet-50 by default) as an ``nn.Module`` that computes what
``petastorm_tpu.models.resnet.ResNet`` (flax) computes, so weights carry over
(:func:`petastorm_tpu_torch.convert.resnet_state_dict_from_flax`) and the two
agree on logits and batch statistics.

Matching flax, not torch defaults:

- Inputs are NHWC ``[B, H, W, C]`` like the JAX model; convolutions run in
  ``dtype`` (bfloat16 by default) on weights kept in float32, batch norm runs
  in float32 and the classifier in float32.
- ``padding='SAME'`` pads asymmetrically: a stride-2 3x3 window on an even
  input pads 0 before and 1 after. Torch's symmetric ``padding=1`` would shift
  every window by a pixel, so :func:`_same_pad` pads explicitly, with ``-inf``
  for the max pool.
- Batch norm keeps flax's semantics: the running averages move by
  ``1 - momentum`` with flax ``momentum=0.9`` (torch's ``momentum=0.1``), the
  batch variance is the biased ``E[x^2] - E[x]^2``, and the running variance
  stores that biased value (torch's ``BatchNorm2d`` stores the unbiased one).
- The last batch norm of each block starts with scale zero.

Like every entry point of the port, the model lives on CUDA unless the caller
passes ``device='cpu'``; without a card a CUDA request raises. Weights are
drawn on the CPU from torch's default generator, then moved, so a seed gives
the same model on either device.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from petastorm_tpu_torch.parallel.loader import resolve_device


def _same_pad(x, kernel, stride, value=0.0):
    """Pad NCHW ``x`` the way XLA's ``SAME`` does: total ``max((ceil(n/s) - 1)
    * s + k - n, 0)`` per spatial dim, the smaller half before."""
    pads = []
    for size in (x.shape[3], x.shape[2]):     # F.pad lists the last dim first
        out = -(-size // stride)
        total = max((out - 1) * stride + kernel - size, 0)
        pads.extend([total // 2, total - total // 2])
    if not any(pads):
        return x
    return F.pad(x, pads, value=value)


class Conv(nn.Module):
    """Bias-free convolution with flax's ``SAME`` padding (or explicit
    symmetric ``padding``), computed in ``dtype`` on float32 weights."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, padding=None,
                 dtype=torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.kernel = kernel
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        # flax's default lecun_normal: truncated normal, variance 1 / fan_in
        fan_in = in_ch * kernel * kernel
        nn.init.trunc_normal_(self.weight, std=math.sqrt(1.0 / fan_in) / .87962566103423978,
                              a=-2 * math.sqrt(1.0 / fan_in) / .87962566103423978,
                              b=2 * math.sqrt(1.0 / fan_in) / .87962566103423978)

    def forward(self, x):
        x = x.to(self.dtype)
        if self.padding is None:
            x = _same_pad(x, self.kernel, self.stride)
            padding = 0
        else:
            padding = self.padding
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride, padding=padding)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)`` on NCHW
    input: float32 statistics over (N, H, W), the biased fast variance, and
    running averages that move by 0.1 of the batch statistics in training."""

    def __init__(self, channels, momentum=0.9, eps=1e-5, zero_scale=False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(channels) if zero_scale
                                   else torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('running_mean', torch.zeros(channels))
        self.register_buffer('running_var', torch.ones(channels))
        self.momentum = momentum
        self.eps = eps

    def forward(self, x):
        x = x.to(torch.float32)
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 (x4 filters) with a projected shortcut when
    the shape changes."""

    def __init__(self, in_ch, filters, stride, dtype):
        super().__init__()
        self.conv1 = Conv(in_ch, filters, 1, dtype=dtype)
        self.bn1 = BatchNorm(filters)
        self.conv2 = Conv(filters, filters, 3, stride, dtype=dtype)
        self.bn2 = BatchNorm(filters)
        self.conv3 = Conv(filters, filters * 4, 1, dtype=dtype)
        self.bn3 = BatchNorm(filters * 4, zero_scale=True)
        self.conv_proj = None
        self.norm_proj = None
        if in_ch != filters * 4 or stride != 1:
            self.conv_proj = Conv(in_ch, filters * 4, 1, stride, dtype=dtype)
            self.norm_proj = BatchNorm(filters * 4)

    def forward(self, x):
        residual = x
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(residual))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet with bottleneck blocks. ``forward`` takes NHWC images and returns
    float32 logits; ``train()``/``eval()`` select batch or running statistics.
    Parameters live on ``device`` (CUDA unless ``'cpu'`` is passed)."""

    def __init__(self, stage_sizes, num_classes=1000, num_filters=64,
                 dtype=torch.bfloat16, in_channels=3, device=None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.conv_init = Conv(in_channels, num_filters, 7, 2, padding=3, dtype=dtype)
        self.bn_init = BatchNorm(num_filters)
        blocks = []
        in_ch = num_filters
        for stage, block_count in enumerate(stage_sizes):
            filters = num_filters * 2 ** stage
            for block in range(block_count):
                stride = 2 if stage > 0 and block == 0 else 1
                blocks.append(BottleneckBlock(in_ch, filters, stride, dtype))
                in_ch = filters * 4
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(in_ch, num_classes)
        fan_in = in_ch
        nn.init.trunc_normal_(self.head.weight, std=math.sqrt(1.0 / fan_in) / .87962566103423978,
                              a=-2 * math.sqrt(1.0 / fan_in) / .87962566103423978,
                              b=2 * math.sqrt(1.0 / fan_in) / .87962566103423978)
        nn.init.zeros_(self.head.bias)
        self.to(device)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = F.max_pool2d(_same_pad(x, 3, 2, value=float('-inf')), 3, 2)
        for block in self.blocks:
            x = block(x)
        x = x.mean(dim=(2, 3))
        return self.head(x.to(torch.float32))


def ResNet50(**kwargs):
    """ResNet-50: stages of 3, 4, 6 and 3 bottleneck blocks."""
    return ResNet(stage_sizes=[3, 4, 6, 3], **kwargs)
