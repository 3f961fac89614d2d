"""ResNet-50 v1.5 (He et al., arXiv:1512.03385; the stride on the 3x3
convolution of a bottleneck) in plain PyTorch, float32, on a dict of weights.

The layout of the weights, and the padding, are those of the benchmark's
``resnet`` configurations: NHWC images in; a 7x7 stride-2 stem with 3 pixels
of padding on each side; TensorFlow's ``SAME`` padding elsewhere (a stride-2
window on an even input pads one pixel after and none before; the max pool
pads with -inf); batch norm over (N, H, W) with the biased variance and
``eps``; a projection shortcut (1x1 convolution and batch norm) where a
block changes shape; global average pooling and a linear head. Weight names:
``conv_init.weight``, ``bn_init.{weight,bias}``,
``blocks.<i>.{conv1,conv2,conv3,conv_proj}.weight`` (``(out, in, k, k)``),
``blocks.<i>.{bn1,bn2,bn3,norm_proj}.{weight,bias}``, ``head.{weight,bias}``.
"""

import torch
import torch.nn.functional as F

from portbench.reference.precision import EXACT


def block_layout(stage_sizes, num_filters):
    """[(in_channels, filters, stride)] of every bottleneck block."""
    layout = []
    in_ch = num_filters
    for stage, count in enumerate(stage_sizes):
        filters = num_filters * 2 ** stage
        for index in range(count):
            layout.append((in_ch, filters, 2 if stage > 0 and index == 0 else 1))
            in_ch = filters * 4
    return layout


def same_pad(x, kernel, stride, value=0.0):
    pads = []
    for size in (x.shape[3], x.shape[2]):
        out = -(-size // stride)
        total = max((out - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value) if any(pads) else x


def conv(x, weight, stride, precision, padding=None):
    kernel = weight.shape[-1]
    if padding is None:
        x = same_pad(x, kernel, stride)
        padding = 0
    return F.conv2d(precision.low(x), precision.low(weight), stride=stride, padding=padding)


def batch_norm(x, weight, bias, eps):
    # training mode: the batch's mean and biased variance over (N, H, W)
    return F.batch_norm(x, None, None, weight, bias, training=True, momentum=0.0, eps=eps)


def logits(params, images, cfg, precision=EXACT):
    """float32 NHWC ``images`` -> ``[N, classes]`` logits, batch statistics
    in every batch norm (training mode)."""
    eps = cfg['batch_norm_epsilon']

    def bn(x, name):
        return batch_norm(x, params[name + '.weight'], params[name + '.bias'], eps)

    x = images.permute(0, 3, 1, 2)
    x = F.relu(bn(conv(x, params['conv_init.weight'], 2, precision, padding=3), 'bn_init'))
    x = F.max_pool2d(same_pad(x, 3, 2, value=float('-inf')), 3, 2)
    for i, (in_ch, filters, stride) in enumerate(block_layout(cfg['stage_sizes'],
                                                              cfg['num_filters'])):
        p = 'blocks.{}.'.format(i)
        y = F.relu(bn(conv(x, params[p + 'conv1.weight'], 1, precision), p + 'bn1'))
        y = F.relu(bn(conv(y, params[p + 'conv2.weight'], stride, precision), p + 'bn2'))
        y = bn(conv(y, params[p + 'conv3.weight'], 1, precision), p + 'bn3')
        if in_ch != filters * 4 or stride != 1:
            x = bn(conv(x, params[p + 'conv_proj.weight'], stride, precision), p + 'norm_proj')
        x = F.relu(x + y)
    x = x.mean(dim=(2, 3))
    return precision.high(x) @ precision.high(params['head.weight']).t() + params['head.bias']


def loss(params, batch, cfg, precision=EXACT):
    """Mean cross-entropy of ``batch['images']`` against ``batch['labels']``;
    ``batch['rows']``, when given, keeps only those rows."""
    images, labels = batch['images'], batch['labels']
    if 'rows' in batch:
        images, labels = images[batch['rows']], labels[batch['rows']]
    out = logits(params, images, cfg, precision)
    return -torch.log_softmax(out, dim=-1).gather(1, labels[:, None]).mean()
