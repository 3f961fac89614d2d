"""Rounding of a reference's operands, for the controls that put the
reference in the program's place one precision lower than the configuration
states. The reference itself uses :func:`exact`.

Each rounding keeps the tensor's dtype and lets gradients pass straight
through, so the backward's products use the rounded operands saved by the
forward."""

import torch

#: the largest finite float8 e4m3 value
E4M3_MAX = 448.0


def exact(x):
    return x


def _straight_through(x, rounded):
    return x + (rounded - x).detach()


def fp8(x):
    """Round to float8 e4m3 with one scale for the tensor (its largest
    magnitude at 448), as an fp8 product takes its operands."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = amax / E4M3_MAX
    rounded = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return _straight_through(x, rounded)


def tf32(x):
    """Round float32 to TF32's 10 stored mantissa bits, to nearest."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return _straight_through(x, rounded)


#: name -> rounding, as a workload's control names them
ROUNDINGS = {'exact': exact, 'fp8': fp8, 'tf32': tf32}


class Precision(object):
    """What a reference rounds: ``low`` for the operands of the products the
    configuration runs in bfloat16 or float16, ``high`` for those it runs in
    float32."""

    def __init__(self, low='exact', high='exact'):
        self.low = ROUNDINGS[low]
        self.high = ROUNDINGS[high]


EXACT = Precision()
