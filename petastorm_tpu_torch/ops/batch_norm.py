"""Batch norm on the card: flax's ``nn.BatchNorm`` over a convolution's
channels-last bfloat16 output as hand-written Hopper kernels
(``csrc/batch_norm.cu``), with what follows it in a ResNet bottleneck folded
in, and the plain PyTorch version beside it.

:func:`batch_norm` takes a ``norm`` that carries ``weight``, ``bias``,
``running_mean``, ``running_var``, ``momentum``, ``eps`` and ``training`` (the
model's ``BatchNorm``) and computes, cast to ``out_dtype``:

- ``bn(x)``;
- ``relu(bn(x))`` with ``relu=True``;
- ``relu(residual + bn(x))`` with a float32 ``residual`` (an identity
  shortcut);
- ``relu(bn2(x2) + bn(x))`` with ``shortcut=(x2, norm2)`` (a projected
  shortcut, ``norm2`` its batch norm).

``bn`` is flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)``
on NCHW input: float32 statistics over (N, H, W), the biased fast variance
``max(E[x^2] - E[x]^2, 0)``, and in training running averages that keep
``momentum`` of themselves and take the rest from the batch (the biased
variance stored); in evaluation the running averages.

For a CPU tensor it runs :func:`batch_norm_plain`, the composition of PyTorch
operators the model always ran, whose autograd is the reference. For a CUDA
tensor it launches the kernels or raises: ``x`` (and ``x2``) bfloat16
``[N, C, H, W]`` in channels-last memory with C a multiple of 8 and N*H*W >= 1,
every parameter and running average float32 ``[C]`` on the same card,
``residual`` float32 and channels-last like ``x``, and bfloat16 output only
for ``relu(bn(x))``. A call is an ``autograd.Function``:

- forward: a statistics pass for each input in training (partial sums, then a
  finalisation that also moves the running averages; in evaluation only the
  finalisation, from the running averages), then one apply pass;
- backward: a reduction of ``sum dy'`` and ``sum dy' xhat`` (``dy'`` the
  gradient under the ReLU's mask), a finalisation that writes ``dweight`` and
  ``dbias``, and one apply pass writing ``dx`` in bfloat16 (what the
  float32 cast's backward gave), the shortcut's float32 gradient or
  ``dx2``.

It saves the bfloat16 inputs and the per-channel statistics, and recomputes
``xhat`` and the ReLU's mask from them in the backward. Only the order of
the float32 sums differs from the plain version.

Each call counts its passes in ``batch_norm.launches`` (``{'stats': n,
'apply': n, 'backward': n}``, a pair of inputs two statistics passes, one
apply and one backward); a call made while a CUDA graph is captured counts
in ``batch_norm.captured`` instead. :func:`batch_norm_check` holds the kernels
against the plain version for the card tests and ``chip_smoke.py``.
"""

import torch
import torch.nn.functional as F

#: what follows the normalisation: the kernels' mode codes
PLAIN, RELU, ADD_RELU, NORM_ADD_RELU = 0, 1, 2, 3
#: threads of a kernel block; a thread owns 8 channels (16 bytes of bf16)
_THREADS = 256
_VEC = 8
#: rows each thread of a reduction should sum before its block's partial row
_ROWS_PER_THREAD = 32
#: partial rows (reduction blocks) per SM, at most
_BLOCKS_PER_SM = 4

_sm_counts = {}
_kernels = {}


# ----------------------------------------------------------------- plain version

def normalize_plain(x, norm):
    """``bn(x)`` in float32 as PyTorch operators (in training it also moves
    ``norm``'s running averages)."""
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


def _pre_activation_plain(x, norm, residual, shortcut):
    y = normalize_plain(x, norm)
    if shortcut is not None:
        residual = normalize_plain(*shortcut)
    return y if residual is None else residual + y


def batch_norm_plain(x, norm, relu=False, residual=None, shortcut=None,
                     out_dtype=torch.float32):
    """Plain PyTorch version of :func:`batch_norm`, on any device."""
    _mode(relu, residual, shortcut)
    y = _pre_activation_plain(x, norm, residual, shortcut)
    if relu:
        y = F.relu(y)
    return y.to(out_dtype)


# ----------------------------------------------------------------- kernel wrappers

def _mode(relu, residual, shortcut):
    if residual is not None and shortcut is not None:
        raise ValueError('batch_norm takes a residual or a shortcut, not both')
    if (residual is not None or shortcut is not None) and not relu:
        raise ValueError('batch_norm adds a shortcut before its ReLU: pass relu=True')
    if shortcut is not None:
        return NORM_ADD_RELU
    if residual is not None:
        return ADD_RELU
    return RELU if relu else PLAIN


def _fail(message):
    raise ValueError('batch_norm: ' + message)


def _check_activation(name, t, like, dtype):
    if t.device != like.device:
        _fail('{} is on {}, x on {}'.format(name, t.device, like.device))
    if t.dtype != dtype:
        _fail('{} must be {}, got {}'.format(name, dtype, t.dtype))
    if t.shape != like.shape:
        _fail('{} must have x\'s shape {}, got {}'.format(name, tuple(like.shape),
                                                        tuple(t.shape)))
    if not t.is_contiguous(memory_format=torch.channels_last) or t.data_ptr() % 16:
        _fail('{} must be channels-last contiguous and 16-byte aligned (the kernels read '
              '[N*H*W, C] rows)'.format(name))


def _check(x, norm, residual, shortcut, mode, out_dtype):
    """Raise unless the kernels take these CUDA inputs."""
    if x.dim() != 4:
        _fail('x must be [N, C, H, W], got shape {}'.format(tuple(x.shape)))
    _check_activation('x', x, x, torch.bfloat16)
    n, c, h, w = x.shape
    if c % _VEC or n * h * w == 0:
        _fail('needs C a multiple of {} and N*H*W >= 1, got shape {}'.format(
            _VEC, tuple(x.shape)))
    norms = [norm]
    if shortcut is not None:
        _check_activation('the shortcut\'s input', shortcut[0], x, torch.bfloat16)
        norms.append(shortcut[1])
        if shortcut[1].training != norm.training:
            _fail('both batch norms must be in training or both in evaluation')
    for each in norms:
        for name in ('weight', 'bias', 'running_mean', 'running_var'):
            t = getattr(each, name)
            if (t.device != x.device or t.dtype != torch.float32 or t.shape != (c,)
                    or not t.is_contiguous() or t.data_ptr() % 16):
                _fail('{} must be a contiguous, 16-byte aligned float32 [{}] on {}, got {} '
                      '{} on {}'.format(name, c, x.device, t.dtype, tuple(t.shape), t.device))
    if residual is not None:
        _check_activation('residual', residual, x, torch.float32)
    if out_dtype not in (torch.bfloat16, torch.float32):
        _fail('out_dtype must be bfloat16 or float32, got {}'.format(out_dtype))
    if out_dtype == torch.bfloat16 and mode != RELU:
        _fail('only relu(bn(x)) writes bfloat16 (it feeds a convolution); a batch norm '
              'without a ReLU or with a shortcut writes float32')


def _partial_rows(m, c, index):
    """Blocks of a reduction pass on card ``index``, each writing one row of
    partial sums: about ``_ROWS_PER_THREAD`` rows a thread, at most
    ``_BLOCKS_PER_SM`` a SM."""
    sms = _sm_counts.get(index)
    if sms is None:
        sms = _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    rows_per_block = _THREADS // min(c // _VEC, _THREADS)
    return max(1, min(-(-m // (rows_per_block * _ROWS_PER_THREAD)), _BLOCKS_PER_SM * sms))


def _launch(symbol, *args):
    """Launch ``symbol`` of ``csrc/batch_norm.cu`` with device pointers and
    numbers; raise on a non-zero cudaError. The step calls this some 300
    times, so the loaded functions are kept here."""
    kernel = _kernels.get(symbol)
    if kernel is None:
        from petastorm_tpu_torch import cuda_build
        kernel = _kernels[symbol] = cuda_build.load('batch_norm', symbol)
    status = kernel(*args)
    if status != 0:
        raise RuntimeError('{} kernel launch failed: cudaError {}'.format(symbol, status))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(index):
    """The current stream of card ``index`` as a pointer (what
    ``torch.cuda.current_stream().cuda_stream`` gives, without the Stream
    object)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _count(name, passes=1):
    if torch.cuda.is_current_stream_capturing():
        batch_norm.captured[name] += passes   # kernel nodes of the captured graph
    else:
        batch_norm.launches[name] += passes


def _rows(x):
    return x.shape[0] * x.shape[2] * x.shape[3]


def _statistics(x, norm, stream):
    """stats ``[4, C]`` (mean, rstd, rstd * weight, 1 where the variance was
    not clamped): from a statistics pass in training, which also moves the
    running averages; from the running averages in evaluation."""
    m, c = _rows(x), x.shape[1]
    stats = torch.empty(4, c, dtype=torch.float32, device=x.device)
    partial, p_rows = None, 0
    if norm.training:
        p_rows = _partial_rows(m, c, x.device.index)
        partial = torch.empty(p_rows, 2, c, dtype=torch.float32, device=x.device)
        _launch('bn_stats', x.data_ptr(), m, c, p_rows, partial.data_ptr(), stream)
    _launch('bn_finalize', _ptr(partial), p_rows, m, c, norm.weight.data_ptr(),
            norm.running_mean.data_ptr(), norm.running_var.data_ptr(), stats.data_ptr(),
            float(norm.momentum), float(1 - norm.momentum), float(norm.eps),
            int(norm.training), stream)
    return stats


def forward_passes(x, norm, mode, out_dtype, residual=None, x2=None, norm2=None):
    """The forward's kernels on checked inputs, on x's card and its current
    stream: (output, stats, stats2)."""
    index = x.device.index
    if torch.cuda.current_device() != index:
        with torch.cuda.device(index):
            return forward_passes(x, norm, mode, out_dtype, residual, x2, norm2)
    stream = _stream(index)
    stats = _statistics(x, norm, stream)
    stats2 = bias2 = None
    if x2 is not None:
        stats2, bias2 = _statistics(x2, norm2, stream), norm2.bias
    out = torch.empty_like(x, dtype=out_dtype, memory_format=torch.channels_last)
    _launch('bn_apply', x.data_ptr(), stats.data_ptr(), norm.bias.data_ptr(), _ptr(x2),
            _ptr(stats2), _ptr(bias2), _ptr(residual), out.data_ptr(), _rows(x), x.shape[1],
            mode, int(out_dtype == torch.bfloat16), stream)
    if norm.training:
        _count('stats', 1 if x2 is None else 2)
    _count('apply')
    return out, stats, stats2


def backward_passes(grad, x, stats, bias, mode, training, residual=None, x2=None,
                    stats2=None, bias2=None):
    """The backward's kernels, on x's card and its current stream: (dx,
    dweight, dbias, dresidual, dx2, dweight2, dbias2), None where the
    forward had no such input. ``grad`` is channels-last in the output's
    dtype."""
    index = x.device.index
    if torch.cuda.current_device() != index:
        with torch.cuda.device(index):
            return backward_passes(grad, x, stats, bias, mode, training, residual, x2, stats2,
                                   bias2)
    m, c = _rows(x), x.shape[1]
    stream = _stream(index)
    p_rows = _partial_rows(m, c, index)
    partial = torch.empty(p_rows, 3, c, dtype=torch.float32, device=x.device)
    dy_bf16 = int(grad.dtype == torch.bfloat16)
    inputs = (x.data_ptr(), stats.data_ptr(), bias.data_ptr(), _ptr(x2), _ptr(stats2),
              _ptr(bias2), _ptr(residual))
    _launch('bn_backward_reduce', grad.data_ptr(), *inputs, m, c, mode, dy_bf16, p_rows,
            partial.data_ptr(), stream)
    sums = torch.empty(4 if x2 is None else 8, c, dtype=torch.float32, device=x.device)
    dweight, dbias = sums[0], sums[1]
    dweight2 = dbias2 = None
    row = 4 * c   # bytes of a row of sums
    coef = sums.data_ptr() + 2 * row
    coef2 = None
    if x2 is not None:
        dweight2, dbias2, coef2 = sums[4], sums[5], coef + 4 * row
    _launch('bn_backward_finalize', partial.data_ptr(), p_rows, m, c, stats.data_ptr(),
            _ptr(stats2), dweight.data_ptr(), dbias.data_ptr(), _ptr(dweight2), _ptr(dbias2),
            coef, coef2, int(training), stream)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    dx2 = None if x2 is None else torch.empty_like(x2, memory_format=torch.channels_last)
    dres = (None if residual is None
            else torch.empty_like(residual, memory_format=torch.channels_last))
    _launch('bn_backward_apply', grad.data_ptr(), x.data_ptr(), stats.data_ptr(),
            bias.data_ptr(), coef, _ptr(x2), _ptr(stats2), _ptr(bias2), coef2, _ptr(residual),
            dx.data_ptr(), _ptr(dx2), _ptr(dres), m, c, mode, dy_bf16, stream)
    _count('backward')
    return dx, dweight, dbias, dres, dx2, dweight2, dbias2


class _BatchNorm(torch.autograd.Function):
    """Forward and backward through the kernels; saves the bf16 inputs, the
    per-channel statistics and, for an identity shortcut, the residual (the
    ReLU's mask is recomputed from them)."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, x2, weight2, bias2, norm, norm2, mode,
                out_dtype):
        out, stats, stats2 = forward_passes(x, norm, mode, out_dtype, residual, x2, norm2)
        ctx.save_for_backward(x, stats, bias, residual, x2, stats2, bias2)
        ctx.mode, ctx.training = mode, norm.training
        return out

    @staticmethod
    def backward(ctx, grad):
        x, stats, bias, residual, x2, stats2, bias2 = ctx.saved_tensors
        grads = backward_passes(grad.contiguous(memory_format=torch.channels_last), x, stats,
                                bias, ctx.mode, ctx.training, residual, x2, stats2, bias2)
        return grads + (None, None, None, None)


def batch_norm(x, norm, relu=False, residual=None, shortcut=None, out_dtype=torch.float32):
    """``bn(x)``, ``relu(bn(x))``, ``relu(residual + bn(x))`` or
    ``relu(bn2(x2) + bn(x))`` (``shortcut=(x2, norm2)``) in ``out_dtype``:
    the kernels for CUDA tensors (or an error), :func:`batch_norm_plain` for
    CPU tensors."""
    mode = _mode(relu, residual, shortcut)
    if x.device.type == 'cpu':
        return batch_norm_plain(x, norm, relu, residual, shortcut, out_dtype)
    _check(x, norm, residual, shortcut, mode, out_dtype)
    x2, norm2 = shortcut if shortcut is not None else (None, None)
    return _BatchNorm.apply(x, norm.weight, norm.bias, residual, x2,
                            None if norm2 is None else norm2.weight,
                            None if norm2 is None else norm2.bias, norm, norm2, mode, out_dtype)


#: statistics, apply and backward passes launched through the wrappers since
#: the counts were last set to 0; a CUDA graph's replay (ResNet's training
#: step on the card) runs its recorded passes without a wrapper, so replays
#: count neither here nor in ``captured``
batch_norm.launches = {'stats': 0, 'apply': 0, 'backward': 0}
#: the same passes recorded into CUDA graph captures (replays run them)
batch_norm.captured = {'stats': 0, 'apply': 0, 'backward': 0}


# ----------------------------------------------------------------- the check

#: a float32 sum in another order: relative error of a sum or mean against the
#: sum of its terms' magnitudes
SUM_RTOL = 1e-5
#: one bfloat16 step: the two float32 results may round to neighbouring values
BF16_STEP = 2.0 ** -7


def _compare(got, want, tol):
    err = (got.float() - want.float()).abs()
    share = float((err / tol).max()) if err.numel() else 0.0
    return {'max_abs_err': float(err.max()) if err.numel() else 0.0, 'tol_share': share,
            'ok': share <= 1.0}


def _elementwise(got, want, floor):
    """Within one bf16 step of |want| (bf16 tensors) or SUM_RTOL of it, plus
    ``floor``."""
    rtol = BF16_STEP if got.dtype == torch.bfloat16 else SUM_RTOL
    return _compare(got, want, rtol * want.float().abs() + floor)


def _state(norms):
    return [(n.running_mean.clone(), n.running_var.clone()) for n in norms]


def _restore(norms, state):
    with torch.no_grad():
        for n, (mean, var) in zip(norms, state):
            n.running_mean.copy_(mean)
            n.running_var.copy_(var)


def batch_norm_check(x, norm, grad, relu=False, residual=None, shortcut=None,
                     out_dtype=torch.float32):
    """Run :func:`batch_norm` and the plain version on the same inputs from
    the same running averages (restored after), forward and backward with
    ``grad``, and hold each result of the first against the second:

    - the output: one bf16 step of |want| (bf16) or ``SUM_RTOL`` of it
      (float32), plus ``SUM_RTOL`` of the largest pre-activation: the
      statistics are float32 sums in another order;
    - the running averages: ``SUM_RTOL`` of |want| plus ``SUM_RTOL`` of the
      batch's largest mean or mean square;
    - dx (and dx2): one bf16 step of |want| plus ``SUM_RTOL`` of the
      largest |want| times 4 (the backward's sums enter every element);
    - dweight, dbias: ``SUM_RTOL`` of the sum of their terms' magnitudes;
    - the shortcut's gradient: equal.

    The plain backward runs under the kernel's own ReLU mask (read off its
    output), so an element whose pre-activation lies within float32 rounding
    of 0 is not counted twice; ``mask_flips`` counts the elements where the
    two masks differ, and each must lie within ``SUM_RTOL`` of the largest
    pre-activation of 0. Returns ``{name: {max_abs_err, tol_share, ok}}``
    with ``mask_flips`` and ``ok`` (all of them)."""
    norms = [norm] + ([shortcut[1]] if shortcut is not None else [])
    start = _state(norms)
    x = x.detach().requires_grad_()
    inputs = [x, norm.weight, norm.bias]
    res = x2 = None
    if residual is not None:
        res = residual.detach().requires_grad_()
        inputs.append(res)
    if shortcut is not None:
        x2 = shortcut[0].detach().requires_grad_()
        inputs += [x2, shortcut[1].weight, shortcut[1].bias]
    out = batch_norm(x, norm, relu, res, None if x2 is None else (x2, shortcut[1]), out_dtype)
    got = dict(zip(_names(residual, shortcut), torch.autograd.grad(out, inputs, grad)))
    got_state = _state(norms)
    _restore(norms, start)
    pre = _pre_activation_plain(x, norm, res, None if x2 is None else (x2, shortcut[1]))
    want_state = _state(norms)
    _restore(norms, start)
    mask = out > 0 if relu else torch.ones_like(pre, dtype=torch.bool)
    want_out = (F.relu(pre) if relu else pre).to(out_dtype)
    want = dict(zip(_names(residual, shortcut),
                    torch.autograd.grad(pre, inputs, torch.where(mask, grad.float(), 0.0))))
    with torch.no_grad():
        floor = SUM_RTOL * float(pre.abs().max())
        flips = mask != (pre > 0) if relu else torch.zeros_like(mask)
        result = {'out': _elementwise(out, want_out, floor),
                  'mask_flips': int(flips.sum()),
                  'flips_near_zero': bool((pre[flips].abs() <= floor).all())}
        for i, (n, src) in enumerate(zip(norms, [x] + ([x2] if x2 is not None else []))):
            xf = src.float()
            scale = SUM_RTOL * (1 - n.momentum)
            for j, (name, moment) in enumerate((('running_mean', xf.abs()),
                                                ('running_var', xf * xf))):
                base = float(moment.mean(dim=(0, 2, 3)).max())
                result['{}{}'.format(name, i or '')] = _compare(
                    got_state[i][j], want_state[i][j],
                    SUM_RTOL * want_state[i][j].abs() + scale * base)
        dy = torch.where(mask, grad.float(), 0.0)
        for suffix, src, n in (('', x, norm),) + ((('2', x2, shortcut[1]),) if x2 is not None
                                                  else ()):
            name = 'dx' + suffix
            result[name] = _elementwise(got[name], want[name],
                                        4 * SUM_RTOL * float(want[name].float().abs().max()))
            xf = src.float()
            if n.training:
                mean = xf.mean(dim=(0, 2, 3), keepdim=True)
                var = (xf * xf).mean(dim=(0, 2, 3), keepdim=True) - mean * mean
            else:
                mean, var = n.running_mean[:, None, None], n.running_var[:, None, None]
            xhat = (xf - mean) * torch.rsqrt(var.clamp(min=0) + n.eps)
            for grad_name, terms in (('dbias', dy), ('dweight', dy * xhat)):
                key = grad_name + suffix
                result[key] = _compare(got[key], want[key],
                                       SUM_RTOL * terms.abs().sum(dim=(0, 2, 3)) + 1e-30)
        if residual is not None:
            result['dres'] = _compare(got['dres'], want['dres'],
                                      torch.full_like(want['dres'], 1e-30))
    result['ok'] = (result['flips_near_zero']
                    and all(v['ok'] for v in result.values() if isinstance(v, dict)))
    return result


def _names(residual, shortcut):
    names = ['dx', 'dweight', 'dbias']
    if residual is not None:
        names.append('dres')
    if shortcut is not None:
        names += ['dx2', 'dweight2', 'dbias2']
    return names
