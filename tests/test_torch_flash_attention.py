"""The port's flash attention (petastorm_tpu_torch.ops.flash_attention) against
petastorm_tpu's, on the CPU: the port runs the plain versions of K2-K4 (its
wrappers take them for CPU tensors), the JAX package its Pallas kernels in
interpret mode. Inputs come from a numpy seed, in float32.

Tolerances: forward outputs within 1e-5 absolute + 1e-5 relative, gradients
within 1e-4 + 1e-4 relative: both sides compute in float32 and differ only in
the order of their sums (the JAX kernels fold 128-key blocks with an online
softmax, the plain versions take a full softmax per block of queries)."""

import importlib
import warnings

import numpy as np
import pytest
import torch

from petastorm_tpu_torch.ops import flash_attention, flash_attention_segmented
from petastorm_tpu_torch.ops.packing import (masked_dense_attention, segment_causal_attention,
                                             segment_mask)
from petastorm_tpu_torch.ops.ring_attention import dense_attention

flash = importlib.import_module('petastorm_tpu_torch.ops.flash_attention')

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(b, t, h, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype(np.float32) for _ in range(4)]


def _segments(b, t):
    """Rows of several documents with padding runs inside and at the end."""
    seg = np.zeros((b, t), dtype=np.int32)
    seg[0, :100] = 1
    seg[0, 100:180] = 2
    seg[0, 200:t - 30] = 3
    if b > 1:
        seg[1, 10:70] = 1
        seg[1, 70:71] = 2
        seg[1, 71:t] = 3
    return seg


def _jax_attention(mode, q, k, v, g, seg):
    """Output and (dq, dk, dv) of the JAX package's Pallas flash attention."""
    import jax
    import jax.numpy as jnp
    from petastorm_tpu.ops.flash_attention import (flash_attention as jax_flash,
                                                   flash_attention_segmented as jax_seg)

    def fn(a, b_, c):
        if mode == 'segmented':
            return jax_seg(a, b_, c, jnp.asarray(seg), True, 128, 128)
        return jax_flash(a, b_, c, mode == 'causal', 128, 128)

    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _port_attention(fn, q, k, v, g):
    q, k, v = (torch.from_numpy(x.copy()).requires_grad_() for x in (q, k, v))
    out = fn(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(g))
    return out.detach().numpy(), [x.numpy() for x in grads]


@pytest.mark.parametrize('t', [256, 384])
@pytest.mark.parametrize('mode', ['causal', 'noncausal', 'segmented'])
def test_flash_attention_matches_jax_pallas(mode, t):
    """Forward and q/k/v gradients against the Pallas kernels (interpret mode),
    B = 2, H = 2, D = 128; the segmented mode has padding rows inside and at
    the end of each batch row."""
    q, k, v, g = _inputs(2, t, 2, 128, seed=t + len(mode))
    seg = _segments(2, t)
    want, want_grads = _jax_attention(mode, q, k, v, g, seg)
    if mode == 'segmented':
        segments = torch.from_numpy(seg)
        got, got_grads = _port_attention(
            lambda a, b_, c: flash_attention_segmented(a, b_, c, segments, True), q, k, v, g)
        assert np.all(got[0, 180:200] == 0) and np.all(got[0, t - 30:] == 0)  # padding
    else:
        got, got_grads = _port_attention(
            lambda a, b_, c: flash_attention(a, b_, c, causal=mode == 'causal'), q, k, v, g)
    np.testing.assert_allclose(got, want, **FWD_TOL)
    for got_grad, want_grad, name in zip(got_grads, want_grads, 'qkv'):
        np.testing.assert_allclose(got_grad, want_grad, err_msg='d' + name, **GRAD_TOL)
    assert flash_attention.launches == {'fwd': 0, 'dq': 0, 'dkv': 0}  # CPU: plain versions


@pytest.mark.parametrize('t,causal,plain_block', [
    (200, True, 1024), (200, False, 1024), (200, True, 64), (77, False, 32), (1, True, 1024)])
def test_head_dim_64_and_ragged_t_match_dense(monkeypatch, t, causal, plain_block):
    """Shapes the JAX kernels cannot take (head_dim 64, T not a multiple of a
    tile) run the port's flash path; it matches the port's dense attention.
    Small plain blocks walk the plain versions' block loops and ragged tail."""
    monkeypatch.setattr(flash, '_PLAIN_BLOCK', plain_block)
    q, k, v, g = _inputs(2, t, 2, 64, seed=t)
    before = flash.dense_fallbacks
    got, got_grads = _port_attention(
        lambda a, b_, c: flash_attention(a, b_, c, causal=causal), q, k, v, g)
    want, want_grads = _port_attention(
        lambda a, b_, c: dense_attention(a, b_, c, causal=causal), q, k, v, g)
    assert flash.dense_fallbacks == before
    np.testing.assert_allclose(got, want, **FWD_TOL)
    for got_grad, want_grad in zip(got_grads, want_grads):
        np.testing.assert_allclose(got_grad, want_grad, **GRAD_TOL)


@pytest.mark.parametrize('plain_block', [1024, 48])
def test_segmented_head_dim_64_matches_masked_dense(monkeypatch, plain_block):
    monkeypatch.setattr(flash, '_PLAIN_BLOCK', plain_block)
    t = 250
    q, k, v, g = _inputs(2, t, 3, 64, seed=5)
    segments = torch.from_numpy(_segments(2, t))
    mask = segment_mask(segments, segments, causal=True)
    got, got_grads = _port_attention(
        lambda a, b_, c: flash_attention_segmented(a, b_, c, segments, True), q, k, v, g)
    want, want_grads = _port_attention(
        lambda a, b_, c: masked_dense_attention(a, b_, c, mask), q, k, v, g)
    np.testing.assert_allclose(got, want, **FWD_TOL)
    for got_grad, want_grad in zip(got_grads, want_grads):
        np.testing.assert_allclose(got_grad, want_grad, **GRAD_TOL)


def test_plain_forward_gives_zero_output_and_lse_on_empty_rows():
    """A row with no valid key (padding) gets o = 0 and lse = 0, as K2 does."""
    q, k, v, _ = (torch.from_numpy(x[0].transpose(1, 0, 2).copy())
                  for x in _inputs(1, 40, 2, 64, seed=1))
    segments = torch.zeros(1, 40, dtype=torch.int32)
    segments[0, 5:30] = 1
    o, lse = flash.flash_forward(q, k, v, True, segments, heads=2)
    assert torch.all(o[:, :5] == 0) and torch.all(o[:, 30:] == 0)
    assert torch.all(lse[:, :5] == 0) and torch.all(lse[:, 30:] == 0)
    assert torch.all(lse[:, 5:30] != 0)


@pytest.mark.parametrize('shape,dtype', [
    ((1, 64, 2, 32), torch.float32),     # head_dim 32
    ((1, 64, 2, 96), torch.float32),     # head_dim 96
    ((1, 64, 2, 64), torch.float64),     # a dtype without a kernel
])
def test_dispatch_counts_dense_fallbacks(shape, dtype):
    rng = np.random.RandomState(3)
    q, k, v = (torch.tensor(rng.randn(*shape), dtype=dtype) for _ in range(3))
    assert not flash._use_kernels(q, k, v)
    before = flash.dense_fallbacks
    out = flash_attention(q, k, v, causal=True)
    assert flash.dense_fallbacks == before + 1
    torch.testing.assert_close(out, dense_attention(q, k, v, causal=True))
    segments = torch.ones(shape[:2], dtype=torch.int32)
    out = flash_attention_segmented(q, k, v, segments, True)
    assert flash.dense_fallbacks == before + 2
    torch.testing.assert_close(out, dense_attention(q, k, v, causal=True))


def test_dispatch_predicate():
    def takes(t, d, dtype=torch.float32, tk=None):
        q = torch.zeros(1, t, 2, d, dtype=dtype)
        k = torch.zeros(1, tk or t, 2, d, dtype=dtype)
        return flash._use_kernels(q, k, k)
    assert takes(384, 128)
    assert takes(100, 64)                          # any T, head_dim 64
    assert takes(100, 64, torch.bfloat16)
    assert not takes(100, 64, tk=120)              # Tq != Tk
    assert not takes(100, 256)
    assert not takes(100, 64, torch.float16)


def test_segment_causal_attention_warns_on_dense_fallback():
    rng = np.random.RandomState(4)
    q, k, v = (torch.tensor(rng.randn(1, 32, 2, 32), dtype=torch.float32) for _ in range(3))
    segments = torch.ones(1, 32, dtype=torch.int32)
    with pytest.warns(UserWarning, match='masked dense path'):
        segment_causal_attention(segments, use_flash=True)(q, k, v)
    q64, k64, v64 = (torch.tensor(rng.randn(1, 32, 2, 64), dtype=torch.float32)
                     for _ in range(3))
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        segment_causal_attention(segments, use_flash=True)(q64, k64, v64)


@pytest.mark.parametrize('call,match', [
    (lambda q: flash.flash_forward(q[:, :, :32].contiguous(), q[:, :, :32].contiguous(),
                                   q[:, :, :32].contiguous()), 'head_dim'),
    (lambda q: flash.flash_forward(q.double(), q.double(), q.double()), 'float32 or bfloat16'),
    (lambda q: flash.flash_forward(q.transpose(0, 1), q.transpose(0, 1), q.transpose(0, 1)),
     'contiguous'),
    (lambda q: flash.flash_forward(q, q, q[:, :10].contiguous()), 'share shape'),
    (lambda q: flash.flash_forward(q, q, q, True, torch.ones(3, 16, dtype=torch.int32), 2),
     'segments'),
    (lambda q: flash.flash_forward(q, q, q, True, torch.ones(2, 16, dtype=torch.int64), 2),
     'segments'),
    (lambda q: flash.flash_bwd_dq(q, q, q, q, torch.zeros(4, 16), torch.zeros(4, 15)),
     'lse and delta'),
    (lambda q: flash.flash_bwd_dkv(q, q, q, q, torch.zeros(4, 16, dtype=torch.float64),
                                   torch.zeros(4, 16)), 'lse and delta'),
    (lambda q: flash.flash_forward(*(torch.empty(4, 16, 64, device='meta'),) * 3),
     'cuda or cpu'),
])
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(call, match):
    q = torch.zeros(4, 16, 64)
    with pytest.raises(ValueError, match=match):
        call(q)


def test_every_kernel_entry_point_is_exported_by_its_source():
    """cuda_build's table names C functions that its sources define with
    ``extern "C"`` and as many parameters as it declares."""
    import os
    import re
    from petastorm_tpu_torch import cuda_build
    for name, (source, symbols) in cuda_build.KERNELS.items():
        with open(os.path.join(os.path.dirname(cuda_build.__file__), 'csrc', source)) as f:
            text = f.read()
        for symbol, argtypes in symbols.items():
            match = re.search(r'extern "C" int {}\(([^)]*)\)'.format(symbol), text)
            assert match, (source, symbol)
            assert len(match.group(1).split(',')) == len(argtypes), (source, symbol)


def test_library_key_covers_the_included_headers(tmp_path, monkeypatch):
    """An edited ``csrc/*.cuh`` header gives its source's library a new path,
    so a library built from the old header is never reused."""
    import os
    import shutil
    from petastorm_tpu_torch import cuda_build
    csrc = tmp_path / 'csrc'
    shutil.copytree(os.path.join(os.path.dirname(cuda_build.__file__), 'csrc'), csrc)
    monkeypatch.setattr(cuda_build, '_PACKAGE_DIR', str(tmp_path))
    before = cuda_build.library_path('flash_attention')
    assert cuda_build.library_path('flash_attention') == before
    header = csrc / 'flash_attention_sm90.cuh'
    header.write_text(header.read_text() + '\n')
    assert cuda_build.library_path('flash_attention') != before
