"""Kernels K2-K4 (csrc/flash_attention.cu) against their plain versions on a
CUDA card, in bfloat16. The file imports nothing of JAX, so on the machine
with the card it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_kernels.py

Without a card every test skips. Tolerance, element by element:
|got - want| <= 2^-7 * |want| + 2^-16 * max|want| for bf16 outputs (both
sides compute in float32 on the same inputs and differ by summation order
before the final rounding, so an element may land on the neighbouring bf16
value), and 2^-18 * |want| + 2^-22 * max|want| for lse (float32 on both
sides); in norm, ||got - want|| / ||want|| <= 2^-12 (bf16) and 2^-21
(float32)."""

import importlib

import pytest
import torch

flash = importlib.import_module('petastorm_tpu_torch.ops.flash_attention')

CASES = {
    'causal': (2, 320, 2, 128, True, False),
    'noncausal': (2, 320, 2, 128, False, False),
    'segmented': (2, 320, 2, 128, True, True),
    'd64_ragged_t': (2, 200, 4, 64, True, False),
    'd64_ragged_t_segmented_noncausal': (1, 77, 2, 64, False, True),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (K2-K4 have no CPU mode)')
    return torch.device('cuda')


def _segments(b, t, device):
    seg = torch.zeros(b, t, dtype=torch.int32)
    for row in range(b):
        pos, ident = 3 * row, 1
        while pos < t - 10:
            seg[row, pos:pos + 5 + 7 * ident % 23] = ident
            pos += 5 + 7 * ident % 23 + (ident % 3 == 0) * 4   # some padding runs
            ident += 1
    return seg.to(device)


def _close(got, want):
    rtol, atol, norm_tol = ((2.0 ** -7, 2.0 ** -16, 2.0 ** -12) if want.dtype == torch.bfloat16
                            else (2.0 ** -18, 2.0 ** -22, 2.0 ** -21))
    got, want = got.double(), want.double()
    err = (got - want).abs()
    allowed = rtol * want.abs() + atol * float(want.abs().max())
    assert bool((err <= allowed).all()), float((err - allowed).max())
    assert float(err.norm()) <= norm_tol * float(want.norm()), (float(err.norm()),
                                                                 float(want.norm()))


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(CASES))
def test_kernels_match_plain_versions(card, case):
    b, t, h, d, causal, segmented = CASES[case]
    gen = torch.Generator().manual_seed(len(case))
    q, k, v, do = (torch.randn(b * h, t, d, generator=gen).to(card, torch.bfloat16)
                   for _ in range(4))
    segments = _segments(b, t, card) if segmented else None
    o, lse = flash.flash_forward(q, k, v, causal, segments, h)
    o_ref, lse_ref = flash.flash_forward_plain(q, k, v, causal, segments, h)
    delta = (do.float() * o_ref.float()).sum(dim=-1)
    dq = flash.flash_bwd_dq(q, k, v, do, lse_ref, delta, causal, segments, h)
    dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal, segments, h)
    torch.cuda.synchronize()
    _close(o, o_ref)
    _close(lse, lse_ref)
    _close(dq, flash.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal, segments, h))
    dk_ref, dv_ref = flash.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, causal,
                                               segments, h)
    _close(dk, dk_ref)
    _close(dv, dv_ref)


@pytest.mark.cuda
def test_autograd_launches_each_kernel_once_a_call(card):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 130, 2, 64, generator=gen).to(card, torch.bfloat16)
               .requires_grad_() for _ in range(3))
    before = dict(flash.flash_attention.launches)
    out = flash.flash_attention(q, k, v, causal=True)
    out.float().sum().backward()
    torch.cuda.synchronize()
    after = flash.flash_attention.launches
    assert {name: after[name] - before[name] for name in after} == {'fwd': 1, 'dq': 1, 'dkv': 1}
    assert all(torch.isfinite(x.grad.float()).all() for x in (q, k, v))


@pytest.mark.cuda
def test_wrapper_refuses_a_head_dim_without_a_kernel(card):
    q = torch.zeros(2, 16, 32, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='head_dim'):
        flash.flash_forward(q, q, q)
