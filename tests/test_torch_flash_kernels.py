"""Kernels K2-K4 (csrc/flash_attention.cu, with the tensor-core K2-K4 of
csrc/flash_attention_sm90.cuh for bfloat16) against their plain versions on
a CUDA card. The file imports nothing of JAX, so on the machine with the card
it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_kernels.py

Without a card every test skips. Each output is checked by
``flash_compare`` (ops/flash_attention.py): element by element within
rtol * |want| + atol * max|want| (bf16: 2^-7 and 2^-16, one bf16 step of the
value, as both sides compute in fp32 and may round to neighbouring values;
float32 and lse: 2^-18 and 2^-22), plus, for the bf16 outputs whose P or dS
the tensor-core kernels round to bf16 (o, dq, dk, dv), 2^-8 of the same sum
over absolute values; and in relative norm."""

import importlib

import pytest
import torch

flash = importlib.import_module('petastorm_tpu_torch.ops.flash_attention')

BF16 = torch.bfloat16
#: name -> (B, T, H, head_dim, causal, segments, dtype); segments None,
#: 'padded' (documents with padding runs inside and at the end of rows) or
#: 'empty_row' (the same, with the last batch row all padding: rows with no
#: valid key). K2 takes 128 query rows and 128-key tiles, K3 128 query rows
#: and 64-key tiles, K4 128 keys and 64-row query tiles: T = 1, 65, 100, 129
#: sit at their edges, and T = 8192 is the LM path's length.
CASES = {
    'causal': (2, 320, 2, 128, True, None, BF16),
    'noncausal': (2, 320, 2, 128, False, None, BF16),
    'segmented': (2, 320, 2, 128, True, 'padded', BF16),
    'd64_ragged_t': (2, 200, 4, 64, True, None, BF16),
    'd64_ragged_t_segmented_noncausal': (1, 77, 2, 64, False, 'padded', BF16),
    't1': (2, 1, 2, 128, True, None, BF16),
    't1_d64_noncausal': (1, 1, 2, 64, False, None, BF16),
    't65_d64_noncausal': (1, 65, 2, 64, False, None, BF16),
    't100_below_one_tile': (2, 100, 2, 128, False, None, BF16),
    't129_one_past_a_tile': (1, 129, 2, 128, True, None, BF16),
    't129_d64_segmented': (2, 129, 2, 64, True, 'padded', BF16),
    'segmented_empty_row': (2, 300, 2, 128, True, 'empty_row', BF16),
    'd64_segmented_empty_row_noncausal': (2, 257, 2, 64, False, 'empty_row', BF16),
    't8192_causal': (1, 8192, 2, 128, True, None, BF16),
    't8192_d64_noncausal': (1, 8192, 2, 64, False, None, BF16),
    't8192_segmented_empty_row': (2, 8192, 1, 128, True, 'empty_row', BF16),
    'float32_simt': (2, 200, 2, 128, True, 'padded', torch.float32),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (K2-K4 have no CPU mode)')
    return torch.device('cuda')


def _segments(b, t, kind, device):
    seg = torch.zeros(b, t, dtype=torch.int32)
    for row in range(b):
        pos, ident = 3 * row, 1
        while pos < t - 10:
            seg[row, pos:pos + 5 + 7 * ident % 23] = ident
            pos += 5 + 7 * ident % 23 + (ident % 3 == 0) * 4   # some padding runs
            ident += 1
    if kind == 'empty_row':
        seg[-1] = 0
    return seg.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(CASES))
def test_kernels_match_plain_versions(card, case):
    b, t, h, d, causal, segmented, dtype = CASES[case]
    gen = torch.Generator().manual_seed(len(case))
    q, k, v, do = (torch.randn(b * h, t, d, generator=gen).to(card, dtype) for _ in range(4))
    segments = _segments(b, t, segmented, card) if segmented else None
    want, bound, lse, delta = flash.flash_reference(q, k, v, do, causal, segments, h)
    o, lse_got = flash.flash_forward(q, k, v, causal, segments, h)
    dq = flash.flash_bwd_dq(q, k, v, do, lse, delta, causal, segments, h)
    dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, delta, causal, segments, h)
    torch.cuda.synchronize()
    got = {'o': o, 'lse': lse_got, 'dq': dq, 'dk': dk, 'dv': dv}
    if t == 1:
        # a softmax over one key has no gradient in q or k: dq and dk are
        # rounding noise (~1e-6 here) on both sides, so they are held to 0
        for name in ('dq', 'dk'):
            assert float(got.pop(name).float().abs().max()) <= 2.0 ** -12, name
    for name, value in got.items():
        assert value.dtype == want[name].dtype and value.shape == want[name].shape, name
        result = flash.flash_compare(value, want[name], bound.get(name))
        assert result['ok'], (name, result)
    if segmented == 'empty_row':
        # rows with no valid key: o = 0 and lse = 0, and no gradient
        assert not o[-h:].float().abs().any() and not lse_got[-h:].abs().any()
        assert not dk[-h:].float().abs().any() and not dv[-h:].float().abs().any()
        assert not dq[-h:].float().abs().any()


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
