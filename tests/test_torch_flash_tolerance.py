"""The check that holds the bf16 tensor-core kernels (K2, K3 and K4 of
csrc/flash_attention_sm90.cuh) against their plain versions, exercised on the
CPU: ``flash_compare`` with the allowance of ``flash_reference``.

The kernels round each term P (forward and dK/dV) and dS (dQ and dK) to bf16
before the second product. Here that is emulated with plain torch on the
same inputs (made from a numpy seed, in bf16): the emulation must pass the
check, and the same emulation with one 64-key tile left out of the long rows
that see it must fail it, for each of o, dq, dk and dv."""

import importlib

import numpy as np
import pytest
import torch

flash = importlib.import_module('petastorm_tpu_torch.ops.flash_attention')

#: name -> (B, T, H, head_dim, causal, segmented)
CASES = {
    'causal': (2, 256, 2, 128, True, False),
    'noncausal': (2, 256, 2, 128, False, False),
    'segmented': (2, 256, 2, 128, True, True),
    'd64_ragged_t': (2, 200, 2, 64, True, False),
}
#: the dropped tile: keys [64, 128) for every query row from 64 on
DROP = (64, 64, 128)


def _inputs(b, t, h, d, segmented, seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(b * h, t, d).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    segments = None
    if segmented:
        seg = np.zeros((b, t), dtype=np.int32)
        for row in range(b):
            pos, ident = 0, 1
            while pos < t:
                n = int(rng.randint(5, 60))
                if rng.rand() > 0.2:   # else a padding run
                    seg[row, pos:pos + n] = ident
                    ident += 1
                pos += n
        segments = torch.from_numpy(seg)
    return q, k, v, do, segments


def _attends(t, causal, segments, heads, drop):
    """[BH or 1, T, T] boolean mask of the (query, key) pairs that count."""
    rows = torch.arange(t)[:, None]
    cols = torch.arange(t)[None, :]
    mask = (cols <= rows) if causal else torch.ones(t, t, dtype=torch.bool)
    mask = mask[None]
    if segments is not None:
        seg = segments.repeat_interleave(heads, dim=0)
        mask = mask & (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0)
    if drop is not None:
        row0, key0, key1 = drop
        mask = mask & ~((rows >= row0) & (cols >= key0) & (cols < key1))[None]
    return mask


def _emulated(q, k, v, do, lse, delta, causal, segments, heads, drop=None):
    """o, dq, dk and dv with the tensor-core kernels' numerics: fp32 scores,
    fp32 softmax sums, P (and dS) rounded to bf16 before the second product. The
    backward replays P from the plain forward's lse, as the kernels are fed."""
    bf16 = torch.bfloat16
    t, d = q.shape[1], q.shape[2]
    scale = d ** -0.5
    mask = _attends(t, causal, segments, heads, drop)
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    m = s.masked_fill(~mask, -1e30).amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(bf16).float(), v.float()) / torch.where(l > 0, l, torch.ones_like(l))
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    ds = p * (dp - delta[..., None])
    dv = torch.matmul(p.to(bf16).float().transpose(1, 2), do.float())
    dq = torch.matmul(ds.to(bf16).float(), k.float()) * scale
    dk = torch.matmul(ds.to(bf16).float().transpose(1, 2), q.float()) * scale
    return {'o': o.to(bf16), 'dq': dq.to(bf16), 'dk': dk.to(bf16), 'dv': dv.to(bf16)}


def _run(case, drop):
    b, t, h, d, causal, segmented = CASES[case]
    q, k, v, do, segments = _inputs(b, t, h, d, segmented, seed=len(case))
    want, bound, lse, delta = flash.flash_reference(q, k, v, do, causal, segments, h)
    got = _emulated(q, k, v, do, lse, delta, causal, segments, h, drop)
    return {name: flash.flash_compare(got[name], want[name], bound[name]) for name in got}


@pytest.mark.parametrize('case', sorted(CASES))
def test_tensor_core_numerics_pass_the_check(case):
    for name, result in _run(case, None).items():
        assert result['ok'], (name, result)


@pytest.mark.parametrize('case', sorted(CASES))
def test_a_dropped_key_tile_fails_the_check(case):
    for name, result in _run(case, DROP).items():
        assert not result['ok'], (name, result)
        assert result['tol_share'] > 2, (name, result)


def test_bf16_dq_gets_a_rounding_allowance_and_float32_none():
    rng = np.random.RandomState(7)
    inputs = [rng.randn(2, 64, 64).astype(np.float32) for _ in range(4)]
    _, bound, _, _ = flash.flash_reference(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in inputs), True)
    assert sorted(bound) == ['dk', 'dq', 'dv', 'o']
    assert bound['dq'].dtype == torch.float32 and bound['dq'].shape == (2, 64, 64)
    _, bound, _, _ = flash.flash_reference(*(torch.from_numpy(x) for x in inputs), True)
    assert 'dq' not in bound


def test_float32_outputs_get_no_rounding_allowance():
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(2, 64, 64, generator=gen) for _ in range(4))
    want, bound, _, _ = flash.flash_reference(q, k, v, do, True)
    assert bound == {}
    off = want['o'] * (1 + 2.0 ** -14)
    assert not flash.flash_compare(off, want['o'])['ok']
    assert flash.flash_compare(want['o'], want['o'])['ok']
