"""Single-device reference attention, the counterpart of
``petastorm_tpu.ops.ring_attention.dense_attention``. The ring itself
(sequence-parallel attention over a device ring) belongs to the distributed
slice and is not ported yet."""

import torch

_NEG_INF = -1e30


def dense_attention(q, k, v, causal=False):
    """Exact attention over ``[B, T, H, D]`` inputs: fp32 scores, masked
    scores set to ``-1e30`` before the softmax, the result cast back to
    ``q``'s dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    if causal:
        t_q, t_k = s.shape[-2], s.shape[-1]
        mask = (torch.arange(t_q, device=s.device)[:, None]
                >= torch.arange(t_k, device=s.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum('bhqk,bkhd->bqhd', p, v.float()).to(q.dtype)
