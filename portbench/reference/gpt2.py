"""A GPT-2 decoder (Radford et al. 2019, "Language Models are Unsupervised
Multitask Learners") in plain PyTorch, float32, on a dict of weights, over
packed batches.

Pre-LN blocks: ``x + proj(attn(ln(x)))``, then ``x + down(gelu(up(ln(x))))``
with the tanh GELU; learned positions added to the token embeddings; a final
LayerNorm and a linear head with a bias. Attention is causal within each
packed document: a token attends to earlier tokens of its own segment, and
padding (segment 0) attends nowhere (its output is zero). The loss is the
mean negative log-likelihood of each next token that lies in the same
document. ``cfg`` gives ``layers``, ``heads`` and ``layer_norm_epsilon``.
Weight names: ``tok_embed.weight``, ``pos_embed.weight``,
``blocks.<i>.{norm_attn,norm_mlp}.{weight,bias}``,
``blocks.<i>.{qkv,proj}.weight`` (``(out, in)``, q, k and v stacked in
that order along the output), ``blocks.<i>.{mlp_up,mlp_down}.{weight,bias}``,
``norm.{weight,bias}``, ``head.{weight,bias}``.

Each block and each slice of the head is recomputed in the backward, so a
batch of 16 x 1024 tokens at GPT-2 medium's widths fits beside nothing else
on one card.
"""

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.precision import EXACT

#: rows of the head computed at once
HEAD_ROWS = 2048


def gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def attention_mask(segments):
    """``[B, 1, T, T]``: key in the query's segment, not after it, not padding."""
    t = segments.shape[1]
    same = segments[:, :, None] == segments[:, None, :]
    causal = torch.ones(t, t, dtype=torch.bool, device=segments.device).tril()
    return (same & causal & (segments[:, None, :] > 0))[:, None]


def linear(x, weight, bias, rounding):
    out = rounding(x) @ rounding(weight).t()
    return out if bias is None else out + bias


def block(x, mask, weights, heads, eps, precision):
    norm_attn_w, norm_attn_b, qkv, proj, norm_mlp_w, norm_mlp_b, up_w, up_b, down_w, down_b = \
        weights
    b, t, e = x.shape
    h = F.layer_norm(x, (e,), norm_attn_w, norm_attn_b, eps)
    q, k, v = linear(h, qkv, None, precision.low).split(e, dim=-1)
    q, k, v = (y.reshape(b, t, heads, e // heads).transpose(1, 2) for y in (q, k, v))
    scores = (precision.low(q) @ precision.low(k).transpose(-1, -2)) / math.sqrt(e // heads)
    probs = torch.softmax(scores.masked_fill(~mask, -1e30), dim=-1)
    probs = probs * mask.any(dim=-1, keepdim=True)    # padding rows attend nowhere
    attn = (precision.low(probs) @ precision.low(v)).transpose(1, 2).reshape(b, t, e)
    x = x + linear(attn, proj, None, precision.low)
    h = F.layer_norm(x, (e,), norm_mlp_w, norm_mlp_b, eps)
    return x + linear(gelu(linear(h, up_w, up_b, precision.low)), down_w, down_b,
                      precision.low)


def _head_nll(h, weight, bias, targets, rounding):
    logp = torch.log_softmax(linear(h, weight, bias, rounding), dim=-1)
    return -logp.gather(1, targets[:, None])[:, 0]


def hidden(params, batch, cfg, precision=EXACT):
    """The final LayerNorm's output ``[B, T, E]`` for ``batch`` (``tokens``,
    ``segments``, ``positions``: ``[B, T]`` int64)."""
    eps = cfg['layer_norm_epsilon']
    x = params['tok_embed.weight'][batch['tokens']] + params['pos_embed.weight'][
        batch['positions']]
    mask = attention_mask(batch['segments'])
    names = ('norm_attn.weight', 'norm_attn.bias', 'qkv.weight', 'proj.weight',
             'norm_mlp.weight', 'norm_mlp.bias', 'mlp_up.weight', 'mlp_up.bias',
             'mlp_down.weight', 'mlp_down.bias')
    for i in range(cfg['layers']):
        weights = tuple(params['blocks.{}.{}'.format(i, name)] for name in names)
        x = checkpoint(block, x, mask, weights, cfg['heads'], eps, precision,
                       use_reentrant=False)
    return F.layer_norm(x, (x.shape[-1],), params['norm.weight'], params['norm.bias'], eps)


def next_token_valid(segments):
    """``[B, T-1]``: position t predicts t+1 inside one document."""
    return (segments[:, 1:] == segments[:, :-1]) & (segments[:, :-1] > 0)


def loss(params, batch, cfg, precision=EXACT):
    """Mean next-token NLL over the valid positions of ``batch``;
    ``batch['rows']``, when given, keeps only those rows."""
    if 'rows' in batch:
        batch = {name: batch[name][batch['rows']] for name in ('tokens', 'segments',
                                                                'positions')}
    h = hidden(params, batch, cfg, precision)[:, :-1]
    valid = next_token_valid(batch['segments'])
    rows = h[valid]
    targets = batch['tokens'][:, 1:][valid]
    total = rows[:0].sum()     # zero, on the graph even with no valid position
    for start in range(0, rows.shape[0], HEAD_ROWS):
        total = total + checkpoint(_head_nll, rows[start:start + HEAD_ROWS],
                                   params['head.weight'], params['head.bias'],
                                   targets[start:start + HEAD_ROWS], precision.high,
                                   use_reentrant=False).sum()
    return total / max(int(valid.sum()), 1)


def logits_at(params, batch, cfg, rows, cols, precision=EXACT):
    """Logits ``[len(rows), vocab]`` at positions ``(rows, cols)`` of ``batch``."""
    with torch.no_grad():
        h = hidden(params, batch, cfg, precision)[rows, cols]
        return linear(h, params['head.weight'], params['head.bias'], precision.high)
