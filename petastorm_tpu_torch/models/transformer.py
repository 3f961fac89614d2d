"""TransformerLM: a decoder-only language model that computes what
``petastorm_tpu.models.transformer.TransformerLM`` (flax) computes, so
weights carry over (:func:`petastorm_tpu_torch.convert.transformer_state_dict_from_flax`)
and the two agree on logits and gradients.

Matching flax, not torch defaults:

- Parameters are float32 masters cast to ``dtype`` (bfloat16 by default) at
  use, as flax ``Dense(dtype=...)`` and ``Embed(dtype=...)`` do; the residual
  stream is in ``dtype``.
- LayerNorm computes in float32 with ``epsilon=1e-6`` and flax's fast
  variance ``E[x^2] - E[x]^2``, then is cast back to ``dtype`` inside blocks.
- The MLP's GELU is the tanh approximation (flax ``nn.gelu``).
- The final LayerNorm and projection run in float32 and give float32 logits.
- ``qkv`` splits into q, k, v along the last axis, each reshaped to
  ``[B, T, H, D]``.

``attention_fn(q, k, v)`` takes and returns ``[B, T, H, D]``: dense causal
attention by default, :func:`~petastorm_tpu_torch.ops.flash_attention.flash_attention`
for the flash kernels, and for packed batches a per-batch
:func:`~petastorm_tpu_torch.ops.packing.segment_causal_attention` passed to
``forward`` (a flax model is rebuilt per batch for that; a torch module keeps
its parameters, so the batch's attention is a call argument). ``remat=True``
recomputes each block in the backward (``torch.utils.checkpoint``). The
model lives on CUDA unless ``device='cpu'`` is passed.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from petastorm_tpu_torch.ops.ring_attention import dense_attention
from petastorm_tpu_torch.parallel.loader import resolve_device

_LN_EPS = 1e-6


def dense_causal_attention(q, k, v):
    """``[B, T, H, D]`` exact causal attention (fp32 scores)."""
    return dense_attention(q, k, v, causal=True)


def _lecun_normal_(weight, fan_in, generator=None):
    # flax's default kernel init: truncated normal with variance 1 / fan_in
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


class Dense(nn.Module):
    """flax ``nn.Dense``: a float32 ``(out, in)`` weight (and bias) cast to
    ``dtype`` with the input. ``generator`` (a CPU ``torch.Generator``, or
    None for torch's global one) draws the weight."""

    def __init__(self, features_in, features_out, bias=True, dtype=torch.bfloat16,
                 generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features_out, features_in))
        self.bias = nn.Parameter(torch.zeros(features_out)) if bias else None
        self.dtype = dtype
        _lecun_normal_(self.weight, features_in, generator)

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class Embed(nn.Module):
    """flax ``nn.Embed``: a float32 ``(num, features)`` table cast to ``dtype``
    before the lookup."""

    def __init__(self, num, features, dtype=torch.bfloat16, generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(num, features, generator=generator)
                                   / math.sqrt(features))
        self.dtype = dtype

    def forward(self, ids):
        return F.embedding(ids.long(), self.weight.to(self.dtype))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: float32 statistics with the fast
    variance and ``epsilon=1e-6``; float32 output."""

    def __init__(self, features):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * torch.rsqrt(var + _LN_EPS) * self.weight + self.bias


def attention_sublayer(x, heads, attention_fn, norm, qkv, proj):
    """Pre-norm attention with residual, shared by :class:`Block`."""
    b, t, embed = x.shape
    h = norm(x).to(x.dtype)
    q, k, v = torch.split(qkv(h), embed, dim=-1)
    shape = (b, t, heads, embed // heads)
    attn = attention_fn(q.reshape(shape), k.reshape(shape), v.reshape(shape))
    return x + proj(attn.reshape(b, t, embed))


class Block(nn.Module):
    """Pre-norm transformer block: attention, then a 4x GELU MLP, each with
    its residual."""

    def __init__(self, embed, heads, dtype=torch.bfloat16, generator=None):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        self.norm_attn = LayerNorm(embed)
        self.qkv = Dense(embed, 3 * embed, bias=False, dtype=dtype, generator=generator)
        self.proj = Dense(embed, embed, bias=False, dtype=dtype, generator=generator)
        self.norm_mlp = LayerNorm(embed)
        self.mlp_up = Dense(embed, 4 * embed, dtype=dtype, generator=generator)
        self.mlp_down = Dense(4 * embed, embed, dtype=dtype, generator=generator)

    def forward(self, x, attention_fn):
        x = attention_sublayer(x, self.heads, attention_fn, self.norm_attn, self.qkv,
                               self.proj)
        h = self.norm_mlp(x).to(self.dtype)
        h = F.gelu(self.mlp_up(h), approximate='tanh')
        return x + self.mlp_down(h)


class TransformerLM(nn.Module):
    """Decoder-only LM: tokens ``[B, T]`` int -> logits ``[B, T, vocab]``
    float32. Parameters live on ``device`` (CUDA unless ``'cpu'``);
    ``generator`` (a CPU ``torch.Generator``, None for torch's global one)
    draws them."""

    def __init__(self, vocab=256, embed=64, heads=4, layers=2, max_len=8192,
                 dtype=torch.bfloat16, attention_fn=None, remat=False, device=None,
                 generator=None):
        super().__init__()
        if embed % heads != 0:
            raise ValueError('embed={} must be divisible by heads={}'.format(embed, heads))
        device = resolve_device(device)
        self.max_len = max_len
        self.dtype = dtype
        self.attention_fn = attention_fn or dense_causal_attention
        self.remat = remat
        self.tok_embed = Embed(vocab, embed, dtype=dtype, generator=generator)
        self.pos_embed = Embed(max_len, embed, dtype=dtype, generator=generator)
        self.blocks = nn.ModuleList(self.make_block(i, embed, heads, dtype, generator)
                                    for i in range(layers))
        self.norm = LayerNorm(embed)
        self.head = Dense(embed, vocab, dtype=torch.float32, generator=generator)
        self.to(device)

    def make_block(self, index, embed, heads, dtype, generator):
        """Block ``index`` of the stack (a subclass picks another kind)."""
        return Block(embed, heads, dtype, generator)

    def embed(self, tokens, positions=None):
        """Token plus position embeddings; ``positions`` None means
        ``arange(T)``."""
        t = tokens.shape[1]
        if t > self.max_len:
            raise ValueError('sequence length {} exceeds max_len={}; raise max_len'
                             .format(t, self.max_len))
        x = self.tok_embed(tokens)
        if positions is None:
            return x + self.pos_embed(torch.arange(t, device=tokens.device))[None]
        return x + self.pos_embed(positions)

    def run_block(self, block, x, attention_fn):
        """``block(x, attention_fn)``, recomputed in the backward
        (``torch.utils.checkpoint``) when ``remat`` is set."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, x, attention_fn, use_reentrant=False)
        return block(x, attention_fn)

    def forward(self, tokens, positions=None, attention_fn=None):
        """``positions`` (optional ``[B, T]`` int): per-token position ids, such
        as a packed batch's ``*_positions`` column, so each packed document
        restarts at 0; None means ``arange(T)``. ``attention_fn`` overrides
        the constructor's for this call."""
        attention_fn = attention_fn or self.attention_fn
        x = self.embed(tokens, positions)
        for block in self.blocks:
            x = self.run_block(block, x, attention_fn)
        return self.head(self.norm(x))


def next_token_loss(logits, tokens):
    """Causal LM loss: predict token t+1 from positions <= t. Requires T >= 2."""
    if tokens.shape[1] < 2:
        raise ValueError('next_token_loss needs sequences of length >= 2 (got {}): '
                         'the mean over zero predicted positions would be NaN'
                         .format(tokens.shape[1]))
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    return -torch.gather(logp, -1, tokens[:, 1:, None].long()).mean()
