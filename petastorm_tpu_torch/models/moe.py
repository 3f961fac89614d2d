"""Mixture-of-Experts layers: the counterpart of ``petastorm_tpu.models.moe``.

:func:`switch_routing` computes what the JAX function computes (top-k
routing with a static capacity ``C = ceil(capacity_factor * k * tokens /
experts)``, slot-major priority, one-hot dispatch and combine ``[S, X, C]``,
the Switch load-balance loss and the drop fraction), so :class:`MoEMlp`,
:class:`MoEBlock` and :class:`MoETransformerLM` take the flax weights
(:func:`petastorm_tpu_torch.convert.moe_state_dict_from_flax`) and agree with
them on outputs, losses and gradients. As there:

- the router is float32 on float32 tokens; ``w1``/``w2`` are float32
  ``[experts, d, f]`` / ``[experts, f, d]`` parameters cast to ``dtype``; the
  dispatch and FFN einsums run in ``dtype`` and the combine in float32;
- tokens past an expert's capacity get zero from the MoE branch and ride the
  block's residual.

Where the port differs:

- **Sown losses are outputs.** ``MoETransformerLM.forward`` returns ``(logits,
  losses)``, ``losses`` shaped like flax's ``'losses'`` collection
  (``{'MoEBlock_i': {'MoEMlp_0': {'moe_aux': t, 'moe_drop_fraction': t}}}``),
  which :func:`collect_sown`, :func:`moe_aux_total` and
  :func:`moe_drop_fractions` read. A module attribute written in ``forward``
  would be written again by a checkpoint recompute and go stale in a CUDA
  graph.
- **Expert parallelism is an explicit exchange.** The JAX ``MoEMlp`` leaves
  the all-to-all to XLA and routes over the global batch. Here
  ``MoEMlp(expert_group=...)`` holds only its rank's ``X / ne`` experts and
  runs :func:`~petastorm_tpu_torch.ops.sharded_moe.expert_alltoall_ffn`. It
  routes each rank's local tokens, with the capacity from the local count,
  as ``sharded_moe_ffn`` does: a defined difference from the JAX module,
  whose outputs it equals when no token is dropped; its losses are the
  rank's own.

Modules live on CUDA unless ``device='cpu'``; ``generator`` (a CPU
``torch.Generator``, None for torch's global one) draws the weights.
"""

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from petastorm_tpu_torch.models.transformer import (Block, Dense, LayerNorm, TransformerLM,
                                                    _lecun_normal_, attention_sublayer)
from petastorm_tpu_torch.ops.sharded_moe import expert_alltoall_ffn, gelu
from petastorm_tpu_torch.parallel.loader import resolve_device
from petastorm_tpu_torch.parallel.mesh import process_group


def _capacity(num_tokens, num_experts, num_selected, capacity_factor):
    cap = int(math.ceil(capacity_factor * num_selected * num_tokens / num_experts))
    return max(1, cap)


def switch_routing(probs, capacity, num_selected):
    """Top-k routing with static capacity: ``probs [S, X]`` (row softmax) ->
    ``(dispatch [S, X, C], combine [S, X, C], aux, drop_fraction)``.

    Slot-major priority: every first choice wins capacity before any second
    choice. Positions are an int32 cumsum, exact past 2^24 token-slots.
    ``torch.topk``'s order among equal probabilities is not fixed on CUDA
    (``lax.top_k`` takes the lower index), so tied routes may differ."""
    n_tokens, n_exp = probs.shape
    k = num_selected
    if k > n_exp:
        raise ValueError('num_selected={} exceeds num_experts={}'.format(k, n_exp))
    gate, expert_idx = torch.topk(probs, k, dim=-1)                       # [S, k]
    if k > 1:
        gate = gate / gate.sum(dim=-1, keepdim=True)

    onehot_i = F.one_hot(expert_idx, n_exp).to(torch.int32)              # [S, k, X]
    flat_i = onehot_i.transpose(0, 1).reshape(k * n_tokens, n_exp)       # slot-major
    flat = flat_i.float()
    pos_in_expert = torch.cumsum(flat_i, dim=0, dtype=torch.int32) - flat_i
    position = (pos_in_expert * flat_i).sum(dim=-1, dtype=torch.int32)   # [kS]
    keep = flat.sum(dim=-1) * (position < capacity).float()              # [kS]

    # one-hot of the position; a position past capacity gives a zero row
    pos_onehot = (position[:, None] == torch.arange(capacity, device=probs.device)).float()
    dispatch_flat = flat[:, :, None] * pos_onehot[:, None, :] * keep[:, None, None]
    gate_flat = gate.transpose(0, 1).reshape(k * n_tokens)
    combine_flat = dispatch_flat * gate_flat[:, None, None]
    dispatch = dispatch_flat.reshape(k, n_tokens, n_exp, capacity).sum(0)
    combine = combine_flat.reshape(k, n_tokens, n_exp, capacity).sum(0)

    # Switch load-balance loss: X * sum_x f_x * P_x, 1 when routing is uniform
    frac_tokens = onehot_i[:, 0, :].float().mean(dim=0)
    aux = n_exp * (frac_tokens * probs.mean(dim=0)).sum()
    drop_fraction = 1.0 - keep.sum() / float(k * n_tokens)
    return dispatch, combine, aux, drop_fraction


class MoEMlp(nn.Module):
    """Top-k routed expert MLP ``[B, T, D] -> ([B, T, D], losses)``, with
    ``losses = {'moe_aux': aux, 'moe_drop_fraction': drop}``.

    ``expert_group`` (a ``ProcessGroup`` or a one-dimensional ``DeviceMesh``
    of ``ne`` ranks) shards the experts: rank ``i`` of the group holds experts
    ``i*X/ne .. (i+1)*X/ne - 1`` (drawn as the whole tensor, so the shards of
    one generator seed make up the unsharded module's weights) and the
    forward runs the all-to-all exchange, routing this rank's tokens."""

    def __init__(self, embed, num_experts, capacity_factor=1.25, num_selected=1,
                 hidden_mult=4, dtype=torch.bfloat16, expert_group=None, device=None,
                 generator=None):
        super().__init__()
        if num_selected > num_experts:
            raise ValueError('num_selected={} exceeds num_experts={}'.format(
                num_selected, num_experts))
        device = resolve_device(device)
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.num_selected = num_selected
        self.dtype = dtype
        self.expert_group = None if expert_group is None else process_group(expert_group)
        rank, size = 0, 1
        if self.expert_group is not None:
            rank, size = dist.get_rank(self.expert_group), dist.get_world_size(self.expert_group)
        if num_experts % size:
            raise ValueError('experts {} not divisible by expert group size {}'.format(
                num_experts, size))
        local = num_experts // size
        hidden = hidden_mult * embed
        self.router = Dense(embed, num_experts, bias=False, dtype=torch.float32,
                            generator=generator)
        w1 = torch.empty(num_experts, embed, hidden)
        _lecun_normal_(w1, embed, generator)
        w2 = torch.empty(num_experts, hidden, embed)
        _lecun_normal_(w2, hidden, generator)
        self.w1 = nn.Parameter(w1[rank * local:(rank + 1) * local].clone())
        self.w2 = nn.Parameter(w2[rank * local:(rank + 1) * local].clone())
        self.to(device)

    def forward(self, x):
        batch, seqlen, d = x.shape
        n_tokens = batch * seqlen
        cap = _capacity(n_tokens, self.num_experts, self.num_selected, self.capacity_factor)
        tokens = x.reshape(n_tokens, d)
        # the router in float32: the softmax over experts must not run in bf16
        probs = torch.softmax(self.router(tokens.float()), dim=-1)            # [S, X]
        dispatch, combine, aux, drop_fraction = switch_routing(probs, cap, self.num_selected)
        compute = self.dtype
        if self.expert_group is not None:
            y = expert_alltoall_ffn(tokens.to(compute), dispatch, combine, self.w1, self.w2,
                                    self.expert_group)
        else:
            expert_in = torch.einsum('sd,sxc->xcd', tokens.to(compute),
                                     dispatch.to(compute))                    # [X, C, D]
            h = gelu(torch.einsum('xcd,xdf->xcf', expert_in, self.w1.to(compute)))
            expert_out = torch.einsum('xcf,xfd->xcd', h, self.w2.to(compute))
            y = torch.einsum('xcd,sxc->sd', expert_out.float(), combine.float())
        losses = {'moe_aux': aux, 'moe_drop_fraction': drop_fraction}
        return y.reshape(batch, seqlen, d).to(x.dtype), losses


class MoEBlock(nn.Module):
    """Pre-norm transformer block whose MLP is a routed expert MLP:
    ``forward(x, attention_fn) -> (x, {'MoEMlp_0': losses})``."""

    def __init__(self, embed, heads, num_experts, capacity_factor=1.25, num_selected=1,
                 dtype=torch.bfloat16, expert_group=None, generator=None):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        self.norm_attn = LayerNorm(embed)
        self.qkv = Dense(embed, 3 * embed, bias=False, dtype=dtype, generator=generator)
        self.proj = Dense(embed, embed, bias=False, dtype=dtype, generator=generator)
        self.norm_mlp = LayerNorm(embed)
        self.moe = MoEMlp(embed, num_experts, capacity_factor, num_selected, dtype=dtype,
                          expert_group=expert_group, device='cpu', generator=generator)

    def forward(self, x, attention_fn):
        x = attention_sublayer(x, self.heads, attention_fn, self.norm_attn, self.qkv,
                               self.proj)
        y, losses = self.moe(self.norm_mlp(x).to(self.dtype))
        return x + y, {'MoEMlp_0': losses}


class MoETransformerLM(TransformerLM):
    """Decoder-only LM with routed-expert blocks: tokens ``[B, T]`` ->
    ``(logits [B, T, vocab] float32, losses)``. Block ``i`` is an
    :class:`MoEBlock` when ``(i + 1) % moe_every == 0`` (1: all), else a dense
    :class:`~petastorm_tpu_torch.models.transformer.Block`. ``expert_group``
    shards every MoE layer's experts over a process group (see
    :class:`MoEMlp`)."""

    def __init__(self, vocab=256, embed=64, heads=4, layers=2, num_experts=4,
                 capacity_factor=1.25, num_selected=1, moe_every=1, max_len=8192,
                 dtype=torch.bfloat16, attention_fn=None, expert_group=None, remat=False,
                 device=None, generator=None):
        # plain attributes, set before the base class builds the blocks
        # through make_block
        self._moe = dict(num_experts=num_experts, capacity_factor=capacity_factor,
                         num_selected=num_selected, expert_group=expert_group)
        self.moe_every = moe_every
        super().__init__(vocab, embed, heads, layers, max_len, dtype, attention_fn, remat,
                         device, generator)

    def make_block(self, index, embed, heads, dtype, generator):
        if (index + 1) % self.moe_every:
            return Block(embed, heads, dtype, generator)
        return MoEBlock(embed, heads, dtype=dtype, generator=generator, **self._moe)

    def forward(self, tokens, positions=None, attention_fn=None):
        """``positions`` (optional ``[B, T]`` int) restart packed documents at
        0; ``attention_fn`` overrides the constructor's for this call."""
        attention_fn = attention_fn or self.attention_fn
        x = self.embed(tokens, positions)
        losses = {}
        for block in self.blocks:
            x = self.run_block(block, x, attention_fn)
            if isinstance(block, MoEBlock):
                x, sown = x
                losses['MoEBlock_{}'.format(len(losses))] = sown
        return self.head(self.norm(x)), losses


def collect_sown(losses, sown_key):
    """Every MoE layer's ``sown_key`` value from the ``losses`` dict that
    :class:`MoETransformerLM` returns, in layer order."""
    leaves = []

    def visit(tree, under_key=False):
        if isinstance(tree, dict):
            for key, sub in tree.items():
                visit(sub, under_key or key == sown_key)
        elif under_key:
            leaves.append(tree)

    visit(losses)
    return leaves


def moe_aux_total(losses, weight=1.0):
    """The sum of every MoE layer's Switch load-balance loss, times
    ``weight``; 0 for a model with no MoE layer."""
    leaves = collect_sown(losses, 'moe_aux')
    if not leaves:
        return torch.zeros(())
    return weight * sum(leaves)


def moe_drop_fractions(losses):
    """Every MoE layer's capacity drop fraction (a list of scalars; empty when
    the model has no MoE layer)."""
    return collect_sown(losses, 'moe_drop_fraction')


#: the mesh axis that expert_partition_specs shards the experts over
EXPERT_AXIS = 'expert'


def expert_partition_specs(state_dict):
    """Per-dimension specs of a ``state_dict``'s tensors, as the JAX package's
    ``PartitionSpec`` s: ``(EXPERT_AXIS, None, None)`` for the 3-D ``w1``/``w2``
    of an :class:`MoEMlp` (one with a ``router`` beside it, nested or at the
    root), a tuple of None for everything else. A ``w1``/``w2`` beside a
    router that is not 3-D (stacked or scanned layers) raises: its specs must
    be written by hand."""
    router_scopes = set()
    for name in state_dict:
        parts = name.split('.')
        if 'router' in parts:
            router_scopes.add(tuple(parts[:parts.index('router')]))
    specs = {}
    for name, tensor in state_dict.items():
        parts = name.split('.')
        ndim = tensor.dim()
        if parts[-1] in ('w1', 'w2') and tuple(parts[:-1]) in router_scopes:
            if ndim != 3:
                raise ValueError('MoE expert weight {} has ndim {} (expected 3): stacked '
                                 'MoE weights need hand-written specs'.format(name, ndim))
            specs[name] = (EXPERT_AXIS, None, None)
        else:
            specs[name] = (None,) * ndim
    return specs
