"""Expert parallelism with the exchange written out: the counterpart of
``petastorm_tpu.ops.sharded_moe``, and the exchange of ``MoEMlp``.

The JAX package leaves the expert exchange of ``MoEMlp`` to XLA and spells
out an all-to-all only inside ``shard_map``; torch has no compiler to place
either, so this module writes both.

:func:`sharded_moe_ffn` and :func:`expert_alltoall_ffn` are the twins of the
JAX functions: routing on each rank's own tokens, with the capacity of the
local count, and the all-to-all:

1. each rank dispatches its local tokens into per-expert capacity slots
   ``[experts, C_local, d]`` (a one-hot einsum, exact in any dtype);
2. ``torch.distributed.all_to_all_single`` over the expert group sends each
   expert's slots to the rank that holds it: ``[ne, local_experts, C, d]``
   split on its first dimension, in the group's rank order, so every rank then
   holds its own experts' slots from every peer, ``[local_experts, ne*C, d]``;
3. the local experts' FFN runs (two batched products and a tanh GELU);
4. the inverse exchange returns the results to the tokens' ranks, where the
   combine einsum weighs them back into token order in float32.

:func:`routed_expert_ffn` is ``MoEMlp`` 's expert FFN, on routing over the
global batch (:func:`~petastorm_tpu_torch.models.moe.global_routing`); on
one device (no groups) it exchanges nothing. Across ranks it keeps the
layout that GSPMD gives the JAX module's sharding hints (``expert_in``
sharded over ``'expert'`` only): every rank scatters its kept assignments
into a zero ``[X, C_global, d]`` buffer, the buffer is summed over the batch
group (the ranks' slots are disjoint, so the sum is exact), each rank runs
its ``X / ne`` experts on its slice, the outputs are gathered over the
expert group, and each rank combines its own tokens' slots in float32.

Rank ``i`` of the expert group holds experts ``i*X_local .. (i+1)*X_local - 1``:
build the group so that its rank order is the expert index
(:func:`~petastorm_tpu_torch.parallel.mesh.make_mesh` does). Every exchange
is an ``autograd.Function`` whose backward is its transpose:
:class:`_AllToAll` exchanges the gradient the same way (with equal splits the
all-to-all is its own transpose), :class:`_AllReduce` sums it, and
:class:`_AllGather` reduce-scatters it (each rank gets its own piece, summed
over the group). Each rank's loss is its share of the global one, so the
gather's backward sums; ``ring_attention_sharded`` 's gather keeps the
rank's slice instead, because there every rank takes the same loss from the
gathered tensor. (``torch.distributed.nn.functional`` is deprecated in
torch 2.13, and its ``all_gather`` backward on a gloo subgroup names the
peers by their global ranks.)
"""

import functools

import torch
import torch.distributed as dist
import torch.nn.functional as F

from petastorm_tpu_torch.parallel.mesh import process_group

#: flax ``nn.gelu``: the tanh approximation
gelu = functools.partial(F.gelu, approximate='tanh')


def _all_to_all(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


#: torch 2.13 names ``reduce_scatter_tensor`` ``reduce_scatter_single``
_reduce_scatter = getattr(dist, 'reduce_scatter_single', None) or dist.reduce_scatter_tensor


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over ``group`` with equal splits of dim 0,
    differentiable: the backward exchanges the gradient the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


class _AllReduce(torch.autograd.Function):
    """``all_reduce`` (sum) over ``group``, differentiable: every rank gets
    the sum, so each rank's input gradient is the sum of every rank's output
    gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _AllGather(torch.autograd.Function):
    """Every rank's ``x`` concatenated on dim 0 in ``group`` 's rank order,
    differentiable: the gradient is reduce-scattered, so each rank gets its
    own piece summed over the group (``1 / ne`` of an all-reduce's bytes)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        out = grad.new_empty(grad.shape[0] // dist.get_world_size(ctx.group), *grad.shape[1:])
        _reduce_scatter(out, grad, group=ctx.group)
        return out, None


def all_reduce_sum(x, group):
    """``x`` summed over ``group`` (a ``ProcessGroup`` or a one-dimensional
    ``DeviceMesh``); its gradient is summed over the group too."""
    return _AllReduce.apply(x, process_group(group))


def expert_alltoall_ffn(tokens, dispatch, combine, w1, w2, group):
    """The expert FFN with the all-to-all exchange over ``group``.

    :param tokens: ``[S_local, d]`` this rank's tokens.
    :param dispatch: ``[S_local, X, C_local]`` dispatch mask over all ``X``
        experts (from :func:`~petastorm_tpu_torch.models.moe.switch_routing` on
        this rank's router probabilities).
    :param combine: ``[S_local, X, C_local]`` the matching combine weights.
    :param w1: ``[X_local, d, f]`` this rank's experts (``X_local = X / ne``).
    :param w2: ``[X_local, f, d]`` likewise.
    :param group: the expert group (a ``ProcessGroup`` or a one-dimensional
        ``DeviceMesh``) of ``ne`` ranks.
    :returns: ``[S_local, d]`` expert outputs in token order, in ``tokens``'
        dtype (combined in float32).
    """
    group = process_group(group)
    ne = dist.get_world_size(group)
    n_exp = dispatch.shape[1]
    if n_exp % ne != 0:
        raise ValueError('experts {} not divisible by expert group size {}'.format(n_exp, ne))
    x_local = n_exp // ne
    if w1.shape[0] != x_local or w2.shape[0] != x_local:
        raise ValueError('expert weight leading dim {} != local experts {} '
                         '(= {} experts / {} ranks)'.format(w1.shape[0], x_local, n_exp, ne))
    cap = dispatch.shape[2]
    dtype = tokens.dtype

    # [S, X, C] x [S, d] -> [X, C, d]: local tokens into capacity slots
    slots = torch.einsum('sxc,sd->xcd', dispatch.to(dtype), tokens)
    # grouped by owning rank and exchanged: dim 0 becomes the source rank,
    # dim 1 this rank's local experts
    slots = _AllToAll.apply(slots.reshape(ne, x_local, cap, -1), group)
    slots = slots.transpose(0, 1).reshape(x_local, ne * cap, -1)

    h = gelu(torch.einsum('xcd,xdf->xcf', slots, w1.to(dtype)))
    out = torch.einsum('xcf,xfd->xcd', h, w2.to(dtype))

    # the inverse exchange, back to the tokens' ranks, then the combine
    out = out.reshape(x_local, ne, cap, -1).transpose(0, 1)
    out = _AllToAll.apply(out, group).reshape(n_exp, cap, -1)
    return torch.einsum('xcd,sxc->sd', out.float(), combine.float()).to(dtype)


def sharded_moe_ffn(tokens, router_kernel, w1, w2, group, capacity_factor=1.25,
                    num_selected=1):
    """Routing, exchange and FFN in one call: ``[S_local, d]`` -> ``([S_local,
    d], aux, drop_fraction)``.

    Routing runs on this rank's tokens with ``router_kernel [d, X]`` (the same
    on every rank of the group); the capacity comes from the local token
    count. ``aux`` and ``drop_fraction`` are this rank's; average them over
    the data ranks for the global values."""
    from petastorm_tpu_torch.models.moe import _capacity, switch_routing
    n_exp = router_kernel.shape[1]
    probs = torch.softmax(tokens.float() @ router_kernel.float(), dim=-1)
    cap = _capacity(tokens.shape[0], n_exp, num_selected, capacity_factor)
    dispatch, combine, aux, drop_fraction = switch_routing(probs, cap, num_selected)
    out = expert_alltoall_ffn(tokens, dispatch, combine, w1, w2, group)
    return out, aux, drop_fraction


def routed_expert_ffn(tokens, slots, gate, capacity, w1, w2, batch_group=None,
                      expert_group=None):
    """The expert FFN on routing over the global batch: ``[S_local, d]`` ->
    ``[S_local, d]`` float32.

    :param tokens: ``[S_local, d]`` this rank's tokens, in the compute dtype.
    :param slots: ``[S_local, k]`` int64, each assignment's slot ``expert *
        capacity + position`` in the global order, ``X * capacity`` or more
        where it was dropped (from
        :func:`~petastorm_tpu_torch.models.moe.global_routing`).
    :param gate: ``[S_local, k]`` float32 gate weights.
    :param capacity: ``C_global``, the slots of one expert.
    :param w1: ``[X_local, d, f]`` this rank's experts (``X_local = X / ne``).
    :param w2: ``[X_local, f, d]`` likewise.
    :param batch_group: the ranks that hold distinct tokens (None: this
        rank's tokens are the whole batch).
    :param expert_group: the ``ne`` ranks that share out the experts (None:
        this rank holds all of them).
    """
    index, ne = 0, 1
    if expert_group is not None:
        expert_group = process_group(expert_group)
        index, ne = dist.get_rank(expert_group), dist.get_world_size(expert_group)
    x_local = w1.shape[0]
    n_exp, dtype, width = x_local * ne, tokens.dtype, tokens.shape[1]
    rows = n_exp * capacity
    assignments = slots.numel()
    # every assignment gets a row of its own: its slot when kept, one past the
    # X * C slots when dropped. No index repeats, so the copy in and the
    # gather out (and their backward passes) have no collisions to serialize.
    flat = slots.reshape(-1)
    flat = torch.where(flat < rows, flat, rows + torch.arange(assignments, device=flat.device))
    source = tokens[:, None, :].expand(-1, slots.shape[1], -1).reshape(-1, width)
    expert_in = tokens.new_zeros(rows + assignments, width).index_copy(0, flat, source)[:rows]
    if batch_group is not None:
        expert_in = all_reduce_sum(expert_in, batch_group)
    expert_in = expert_in.view(n_exp, capacity, width)[index * x_local:(index + 1) * x_local]

    h = gelu(torch.einsum('xcd,xdf->xcf', expert_in, w1.to(dtype)))
    out = torch.einsum('xcf,xfd->xcd', h, w2.to(dtype))
    if expert_group is not None:
        out = _AllGather.apply(out, expert_group)                            # [X, C, d]

    # each assignment's slot back in token order (zero rows for the dropped),
    # weighed in float32
    out = torch.cat([out.reshape(rows, width).float(),
                     out.new_zeros(assignments, width, dtype=torch.float32)])
    return (out.index_select(0, flat).view(*slots.shape, width) * gate[..., None]).sum(dim=1)
