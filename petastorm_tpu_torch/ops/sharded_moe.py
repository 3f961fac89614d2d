"""Expert parallelism with the exchange written out: the counterpart of
``petastorm_tpu.ops.sharded_moe``.

The JAX package leaves the expert all-to-all of ``MoEMlp`` to XLA and spells it
out only inside ``shard_map``; torch has no compiler to place it, so the port's
expert parallelism is this module (``MoEMlp(expert_group=...)`` calls
:func:`expert_alltoall_ffn`). Its data path, on the same routing math
(:func:`petastorm_tpu_torch.models.moe.switch_routing`):

1. each rank dispatches its local tokens into per-expert capacity slots
   ``[experts, C_local, d]`` (a one-hot einsum, exact in any dtype);
2. ``torch.distributed.all_to_all_single`` over the expert group sends each
   expert's slots to the rank that holds it: ``[ne, local_experts, C, d]``
   split on its first dimension, in the group's rank order, so every rank then
   holds its own experts' slots from every peer, ``[local_experts, ne*C, d]``;
3. the local experts' FFN runs (two batched products and a tanh GELU);
4. the inverse exchange returns the results to the tokens' ranks, where the
   combine einsum weighs them back into token order in float32.

Rank ``i`` of the expert group holds experts ``i*X_local .. (i+1)*X_local - 1``:
build the group so that its rank order is the expert index
(:func:`~petastorm_tpu_torch.parallel.mesh.make_mesh` does). The gradient
goes through :class:`_AllToAll`, whose backward is the same exchange applied
to the gradient (with equal splits the all-to-all is its own transpose).
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
