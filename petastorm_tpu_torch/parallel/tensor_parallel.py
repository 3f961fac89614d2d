"""Tensor parallelism over one dimension of a ``DeviceMesh``, and the
composed dp + sp + tp language model built from it.

The JAX package has no tensor-parallel module: inside ``shard_map`` a
stage calls ``jax.lax.psum(..., 'model')``, and outside it GSPMD inserts
the all-reduce that weights placed ``P(None, 'model')`` and ``P('model',
None)`` need (``__graft_entry__.py``'s dryrun). torch places nothing by
itself, so the port spells the exchange out:

- :func:`copy_to_group` and :func:`reduce_from_group`, Megatron's f and g:
  f is the identity forward and an all-reduce of the gradient backward (the
  input of a column-cut product, whose model ranks each give a partial
  gradient); g is an all-reduce forward and the identity backward (the
  output of a row-cut product, the same on every model rank afterwards).
  Between them the model ranks' gradients of everything outside the cut
  product are already equal, so no parameter's gradient is summed over the
  model dimension.
- :func:`shard_by_spec`: this rank's piece of a global tensor laid out by a
  :class:`~petastorm_tpu_torch.parallel.mesh.PartitionSpec` on a mesh.
- :func:`reduce_gradients`: the step GSPMD takes silently: each
  parameter's gradient summed over the mesh dimensions that split the batch
  (``'data'``, ``'seq'``) and that its spec leaves unsharded. The loss must
  be each rank's share of the global mean (its partial sum over the global
  count), so that the sum is the global gradient. Leaving it out gives the
  right loss with gradients short of the other batch shards'; summing over
  ``'model'`` as well gives gradients ``model`` times too large.
- :func:`sum_over`, :func:`next_token_targets`: a global loss over a batch
  split over ``'data'`` and ``'seq'``.
- :class:`ColumnCutDense`, :class:`RowCutDense`: a ``Dense`` cut over
  ``'model'`` by output features with f before it, or by input features
  with g after it.
- :class:`TensorParallelLM`: a
  :class:`~petastorm_tpu_torch.models.transformer.TransformerLM` trained on
  a ``('data', 'seq', 'model')`` mesh: each block's MLP cut over
  ``'model'`` (``mlp_up`` by output features, ``mlp_down`` by input
  features) and run through f and g, causal
  :func:`~petastorm_tpu_torch.ops.ring_attention.ring_attention` over
  ``'seq'`` (the flash kernels on each block), the batch over ``'data'``.
"""

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from petastorm_tpu_torch.models.transformer import Dense
from petastorm_tpu_torch.ops.ring_attention import _shard, ring_attention
from petastorm_tpu_torch.parallel.mesh import PartitionSpec, Ring, process_group, spec_axes

#: the mesh dimensions that split a batch
BATCH_AXES = ('data', 'seq')


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: the identity forward, the gradient all-reduced over the
    group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: all-reduce forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x, group):
    """``x`` as it is; its gradient summed over ``group`` (a ``ProcessGroup``
    or a one-dimensional ``DeviceMesh``)."""
    return _CopyToGroup.apply(x, process_group(group))


def reduce_from_group(x, group):
    """``x`` summed over ``group`` (the counterpart of ``jax.lax.psum``); its
    gradient passes as it is."""
    return _ReduceFromGroup.apply(x, process_group(group))


def axis_size(mesh, axis):
    """The size of ``mesh`` 's dimension ``axis``, read off the mesh
    (``mesh[axis].size()`` builds a sub-mesh on every call, too slow for
    every parameter of a step)."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def shard_by_spec(x, spec, mesh):
    """This rank's piece of the global tensor ``x`` laid out by ``spec`` on
    ``mesh``: each dimension that a mesh dimension names is cut to the
    rank's coordinate along it (a tuple of names cuts over their product,
    the first outermost). A view of ``x``; a dimension that does not split
    evenly raises ``ValueError``."""
    if len(spec) > x.dim():
        raise ValueError('spec {} has more entries than the tensor has dimensions ({})'
                         .format(spec, x.dim()))
    for dim, entry in enumerate(spec):
        index, count = 0, 1
        for axis in spec_axes(entry):
            index = index * axis_size(mesh, axis) + mesh.get_local_rank(axis)
            count *= axis_size(mesh, axis)
        if count > 1:
            x = _shard(x, dim, index, count)
    return x


def sum_over(x, mesh, axes=BATCH_AXES):
    """``x`` (detached) summed over the mesh dimensions ``axes`` that
    ``mesh`` has."""
    x = x.detach().clone()
    for axis in axes:
        if axis in (mesh.mesh_dim_names or ()) and axis_size(mesh, axis) > 1:
            dist.all_reduce(x, group=mesh.get_group(axis))
    return x


def reduce_gradients(params, specs, mesh, axes=BATCH_AXES):
    """Sum each parameter's gradient, in place, over every mesh dimension of
    ``axes`` that ``mesh`` has and that its spec does not name.

    :param params: a dict of parameters (or ``(name, parameter)`` pairs, as
        ``named_parameters()`` gives them); those without a gradient are
        skipped.
    :param specs: ``{name: PartitionSpec}`` of the sharded ones; a parameter
        missing from it is replicated.
    :param axes: the dimensions that split the batch. A dimension over which
        the batch is copied belongs here only when each copy's loss is
        divided by its size: the expert dimension of an expert-parallel
        layer, whose all-to-all already sums the copies' gradients into the
        experts and leaves every other parameter a share.
    """
    split = [axis for axis in axes
             if axis in (mesh.mesh_dim_names or ()) and axis_size(mesh, axis) > 1]
    for name, param in dict(params).items():
        if param.grad is None:
            continue
        named = {axis for entry in specs.get(name, ()) for axis in spec_axes(entry)}
        for axis in split:
            if axis not in named:
                dist.all_reduce(param.grad, group=mesh.get_group(axis))


def next_token_targets(tokens, group):
    """``(targets, valid)`` of a ``[B, T_local]`` shard of sequences split
    over ``group`` in group rank order: each position's next token, the last
    column's the first of the next rank's shard, and ``valid`` False only at
    the global last position, which has none."""
    ring = Ring(process_group(group))
    following = tokens[:, :1].contiguous()
    if ring.size > 1:
        requests, (following,) = ring.start([following], reverse=True)
        for request in requests:
            request.wait()
    targets = torch.cat([tokens[:, 1:], following], dim=1)
    valid = torch.ones(targets.shape, dtype=torch.bool, device=tokens.device)
    if ring.index == ring.size - 1:
        valid[:, -1] = False
    return targets, valid


class ColumnCutDense(Dense):
    """This rank's piece of ``dense`` cut by output features over ``group``
    (weight ``P('model', None)``, bias ``P('model')``), its input passed
    through f."""

    def __init__(self, dense, mesh, axis='model'):
        nn.Module.__init__(self)
        self.dtype = dense.dtype
        self.group = mesh.get_group(axis)
        self.weight = nn.Parameter(
            shard_by_spec(dense.weight.detach(), PartitionSpec(axis, None), mesh).clone())
        self.bias = nn.Parameter(
            shard_by_spec(dense.bias.detach(), PartitionSpec(axis), mesh).clone())

    def forward(self, x):
        return super().forward(copy_to_group(x, self.group))


class RowCutDense(Dense):
    """This rank's piece of ``dense`` cut by input features over ``group``
    (weight ``P(None, 'model')``); the partial products are summed through g
    and the whole bias is added after."""

    def __init__(self, dense, mesh, axis='model'):
        nn.Module.__init__(self)
        self.dtype = dense.dtype
        self.group = mesh.get_group(axis)
        self.weight = nn.Parameter(
            shard_by_spec(dense.weight.detach(), PartitionSpec(None, axis), mesh).clone())
        self.bias = nn.Parameter(dense.bias.detach().clone())

    def forward(self, x):
        out = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        return reduce_from_group(out, self.group) + self.bias.to(self.dtype)


class TensorParallelLM(nn.Module):
    """A :class:`~petastorm_tpu_torch.models.transformer.TransformerLM`
    trained with dp + sp + tp on ``mesh``, whose dimensions include
    ``'data'``, ``'seq'`` and ``'model'``.

    Construction swaps each block's ``mlp_up`` for a :class:`ColumnCutDense`
    and ``mlp_down`` for a :class:`RowCutDense` of this rank's piece (the
    parameters keep their names), so every rank must build it from the same
    weights; the blocks themselves, ``remat`` included, run as ``lm`` runs
    them. :meth:`forward` takes this rank's ``[B_local, T_local]`` token
    shard (batch over ``'data'``, sequence over ``'seq'``, the same on
    every model rank) and returns its logits; attention is causal
    :func:`~petastorm_tpu_torch.ops.ring_attention.ring_attention` over
    ``'seq'``, positions count from the shard's global offset.
    :meth:`loss` gives this rank's share of the global next-token loss and
    :meth:`reduce_gradients` finishes the backward. At one rank the MLP's
    reductions change nothing and the ring is one causal flash call a
    layer.
    """

    def __init__(self, lm, mesh):
        super().__init__()
        self.lm = lm
        self.mesh = mesh
        self.seq_group = mesh.get_group('seq')
        self.specs = {}
        with torch.no_grad():
            for index, block in enumerate(lm.blocks):
                block.mlp_up = ColumnCutDense(block.mlp_up, mesh)
                block.mlp_down = RowCutDense(block.mlp_down, mesh)
                prefix = 'lm.blocks.{}.'.format(index)
                self.specs[prefix + 'mlp_up.weight'] = PartitionSpec('model', None)
                self.specs[prefix + 'mlp_up.bias'] = PartitionSpec('model')
                self.specs[prefix + 'mlp_down.weight'] = PartitionSpec(None, 'model')

    def attention(self, q, k, v):
        return ring_attention(q, k, v, self.seq_group, causal=True)

    def forward(self, tokens):
        t_local = tokens.shape[1]
        start = dist.get_rank(self.seq_group) * t_local
        positions = torch.arange(start, start + t_local, device=tokens.device)
        return self.lm(tokens, positions=positions.expand(tokens.shape[0], -1),
                       attention_fn=self.attention)

    def loss(self, tokens):
        """``(share, loss)``: this rank's partial sum of the next-token
        losses over the global count of predicted tokens, to call
        ``backward`` on, and the global mean loss (summed over the data and
        sequence ranks, detached)."""
        targets, valid = next_token_targets(tokens, self.seq_group)
        logp = torch.log_softmax(self(tokens).float(), dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
        data, seq = (axis_size(self.mesh, axis) for axis in BATCH_AXES)
        count = tokens.shape[0] * data * (tokens.shape[1] * seq - 1)
        share = torch.where(valid, nll, torch.zeros_like(nll)).sum() / count
        return share, sum_over(share, self.mesh)

    def reduce_gradients(self):
        reduce_gradients(self.named_parameters(), self.specs, self.mesh)
