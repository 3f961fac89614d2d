"""GPipe pipeline parallelism over the ``'stage'`` dimension of a
``DeviceMesh``: the counterpart of ``petastorm_tpu.parallel.pipeline`` (J8),
on ``torch.distributed``.

- :func:`stack_stage_params` / :func:`unstack_stage_params` stack dicts of
  tensors (``state_dict`` s) of uniform stages along a leading stages
  dimension and take one back; :func:`stage_partition_specs` gives every
  leaf ``PartitionSpec('stage', None, ...)``.
- :func:`make_pipeline` runs ``stage_fn`` as the JAX package's schedule:
  ``n_micro + n_stages - 1`` ticks; at tick ``t`` stage 0 feeds
  ``xs[min(t, n_micro - 1)]`` and every other stage the activation it
  received; the last stage writes output ``t - (n_stages - 1)``; the
  activation then moves stage ``i -> (i + 1) % n_stages`` by
  ``batch_isend_irecv`` (the ring's pairing,
  :class:`~petastorm_tpu_torch.parallel.mesh.Ring`: every rank posts
  the wrap-around send too). A masked all-reduce over the stage group
  returns the outputs on every stage rank.
- :func:`microbatch` splits ``[batch, ...]`` into ``[n_micro, batch /
  n_micro, ...]``.

The schedule is one ``torch.autograd.Function``. Its forward runs every tick
with autograd on, keeping each tick's graph (GPipe keeps every microbatch's
activations, as ``jax.grad`` of the JAX ``scan`` does). Its backward walks
the ticks in reverse: each tick's output gradient (the received one, plus the
loss's on the last stage) goes through that tick's graph, and the gradient of
the tick's input is sent to the previous stage. One function, not one per
shift, because autograd would not run the backward of a shift whose received
value a stage ignores (stage 0 ignores what the last stage sends it), and
the exchanges must pair in the same order on every rank.

Defined differences from the JAX package:

- **Calling convention.** ``pipeline(stage_params, xs)`` takes THIS rank's
  stage parameters: a dict of tensors without the leading stages dimension
  (and, where ``params_spec`` shards other dimensions over other mesh
  dimensions, only this rank's piece of them, which the caller cuts).
  ``shard_map`` hands the JAX ``local_fn`` the same slice, with a
  leading dimension of 1, out of the global stacked tree. ``params_spec``
  is only checked here: the caller already placed the weights.
- **Replicated over the stage group**: every stage rank passes the same
  ``xs`` and gets the same outputs. Their backward is that of the JAX
  ``psum``: each rank computes the loss from the outputs and calls
  ``backward``; only the last stage's output gradient enters the schedule
  (no factor of ``n_stages``), and the gradient of ``xs`` (stage 0's) is
  all-reduced over the stage group, so parameters upstream of the pipeline
  get the same gradient on every stage rank. Other mesh dimensions are the
  caller's: average gradients over ``'data'`` as with any data parallelism.
- **One stage**: the shift to itself is skipped (a one-stage pipeline sends
  nothing); the all-reduce still runs.
"""

import contextlib

import torch
import torch.distributed as dist

from petastorm_tpu_torch.parallel.mesh import PartitionSpec, Ring, spec_axes


def stack_stage_params(stage_params_list):
    """Stack a list of per-stage dicts of tensors (such as ``state_dict`` s
    of uniform stages) into one dict whose tensors carry a leading stages
    dimension (new tensors, detached)."""
    if not stage_params_list:
        raise ValueError('need at least one stage')
    names = list(stage_params_list[0])
    for stage in stage_params_list[1:]:
        if sorted(stage) != sorted(names):
            raise ValueError('stages hold different parameters: {} and {}'.format(
                sorted(names), sorted(stage)))
    return {name: torch.stack([torch.as_tensor(stage[name]).detach()
                               for stage in stage_params_list]) for name in names}


def unstack_stage_params(stacked, stage):
    """Stage ``stage`` 's dict of tensors from the stacked dict."""
    return {name: leaf[stage] for name, leaf in stacked.items()}


def stage_partition_specs(stacked, stage_axis='stage'):
    """``PartitionSpec(stage_axis, None, ...)`` for every stacked tensor: the
    stages dimension over ``stage_axis``, the rest not sharded."""
    return {name: PartitionSpec(stage_axis, *([None] * (leaf.dim() - 1)))
            for name, leaf in stacked.items()}


def _exchange(ring, tensor, reverse=False):
    requests, (received,) = ring.start([tensor], reverse=reverse)
    for request in requests:
        request.wait()
    return received


class _Pipeline(torch.autograd.Function):
    """The GPipe schedule, forward and backward (see the module docstring)."""

    @staticmethod
    def forward(ctx, stage_fn, ring, names, grad, xs, *params):
        n, index = ring.size, ring.index
        n_micro = xs.shape[0]
        ticks = n_micro + n - 1
        leaves = [p.detach().requires_grad_(grad and p.requires_grad) for p in params]
        stage_params = dict(zip(names, leaves))
        state = torch.zeros_like(xs[0])
        outputs = [None] * n_micro
        graphs = []
        with torch.enable_grad() if grad else contextlib.nullcontext():
            for t in range(ticks):
                feed = xs[min(t, n_micro - 1)] if index == 0 else state
                inp = feed.detach().requires_grad_(grad and (index > 0 or xs.requires_grad))
                out = stage_fn(stage_params, inp)
                if out.shape != inp.shape or out.dtype != inp.dtype:
                    raise ValueError('pipeline stage_fn must preserve shape/dtype: {} {} -> '
                                     '{} {}'.format(tuple(inp.shape), inp.dtype,
                                                    tuple(out.shape), out.dtype))
                graphs.append((inp, out))
                done = t - (n - 1)
                if index == n - 1 and done >= 0:
                    outputs[done] = out.detach()
                if n > 1 and t < ticks - 1:
                    state = _exchange(ring, out.detach())
        ys = torch.stack(outputs) if index == n - 1 else torch.zeros_like(xs)
        dist.all_reduce(ys, group=ring.group)
        ctx.ring, ctx.graphs, ctx.leaves = ring, graphs, leaves
        ctx.xs_grad = xs.requires_grad
        return ys

    @staticmethod
    def backward(ctx, grad_ys):
        ring, graphs, leaves = ctx.ring, ctx.graphs, ctx.leaves
        ctx.graphs = None   # each tick's graph is freed as its backward runs
        n, index = ring.size, ring.index
        n_micro = grad_ys.shape[0]
        wanted = [i for i, leaf in enumerate(leaves) if leaf.requires_grad]
        param_grads = [None] * len(leaves)
        xs_grad = torch.zeros_like(grad_ys) if ctx.xs_grad else None
        incoming = None   # the gradient of this tick's output, from the next stage
        for t in reversed(range(len(graphs))):
            inp, out = graphs[t]
            graphs[t] = None
            g = torch.zeros_like(out) if incoming is None else incoming
            done = t - (n - 1)
            if index == n - 1 and done >= 0:
                g = g + grad_ys[done]   # the masked all-reduce's backward: no sum
            inputs = [leaves[i] for i in wanted] + ([inp] if inp.requires_grad else [])
            grads = torch.autograd.grad(out, inputs, g, allow_unused=True) if inputs else []
            for i, value in zip(wanted, grads):
                if value is not None:
                    param_grads[i] = value if param_grads[i] is None else param_grads[i] + value
            inp_grad = grads[-1] if inp.requires_grad else None
            if inp_grad is None:
                inp_grad = torch.zeros_like(inp)
            if index == 0 and xs_grad is not None:
                xs_grad[min(t, n_micro - 1)] += inp_grad
            if n > 1 and t > 0:
                # the reverse of the forward's shift after tick t - 1 (stage 0
                # sends zeros: what it received there was never used)
                incoming = _exchange(ring, inp_grad if index > 0 else torch.zeros_like(inp),
                                     reverse=True)
        if xs_grad is not None:
            dist.all_reduce(xs_grad, group=ring.group)   # xs is replicated over the stages
        return (None, None, None, None, xs_grad) + tuple(param_grads)


def make_pipeline(stage_fn, mesh, stage_axis='stage', params_spec=None):
    """Build ``pipeline(stage_params, xs) -> ys`` running ``stage_fn`` as a
    GPipe pipeline over ``mesh`` 's dimension ``stage_axis``.

    :param stage_fn: ``(stage_params, microbatch) -> microbatch``: one stage's
        computation on this rank's stage parameters (a dict of tensors, e.g.
        through ``torch.func.functional_call``); must preserve shape and
        dtype. It may use collectives over the mesh's other dimensions (e.g.
        :func:`~petastorm_tpu_torch.ops.sharded_moe.expert_alltoall_ffn` over
        ``'expert'``).
    :param mesh: a ``DeviceMesh`` with a dimension ``stage_axis``; rank ``i``
        of that dimension's group runs stage ``i``.
    :param params_spec: how the caller cut the stacked parameters onto the
        ranks: None, one spec, or a dict of specs. It is only checked (every
        spec must shard dim 0 over ``stage_axis``, as the JAX package
        requires) and has no other effect: ``stage_params`` is already this
        rank's piece.
    :returns: ``pipeline(stage_params, xs)`` with ``stage_params`` this rank's
        stage's dict of tensors and ``xs`` ``[n_micro, ...microbatch...]``,
        the same on every stage rank; returns ``[n_micro, ...]`` outputs of
        the last stage on every stage rank (see the module docstring for the
        gradients).
    """
    names = tuple(mesh.mesh_dim_names or ())
    if stage_axis not in names:
        raise ValueError('mesh has no dimension {!r} (dimensions: {})'.format(stage_axis, names))
    if params_spec is not None:
        specs = list(params_spec.values()) if isinstance(params_spec, dict) else [params_spec]
        for spec in specs:
            if spec is None or not len(spec) or spec_axes(spec[0]) != (stage_axis,):
                raise ValueError('params_spec leaf {} must shard dim 0 over {!r} (each rank '
                                 'holds its own stage)'.format(spec, stage_axis))
    ring = Ring(mesh.get_group(stage_axis))

    def pipeline(stage_params, xs):
        keys = tuple(stage_params)
        values = [stage_params[key] for key in keys]
        grad = torch.is_grad_enabled() and (xs.requires_grad
                                            or any(v.requires_grad for v in values))
        return _Pipeline.apply(stage_fn, ring, keys, grad, xs, *values)

    return pipeline


def blocks_stage_fn(blocks, *args):
    """A ``stage_fn`` running the modules ``blocks`` (an ``nn.ModuleList`` or
    a sequence) in order on stage parameters named as
    ``nn.ModuleList(blocks).named_parameters()`` names them (``'0.qkv.weight'``
    ...), each called as ``block(x, *args)`` through
    ``torch.func.functional_call``."""
    from torch.func import functional_call
    blocks = list(blocks)

    def stage_fn(stage_params, x):
        for i, block in enumerate(blocks):
            prefix = '{}.'.format(i)
            own = {name[len(prefix):]: value for name, value in stage_params.items()
                   if name.startswith(prefix)}
            x = functional_call(block, own, (x,) + args)
        return x

    return stage_fn


def microbatch(batch, n_micro):
    """Split ``[batch, ...]`` into ``[n_micro, batch / n_micro, ...]`` (the
    pipeline's input layout). The batch must divide evenly."""
    leading = batch.shape[0]
    if leading % n_micro != 0:
        raise ValueError('batch {} not divisible into {} microbatches'.format(leading, n_micro))
    return batch.reshape((n_micro, leading // n_micro) + tuple(batch.shape[1:]))
