"""Ring attention: exact attention over a sequence sharded across the ranks of
a process group, the counterpart of ``petastorm_tpu.ops.ring_attention``, and
the single-device reference :func:`dense_attention`.

Each rank holds one shard ``[B, T_local, H, D]`` of q, k and v (the global
sequence is the shards in group rank order). K/V blocks, with their segment
ids, rotate round the ring by ``isend``/``irecv``; the next block's transfer
is started before the local block's work and waited for after it. Where the
JAX package computes each block with plain float32 einsums, here each block is
K2 (:func:`~petastorm_tpu_torch.ops.flash_attention.flash_forward`, which
gives ``o`` and ``lse``):

- causal: the diagonal block is causal, blocks from earlier ranks are not
  masked and blocks from later ranks are skipped (the mask over global
  positions); with segment ids the segmented mode runs, the local queries'
  ids against the block's keys' ids;
- blocks merge by their lse. K2 gives ``o = 0, lse = 0`` to a row with no
  valid key in its block; such a row's lse is masked out of the merge, and a
  row empty in every block (padding) comes out as zeros with ``lse = 0``.

The backward is a ``torch.autograd.Function``: K3 and K4
(:func:`~petastorm_tpu_torch.ops.flash_attention.flash_bwd_dq`,
:func:`~petastorm_tpu_torch.ops.flash_attention.flash_bwd_dkv`) run on each
block with the final lse and ``delta = rowsum(dO * O)``, so each block's
softmax is the global one; dQ accumulates in float32 and the dK/dV
accumulators travel round the ring with their blocks and arrive home after
a full turn. With one rank in the group the ring is one causal or segmented
flash call and exchanges nothing. On CPU tensors the same calls reach the
kernels' plain versions.
"""

import torch
import torch.distributed as dist

from petastorm_tpu_torch.parallel.mesh import Ring, process_group

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


# ----------------------------------------------------------------- the ring

def _block_mode(ring, step, causal):
    """At ``step`` the block held came from rank ``index - step``: None
    when the causal mask hides it, else whether it is the diagonal
    (causal) block."""
    source = (ring.index - step) % ring.size
    if causal and source > ring.index:
        return None
    return causal and source == ring.index


def _wait(requests):
    for request in requests:
        request.wait()


def _rows_meet(segments, key_segments, heads):
    """``[B, T]`` query ids against a block's key ids -> ``[B*H, T]`` bool:
    the row is not padding and its segment has a key in the block."""
    keys = key_segments.sort(dim=-1).values
    at = torch.searchsorted(keys, segments).clamp_max(keys.shape[-1] - 1)
    meets = (keys.gather(-1, at) == segments) & (segments > 0)
    return meets.repeat_interleave(heads, dim=0)


def _ring_forward(ring, q, k, v, segments, causal, heads):
    """``[BH, T, D]`` shards -> (o in q's dtype, final lse ``[BH, T]``)."""
    from petastorm_tpu_torch.ops.flash_attention import flash_forward
    o_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse_acc = torch.full(q.shape[:2], _NEG_INF, dtype=torch.float32, device=q.device)
    block = [k, v] if segments is None else [k, v, segments]
    for step in range(ring.size):
        requests, received = ring.start(block) if step < ring.size - 1 else ([], block)
        mode = _block_mode(ring, step, causal)
        if mode is not None:
            key_segments = None if segments is None else block[2]
            o_blk, lse_blk = flash_forward(q, block[0], block[1], mode, segments, heads,
                                           key_segments=key_segments)
            if segments is not None:
                lse_blk = lse_blk.masked_fill(~_rows_meet(segments, key_segments, heads),
                                              _NEG_INF)
            lse_new = torch.logaddexp(lse_acc, lse_blk)
            o_acc = (o_acc * torch.exp(lse_acc - lse_new)[..., None]
                     + o_blk.float() * torch.exp(lse_blk - lse_new)[..., None])
            lse_acc = lse_new
        _wait(requests)
        block = received
    lse = lse_acc.masked_fill(lse_acc < _NEG_INF / 2, 0.0)
    return o_acc.to(q.dtype), lse


def _ring_backward(ring, do, q, k, v, o, lse, segments, causal, heads):
    """dQ, dK, dV ``[BH, T, D]`` of this rank's shards."""
    from petastorm_tpu_torch.ops.flash_attention import flash_bwd_dkv, flash_bwd_dq
    delta = (do.float() * o.float()).sum(dim=-1)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    block = [k, v] if segments is None else [k, v, segments]
    acc = []   # dK, dV (float32) of the block this rank handled at the last step
    for step in range(ring.size):
        # the next block, and the previous block's accumulators to its next rank
        moving = block if step < ring.size - 1 else []
        requests, received = ring.start(moving + acc)
        mode = _block_mode(ring, step, causal)   # never None at step 0: the diagonal
        contribution = None
        if mode is not None:
            key_segments = None if segments is None else block[2]
            args = (q, block[0], block[1], do, lse, delta, mode, segments, heads)
            dq += flash_bwd_dq(*args, key_segments=key_segments).float()
            dk, dv = flash_bwd_dkv(*args, key_segments=key_segments)
            contribution = [dk.float(), dv.float()]
        _wait(requests)
        arrived = received[len(moving):]   # this step's block's accumulators
        if moving:
            block = received[:len(moving)]
        if contribution is None:
            acc = arrived
        else:
            acc = [a + c for a, c in zip(arrived, contribution)] if arrived else contribution
    if ring.size > 1:
        # one more hop brings this rank's own block's accumulators home
        requests, acc = ring.start(acc)
        _wait(requests)
    dk, dv = acc
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    """Forward and backward of the ring on ``[B, T_local, H, D]`` shards."""

    @staticmethod
    def forward(ctx, q, k, v, segments, ring, causal):
        from petastorm_tpu_torch.ops.flash_attention import _from_bh, _to_bh
        b, _, h, _ = q.shape
        q_bh, k_bh, v_bh = _to_bh(q), _to_bh(k), _to_bh(v)
        o_bh, lse = _ring_forward(ring, q_bh, k_bh, v_bh, segments, causal, h)
        ctx.save_for_backward(q_bh, k_bh, v_bh, o_bh, lse, segments)
        ctx.ring, ctx.causal, ctx.dims = ring, causal, (b, h)
        return _from_bh(o_bh, b, h)

    @staticmethod
    def backward(ctx, grad):
        from petastorm_tpu_torch.ops.flash_attention import _from_bh, _to_bh
        q_bh, k_bh, v_bh, o_bh, lse, segments = ctx.saved_tensors
        b, h = ctx.dims
        do = _to_bh(grad.to(o_bh.dtype))
        grads = _ring_backward(ctx.ring, do, q_bh, k_bh, v_bh, o_bh, lse, segments,
                               ctx.causal, h)
        return tuple(_from_bh(x, b, h) for x in grads) + (None, None, None)


def ring_attention(q, k, v, group, causal=False, segments=None):
    """Exact attention with K/V rotated round the ranks of ``group`` (a
    ``ProcessGroup`` or a one-dimensional ``DeviceMesh``). Every tensor is
    this rank's shard ``[B, T_local, H, D]``, T_local the same on every rank;
    the global sequence is the shards in group rank order.

    :param causal: a causal mask over GLOBAL positions, so the result equals
        dense causal attention on the gathered sequence.
    :param segments: optional ``[B, T_local]`` int shard of packed-sequence
        segment ids (0 = padding, documents numbered from 1): attention stays
        within a segment and padding rows return zeros. The ids travel with
        their K/V blocks.
    """
    if not q.shape == k.shape == v.shape or q.dim() != 4:
        raise ValueError('ring_attention takes equal [B, T_local, H, D] q, k, v; got {}, '
                         '{}, {}'.format(tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if segments is not None:
        if tuple(segments.shape) != tuple(q.shape[:2]):
            raise ValueError('segments must be [B, T_local] = {}, got {}'.format(
                tuple(q.shape[:2]), tuple(segments.shape)))
        segments = segments.to(device=q.device, dtype=torch.int32).contiguous()
    ring = Ring(process_group(group))
    return _RingAttention.apply(q, k, v, segments, ring, bool(causal))


# ------------------------------------------------------------ global tensors

def _shard(x, dim, index, count):
    if x.shape[dim] % count:
        raise ValueError('dimension {} of size {} does not split into {} shards'.format(
            dim, x.shape[dim], count))
    size = x.shape[dim] // count
    return x.narrow(dim, index * size, size)


class _Gather(torch.autograd.Function):
    """All-gather of equal shards along ``dim`` in group rank order; the
    backward keeps this rank's slice of the gradient (the gathered tensor is
    the same on every rank, and so is the loss taken from it)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        count = dist.get_world_size(ctx.group)
        part = _shard(grad, ctx.dim, dist.get_rank(ctx.group), count)
        return part.contiguous(), None, None


def ring_attention_sharded(mesh, seq_axis, causal=False, batch_axis=None):
    """``fn(q, k, v, segments=None)`` running :func:`ring_attention` with the
    sequence dimension sharded over ``mesh``'s dimension ``seq_axis`` (and the
    batch over ``batch_axis``, dp + sp; default: replicated). It takes GLOBAL
    ``[B, T, H, D]`` tensors (and optional ``[B, T]`` int segments), keeps
    this rank's shard and returns the gathered global result; gradients reach
    the global inputs' shards this rank holds. The JAX function's
    ``with_segments`` flag is not taken: passing ``segments`` or not decides."""
    seq_group = mesh.get_group(seq_axis)
    batch_group = None if batch_axis is None else mesh.get_group(batch_axis)

    def local(x):
        # shard i of a dimension is group rank i's, the ring's order
        x = _shard(x, 1, dist.get_rank(seq_group), dist.get_world_size(seq_group))
        if batch_group is None:
            return x
        return _shard(x, 0, dist.get_rank(batch_group), dist.get_world_size(batch_group))

    def run(q, k, v, segments=None):
        out = ring_attention(local(q), local(k), local(v), seq_group, causal,
                             None if segments is None else local(segments))
        out = _Gather.apply(out, seq_group, 1)
        return out if batch_group is None else _Gather.apply(out, batch_group, 0)

    return run
