"""The port's ring attention (petastorm_tpu_torch.ops.ring_attention) on one
gloo world of 4 CPU ranks over 'seq', against ring_attention_sharded of the
JAX package on a 4-device mesh and against the port's dense attention:
causal and non-causal, with packed segments (documents crossing shards, and
one shard of a row all padding), forward and gradients; and with the batch
over 'data' on a (data=2, seq=2) mesh. On the CPU the ring's blocks run the
kernels' plain versions, the same calls that launch K2-K4 on the card.

Tolerances: outputs rtol 2e-4, atol 2e-5 (float32, summed in another order);
gradients within 1e-4 of the largest magnitude. Padding rows are exactly 0
in the output and in dQ."""

import os
import sys

import numpy as np
import pytest
import torch

from test_torch_sharded_moe import init_world, run_world

TOL = dict(rtol=2e-4, atol=2e-5)
B, T, H, D = 2, 32, 2, 64
#: (name, causal, with segments, batch axis)
CASES = (('noncausal', False, False, None), ('causal', True, False, None),
         ('causal_segments', True, True, None), ('noncausal_segments', False, True, None),
         ('causal_batch', True, False, 'data'))


def _inputs():
    rng = np.random.RandomState(0)
    q, k, v, w = (rng.randn(B, T, H, D).astype(np.float32) for _ in range(4))
    segments = np.ones((B, T), np.int32)
    segments[0, 5:20] = 2      # documents crossing the shards of 8 positions
    segments[0, 20:] = 3
    segments[1, 3:12] = 2
    segments[1, 12:24] = 4
    segments[1, 24:] = 0       # the last rank's shard of row 1: all padding
    return dict(q=q, k=k, v=v, w=w, segments=segments)


# ------------------------------------------------------------------ the ranks

def _worker(rank, world, store, workdir):
    import torch.distributed as dist

    from petastorm_tpu_torch.ops.ring_attention import ring_attention_sharded
    from petastorm_tpu_torch.parallel.mesh import make_mesh
    init_world(rank, world, store)
    inputs = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(workdir,
                                                                      'inputs.npz')).items()}
    meshes = {None: make_mesh(('seq',), device='cpu'),
              'data': make_mesh(('data', 'seq'), (2, 2), device='cpu')}
    out = {}
    for name, causal, with_segments, batch_axis in CASES:
        fn = ring_attention_sharded(meshes[batch_axis], 'seq', causal=causal,
                                    batch_axis=batch_axis)
        q, k, v = (inputs[x].clone().requires_grad_() for x in 'qkv')
        args = (q, k, v, inputs['segments']) if with_segments else (q, k, v)
        o = fn(*args)
        (o * inputs['w']).sum().backward()
        out.update({name: o.detach(), name + '_dq': q.grad, name + '_dk': k.grad,
                    name + '_dv': v.grad})
    np.savez(os.path.join(workdir, 'rank{}.npz'.format(rank)),
             **{k: v.numpy() for k, v in out.items()})
    dist.destroy_process_group()


# ------------------------------------------------------------------ the test

def _jax_ring(inputs, causal, with_segments, batch_axis):
    """The JAX package's ring over 4 devices: output and the gradients of
    sum(out * w) by q, k, v."""
    import jax
    import jax.numpy as jnp

    from petastorm_tpu.ops.ring_attention import ring_attention_sharded as jax_sharded
    from petastorm_tpu.parallel.mesh import make_mesh as jax_mesh
    devices = jax.devices()[:4]
    if batch_axis:
        mesh = jax_mesh(('data', 'seq'), (2, 2), devices=devices)
    else:
        mesh = jax_mesh(('seq',), devices=devices)
    fn = jax_sharded(mesh, 'seq', causal=causal, with_segments=with_segments,
                     batch_axis=batch_axis)
    extra = (jnp.asarray(inputs['segments']),) if with_segments else ()
    qkv = [jnp.asarray(inputs[x]) for x in 'qkv']
    w = jnp.asarray(inputs['w'])
    out = fn(*qkv, *extra)
    grads = jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v, *extra) * w), argnums=(0, 1, 2))(*qkv)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _dense(inputs, causal, with_segments):
    """The port's single-device attention on the gathered sequence."""
    from petastorm_tpu_torch.ops.packing import masked_dense_attention, segment_mask
    from petastorm_tpu_torch.ops.ring_attention import dense_attention
    q, k, v = (torch.from_numpy(inputs[x]).requires_grad_() for x in 'qkv')
    if with_segments:
        segments = torch.from_numpy(inputs['segments'])
        o = masked_dense_attention(q, k, v, segment_mask(segments, segments, causal))
    else:
        o = dense_attention(q, k, v, causal)
    (o * torch.from_numpy(inputs['w'])).sum().backward()
    return o.detach().numpy(), [x.grad.numpy() for x in (q, k, v)]


def test_ring_attention_on_a_gloo_world_of_four(tmp_path):
    inputs = _inputs()
    ranks = run_world(os.path.abspath(__file__), tmp_path, inputs)
    padding = inputs['segments'] == 0
    assert padding[1, 24:].all() and not padding[0].any()
    for name, causal, with_segments, batch_axis in CASES:
        got = ranks[0][name]
        for rank in ranks[1:]:
            np.testing.assert_array_equal(rank[name], got, err_msg=name)   # gathered
        # each rank's gradient covers the shard it holds: their sum is the global one
        grads = [sum(rank['{}_{}'.format(name, g)] for rank in ranks) for g in ('dq', 'dk', 'dv')]
        for label, (want, want_grads) in (
                ('jax', _jax_ring(inputs, causal, with_segments, batch_axis)),
                ('dense', _dense(inputs, causal, with_segments))):
            np.testing.assert_allclose(got, want, err_msg='{} {}'.format(name, label), **TOL)
            for g, w, which in zip(grads, want_grads, ('dq', 'dk', 'dv')):
                np.testing.assert_allclose(g, w, atol=1e-4 * float(np.abs(w).max()), rtol=0,
                                           err_msg='{} {} {}'.format(name, label, which))
        if with_segments:
            assert not got[padding].any() and not grads[0][padding].any()
            assert np.isfinite(got).all()


def test_ring_attention_checks_its_shards():
    from petastorm_tpu_torch.ops.ring_attention import ring_attention
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match='equal'):
        ring_attention(q, torch.zeros(1, 4, 2, 64), q, group=None)
    with pytest.raises(ValueError, match='segments'):
        ring_attention(q, q, q, group=None, segments=torch.zeros(1, 4, dtype=torch.int32))


if __name__ == '__main__':
    _worker(*sys.argv[1:])
