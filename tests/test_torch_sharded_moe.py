"""Expert parallelism in the port (petastorm_tpu_torch.ops.sharded_moe,
MoEMlp(expert_group=...)) on one gloo world of 4 CPU ranks, against the JAX
package's shard_map on a 2 x 2 mesh of the same shards:

- sharded_moe_ffn on a (data=2, expert=2) mesh, forward and gradients;
- MoEMlp(expert_group=...) with capacity_factor 4 (no token dropped) against
  the unsharded module from the same generator seed, outputs and the experts'
  gradients;
- the sp + ep layer of tests/test_sharded_moe.py: ring attention over 'seq',
  the expert FFN over 'expert', on a (seq=2, expert=2) mesh;
- the errors: experts not divisible by the group, a wrong local slice, mesh
  sizes that do not multiply to the world size.

The ranks are this file run as a script (no JAX in them), joined by a file
store under tmp_path. Tolerances: float32 outputs rtol 2e-4, atol 2e-5;
gradients within 1e-4 of the largest magnitude. The JAX layer replicates the
tokens over 'expert'; a torch rank's loss is divided by the expert group's
size so that the expert replicas' gradients add up to the data shard's."""

import datetime
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-5)
N_EXPERTS, DIM, HID, S = 8, 16, 32, 32   # as tests/test_sharded_moe.py
LAYER = dict(B=4, T=16, H=2, D=64, X=4)   # the sp + ep layer (head_dim the kernels take)


def run_world(script, tmp_path, inputs, world=4, timeout=240):
    """Run ``script rank world store dir`` as ``world`` processes joined by a
    gloo file store; returns each rank's saved arrays."""
    np.savez(os.path.join(str(tmp_path), 'inputs.npz'), **inputs)
    env = dict(os.environ, OMP_NUM_THREADS='1',
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get('PYTHONPATH', '')]))
    store = os.path.join(str(tmp_path), 'store')
    procs = [subprocess.Popen([sys.executable, script, str(rank), str(world), store,
                               str(tmp_path)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for rank in range(world)]
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=timeout)[0].decode(errors='replace'))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, output) in enumerate(zip(procs, outputs)):
        assert proc.returncode == 0, 'rank {} exited {}:\n{}'.format(
            rank, proc.returncode, output[-4000:])
    return [dict(np.load(os.path.join(str(tmp_path), 'rank{}.npz'.format(rank))))
            for rank in range(world)]


def init_world(rank, world, store):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method='file://' + store, rank=int(rank),
                            world_size=int(world), timeout=datetime.timedelta(seconds=180))


# ------------------------------------------------------------------ the ranks

def _raises(fn):
    try:
        fn()
    except ValueError:
        return True
    return False


def _worker(rank, world, store, workdir):
    import torch.distributed as dist

    from petastorm_tpu_torch.models.moe import MoEMlp
    from petastorm_tpu_torch.ops.ring_attention import ring_attention
    from petastorm_tpu_torch.ops.sharded_moe import expert_alltoall_ffn, sharded_moe_ffn
    from petastorm_tpu_torch.parallel.mesh import make_mesh
    init_world(rank, world, store)
    inputs = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(workdir,
                                                                      'inputs.npz')).items()}
    out = {}

    def leaf(x):
        return x.detach().clone().requires_grad_()

    # sharded_moe_ffn on (data=2, expert=2)
    mesh = make_mesh(('data', 'expert'), (2, 2), device='cpu')
    data, expert = mesh.get_group('data'), mesh.get_group('expert')
    d, e = dist.get_rank(data), dist.get_rank(expert)
    ne, xl = dist.get_world_size(expert), N_EXPERTS // 2
    tokens = leaf(inputs['tokens'][d * S // 2:(d + 1) * S // 2])
    router = leaf(inputs['router'])
    w1 = leaf(inputs['w1'][e * xl:(e + 1) * xl])
    w2 = leaf(inputs['w2'][e * xl:(e + 1) * xl])
    y, aux, drop = sharded_moe_ffn(tokens, router, w1, w2, mesh['expert'], capacity_factor=8.0)
    ((y ** 2).sum() / ne).backward()
    out.update(ffn=y.detach(), ffn_drop=drop, ffn_tokens_grad=tokens.grad,
               ffn_router_grad=router.grad, ffn_w1_grad=w1.grad, ffn_w2_grad=w2.grad)
    y2 = sharded_moe_ffn(tokens.detach(), router.detach(), w1.detach(), w2.detach(), expert,
                         capacity_factor=8.0, num_selected=2)[0]
    out['ffn_top2'] = y2

    # MoEMlp(expert_group=...) against the unsharded module of the same seed
    x = inputs['x']
    kwargs = dict(capacity_factor=4.0, dtype=torch.float32, device='cpu')
    sharded = MoEMlp(16, 4, expert_group=expert, generator=torch.Generator().manual_seed(11),
                     **kwargs)
    whole = MoEMlp(16, 4, generator=torch.Generator().manual_seed(11), **kwargs)
    x_local = x[d * 2:(d + 1) * 2]
    y_sharded, losses = sharded(x_local)
    ((y_sharded ** 2).sum() / ne).backward()
    y_whole = whole(x)[0]
    (y_whole ** 2).sum().backward()
    out.update(mlp=y_sharded.detach(), mlp_want=y_whole.detach()[d * 2:(d + 1) * 2],
               mlp_drop=losses['moe_drop_fraction'].detach(), mlp_w1_grad=sharded.w1.grad,
               mlp_w1_grad_want=whole.w1.grad[e * 2:(e + 1) * 2],
               mlp_router_grad=sharded.router.weight.grad,
               mlp_router_grad_want=whole.router.weight.grad)

    # the sp + ep layer on (seq=2, expert=2)
    layer_mesh = make_mesh(('seq', 'expert'), (2, 2), device='cpu')
    seq, expert2 = layer_mesh.get_group('seq'), layer_mesh.get_group('expert')
    s_index, e_index = dist.get_rank(seq), dist.get_rank(expert2)
    t_local, xl2 = LAYER['T'] // 2, LAYER['X'] // 2
    xs = inputs['layer_x'][:, s_index * t_local:(s_index + 1) * t_local]
    attn = ring_attention(xs, xs, xs, seq, causal=True)
    flat = attn.reshape(-1, LAYER['H'] * LAYER['D'])
    moe_out = sharded_moe_ffn(flat, inputs['layer_router'],
                              inputs['layer_w1'][e_index * xl2:(e_index + 1) * xl2],
                              inputs['layer_w2'][e_index * xl2:(e_index + 1) * xl2], expert2,
                              capacity_factor=8.0)[0]
    out['layer'] = (flat + moe_out).reshape(attn.shape)

    # the errors, raised before any exchange
    dispatch = torch.zeros(16, 5, 4)
    out['error_indivisible'] = torch.tensor(_raises(lambda: expert_alltoall_ffn(
        torch.zeros(16, DIM), dispatch, dispatch, torch.zeros(5, DIM, HID),
        torch.zeros(5, HID, DIM), expert)))
    dispatch = torch.zeros(16, N_EXPERTS, 4)
    out['error_slice'] = torch.tensor(_raises(lambda: expert_alltoall_ffn(
        torch.zeros(16, DIM), dispatch, dispatch, inputs['w1'], inputs['w2'], expert)))
    out['error_mesh'] = torch.tensor(_raises(lambda: make_mesh(('a', 'b'), (2, 3),
                                                               device='cpu')))
    np.savez(os.path.join(workdir, 'rank{}.npz'.format(rank)),
             **{k: v.detach().numpy() for k, v in out.items()})
    dist.destroy_process_group()


# ------------------------------------------------------------------ the test

def _inputs():
    rng = np.random.RandomState(0)   # tests/test_sharded_moe.py's params(0) and tokens
    router = (rng.randn(DIM, N_EXPERTS) * 0.5).astype(np.float32)
    w1 = (rng.randn(N_EXPERTS, DIM, HID) * 0.3).astype(np.float32)
    w2 = (rng.randn(N_EXPERTS, HID, DIM) * 0.3).astype(np.float32)
    tokens = np.random.RandomState(1).randn(S, DIM).astype(np.float32)
    rng = np.random.RandomState(10)
    e = LAYER['H'] * LAYER['D']
    return dict(router=router, w1=w1, w2=w2, tokens=tokens,
                x=np.random.RandomState(4).randn(4, 8, 16).astype(np.float32),
                layer_x=rng.randn(LAYER['B'], LAYER['T'], LAYER['H'],
                                  LAYER['D']).astype(np.float32),
                layer_router=(rng.randn(e, LAYER['X']) * 0.5).astype(np.float32),
                layer_w1=(rng.randn(LAYER['X'], e, 2 * e) * 0.3 / np.sqrt(8)).astype(np.float32),
                layer_w2=(rng.randn(LAYER['X'], 2 * e, e) * 0.3 / np.sqrt(16)).astype(np.float32))


def _jax_ffn(inputs, num_selected=1):
    """sharded_moe_ffn of the JAX package on a 2 x 2 (data, expert) mesh: the
    output and the gradients of sum(out ** 2) by tokens, router, w1, w2."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from petastorm_tpu.ops.sharded_moe import sharded_moe_ffn as jax_ffn
    from petastorm_tpu.parallel.mesh import shard_map_compat
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ('data', 'expert'))
    fn = shard_map_compat(
        lambda t, rk, w1, w2: jax_ffn(t, rk, w1, w2, 'expert', capacity_factor=8.0,
                                      num_selected=num_selected)[0],
        mesh, (P('data', None), P(None, None), P('expert', None, None),
               P('expert', None, None)), P('data', None))
    args = [jnp.asarray(inputs[name]) for name in ('tokens', 'router', 'w1', 'w2')]
    out = jax.jit(fn)(*args)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) ** 2), argnums=(0, 1, 2, 3)))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _jax_layer(inputs):
    """tests/test_sharded_moe.py's sp + ep layer on a (seq=2, expert=2) mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from petastorm_tpu.ops.ring_attention import ring_attention as jax_ring
    from petastorm_tpu.ops.sharded_moe import sharded_moe_ffn as jax_ffn
    from petastorm_tpu.parallel.mesh import shard_map_compat
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ('seq', 'expert'))
    e = LAYER['H'] * LAYER['D']

    def layer(x, rk, w1, w2):
        attn = jax_ring(x, x, x, axis_name='seq', causal=True)
        tokens = attn.reshape(-1, e)
        out, _, _ = jax_ffn(tokens, rk, w1, w2, 'expert', capacity_factor=8.0)
        return (tokens + out).reshape(attn.shape)

    x_spec = P(None, 'seq', None, None)
    fn = shard_map_compat(layer, mesh, (x_spec, P(None, None), P('expert', None, None),
                                        P('expert', None, None)), x_spec)
    return np.asarray(jax.jit(fn)(*[jnp.asarray(inputs[name]) for name in (
        'layer_x', 'layer_router', 'layer_w1', 'layer_w2')]))


def _close_grads(got, want, name):
    np.testing.assert_allclose(got, want, atol=1e-4 * float(np.abs(want).max()), rtol=0,
                               err_msg=name)


def test_expert_parallel_ops_on_a_gloo_world_of_four(tmp_path):
    inputs = _inputs()
    ranks = run_world(os.path.abspath(__file__), tmp_path, inputs)
    # rank = 2 * data + expert on the (data, expert) mesh, 2 * seq + expert on the layer's
    by = {(r // 2, r % 2): ranks[r] for r in range(4)}

    # sharded_moe_ffn, forward and gradients
    want, (g_tokens, g_router, g_w1, g_w2) = _jax_ffn(inputs)
    for d in range(2):
        for e in range(2):
            np.testing.assert_allclose(by[d, e]['ffn'], want[d * 16:(d + 1) * 16], **TOL)
            assert float(by[d, e]['ffn_drop']) == 0.0
        _close_grads(by[d, 0]['ffn_tokens_grad'] + by[d, 1]['ffn_tokens_grad'],
                     g_tokens[d * 16:(d + 1) * 16], 'tokens')
    for e in range(2):
        _close_grads(by[0, e]['ffn_w1_grad'] + by[1, e]['ffn_w1_grad'],
                     g_w1[e * 4:(e + 1) * 4], 'w1')
        _close_grads(by[0, e]['ffn_w2_grad'] + by[1, e]['ffn_w2_grad'],
                     g_w2[e * 4:(e + 1) * 4], 'w2')
    _close_grads(sum(r['ffn_router_grad'] for r in ranks), g_router, 'router')
    want_top2 = _jax_ffn(inputs, num_selected=2)[0]
    for (d, e), r in by.items():
        np.testing.assert_allclose(r['ffn_top2'], want_top2[d * 16:(d + 1) * 16], **TOL)

    # MoEMlp(expert_group=...) against the unsharded module
    for (d, e), r in by.items():
        assert float(r['mlp_drop']) == 0.0
        np.testing.assert_allclose(r['mlp'], r['mlp_want'], **TOL)
    for e in range(2):
        _close_grads(by[0, e]['mlp_w1_grad'] + by[1, e]['mlp_w1_grad'],
                     by[0, e]['mlp_w1_grad_want'], 'MoEMlp w1')
    _close_grads(sum(r['mlp_router_grad'] for r in ranks), ranks[0]['mlp_router_grad_want'],
                 'MoEMlp router')

    # the sp + ep layer
    want_layer = _jax_layer(inputs)
    t_local = LAYER['T'] // 2
    for (s, e), r in by.items():
        np.testing.assert_allclose(r['layer'], want_layer[:, s * t_local:(s + 1) * t_local],
                                   **TOL)

    for r in ranks:
        assert r['error_indivisible'] and r['error_slice'] and r['error_mesh']


if __name__ == '__main__':
    _worker(*sys.argv[1:])
