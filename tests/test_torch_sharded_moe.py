"""Expert parallelism in the port (petastorm_tpu_torch.ops.sharded_moe,
MoEMlp(expert_group=...)) on one gloo world of 4 CPU ranks, against the JAX
package's shard_map on a 2 x 2 mesh of the same shards:

- sharded_moe_ffn on a (data=2, expert=2) mesh, forward and gradients;
- MoEMlp(expert_group=...) with capacity_factor 4 (no token dropped) against
  the unsharded module from the same generator seed, outputs and the experts'
  gradients;
- MoEMlp(expert_group=, batch_group=) against the JAX MoEMlp on the whole
  global batch (the weights carried by convert.moe_state_dict_from_flax), at
  capacity_factor 0.5 and 1.25, top-1 and top-2, in both token layouts:
  tokens over 'data' copied over 'expert' (batch_group = the data group) and
  tokens over all 4 ranks (batch_group = the world): outputs, moe_aux,
  moe_drop_fraction, and the gradients of sum(y * probe) + aux by the
  tokens, the router and the experts; then one MoETransformerLM step over
  all 4 ranks: the loss and every gradient against jax.grad of the
  whole-batch next_token_loss + moe_aux_total(weight=0.01);
- the sp + ep layer of tests/test_sharded_moe.py: ring attention over 'seq',
  the expert FFN over 'expert', on a (seq=2, expert=2) mesh;
- the errors: experts not divisible by the group, a wrong local slice, mesh
  sizes that do not multiply to the world size, an expert group without a
  batch group.

The ranks are this file run as a script (no JAX in them), joined by a file
store under tmp_path. Tolerances: float32 outputs rtol 2e-4, atol 2e-5;
gradients within 1e-4 of the largest magnitude. The JAX layer replicates the
tokens over 'expert'; a torch rank's loss is divided by the expert group's
size so that the expert replicas' gradients add up to the data shard's. In
the global-routing cases a rank's loss is its rows' part divided by its
copies plus aux divided by the world size (aux is the same on every rank),
so that the ranks' losses add up to the whole batch's."""

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
#: the global-routing cases: (layout, num_selected, capacity_factor); layout
#: 'data' shards the rows over 'data' and copies them over 'expert', 'all'
#: gives each of the 4 ranks its own rows
ROUTED = [(layout, k, cf) for layout in ('data', 'all') for k in (1, 2) for cf in (0.5, 1.25)]
ROUTED_X, ROUTED_SHAPE = 4, (4, 8, 16)
ROUTED_LM = dict(vocab=32, embed=16, heads=2, layers=2, num_experts=4, max_len=8)


def routed_name(layout, k, cf):
    return 'routed_{}_k{}_c{}'.format(layout, k, cf)


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

    from petastorm_tpu_torch.models.moe import (MoEMlp, MoETransformerLM,
                                                expert_partition_specs, moe_aux_total,
                                                moe_drop_fractions)
    from petastorm_tpu_torch.models.transformer import next_token_loss
    from petastorm_tpu_torch.ops.ring_attention import ring_attention
    from petastorm_tpu_torch.ops.sharded_moe import expert_alltoall_ffn, sharded_moe_ffn
    from petastorm_tpu_torch.parallel.mesh import make_mesh
    from petastorm_tpu_torch.parallel.tensor_parallel import shard_by_spec
    init_world(rank, world, store)
    rank, world_size = int(rank), int(world)
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
    sharded = MoEMlp(16, 4, expert_group=expert, batch_group=data,
                     generator=torch.Generator().manual_seed(11), **kwargs)
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

    # MoEMlp(expert_group=, batch_group=): the global batch routed as JAX does
    world = dist.group.WORLD
    state = {k[len('mlp.'):]: v for k, v in inputs.items() if k.startswith('mlp.')}
    for layout, k, cf in ROUTED:
        rows, copies, batch = ((slice(d * 2, (d + 1) * 2), ne, data) if layout == 'data'
                               else (slice(rank, rank + 1), 1, world))
        layer = MoEMlp(16, ROUTED_X, capacity_factor=cf, num_selected=k, hidden_mult=2,
                       dtype=torch.float32, expert_group=expert, batch_group=batch,
                       device='cpu')
        xl = ROUTED_X // ne
        layer.load_state_dict({name: v[e * xl:(e + 1) * xl] if name in ('w1', 'w2') else v
                               for name, v in state.items()})
        x_rows = leaf(inputs['routed_x'][rows])
        y, losses = layer(x_rows)
        share = ((y * inputs['routed_probe'][rows]).sum() / copies
                 + losses['moe_aux'] / dist.get_world_size())
        share.backward()
        name = routed_name(layout, k, cf)
        out.update({name: y.detach(), name + '_aux': losses['moe_aux'].detach(),
                    name + '_drop': losses['moe_drop_fraction'], name + '_x_grad': x_rows.grad,
                    name + '_router_grad': layer.router.weight.grad,
                    name + '_w1_grad': layer.w1.grad, name + '_w2_grad': layer.w2.grad})

    # one MoETransformerLM step, every rank its own row
    lm_state = {k[len('lm.'):]: v for k, v in inputs.items() if k.startswith('lm.')}
    lm = MoETransformerLM(dtype=torch.float32, expert_group=expert, batch_group=world,
                          device='cpu', **ROUTED_LM)
    specs = expert_partition_specs(lm_state)
    lm.load_state_dict({name: shard_by_spec(v, specs[name], mesh)
                        for name, v in lm_state.items()})
    lm_tokens = inputs['lm_tokens'][rank:rank + 1]
    logits, losses = lm(lm_tokens)
    share = ((next_token_loss(logits, lm_tokens) + moe_aux_total(losses, weight=0.01))
             / world_size)
    share.backward()
    out['lm_loss'] = share.detach()
    out['lm_drop'] = torch.stack(moe_drop_fractions(losses)).detach()
    out.update({'lm_grad.' + name: p.grad for name, p in lm.named_parameters()})

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
    # an expert group with no batch group does not say which ranks hold
    # distinct rows, so it is refused
    out['error_no_batch_group'] = torch.tensor(
        _raises(lambda: MoEMlp(16, 4, expert_group=expert, device='cpu'))
        and _raises(lambda: MoETransformerLM(dtype=torch.float32, expert_group=expert,
                                             device='cpu', **ROUTED_LM)))
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


def _routed_inputs():
    """The JAX MoEMlp's and MoETransformerLM's initial weights in the port's
    layout (prefixed 'mlp.' and 'lm.'), the global batch, the probe and the
    LM's tokens; with the flax modules and variables for the references."""
    import jax
    import jax.numpy as jnp

    from petastorm_tpu.models.moe import MoEMlp as FlaxMoEMlp
    from petastorm_tpu.models.moe import MoETransformerLM as FlaxLM
    from petastorm_tpu_torch.convert import moe_state_dict_from_flax
    rng = np.random.RandomState(7)
    x = rng.randn(*ROUTED_SHAPE).astype(np.float32)
    probe = rng.randn(*ROUTED_SHAPE).astype(np.float32)
    tokens = rng.randint(0, ROUTED_LM['vocab'], (4, ROUTED_LM['max_len'])).astype(np.int32)
    mlp_vars = jax.tree.map(np.asarray, FlaxMoEMlp(num_experts=ROUTED_X, hidden_mult=2).init(
        jax.random.PRNGKey(3), jnp.asarray(x)))
    lm_model = FlaxLM(dtype=jnp.float32, **ROUTED_LM)
    lm_vars = {'params': jax.tree.map(np.asarray, lm_model.init(
        jax.random.PRNGKey(5), jnp.asarray(tokens))['params'])}
    inputs = {'routed_x': x, 'routed_probe': probe, 'lm_tokens': tokens}
    inputs.update({'mlp.' + k: v.numpy() for k, v in moe_state_dict_from_flax(
        {'params': mlp_vars['params']}).items()})
    inputs.update({'lm.' + k: v.numpy() for k, v in moe_state_dict_from_flax(lm_vars).items()})
    return inputs, {'params': mlp_vars['params']}, (lm_model, lm_vars)


def _jax_routed(variables, x, probe, k, cf):
    """The JAX MoEMlp on the whole batch: y, aux, drop fraction, and the
    gradients of sum(y * probe) + aux by the tokens and (in the port's
    layout) the weights."""
    import jax
    import jax.numpy as jnp

    from petastorm_tpu.models.moe import MoEMlp as FlaxMoEMlp
    from petastorm_tpu_torch.convert import moe_state_dict_from_flax
    model = FlaxMoEMlp(num_experts=ROUTED_X, capacity_factor=cf, num_selected=k,
                       hidden_mult=2, dtype=jnp.float32)

    def loss(params, x):
        y, mods = model.apply(params, x, mutable='losses')
        aux, drop = mods['losses']['moe_aux'][0], mods['losses']['moe_drop_fraction'][0]
        return jnp.sum(y * probe) + aux, (y, aux, drop)

    (_, (y, aux, drop)), (g_params, g_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(variables, jnp.asarray(x))
    grads = {k: v.numpy() for k, v in moe_state_dict_from_flax(
        jax.tree.map(np.asarray, g_params)).items()}
    return np.asarray(y), float(aux), float(drop), np.asarray(g_x), grads


def _jax_lm(lm, tokens):
    """jax.grad of the whole batch's next_token_loss + moe_aux_total(weight
    0.01): the loss, the drop fractions and the gradients in the port's
    names."""
    import jax
    import jax.numpy as jnp

    from petastorm_tpu.models.moe import moe_aux_total, moe_drop_fractions
    from petastorm_tpu.models.transformer import next_token_loss
    from petastorm_tpu_torch.convert import moe_state_dict_from_flax
    model, variables = lm

    def loss(params):
        logits, mods = model.apply(params, jnp.asarray(tokens), mutable='losses')
        return (next_token_loss(logits, jnp.asarray(tokens)) + moe_aux_total(mods, weight=0.01),
                jnp.stack(moe_drop_fractions(mods)))

    (value, drops), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables)
    return float(value), np.asarray(drops), {k: v.numpy() for k, v in moe_state_dict_from_flax(
        jax.tree.map(np.asarray, grads)).items()}


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


def _check_routed(ranks, by, mlp_vars, inputs):
    """The global-routing cases against the JAX MoEMlp on the whole batch."""
    x, probe = inputs['routed_x'], inputs['routed_probe']
    for layout, k, cf in ROUTED:
        name = routed_name(layout, k, cf)
        y, aux, drop, g_x, grads = _jax_routed(mlp_vars, x, probe, k, cf)
        if cf < 1:
            assert drop > 0, name
        for (d, e), r in by.items():
            rows = slice(d * 2, (d + 1) * 2) if layout == 'data' else slice(2 * d + e,
                                                                            2 * d + e + 1)
            np.testing.assert_allclose(r[name], y[rows], err_msg=name, **TOL)
            np.testing.assert_allclose(r[name + '_aux'], aux, err_msg=name, **TOL)
            np.testing.assert_allclose(r[name + '_drop'], drop, err_msg=name, **TOL)
            if layout == 'all':
                _close_grads(r[name + '_x_grad'], g_x[rows], name + ' tokens')
        if layout == 'data':
            for d in range(2):
                _close_grads(by[d, 0][name + '_x_grad'] + by[d, 1][name + '_x_grad'],
                             g_x[d * 2:(d + 1) * 2], name + ' tokens')
        _close_grads(sum(r[name + '_router_grad'] for r in ranks), grads['router.weight'],
                     name + ' router')
        for e in range(2):
            for w in ('w1', 'w2'):
                key = '{}_{}_grad'.format(name, w)
                _close_grads(by[0, e][key] + by[1, e][key], grads[w][e * 2:(e + 1) * 2],
                             name + ' ' + w)


def _check_routed_lm(ranks, by, lm, tokens):
    """One MoETransformerLM step over all 4 ranks against jax.grad of the
    whole batch's loss."""
    loss, drops, grads = _jax_lm(lm, tokens)
    np.testing.assert_allclose(sum(float(r['lm_loss']) for r in ranks), loss, **TOL)
    for r in ranks:
        np.testing.assert_allclose(r['lm_drop'], drops, **TOL)
    for name, want in grads.items():
        if name.endswith(('.w1', '.w2')):
            for e in range(2):
                _close_grads(by[0, e]['lm_grad.' + name] + by[1, e]['lm_grad.' + name],
                             want[e * 2:(e + 1) * 2], 'lm ' + name)
        else:
            _close_grads(sum(r['lm_grad.' + name] for r in ranks), want, 'lm ' + name)


def test_expert_parallel_ops_on_a_gloo_world_of_four(tmp_path):
    inputs = _inputs()
    routed, mlp_vars, lm = _routed_inputs()
    inputs.update(routed)
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

    # MoEMlp and MoETransformerLM over the global batch against JAX
    _check_routed(ranks, by, mlp_vars, inputs)
    _check_routed_lm(ranks, by, lm, inputs['lm_tokens'])

    for r in ranks:
        assert r['error_indivisible'] and r['error_slice'] and r['error_mesh']
        assert r['error_no_batch_group']


if __name__ == '__main__':
    _worker(*sys.argv[1:])
