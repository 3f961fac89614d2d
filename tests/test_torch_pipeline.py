"""Pipeline parallelism in the port (petastorm_tpu_torch.parallel.pipeline,
J8) on one gloo world of 4 CPU ranks, against the JAX package's make_pipeline
(shard_map + ppermute) on 4 of its CPU devices, the counterparts of
tests/test_pipeline.py:

- four float32 transformer Block stages on a ('stage',) mesh: the forward
  for one microbatch and for many, and the gradients of a loss through the
  pipeline, against JAX's make_pipeline and against a sequential loop over
  the stages; the weights are flax Block params drawn from a seed with
  numpy, stacked, and carried to the port by block_state_dicts_from_flax;
- dp + pp on a 2 x 2 ('stage', 'data') mesh: the losses of 2 Adam steps;
- pp + ep: a Switch-routed expert FFN (sharded_moe_ffn, its all-to-all over
  'expert') inside each stage on a ('stage', 'expert') mesh;
- pp x tp x dp on a ('stage', 'data', 'model') mesh of 2 x 1 x 2: a
  tensor-parallel MLP inside each stage (hidden dimension over 'model',
  through parallel.tensor_parallel's copy_to_group and reduce_from_group);
- the guards: no stage dimension, a params_spec that does not shard dim 0
  over 'stage', a stage that changes shape, no stages, an uneven
  microbatch split.

Tolerances (float32): the Block pipeline's forward rtol 1e-5, atol 1e-6 and
its gradients rtol 1e-4, atol 1e-6, against JAX and against the sequential
loop; the Adam losses rtol 1e-5; the expert and tensor-parallel stages rtol
3e-5, atol 3e-6 forward and gradients within 1e-4 of the largest magnitude
(their reductions run in another order across the exchanges)."""

import os
import sys

import numpy as np
import pytest
import torch

from test_torch_sharded_moe import init_world, run_world

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
SHARDED = dict(rtol=3e-5, atol=3e-6)
E, HEADS, T, MB = 32, 2, 8, 2          # the Block stages: embed, heads, length, rows
MANY = 6                               # microbatches of the "many" case
N_EXP, D, F = 4, 8, 16                 # the expert stages (tests/test_pipeline.py)
TP_HID = 16


def flax_block_params(rng, embed=E):
    """One flax Block's params of width ``embed``, from ``rng``."""
    def dense(n_in, n_out, bias):
        layer = {'kernel': (0.5 * rng.randn(n_in, n_out) / np.sqrt(n_in)).astype(np.float32)}
        if bias:
            layer['bias'] = (rng.randn(n_out) * 0.1).astype(np.float32)
        return layer

    def norm():
        return {'scale': (1 + 0.1 * rng.randn(embed)).astype(np.float32),
                'bias': (0.1 * rng.randn(embed)).astype(np.float32)}
    return {'LayerNorm_0': norm(), 'Dense_0': dense(embed, 3 * embed, False),
            'Dense_1': dense(embed, embed, False), 'LayerNorm_1': norm(),
            'Dense_2': dense(embed, 4 * embed, True), 'Dense_3': dense(4 * embed, embed, True)}


def stacked_blocks(seed, stages, embed=E):
    """flax Block params of ``stages`` stages, stacked along a leading axis."""
    rng = np.random.RandomState(seed)
    blocks = [flax_block_params(rng, embed) for _ in range(stages)]
    return {layer: {name: np.stack([b[layer][name] for b in blocks])
                    for name in blocks[0][layer]} for layer in blocks[0]}


def _flatten(stacked):
    return {'{}:{}'.format(layer, name): value for layer, leaves in stacked.items()
            for name, value in leaves.items()}


def _unflatten(flat):
    out = {}
    for key, value in flat.items():
        layer, name = key.split(':')
        out.setdefault(layer, {})[name] = value
    return out


def _inputs():
    rng = np.random.RandomState(5)
    inputs = {'ppw_' + k: v for k, v in _flatten(stacked_blocks(0, 4)).items()}
    inputs.update({'dpw_' + k: v for k, v in _flatten(stacked_blocks(1, 2)).items()})
    inputs.update(
        xs_one=rng.randn(1, MB, T, E).astype(np.float32),
        xs_many=rng.randn(MANY, MB, T, E).astype(np.float32),
        target=(0.1 * rng.randn(MANY, MB, T, E)).astype(np.float32),
        dp_xs=rng.randn(2, 4, T, E).astype(np.float32),
        dp_target=(0.1 * rng.randn(2, 4, T, E)).astype(np.float32),
        ep_router=(rng.randn(2, D, N_EXP) * 0.5).astype(np.float32),
        ep_w1=(rng.randn(2, N_EXP, D, F) * 0.3).astype(np.float32),
        ep_w2=(rng.randn(2, N_EXP, F, D) * 0.3).astype(np.float32),
        ep_xs=rng.randn(2, 4, D).astype(np.float32),
        tp_w1=(rng.randn(2, D, TP_HID) * 0.3).astype(np.float32),
        tp_w2=(rng.randn(2, TP_HID, D) * 0.3).astype(np.float32),
        tp_xs=rng.randn(4, 2, D).astype(np.float32))
    return inputs


# ------------------------------------------------------------------ the ranks

def _raises(fn):
    try:
        fn()
    except ValueError:
        return True
    return False


def _local_stage_params(stacked, mesh, params_spec=None):
    """This rank's piece of a stacked dict, as ``shard_map`` hands it to the
    JAX ``local_fn``: ``shard_by_spec`` of each leaf (dim 0 over ``'stage'``
    when ``params_spec``, None, one spec or a dict of specs, gives none), the
    stages dimension dropped."""
    from petastorm_tpu_torch.parallel.tensor_parallel import shard_by_spec
    out = {}
    for name, leaf in stacked.items():
        spec = params_spec.get(name) if isinstance(params_spec, dict) else params_spec
        out[name] = shard_by_spec(leaf, spec or ('stage',), mesh)[0].contiguous().clone()
    return out


def _worker(rank, world, store, workdir):
    import torch.distributed as dist

    from petastorm_tpu_torch.convert import block_state_dicts_from_flax
    from petastorm_tpu_torch.models.transformer import Block, dense_causal_attention
    from petastorm_tpu_torch.ops.sharded_moe import gelu, sharded_moe_ffn
    from petastorm_tpu_torch.parallel.mesh import PartitionSpec as P
    from petastorm_tpu_torch.parallel.mesh import make_mesh
    from petastorm_tpu_torch.parallel.pipeline import (blocks_stage_fn, make_pipeline,
                                                       stack_stage_params,
                                                       stage_partition_specs,
                                                       unstack_stage_params)
    from petastorm_tpu_torch.parallel.tensor_parallel import copy_to_group, reduce_from_group
    init_world(rank, world, store)
    raw = dict(np.load(os.path.join(workdir, 'inputs.npz')))
    inputs = {k: torch.from_numpy(v) for k, v in raw.items()}
    out = {}

    def block():
        return Block(E, HEADS, dtype=torch.float32)

    def leaves(params):
        return {k: v.clone().requires_grad_() for k, v in params.items()}

    # four Block stages on ('stage',): forward for one and many microbatches,
    # gradients, and the sequential loop over all four stages
    pp = _unflatten({k[4:]: v for k, v in raw.items() if k.startswith('ppw_')})
    states = block_state_dicts_from_flax(pp)
    stacked = stack_stage_params(states)
    mesh = make_mesh(('stage',), device='cpu')
    s = mesh.get_local_rank('stage')
    module = block()
    stage_fn = blocks_stage_fn([module], dense_causal_attention)
    pipe = make_pipeline(stage_fn, mesh)
    mine = {'0.' + k: v for k, v in _local_stage_params(stacked, mesh).items()}
    assert all(torch.equal(v, unstack_stage_params(stacked, s)[k[2:]]) for k, v in mine.items())
    with torch.no_grad():
        out['pp_one'] = pipe(mine, inputs['xs_one'])
    params = leaves(mine)
    ys = pipe(params, inputs['xs_many'])
    ((ys - inputs['target']) ** 2).mean().backward()
    out['pp_many'] = ys.detach()
    out.update({'pp_grad_' + k[2:]: v.grad for k, v in params.items()})
    seq = [leaves(state) for state in states]
    x = inputs['xs_many'].reshape(MANY * MB, T, E)
    for state in seq:
        x = torch.func.functional_call(module, state, (x, dense_causal_attention))
    x = x.reshape(MANY, MB, T, E)
    ((x - inputs['target']) ** 2).mean().backward()
    out['seq_many'] = x.detach()
    out.update({'seq_grad_' + k: v.grad for k, v in seq[s].items()})
    out['specs_ok'] = torch.tensor(stage_partition_specs(stacked)['qkv.weight']
                                   == P('stage', None, None))

    # dp + pp on ('stage', 'data'): 2 Adam steps
    mesh = make_mesh(('stage', 'data'), (2, 2), device='cpu')
    s, d = mesh.get_local_rank('stage'), mesh.get_local_rank('data')
    data = mesh.get_group('data')
    dp = _unflatten({k[4:]: v for k, v in raw.items() if k.startswith('dpw_')})
    params = {'0.' + k: v.clone().requires_grad_()
              for k, v in block_state_dicts_from_flax(dp)[s].items()}
    pipe = make_pipeline(stage_fn, mesh)
    optimizer = torch.optim.Adam(params.values(), lr=1e-2)
    xs, target = inputs['dp_xs'][:, 2 * d:2 * d + 2], inputs['dp_target'][:, 2 * d:2 * d + 2]
    losses = []
    for _ in range(2):
        optimizer.zero_grad()
        loss = ((pipe(params, xs) - target) ** 2).mean()
        loss.backward()
        for value in params.values():
            dist.all_reduce(value.grad, group=data)
            value.grad /= 2
        optimizer.step()
        total = loss.detach().clone()
        dist.all_reduce(total, group=data)
        losses.append(total / 2)
    out['dp_losses'] = torch.stack(losses)

    # pp + ep on ('stage', 'expert'): each stage an expert-routed FFN
    mesh = make_mesh(('stage', 'expert'), (2, 2), device='cpu')
    s, e = mesh.get_local_rank('stage'), mesh.get_local_rank('expert')
    specs = {'router': P('stage', None, None), 'w1': P('stage', 'expert', None, None),
             'w2': P('stage', 'expert', None, None)}
    ep = {k: inputs['ep_' + k] for k in ('router', 'w1', 'w2')}
    params = leaves(_local_stage_params(ep, mesh, specs))

    def moe_stage(p, mb):
        return mb + sharded_moe_ffn(mb, p['router'], p['w1'], p['w2'], mesh['expert'],
                                    capacity_factor=8.0)[0]
    pipe = make_pipeline(moe_stage, mesh, params_spec=specs)
    ys = pipe(params, inputs['ep_xs'])
    ((ys ** 2).sum() / 2).backward()
    out.update(ep=ys.detach(), **{'ep_grad_' + k: v.grad for k, v in params.items()})

    # pp x tp x dp on ('stage', 'data', 'model'): a tensor-parallel MLP a stage
    mesh = make_mesh(('stage', 'data', 'model'), (2, 1, 2), device='cpu')
    model = mesh.get_group('model')
    specs = {'w1': P('stage', None, 'model'), 'w2': P('stage', 'model', None)}
    params = leaves(_local_stage_params({k: inputs['tp_' + k] for k in ('w1', 'w2')}, mesh,
                                       specs))

    def tp_stage(p, mb):
        h = gelu(copy_to_group(mb, model) @ p['w1'])
        return mb + reduce_from_group(h @ p['w2'], model)
    pipe = make_pipeline(tp_stage, mesh, params_spec=specs)
    ys = pipe(params, inputs['tp_xs'])
    (ys ** 2).sum().backward()
    out.update(tp=ys.detach(), **{'tp_grad_' + k: v.grad for k, v in params.items()})

    # the guards
    stage_mesh = make_mesh(('stage',), device='cpu')
    out['error_axis'] = torch.tensor(_raises(lambda: make_pipeline(
        stage_fn, make_mesh(('data',), device='cpu'))))
    out['error_spec'] = torch.tensor(
        _raises(lambda: make_pipeline(stage_fn, mesh, params_spec={'w1': P('model', 'stage')}))
        and _raises(lambda: make_pipeline(stage_fn, mesh, params_spec={'w1': P('stage'),
                                                                      'w2': None})))

    def widen(p, mb):
        return torch.cat([mb, mb], dim=-1)
    out['error_shape'] = torch.tensor(_raises(lambda: make_pipeline(widen, stage_mesh)(
        {}, torch.zeros(2, 2, D))))
    np.savez(os.path.join(workdir, 'rank{}.npz'.format(rank)),
             **{k: v.detach().numpy() for k, v in out.items()})
    dist.destroy_process_group()


# ------------------------------------------------------------------ the JAX side

def _jax_mesh(shape, names):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:4]).reshape(shape), names)


def _jax_blocks(inputs):
    """make_pipeline of four flax Blocks: outputs for one and many
    microbatches, and the gradients of the many case's loss."""
    import jax
    import jax.numpy as jnp

    from petastorm_tpu.models.transformer import Block, dense_causal_attention
    from petastorm_tpu.parallel.pipeline import make_pipeline
    block = Block(heads=HEADS, attention_fn=dense_causal_attention, dtype=jnp.float32)
    pipe = jax.jit(make_pipeline(lambda p, mb: block.apply({'params': p}, mb),
                                 _jax_mesh((4,), ('stage',))))
    stacked = jax.tree.map(jnp.asarray, _unflatten(
        {k[4:]: v for k, v in inputs.items() if k.startswith('ppw_')}))
    one = pipe(stacked, jnp.asarray(inputs['xs_one']))
    many = pipe(stacked, jnp.asarray(inputs['xs_many']))
    target = jnp.asarray(inputs['target'])
    grads = jax.jit(jax.grad(lambda p: jnp.mean((pipe(p, jnp.asarray(inputs['xs_many']))
                                                 - target) ** 2)))(stacked)
    return np.asarray(one), np.asarray(many), jax.tree.map(np.asarray, grads)


def _jax_dp_losses(inputs):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as JP

    from petastorm_tpu.models.transformer import Block, dense_causal_attention
    from petastorm_tpu.parallel.pipeline import make_pipeline
    block = Block(heads=HEADS, attention_fn=dense_causal_attention, dtype=jnp.float32)
    spec = JP(None, 'data', None, None)
    pipe = make_pipeline(lambda p, mb: block.apply({'params': p}, mb),
                         _jax_mesh((2, 2), ('stage', 'data')), xs_spec=spec, out_spec=spec)
    params = jax.tree.map(jnp.asarray, _unflatten(
        {k[4:]: v for k, v in inputs.items() if k.startswith('dpw_')}))
    xs, target = jnp.asarray(inputs['dp_xs']), jnp.asarray(inputs['dp_target'])
    optimizer = optax.adam(1e-2)
    opt_state = optimizer.init(params)

    @jax.jit
    def step(params, opt_state):
        loss, grads = jax.value_and_grad(lambda p: jnp.mean((pipe(p, xs) - target) ** 2))(
            params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    for _ in range(2):
        params, opt_state, loss = step(params, opt_state)
        losses.append(float(loss))
    return np.asarray(losses)


def _jax_expert(inputs):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from petastorm_tpu.ops.sharded_moe import sharded_moe_ffn
    from petastorm_tpu.parallel.pipeline import make_pipeline
    specs = {'router': JP('stage', None, None), 'w1': JP('stage', 'expert', None, None),
             'w2': JP('stage', 'expert', None, None)}

    def stage(p, mb):
        return mb + sharded_moe_ffn(mb, p['router'], p['w1'], p['w2'], 'expert',
                                    capacity_factor=8.0)[0]
    pipe = make_pipeline(stage, _jax_mesh((2, 2), ('stage', 'expert')), params_spec=specs)
    params = {k: jnp.asarray(inputs['ep_' + k]) for k in ('router', 'w1', 'w2')}
    xs = jnp.asarray(inputs['ep_xs'])
    grads = jax.jit(jax.grad(lambda p: jnp.sum(pipe(p, xs) ** 2)))(params)
    return np.asarray(jax.jit(pipe)(params, xs)), {k: np.asarray(v) for k, v in grads.items()}


def _jax_tensor_parallel(inputs):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from petastorm_tpu.parallel.pipeline import make_pipeline
    specs = {'w1': JP('stage', None, 'model'), 'w2': JP('stage', 'model', None)}

    def stage(p, mb):
        h = jax.nn.gelu(mb @ p['w1'])
        return mb + jax.lax.psum(h @ p['w2'], 'model')
    pipe = make_pipeline(stage, _jax_mesh((2, 1, 2), ('stage', 'data', 'model')),
                         params_spec=specs)
    params = {k: jnp.asarray(inputs['tp_' + k]) for k in ('w1', 'w2')}
    xs = jnp.asarray(inputs['tp_xs'])
    grads = jax.jit(jax.grad(lambda p: jnp.sum(pipe(p, xs) ** 2)))(params)
    return np.asarray(jax.jit(pipe)(params, xs)), {k: np.asarray(v) for k, v in grads.items()}


# ------------------------------------------------------------------ the tests

def _close_grads(got, want, name):
    np.testing.assert_allclose(got, want, atol=1e-4 * float(np.abs(want).max()), rtol=0,
                               err_msg=name)


def test_pipeline_families_on_a_gloo_world_of_four(tmp_path):
    from petastorm_tpu_torch.convert import block_state_dicts_from_flax
    inputs = _inputs()
    ranks = run_world(os.path.abspath(__file__), tmp_path, inputs)

    # four Block stages: rank s runs stage s
    one, many, grads = _jax_blocks(inputs)
    want = block_state_dicts_from_flax(grads)   # JAX's gradients in the port's layout
    for s, r in enumerate(ranks):
        np.testing.assert_allclose(r['pp_one'], one, **FWD)
        np.testing.assert_allclose(r['pp_many'], many, **FWD)
        np.testing.assert_allclose(r['pp_many'], r['seq_many'], **FWD)
        for name, value in want[s].items():
            np.testing.assert_allclose(r['pp_grad_' + name], value.numpy(), err_msg=name,
                                       **GRAD)
            np.testing.assert_allclose(r['pp_grad_' + name], r['seq_grad_' + name],
                                       err_msg=name, **GRAD)
        assert r['specs_ok']

    # dp + pp: the same losses on every rank, JAX's
    jax_losses = _jax_dp_losses(inputs)
    for r in ranks:
        np.testing.assert_allclose(r['dp_losses'], jax_losses, rtol=1e-5)
    assert jax_losses[1] < jax_losses[0]

    # pp + ep: rank = 2 * stage + expert; the experts' gradients are their
    # owner's, the router's the sum over the expert ranks of the loss / 2
    ys, grads = _jax_expert(inputs)
    for rank, r in enumerate(ranks):
        s, e = divmod(rank, 2)
        np.testing.assert_allclose(r['ep'], ys, **SHARDED)
        for name in ('w1', 'w2'):
            _close_grads(r['ep_grad_' + name], grads[name][s, 2 * e:2 * e + 2], name)
    for s in range(2):
        _close_grads(ranks[2 * s]['ep_grad_router'] + ranks[2 * s + 1]['ep_grad_router'],
                     grads['router'][s], 'router')
    assert np.abs(grads['w1']).sum() > 0

    # pp x tp x dp: rank = 2 * stage + model
    ys, grads = _jax_tensor_parallel(inputs)
    half = TP_HID // 2
    for rank, r in enumerate(ranks):
        s, m = divmod(rank, 2)
        np.testing.assert_allclose(r['tp'], ys, **SHARDED)
        _close_grads(r['tp_grad_w1'], grads['w1'][s][:, m * half:(m + 1) * half], 'w1')
        _close_grads(r['tp_grad_w2'], grads['w2'][s][m * half:(m + 1) * half], 'w2')

    for r in ranks:
        assert r['error_axis'] and r['error_spec'] and r['error_shape']


def test_stacking_and_microbatch_guards():
    from petastorm_tpu_torch.parallel.pipeline import (microbatch, stack_stage_params,
                                                       unstack_stage_params)
    batch = torch.zeros(8, D)
    assert microbatch(batch, 4).shape == (4, 2, D)
    with pytest.raises(ValueError, match='not divisible'):
        microbatch(batch, 3)
    with pytest.raises(ValueError, match='at least one stage'):
        stack_stage_params([])
    with pytest.raises(ValueError, match='different parameters'):
        stack_stage_params([{'w': torch.zeros(2)}, {'b': torch.zeros(2)}])
    stages = [{'w': torch.full((2, 3), float(i)), 'b': torch.full((3,), -float(i))}
              for i in range(3)]
    stacked = stack_stage_params(stages)
    assert stacked['w'].shape == (3, 2, 3) and stacked['b'].shape == (3, 3)
    for i, stage in enumerate(stages):
        assert all(torch.equal(unstack_stage_params(stacked, i)[k], v) for k, v in stage.items())


def test_block_converter_matches_the_flax_block():
    """block_state_dicts_from_flax against flax Block.apply, stage by stage."""
    import jax.numpy as jnp

    from petastorm_tpu.models.transformer import Block as FlaxBlock
    from petastorm_tpu.models.transformer import dense_causal_attention as jax_attention
    from petastorm_tpu_torch.convert import block_state_dicts_from_flax
    from petastorm_tpu_torch.models.transformer import Block, dense_causal_attention
    stacked = stacked_blocks(3, 2)
    x = np.random.RandomState(4).randn(MB, T, E).astype(np.float32)
    flax_block = FlaxBlock(heads=HEADS, attention_fn=jax_attention, dtype=jnp.float32)
    block = Block(E, HEADS, dtype=torch.float32)
    for s, state in enumerate(block_state_dicts_from_flax(stacked)):
        params = {layer: {k: jnp.asarray(v[s]) for k, v in leaves.items()}
                  for layer, leaves in stacked.items()}
        want = np.asarray(flax_block.apply({'params': params}, jnp.asarray(x)))
        block.load_state_dict(state)
        got = block(torch.from_numpy(x), dense_causal_attention).detach().numpy()
        np.testing.assert_allclose(got, want, **FWD)


if __name__ == '__main__':
    _worker(*sys.argv[1:])
