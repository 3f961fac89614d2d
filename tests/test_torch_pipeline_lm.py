"""The slice at a small size on one gloo world of 4 CPU ranks: a token store
-> make_reader (sharded by the 'data' coordinate) -> TorchDataLoader(mesh)
on a 2 x 2 ('stage', 'data') mesh -> the pipelined LM of
examples/moe/torch_example.py (embed, two pipelined float32 Blocks with
dense causal attention, the output projection; embed 64, heads 4, T 128,
2 microbatches), held against the JAX example's loss_fn
(examples/moe/jax_example.py:131-138) through the JAX package's
make_pipeline with the same weights and the same global batch: the loss
rtol 1e-5, the gradients of every weight within 1e-4 of their largest
magnitude. The port's gradients are averaged over 'data', as a
data-parallel step does; JAX's are of the global batch's mean loss."""

import os
import sys

import numpy as np

from test_torch_pipeline import _close_grads, _flatten, _unflatten, stacked_blocks
from test_torch_sharded_moe import init_world, run_world

VOCAB, EMBED, HEADS, T, N_MICRO, BATCH = 256, 64, 4, 128, 2, 2


def _weights():
    rng = np.random.RandomState(12)
    inputs = {'stage_' + k: v for k, v in _flatten(stacked_blocks(11, 2, EMBED)).items()}
    inputs['embed'] = (rng.randn(VOCAB, EMBED) * 0.02).astype(np.float32)
    inputs['w_out'] = (rng.randn(EMBED, VOCAB) * 0.02).astype(np.float32)
    return inputs


# ------------------------------------------------------------------ the ranks

def _worker(rank, world, store, workdir):
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from examples.moe.torch_example import average_gradients, pipeline_loss
    from petastorm_tpu_torch import TorchDataLoader, make_reader
    from petastorm_tpu_torch.convert import block_state_dicts_from_flax
    from petastorm_tpu_torch.models.transformer import Block, dense_causal_attention
    from petastorm_tpu_torch.parallel.mesh import PartitionSpec, make_mesh, mesh_shard_info
    from petastorm_tpu_torch.parallel.pipeline import blocks_stage_fn, make_pipeline
    init_world(rank, world, store)
    inputs = dict(np.load(os.path.join(workdir, 'inputs.npz')))
    mesh = make_mesh(('stage', 'data'), (2, 2), device='cpu')
    stage = mesh.get_local_rank('stage')
    cur_shard, shard_count = mesh_shard_info(mesh, 'data')
    reader = make_reader('file://' + os.path.join(workdir, 'dataset'), reader_pool_type='dummy',
                         shuffle_row_groups=False, cur_shard=cur_shard, shard_count=shard_count,
                         schema_fields=['tokens'])
    with TorchDataLoader(reader, batch_size=BATCH, mesh=mesh, partition_spec=PartitionSpec('data'),
                         device='cpu') as loader:
        batch = next(iter(loader))
    assert isinstance(batch['tokens'], DTensor)
    tokens = batch['tokens'].to_local()

    stacked = _unflatten({k[6:]: v for k, v in inputs.items() if k.startswith('stage_')})
    block = Block(EMBED, HEADS, dtype=torch.float32)
    stage_params = {'0.' + k: v.requires_grad_()
                    for k, v in block_state_dicts_from_flax(stacked)[stage].items()}
    extra = {k: torch.from_numpy(inputs[k]).requires_grad_() for k in ('embed', 'w_out')}
    pipe = make_pipeline(blocks_stage_fn([block], dense_causal_attention), mesh)
    loss = pipeline_loss(pipe, stage_params, extra, tokens, N_MICRO)
    loss.backward()
    data = mesh.get_group('data')
    params = list(stage_params.values()) + list(extra.values())
    average_gradients(params, data, shard_count)
    total = loss.detach().clone()
    dist.all_reduce(total, group=data)
    out = {'tokens': tokens.numpy(), 'loss': (total / shard_count).numpy(),
           'embed_grad': extra['embed'].grad.numpy(), 'w_out_grad': extra['w_out'].grad.numpy()}
    out.update({'grad_' + k[2:]: v.grad.numpy() for k, v in stage_params.items()})
    np.savez(os.path.join(workdir, 'rank{}.npz'.format(rank)), **out)
    dist.destroy_process_group()


# ------------------------------------------------------------------ the JAX side

def _jax_loss_and_grads(inputs, tokens):
    """jax_example.py's loss_fn (:131-138) with the same weights."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from petastorm_tpu.models.transformer import Block, dense_causal_attention
    from petastorm_tpu.parallel.pipeline import make_pipeline, microbatch
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ('stage', 'data'))
    block = Block(heads=HEADS, attention_fn=dense_causal_attention, dtype=jnp.float32)
    pipe = make_pipeline(lambda p, mb: block.apply({'params': p}, mb), mesh,
                         xs_spec=P(None, 'data', None, None), out_spec=P(None, 'data', None, None))

    def loss_fn(params, tokens):
        stacked, extra = params
        xs = microbatch(extra['embed'][tokens], N_MICRO)
        logits = pipe(stacked, xs) @ extra['w_out']
        logp = jax.nn.log_softmax(logits[:, :, :-1], axis=-1)
        targets = microbatch(tokens, N_MICRO)[:, :, 1:]
        return jnp.mean(-jnp.take_along_axis(logp, targets[..., None], axis=-1))

    stacked = jax.tree.map(jnp.asarray, _unflatten(
        {k[6:]: v for k, v in inputs.items() if k.startswith('stage_')}))
    extra = {k: jnp.asarray(inputs[k]) for k in ('embed', 'w_out')}
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))((stacked, extra), jnp.asarray(tokens))
    return float(loss), jax.tree.map(np.asarray, grads)


def test_pipelined_lm_fed_by_the_mesh_loader_matches_jax(tmp_path):
    from examples.moe.torch_example import build_dataset
    from petastorm_tpu_torch.convert import block_state_dicts_from_flax
    build_dataset('file://' + str(tmp_path / 'dataset'), num_docs=32, seq_len=T)
    inputs = _weights()
    ranks = run_world(os.path.abspath(__file__), tmp_path, inputs)
    # rank = 2 * stage + data; the global batch is the data ranks' rows in order
    for d in range(2):
        np.testing.assert_array_equal(ranks[d]['tokens'], ranks[2 + d]['tokens'])
    tokens = np.concatenate([ranks[0]['tokens'], ranks[1]['tokens']])
    assert tokens.shape == (2 * BATCH, T) and len({r.tobytes() for r in tokens}) == 2 * BATCH
    loss, (stage_grads, extra_grads) = _jax_loss_and_grads(inputs, tokens)
    want = block_state_dicts_from_flax(stage_grads)
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(float(r['loss']), loss, rtol=1e-5)
        for name in ('embed', 'w_out'):
            _close_grads(r[name + '_grad'], extra_grads[name], name)
        for name, value in want[rank // 2].items():
            _close_grads(r['grad_' + name], value.numpy(), name)


if __name__ == '__main__':
    _worker(*sys.argv[1:])
