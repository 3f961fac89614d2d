"""Scaling-families demo on ``torch.distributed``: expert-parallel MoE and
pipeline-parallel training fed from a store, the twin of
``examples/moe/jax_example.py`` on ``petastorm_tpu_torch``.

Both configurations are fed by the same input pipeline (``write_rows`` ->
``make_reader`` -> ``TorchDataLoader(mesh=...)``), whose batches are
``DTensor`` s over the mesh:

- **default (ep)**: :class:`petastorm_tpu_torch.MoETransformerLM` with
  ``expert_group=mesh['expert']`` on a ``('data', 'expert')`` mesh: each rank
  holds ``num_experts / expert`` experts. Every rank reads its own rows (the
  batch is sharded over both dimensions, the reader by the global rank), so
  every rank is in the batch group (``batch_group``, the world in global
  rank order) and the layers route the global batch as the JAX example's
  do. Each rank's loss is its rows' mean plus the global load-balance term,
  the same on every rank; the replicated weights' gradients are averaged
  over every rank and the experts' summed over the data ranks that hold the
  same experts and divided by the world size, which gives the gradient of
  the global mean loss plus that term.
- **``--pipeline-stages N`` (pp)**: an embedding, ``N`` transformer
  ``Block`` s pipelined over a ``('stage', 'data')`` mesh by
  :func:`petastorm_tpu_torch.parallel.pipeline.make_pipeline` (the GPipe
  schedule, one Block a stage, ``--microbatches`` microbatches), and an
  output projection. The reader is sharded by the ``'data'`` coordinate, so
  the stage ranks of one data coordinate read the same rows; gradients are
  averaged over ``'data'``.

``--batch-size`` counts one rank's rows (the JAX example's counts one host's).

Run on the CPU (4 ranks)::

    torchrun --nproc-per-node 4 -m examples.moe.torch_example --device cpu
    torchrun --nproc-per-node 4 -m examples.moe.torch_example --device cpu --pipeline-stages 2

and on one card (one rank, NCCL)::

    torchrun --nproc-per-node 1 -m examples.moe.torch_example --pipeline-stages 1
"""

import argparse
import os
import tempfile

import numpy as np

VOCAB = 256
EMBED = 64
HEADS = 4


def build_dataset(url, num_docs=256, seq_len=128, seed=0):
    """A synthetic learnable corpus, the JAX examples' language: each
    document repeats a per-document 8-token pattern."""
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('Docs', [
        UnischemaField('doc_id', np.int64, (), ScalarCodec(), False),
        UnischemaField('tokens', np.int32, (seq_len,), NdarrayCodec(), False),
    ])
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(num_docs):
        base = rng.randint(0, VOCAB, size=8, dtype=np.int32)
        rows.append({'doc_id': i, 'tokens': np.tile(base, seq_len // 8 + 1)[:seq_len]})
    write_rows(url, schema, rows, n_files=4)
    return schema


def average_gradients(parameters, group, count):
    """Sum every gradient over ``group`` and divide by ``count``."""
    import torch.distributed as dist
    for p in parameters:
        if p.grad is not None:
            dist.all_reduce(p.grad, group=group)
            p.grad /= count


def agreed_batches(loader, group, device):
    """``loader`` 's batches while every rank of ``group`` still has one: the
    data ranks' readers may hold different row counts, and a rank that ran
    one step more would wait for its gradients' all-reduce forever."""
    import torch
    import torch.distributed as dist
    batches = iter(loader)
    while True:
        batch = next(batches, None)
        more = torch.tensor(int(batch is not None), device=device)
        dist.all_reduce(more, op=dist.ReduceOp.MIN, group=group)
        if not int(more):
            return
        yield batch


def pipeline_loss(pipe, stage_params, extra, tokens, n_micro):
    """The JAX example's ``loss_fn``: embed, the pipeline over microbatches,
    the output projection and the mean next-token NLL of this rank's rows."""
    import torch

    from petastorm_tpu_torch.parallel.pipeline import microbatch
    xs = microbatch(extra['embed'][tokens.long()], n_micro)     # [M, mb, T, E]
    logits = pipe(stage_params, xs) @ extra['w_out']            # [M, mb, T, V]
    logp = torch.log_softmax(logits[:, :, :-1], dim=-1)
    targets = microbatch(tokens.long(), n_micro)[:, :, 1:]
    return -torch.gather(logp, -1, targets[..., None]).mean()


def train_pipeline(dataset_url, n_stages=4, batch_size=8, n_micro=2, epochs=2,
                   learning_rate=1e-2, device=None):
    """Pipeline-parallel training: embed -> ``n_stages`` pipelined Blocks ->
    projection, the stage's Block on this rank, batches over ``'data'``."""
    import torch
    import torch.distributed as dist

    from petastorm_tpu_torch import TorchDataLoader, make_reader
    from petastorm_tpu_torch.models.transformer import Block, dense_causal_attention
    from petastorm_tpu_torch.parallel.loader import resolve_device
    from petastorm_tpu_torch.parallel.mesh import (PartitionSpec, initialize_distributed,
                                                   make_mesh, mesh_shard_info)
    from petastorm_tpu_torch.parallel.pipeline import blocks_stage_fn, make_pipeline

    device = resolve_device(device)
    initialize_distributed(device=device)
    n = dist.get_world_size()
    if n % n_stages:
        raise ValueError('stages {} do not divide the world size {}'.format(n_stages, n))
    mesh = make_mesh(('stage', 'data'), (n_stages, n // n_stages), device=device)
    stage = mesh.get_local_rank('stage')
    block = Block(EMBED, HEADS, dtype=torch.float32,
                  generator=torch.Generator().manual_seed(10 + stage)).to(device)
    stage_params = {'0.' + name: p for name, p in block.named_parameters()}
    pipe = make_pipeline(blocks_stage_fn([block], dense_causal_attention), mesh)
    rng = torch.Generator().manual_seed(0)   # the same on every rank: replicated
    extra = {'embed': torch.nn.Parameter((torch.randn(VOCAB, EMBED, generator=rng) * 0.02)
                                         .to(device)),
             'w_out': torch.nn.Parameter((torch.randn(EMBED, VOCAB, generator=rng) * 0.02)
                                         .to(device))}
    parameters = list(stage_params.values()) + list(extra.values())
    optimizer = torch.optim.Adam(parameters, lr=learning_rate)
    data, data_size = mesh_shard_info(mesh, 'data')
    reader = make_reader(dataset_url, schema_fields=['tokens'], num_epochs=epochs,
                         shuffle_row_groups=True, seed=7, cur_shard=data,
                         shard_count=data_size)
    loss = None
    with TorchDataLoader(reader, batch_size=batch_size, mesh=mesh,
                         partition_spec=PartitionSpec('data'), device=device) as loader:
        for step, batch in enumerate(agreed_batches(loader, mesh.get_group('data'), device)):
            optimizer.zero_grad(set_to_none=True)
            loss = pipeline_loss(pipe, stage_params, extra, batch['tokens'].to_local(),
                                 n_micro)
            loss.backward()
            average_gradients(parameters, mesh.get_group('data'), data_size)
            optimizer.step()
            if step % 20 == 0 and dist.get_rank() == 0:
                print('step {} loss {:.4f}'.format(step, float(loss.detach())))
        if dist.get_rank() == 0:
            print('input pipeline stats:', loader.stats.as_dict())
    return stage_params, extra, float(loss.detach())


def train_moe(dataset_url, batch_size=8, epochs=2, expert_axis_size=None, learning_rate=1e-2,
              device=None):
    """Expert-parallel training: one step per loader batch on a ``('data',
    'expert')`` mesh, every rank reading its own rows."""
    import torch
    import torch.distributed as dist

    from petastorm_tpu_torch import (MoETransformerLM, TorchDataLoader, make_reader,
                                     moe_aux_total)
    from petastorm_tpu_torch.models.transformer import next_token_loss
    from petastorm_tpu_torch.parallel.loader import resolve_device
    from petastorm_tpu_torch.parallel.mesh import (PartitionSpec, initialize_distributed,
                                                   make_mesh)

    device = resolve_device(device)
    initialize_distributed(device=device)
    n = dist.get_world_size()
    if expert_axis_size is None:
        expert_axis_size = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    if n % expert_axis_size:
        raise ValueError('expert axis {} does not divide the world size {}'.format(
            expert_axis_size, n))
    mesh = make_mesh(('data', 'expert'), (n // expert_axis_size, expert_axis_size),
                     device=device)
    model = MoETransformerLM(vocab=VOCAB, embed=EMBED, heads=HEADS, layers=2,
                             num_experts=max(2, expert_axis_size), moe_every=2,
                             dtype=torch.float32, expert_group=mesh['expert'],
                             batch_group=dist.group.WORLD, device=device,
                             generator=torch.Generator().manual_seed(0))
    experts = [p for name, p in model.named_parameters() if name.endswith(('.w1', '.w2'))]
    replicated = [p for name, p in model.named_parameters()
                  if not name.endswith(('.w1', '.w2'))]
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate)
    reader = make_reader(dataset_url, schema_fields=['tokens'], num_epochs=epochs,
                         shuffle_row_groups=True, seed=7, cur_shard=dist.get_rank(),
                         shard_count=n)
    loss = None
    # the batch over both dimensions: rank (d, e) holds chunk d * expert + e,
    # which is its global rank, the reader's shard
    spec = PartitionSpec(('data', 'expert'))
    with TorchDataLoader(reader, batch_size=batch_size, mesh=mesh, partition_spec=spec,
                         device=device) as loader:
        for step, batch in enumerate(agreed_batches(loader, None, device)):
            tokens = batch['tokens'].to_local()
            optimizer.zero_grad(set_to_none=True)
            logits, losses = model(tokens)
            loss = next_token_loss(logits, tokens) + moe_aux_total(losses, 0.01)
            loss.backward()
            average_gradients(replicated, None, n)
            average_gradients(experts, mesh.get_group('data'), n)
            optimizer.step()
            if step % 20 == 0 and dist.get_rank() == 0:
                print('step {} loss {:.4f}'.format(step, float(loss.detach())))
        if dist.get_rank() == 0:
            print('input pipeline stats:', loader.stats.as_dict())
    return model, float(loss.detach())


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--dataset-url', default=None)
    parser.add_argument('--num-docs', type=int, default=256)
    parser.add_argument('--seq-len', type=int, default=128)
    parser.add_argument('--batch-size', type=int, default=8)
    parser.add_argument('--epochs', type=int, default=2)
    parser.add_argument('--expert-axis', type=int, default=None,
                        help='expert mesh-dimension size (default: 4 when the world size '
                             'divides, else 2, else 1)')
    parser.add_argument('--pipeline-stages', type=int, default=0,
                        help='train the pipeline-parallel configuration with this many '
                             'stages instead of the MoE one (0 = MoE)')
    parser.add_argument('--microbatches', type=int, default=2)
    parser.add_argument('--device', default=None, help='cuda (default) or cpu')
    args = parser.parse_args()

    import torch.distributed as dist

    from petastorm_tpu_torch.parallel.mesh import initialize_distributed
    initialize_distributed(device=args.device)
    url = args.dataset_url or 'file://' + os.path.join(
        tempfile.gettempdir(), 'moe_torch_demo_{}x{}'.format(args.num_docs, args.seq_len))
    if dist.get_rank() == 0 and not os.path.exists(
            os.path.join(url.replace('file://', ''), '_common_metadata')):
        print('materializing {} docs x {} tokens to {}'.format(args.num_docs, args.seq_len,
                                                               url))
        build_dataset(url, args.num_docs, args.seq_len)
    dist.barrier()
    try:
        if args.pipeline_stages:
            final_loss = train_pipeline(url, n_stages=args.pipeline_stages,
                                        batch_size=args.batch_size, n_micro=args.microbatches,
                                        epochs=args.epochs, device=args.device)[-1]
        else:
            final_loss = train_moe(url, batch_size=args.batch_size, epochs=args.epochs,
                                   expert_axis_size=args.expert_axis, device=args.device)[-1]
        if dist.get_rank() == 0:
            print('final loss: {:.4f}'.format(final_loss))
    finally:
        dist.destroy_process_group()


if __name__ == '__main__':
    main()
