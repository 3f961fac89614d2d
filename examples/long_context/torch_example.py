"""Long-context training from Parquet on ``torch.distributed``: the twin of
``examples/long_context/jax_example.py`` on ``petastorm_tpu_torch``.

The loader's batches are ``DTensor`` s over a ``('data', 'seq')`` mesh
(``make_mesh``; ``--data-axis`` sets the data dimension, the sequence
dimension takes the other ranks) with ``PartitionSpec('data')``: the reader
is sharded by the data coordinate, so the ranks along ``'seq'`` hold the same
whole rows, which ``ring_attention_sharded`` cuts itself (the JAX example's
``PartitionSpec('data', 'seq')`` would hand each rank its slice instead).
``TransformerLM`` trains with ``ring_attention_sharded`` over ``'seq'`` as its
attention: each rank computes attention over its own sequence shard, the K/V
blocks rotating round the ring, and each block is the flash kernels (K2-K4 on
the card). The model runs on the global batch on every rank; the attention
inputs' gradients are summed over the ranks (each rank's ring fills only its
own shard's), so every rank takes the same step.

Three dataset modes, as in the JAX example:

- default: fixed-length tokenized documents (one ``(seq_len,)`` row each);
- ``--ngram-frames N``: a token stream stored as frames, each training
  sequence an ``NGram`` window of N consecutive frames, ``(batch, N,
  frame_len)``, flattened to ``(batch, N * frame_len)``;
- ``--packed``: ragged documents of a plain Parquet store packed into
  ``seq_len`` bins by ``make_packing_transform`` in the reader's workers;
  the segment ids ride the ring with their K/V blocks (segmented K2-K4) and
  ``packed_next_token_loss`` counts only predictions within a document.

The width is set by ``--embed``, ``--heads``, ``--layers`` and ``--dtype``.
The ring's blocks are the flash kernels, which take head_dim 64 or 128: the
defaults (embed 128, 2 heads) are the JAX example's nearest width they take
(its embed 64 over 4 heads is head_dim 16).

Run at one rank (``torchrun`` for more)::

    python -m examples.long_context.torch_example --seq-len 512
    python -m examples.long_context.torch_example --packed --device cpu
"""

import argparse
import os
import shutil
import tempfile

import numpy as np

VOCAB = 256


def build_dataset(url, num_docs=256, seq_len=512, seed=0):
    """The JAX example's synthetic tokenized documents: each repeats a
    per-document 8-token pattern."""
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
        tokens = np.tile(base, seq_len // 8 + 1)[:seq_len].astype(np.int32)
        rows.append({'doc_id': i, 'tokens': tokens})
    write_rows(url, schema, rows, n_files=4)
    return schema


def build_frame_dataset(url, num_frames=512, frame_len=64, seed=0):
    """The JAX example's token stream stored as consecutive frames ordered by
    ``frame_id`` (the NGram timestamp)."""
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('Frames', [
        UnischemaField('frame_id', np.int64, (), ScalarCodec(), False),
        UnischemaField('tokens', np.int32, (frame_len,), NdarrayCodec(), False),
    ])
    rng = np.random.RandomState(seed)
    base = rng.randint(0, VOCAB, size=8, dtype=np.int32)
    stream = np.tile(base, num_frames * frame_len // 8 + 1)[:num_frames * frame_len]
    rows = [{'frame_id': i, 'tokens': stream[i * frame_len:(i + 1) * frame_len]
             .astype(np.int32)} for i in range(num_frames)]
    write_rows(url, schema, rows, rows_per_file=max(64, num_frames // 4),
               rowgroup_size_mb=64)
    return schema


def build_ragged_dataset(url, num_docs=256, max_len=48, seed=0):
    """The JAX example's plain Parquet store of variable-length documents
    (``doc_id`` int64, ``tokens`` ``list<int32>``) in 4 files."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.fs_utils import get_filesystem_and_path_or_paths
    fs, path = get_filesystem_and_path_or_paths(url)
    fs.create_dir(path, recursive=True)
    rng = np.random.RandomState(seed)
    docs = []
    for _ in range(num_docs):
        base = rng.randint(0, VOCAB, size=8, dtype=np.int32)
        n = int(rng.randint(8, max_len + 1))
        docs.append(np.tile(base, n // 8 + 1)[:n].astype(np.int32).tolist())
    per_file = max(1, num_docs // 4)
    for part in range(0, num_docs, per_file):
        chunk = docs[part:part + per_file]
        table = pa.table({
            'doc_id': np.arange(part, part + len(chunk), dtype=np.int64),
            'tokens': pa.array(chunk, type=pa.list_(pa.int32())),
        })
        with fs.open_output_stream('{}/part_{}.parquet'.format(path, part)) as sink:
            pq.write_table(table, sink)


def make_data_seq_mesh(data_axis, device):
    """The ``(data, seq)`` mesh over every rank: data 2 on an even world size
    above 1 unless ``data_axis`` says otherwise, seq the rest."""
    import torch.distributed as dist

    from petastorm_tpu_torch.parallel.mesh import make_mesh
    n = dist.get_world_size()
    if data_axis is None:
        data_axis = 2 if n % 2 == 0 and n > 1 else 1
    if n % data_axis:
        raise ValueError('data_axis {} does not divide the world size {}'.format(data_axis, n))
    return make_mesh(('data', 'seq'), (data_axis, n // data_axis), device=device)


def _sum_grad_over_ranks():
    """Identity forward whose backward sums the gradient over every rank."""
    import torch
    import torch.distributed as dist

    class SumGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, grad):
            grad = grad.contiguous()
            if dist.get_world_size() > 1:
                dist.all_reduce(grad)
            return grad

    return SumGrad.apply


def ring_attention_fn(mesh):
    """``attention_fn(segments) -> fn(q, k, v)``: causal ring attention over
    the mesh's ``'seq'`` dimension (batch over ``'data'``) on global tensors,
    the inputs' gradients summed over the ranks."""
    from petastorm_tpu_torch.ops.ring_attention import ring_attention_sharded
    ring = ring_attention_sharded(mesh, 'seq', causal=True, batch_axis='data')
    sum_grad = _sum_grad_over_ranks()

    def attention_for(segments=None):
        def attention(q, k, v):
            return ring(sum_grad(q), sum_grad(k), sum_grad(v), segments)
        return attention
    return attention_for


def make_model(embed, heads, layers, max_len, dtype, device):
    import torch

    from petastorm_tpu_torch import TransformerLM
    return TransformerLM(vocab=VOCAB, embed=embed, heads=heads, layers=layers,
                         max_len=max_len, dtype=getattr(torch, dtype), device=device,
                         generator=torch.Generator().manual_seed(0))


def make_reader_for(dataset_url, mode, seq_len, ngram_frames=0, epochs=2, seed=7,
                    **kwargs):
    """The JAX example's reader of each mode."""
    from petastorm_tpu_torch import make_batch_reader, make_packing_transform, make_reader
    if mode == 'packed':
        return make_batch_reader(dataset_url,
                                 transform_spec=make_packing_transform('tokens', seq_len),
                                 num_epochs=epochs, shuffle_row_groups=True, seed=seed,
                                 **kwargs)
    if mode == 'ngram':
        from petastorm_tpu_torch import NGram
        ngram = NGram({i: ['tokens'] for i in range(ngram_frames)}, delta_threshold=1,
                      timestamp_field='frame_id')
        return make_reader(dataset_url, schema_fields=ngram, num_epochs=epochs,
                           shuffle_row_groups=True, seed=seed, **kwargs)
    return make_reader(dataset_url, schema_fields=['tokens'], num_epochs=epochs,
                       shuffle_row_groups=True, seed=seed, **kwargs)


def train(dataset_url, mode='docs', seq_len=512, batch_size=8, epochs=2, data_axis=None,
          ngram_frames=0, embed=128, heads=2, layers=1, dtype='float32',
          learning_rate=1e-2, max_steps=None, device=None, **reader_kwargs):
    """Train on this rank's mesh coordinate; returns ``(model, final loss)``.
    ``batch_size`` counts the rows of one data coordinate, as the JAX
    example's counts one host's."""
    import torch

    from petastorm_tpu_torch import TorchDataLoader
    from petastorm_tpu_torch.models.transformer import next_token_loss
    from petastorm_tpu_torch.ops.packing import packed_next_token_loss
    from petastorm_tpu_torch.parallel.loader import resolve_device
    from petastorm_tpu_torch.parallel.mesh import (PartitionSpec, initialize_distributed,
                                                   mesh_shard_info)
    device = resolve_device(device)
    initialize_distributed(device=device)
    mesh = make_data_seq_mesh(data_axis, device)
    seq = mesh['seq'].size()
    if seq_len % seq:
        raise ValueError('seq_len {} not divisible by the seq mesh dimension ({})'
                         .format(seq_len, seq))
    model = make_model(embed, heads, layers, seq_len, dtype, device)
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate)
    attention_for = ring_attention_fn(mesh)
    cur_shard, shard_count = mesh_shard_info(mesh, 'data')
    if seq > 1:
        # the ranks along 'seq' must read the same rows in the same order:
        # one worker keeps the order of the work items
        reader_kwargs.setdefault('workers_count', 1)
    reader = make_reader_for(dataset_url, mode, seq_len, ngram_frames, epochs,
                             cur_shard=cur_shard, shard_count=shard_count, **reader_kwargs)
    loss = None
    with TorchDataLoader(reader, batch_size=batch_size, mesh=mesh,
                         partition_spec=PartitionSpec('data'), device=device) as loader:
        for step, batch in enumerate(loader):
            tokens = batch['tokens'].full_tensor()
            if tokens.dim() == 3:   # NGram windows: frames in stream order
                tokens = tokens.reshape(tokens.shape[0], -1)
            optimizer.zero_grad(set_to_none=True)
            if mode == 'packed':
                segments = batch['tokens_segments'].full_tensor()
                logits = model(tokens, positions=batch['tokens_positions'].full_tensor(),
                               attention_fn=attention_for(segments))
                loss = packed_next_token_loss(logits, tokens, segments)
            else:
                loss = next_token_loss(model(tokens, attention_fn=attention_for()), tokens)
            loss.backward()
            optimizer.step()
            if step % 20 == 0:
                print('step {} loss {:.4f}'.format(step, float(loss.detach())))
            if max_steps is not None and step + 1 >= max_steps:
                break
        print('input pipeline stats:', loader.stats.as_dict())
    if loss is None:
        raise ValueError('no batches: the store holds fewer than batch_size={} rows (or '
                         'packed bins) for this data coordinate'.format(batch_size))
    return model, float(loss.detach())


def main(argv=None):
    """Run the example; returns the final loss."""
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--dataset-url', default=None)
    parser.add_argument('--num-docs', type=int, default=256)
    parser.add_argument('--seq-len', type=int, default=512)
    parser.add_argument('--batch-size', type=int, default=8)
    parser.add_argument('--epochs', type=int, default=2)
    parser.add_argument('--max-steps', type=int, default=None)
    parser.add_argument('--data-axis', type=int, default=None,
                        help='mesh data-dimension size (default: 2 if the world size is '
                             'even and above 1, else 1; seq gets the rest)')
    parser.add_argument('--ngram-frames', type=int, default=0,
                        help='train on NGram windows of this many consecutive token '
                             'frames (0 = the documents mode)')
    parser.add_argument('--packed', action='store_true',
                        help='variable-length documents packed into bins in the reader '
                             'workers (segmented attention and loss)')
    parser.add_argument('--embed', type=int, default=128)
    parser.add_argument('--heads', type=int, default=2)
    parser.add_argument('--layers', type=int, default=1)
    parser.add_argument('--dtype', default='float32', choices=['float32', 'bfloat16'])
    parser.add_argument('--device', default=None, help='cuda (default) or cpu')
    args = parser.parse_args(argv)
    if args.packed and args.ngram_frames:
        parser.error('--packed and --ngram-frames are mutually exclusive')
    if args.ngram_frames and (args.seq_len % args.ngram_frames
                              or args.seq_len < args.ngram_frames):
        parser.error('--ngram-frames ({}) must divide --seq-len ({})'
                     .format(args.ngram_frames, args.seq_len))

    import torch.distributed as dist

    from petastorm_tpu_torch.parallel.loader import resolve_device
    from petastorm_tpu_torch.parallel.mesh import initialize_distributed
    device = resolve_device(args.device)
    store = None
    if not dist.is_initialized() and 'RANK' not in os.environ:
        # one rank without torchrun: a file store of this run's own
        store = tempfile.mkdtemp(prefix='long_context_torch_')
        started = initialize_distributed('file://' + os.path.join(store, 'group'),
                                         world_size=1, rank=0, device=device)
    else:
        started = initialize_distributed(device=device)
    mode = 'packed' if args.packed else ('ngram' if args.ngram_frames else 'docs')
    try:
        url = args.dataset_url or _default_store(args, mode)
        _, final_loss = train(url, mode=mode, seq_len=args.seq_len,
                              batch_size=args.batch_size, epochs=args.epochs,
                              data_axis=args.data_axis, ngram_frames=args.ngram_frames,
                              embed=args.embed, heads=args.heads, layers=args.layers,
                              dtype=args.dtype, max_steps=args.max_steps, device=device)
        if dist.get_rank() == 0:
            print('final loss: {:.4f}'.format(final_loss))
    finally:
        if started:
            dist.destroy_process_group()
        if store is not None:
            shutil.rmtree(store, ignore_errors=True)
    return final_loss


def _default_store(args, mode):
    """The synthetic store of ``mode`` under the temporary directory, keyed by
    its geometry, written by rank 0 when missing."""
    import torch.distributed as dist
    if mode == 'packed':
        max_len = min(48, args.seq_len)
        path = os.path.join(tempfile.gettempdir(), 'long_context_torch_ragged_{}x{}'.format(
            args.num_docs, max_len))
        exists = os.path.isdir(path) and os.listdir(path)
        build = lambda: build_ragged_dataset(path, num_docs=args.num_docs,  # noqa: E731
                                             max_len=max_len)
    elif mode == 'ngram':
        frame_len = args.seq_len // args.ngram_frames
        path = os.path.join(tempfile.gettempdir(), 'long_context_torch_frames_{}x{}'.format(
            args.num_docs, frame_len))
        exists = os.path.exists(os.path.join(path, '_common_metadata'))
        build = lambda: build_frame_dataset(path, num_frames=args.num_docs,  # noqa: E731
                                            frame_len=frame_len)
    else:
        path = os.path.join(tempfile.gettempdir(), 'long_context_torch_{}x{}'.format(
            args.num_docs, args.seq_len))
        exists = os.path.exists(os.path.join(path, '_common_metadata'))
        build = lambda: build_dataset(path, args.num_docs, args.seq_len)  # noqa: E731
    if dist.get_rank() == 0 and not exists:
        print('materializing the {} store to {}'.format(mode, path))
        build()
    dist.barrier()
    return path


if __name__ == '__main__':
    main()
