"""Train ``MnistCNN`` from an MNIST store with ``petastorm_tpu_torch``: the twin
of ``examples/mnist/jax_example.py`` (and, with ``--reference-loader``, of
``examples/mnist/pytorch_example.py``).

Paths, as in the JAX example:

- default: ``make_reader`` -> ``TorchDataLoader`` (a shuffling queue of 1024
  rows) -> eager Adam steps; ``--checkpoint-dir``/``--save-every`` save the
  model, the optimizer and the input position with ``TrainingCheckpointer``
  and resume from them (the unbuffered stream, as in the JAX example);
- ``--inmem``: ``InMemTorchLoader.scan_epochs``, each epoch one CUDA graph
  replay on the card;
- ``--scan-stream``: ``TorchDataLoader.scan_stream``, chunks of steps as CUDA
  graph replays;
- ``--reference-loader``: the reference API's row-based
  ``petastorm_tpu_torch.pytorch.DataLoader``.

A missing store is first written as the synthetic MNIST store of
``generate_petastorm_mnist.py --source synthetic`` (:func:`generate_store`).
Batches and the model are on the card unless ``--device cpu``.

Run: ``python -m examples.mnist.torch_example --dataset-url file:///tmp/mnist``
"""

import argparse
import os

import numpy as np

from examples.mnist import DEFAULT_MNIST_DATA_PATH


def mnist_schema():
    """The MNIST Unischema of ``examples/mnist/schema.py``, in the port."""
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    return Unischema('MnistSchema', [
        UnischemaField('idx', np.int64, (), ScalarCodec(np.int64), False),
        UnischemaField('digit', np.int64, (), ScalarCodec(np.int64), False),
        UnischemaField('image', np.uint8, (28, 28), NdarrayCodec(), False),
    ])


def synthetic_mnist_rows(count, seed=0):
    """MNIST-shaped rows: a digit-dependent mean intensity plus noise, the
    rows of ``generate_petastorm_mnist.synthetic_mnist_rows``."""
    rng = np.random.default_rng(seed)
    rows = []
    for idx in range(count):
        digit = int(rng.integers(10))
        base = np.full((28, 28), 20 + digit * 23, dtype=np.float32)
        noise = rng.normal(0, 10, size=(28, 28)).astype(np.float32)
        image = np.clip(base + noise, 0, 255).astype(np.uint8)
        rows.append({'idx': idx, 'digit': digit, 'image': image})
    return rows


def generate_store(output_url, train_count=600, test_count=100, rowgroup_size_mb=1):
    """The ``train`` and ``test`` splits of the synthetic MNIST store."""
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    for split, count in (('train', train_count), ('test', test_count)):
        rows = synthetic_mnist_rows(count, seed=0 if split == 'train' else 1)
        write_rows('{}/{}'.format(output_url.rstrip('/'), split), mnist_schema(), rows,
                   rowgroup_size_mb=rowgroup_size_mb)


def _transform_row(row):
    # normalized on the host worker; the model casts to its dtype
    row['image'] = (row['image'].astype(np.float32) - 127.5) / 127.5
    return row


def transform():
    from petastorm_tpu_torch.transform import TransformSpec
    return TransformSpec(_transform_row, edit_fields=[('image', np.float32, (28, 28), False)])


def make_model(device, learning_rate=1e-3, capturable=False):
    import torch

    from petastorm_tpu_torch import MnistCNN
    torch.manual_seed(0)
    model = MnistCNN(device=device)
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate,
                                 capturable=capturable)
    return model, optimizer


def make_step(model, optimizer):
    """One Adam step on a batch; returns the loss (a tensor, no host sync)."""
    import torch.nn.functional as F

    def step(batch):
        loss = F.cross_entropy(model(batch['image'][..., None]), batch['digit'])
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()
    return step


def train_reader(dataset_url, epochs, resume_state=None, **kwargs):
    """The JAX example's training reader: rows shuffled in their rowgroup
    with seed 42."""
    from petastorm_tpu_torch import make_reader
    return make_reader('{}/train'.format(dataset_url.rstrip('/')), num_epochs=epochs,
                       transform_spec=transform(), shuffle_rows=True, seed=42,
                       resume_state=resume_state, **kwargs)


def train_loader(reader, batch_size, shuffling_queue_capacity, device):
    """The JAX example's streaming loader over ``reader``."""
    from petastorm_tpu_torch import TorchDataLoader
    return TorchDataLoader(reader, batch_size=batch_size,
                           shuffling_queue_capacity=shuffling_queue_capacity, seed=42,
                           device=device)


def train(dataset_url, batch_size=128, epochs=1, learning_rate=1e-3,
          shuffling_queue_capacity=None, checkpoint_dir=None, save_every=100,
          max_steps=None, device=None):
    """Streaming training with eager steps; with ``checkpoint_dir`` the model,
    the optimizer and the input position save every ``save_every`` steps and a
    restart resumes from the newest. Returns ``(model, loss)``."""
    from petastorm_tpu_torch.parallel.loader import resolve_device
    device = resolve_device(device)
    if checkpoint_dir and shuffling_queue_capacity:
        raise ValueError('checkpoint_dir needs the unbuffered stream; do not pass '
                         'shuffling_queue_capacity with it')
    if shuffling_queue_capacity is None:
        shuffling_queue_capacity = 0 if checkpoint_dir else 1024
    model, optimizer = make_model(device, learning_rate)
    step_fn = make_step(model, optimizer)
    ckpt = resume_state = None
    start_step = 0
    loss = None
    if checkpoint_dir:
        from petastorm_tpu_torch import TrainingCheckpointer
        ckpt = TrainingCheckpointer(checkpoint_dir, save_interval_steps=save_every)
        if ckpt.latest_step is not None:
            state, loader_state = ckpt.restore({'model': model.state_dict(),
                                                'optimizer': optimizer.state_dict()},
                                               device=device)
            model.load_state_dict(state['model'])
            optimizer.load_state_dict(state['optimizer'])
            resume_state = loader_state['reader'] if loader_state else None
            start_step = int(ckpt.latest_step) + 1
            print('resuming from step {} (input position restored)'.format(start_step))
    try:
        reader = train_reader(dataset_url, epochs, resume_state=resume_state)
    except ValueError as exc:
        if resume_state is not None and 'already consumed' in str(exc):
            print('nothing left to train: input fully consumed at resume point')
            return model, None
        raise
    with reader:
        loader = train_loader(reader, batch_size, shuffling_queue_capacity, device)
        for step, batch in enumerate(loader, start=start_step):
            loss = step_fn(batch)
            if ckpt is not None:
                ckpt.save(step, {'model': model.state_dict(),
                                 'optimizer': optimizer.state_dict()}, loader=loader)
            if step % 50 == 0:
                print('step {} loss {:.4f}'.format(step, float(loss)))
            if max_steps is not None and step - start_step + 1 >= max_steps:
                break
        print('input pipeline stats:', loader.stats.as_dict())
    if ckpt is not None:
        ckpt.close()
    if loss is None:
        print('nothing left to train: input fully consumed at resume point')
        return model, None
    return model, float(loss)


def train_inmem(dataset_url, batch_size=128, epochs=1, learning_rate=1e-3, device=None):
    """Fill once, then run each epoch (shuffle, gather and every step) as one
    program: ``InMemTorchLoader.scan_epochs``. Returns ``(model, loss)``."""
    from petastorm_tpu_torch import InMemTorchLoader, make_reader
    from petastorm_tpu_torch.parallel.loader import resolve_device
    device = resolve_device(device)
    model, optimizer = make_model(device, learning_rate, capturable=device.type == 'cuda')
    reader = make_reader('{}/train'.format(dataset_url.rstrip('/')), num_epochs=1,
                         transform_spec=transform())
    loader = InMemTorchLoader(reader, batch_size=batch_size, num_epochs=None, seed=42,
                              device=device)
    per_epoch = loader.scan_epochs(make_step(model, optimizer), num_epochs=epochs,
                                   state=(model, optimizer))
    for epoch, losses in enumerate(per_epoch):
        print('epoch {}: loss {:.4f}'.format(epoch, float(losses[-1])))
    return model, float(per_epoch[-1][-1])


def train_scan_stream(dataset_url, batch_size=128, epochs=1, learning_rate=1e-3,
                      chunk_batches=32, device=None):
    """Re-read the store each epoch, running every ``chunk_batches`` steps as
    one program: ``TorchDataLoader.scan_stream``. Returns ``(model, loss)``."""
    from petastorm_tpu_torch import TorchDataLoader, make_reader
    from petastorm_tpu_torch.parallel.loader import resolve_device
    device = resolve_device(device)
    model, optimizer = make_model(device, learning_rate, capturable=device.type == 'cuda')
    step = make_step(model, optimizer)
    loss = None
    with make_reader('{}/train'.format(dataset_url.rstrip('/')), num_epochs=1,
                     transform_spec=transform(), shuffle_row_groups=True, seed=42) as reader:
        loader = TorchDataLoader(reader, batch_size=batch_size, device=device)
        for epoch in range(epochs):   # a consumed reader resets each pass
            chunks = loader.scan_stream(step, chunk_batches=chunk_batches, seed=epoch,
                                        state=(model, optimizer))
            loss = float(chunks[-1][-1])
            print('epoch {}: loss {:.4f} ({} chunks)'.format(epoch, loss, len(chunks)))
    return model, loss


def train_reference_loader(dataset_url, batch_size=64, epochs=1, learning_rate=1e-3,
                           device=None):
    """The reference petastorm's torch path (``pytorch_example.py``): rows
    through ``petastorm_tpu_torch.pytorch.DataLoader``. Returns
    ``(model, loss)``."""
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.parallel.loader import resolve_device
    from petastorm_tpu_torch.pytorch import DataLoader
    device = resolve_device(device)
    model, optimizer = make_model(device, learning_rate)
    step = make_step(model, optimizer)
    loss = None
    for _ in range(epochs):
        reader = make_reader('{}/train'.format(dataset_url.rstrip('/')),
                             transform_spec=transform(), num_epochs=1)
        with DataLoader(reader, batch_size=batch_size, device=device) as loader:
            for index, batch in enumerate(loader):
                loss = step(batch)
                if index % 50 == 0:
                    print('train batch {} loss {:.4f}'.format(index, float(loss)))
    return model, float(loss)


def evaluate(model, dataset_url, batch_size=128, device=None):
    import torch

    from petastorm_tpu_torch import TorchDataLoader, make_reader
    correct = total = 0
    with make_reader('{}/test'.format(dataset_url.rstrip('/')), num_epochs=1,
                     transform_spec=transform(), shuffle_row_groups=False) as reader:
        loader = TorchDataLoader(reader, batch_size=batch_size, drop_last=True,
                                 device=device)
        with torch.no_grad():
            for batch in loader:
                logits = model(batch['image'][..., None])
                correct += int((logits.argmax(-1) == batch['digit']).sum())
                total += int(batch['digit'].shape[0])
    print('test accuracy: {}/{} = {:.3f}'.format(correct, total, correct / max(1, total)))
    return correct / max(1, total)


def main(argv=None):
    """Run the example; returns the final training loss."""
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--dataset-url',
                        default='file://{}'.format(DEFAULT_MNIST_DATA_PATH))
    parser.add_argument('--batch-size', type=int, default=128)
    parser.add_argument('--epochs', type=int, default=1)
    parser.add_argument('--learning-rate', type=float, default=1e-3)
    parser.add_argument('--inmem', action='store_true',
                        help='card-resident epochs through InMemTorchLoader.scan_epochs')
    parser.add_argument('--scan-stream', action='store_true',
                        help='chunks of steps as CUDA graphs through '
                             'TorchDataLoader.scan_stream')
    parser.add_argument('--reference-loader', action='store_true',
                        help="the reference API's row-based DataLoader")
    parser.add_argument('--checkpoint-dir',
                        help='save (model, input position) every --save-every steps and '
                             'resume from it on restart (streaming mode only)')
    parser.add_argument('--save-every', type=int, default=100)
    parser.add_argument('--chunk-batches', type=int, default=32)
    parser.add_argument('--max-steps', type=int, default=None)
    parser.add_argument('--device', default=None, help='cuda (default) or cpu')
    args = parser.parse_args(argv)
    modes = [args.inmem, args.scan_stream, args.reference_loader]
    if sum(modes) > 1:
        parser.error('--inmem, --scan-stream and --reference-loader are mutually exclusive')
    if args.checkpoint_dir and any(modes):
        parser.error('--checkpoint-dir applies to the streaming mode')
    if not os.path.exists(os.path.join(args.dataset_url.replace('file://', ''), 'train',
                                       '_common_metadata')):
        print('materializing the synthetic MNIST store to {}'.format(args.dataset_url))
        generate_store(args.dataset_url)
    common = dict(batch_size=args.batch_size, epochs=args.epochs,
                  learning_rate=args.learning_rate, device=args.device)
    if args.inmem:
        model, loss = train_inmem(args.dataset_url, **common)
    elif args.scan_stream:
        model, loss = train_scan_stream(args.dataset_url, chunk_batches=args.chunk_batches,
                                        **common)
    elif args.reference_loader:
        model, loss = train_reference_loader(args.dataset_url, **common)
    else:
        model, loss = train(args.dataset_url, checkpoint_dir=args.checkpoint_dir,
                            save_every=args.save_every, max_steps=args.max_steps, **common)
    evaluate(model, args.dataset_url, batch_size=args.batch_size, device=args.device)
    if loss is not None:
        print('final loss: {:.4f}'.format(loss))
    return loss


if __name__ == '__main__':
    main()
