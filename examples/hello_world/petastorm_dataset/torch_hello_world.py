"""Read the hello world store straight onto the card as batches of tensors:
the twin of ``jax_hello_world.py``, with ``TorchDataLoader`` in place of
``JaxDataLoader`` (``--device cpu`` keeps the batches on the host)."""

import argparse

import torch

from petastorm_tpu_torch.parallel.loader import TorchDataLoader
from petastorm_tpu_torch.reader import make_reader


def torch_hello_world(dataset_url='file:///tmp/hello_world_dataset', device=None):
    """Print each batch's ids and image shape; returns the ids in the order
    read."""
    ids = []
    # `array_4d` has variable dimensions; the demo keeps to the fields of
    # static shape (ragged fields need TorchDataLoader(pad_ragged=...))
    with make_reader(dataset_url, schema_fields=['id', 'image1'], num_epochs=1) as reader:
        loader = TorchDataLoader(reader, batch_size=2, drop_last=False, device=device)
        for batch in loader:
            assert isinstance(batch['image1'], torch.Tensor)
            print('ids', batch['id'], 'image batch shape', tuple(batch['image1'].shape),
                  'on', batch['image1'].device)
            ids.extend(batch['id'].tolist())
    return ids


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('-d', '--dataset-url', default='file:///tmp/hello_world_dataset')
    parser.add_argument('--device', default=None, help='cuda (default) or cpu')
    args = parser.parse_args(argv)
    return torch_hello_world(args.dataset_url, args.device)


if __name__ == '__main__':
    main()
