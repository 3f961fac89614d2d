"""Feed a plain Parquet store to PyTorch on the card: ``make_batch_reader`` ->
``TorchDataLoader`` -> tensors, with ``petastorm_tpu_torch``. The twin of
``jax_hello_world.py`` (``--device cpu`` keeps the batches on the host)."""

import argparse

from petastorm_tpu_torch.parallel.loader import TorchDataLoader
from petastorm_tpu_torch.reader import make_batch_reader


def torch_hello_world(dataset_url='file:///tmp/external_dataset', device=None):
    """Print each batch's first ids and ``value1`` mean; returns every id in
    the order read."""
    ids = []
    with make_batch_reader(dataset_url, num_epochs=1) as reader:
        loader = TorchDataLoader(reader, batch_size=16, drop_last=False, device=device)
        for batch in loader:
            print('ids', batch['id'][:4], 'value1 mean', float(batch['value1'].mean()))
            ids.extend(batch['id'].tolist())
    return ids


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('-d', '--dataset-url', default='file:///tmp/external_dataset')
    parser.add_argument('--device', default=None, help='cuda (default) or cpu')
    args = parser.parse_args(argv)
    return torch_hello_world(args.dataset_url, args.device)


if __name__ == '__main__':
    main()
