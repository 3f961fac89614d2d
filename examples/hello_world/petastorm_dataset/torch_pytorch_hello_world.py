"""The reference API's ``DataLoader`` over the hello world store with
``petastorm_tpu_torch``: the twin of ``pytorch_hello_world.py``. The batch goes
to the card unless ``--device cpu``."""

import argparse

from petastorm_tpu_torch.pytorch import DataLoader
from petastorm_tpu_torch.reader import make_reader


def pytorch_hello_world(dataset_url='file:///tmp/hello_world_dataset', device=None):
    """Print the first batch's ids; returns that batch."""
    with DataLoader(make_reader(dataset_url), device=device) as train_loader:
        sample = next(iter(train_loader))
        print(sample['id'])
    return sample


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('-d', '--dataset-url', default='file:///tmp/hello_world_dataset')
    parser.add_argument('--device', default=None, help='cuda (default) or cpu')
    args = parser.parse_args(argv)
    return pytorch_hello_world(args.dataset_url, args.device)


if __name__ == '__main__':
    main()
