"""Minimal pure-python read of the hello world store with ``petastorm_tpu_torch``:
the twin of ``python_hello_world.py``."""

import argparse

from petastorm_tpu_torch.reader import make_reader


def python_hello_world(dataset_url='file:///tmp/hello_world_dataset'):
    """Print each row's id; returns the ids in the order read."""
    ids = []
    with make_reader(dataset_url) as reader:
        for sample in reader:
            print(sample.id)
            ids.append(int(sample.id))
    return ids


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('-d', '--dataset-url', default='file:///tmp/hello_world_dataset')
    args = parser.parse_args(argv)
    return python_hello_world(args.dataset_url)


if __name__ == '__main__':
    main()
