"""Read a plain Parquet store with ``petastorm_tpu_torch``'s ``make_batch_reader``,
one namedtuple of column arrays a rowgroup: the twin of ``python_hello_world.py``."""

import argparse

from petastorm_tpu_torch.reader import make_batch_reader


def python_hello_world(dataset_url='file:///tmp/external_dataset'):
    """Print each batch's first ids; returns every id in the order read."""
    ids = []
    with make_batch_reader(dataset_url) as reader:
        for schema_view in reader:
            print('batch of {} ids: {}...'.format(len(schema_view.id), schema_view.id[:5]))
            ids.extend(int(i) for i in schema_view.id)
    return ids


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('-d', '--dataset-url', default='file:///tmp/external_dataset')
    args = parser.parse_args(argv)
    return python_hello_world(args.dataset_url)


if __name__ == '__main__':
    main()
