"""Generate the tiny "hello world" store with ``petastorm_tpu_torch``: the twin
of ``generate_petastorm_dataset.py``. The rows are drawn from ``--seed``.

Run: ``python -m examples.hello_world.petastorm_dataset.torch_generate_petastorm_dataset
-o file:///tmp/hello_world_dataset``
"""

import argparse

import numpy as np

from petastorm_tpu_torch.codecs import CompressedImageCodec, NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.etl.dataset_metadata import write_rows
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

HelloWorldSchema = Unischema('HelloWorldSchema', [
    UnischemaField('id', np.int32, (), ScalarCodec(np.int32), False),
    UnischemaField('image1', np.uint8, (128, 256, 3), CompressedImageCodec('png'), False),
    UnischemaField('array_4d', np.uint8, (None, 128, 30, None), NdarrayCodec(), False),
])


def row_generator(x, rng):
    """One row of the store, keyed by its ``id`` field."""
    return {'id': x,
            'image1': np.asarray(x % 255, dtype=np.uint8) *
            np.ones((128, 256, 3), dtype=np.uint8),
            'array_4d': rng.randint(0, 255, dtype=np.uint8, size=(4, 128, 30, 3))}


def generate_petastorm_dataset(output_url='file:///tmp/hello_world_dataset',
                               rows_count=10, rowgroup_size_mb=1, seed=0):
    rng = np.random.RandomState(seed)
    rows = [row_generator(x, rng) for x in range(rows_count)]
    write_rows(output_url, HelloWorldSchema, rows, rowgroup_size_mb=rowgroup_size_mb)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('-o', '--output-url', default='file:///tmp/hello_world_dataset',
                        help='file:// url the store is written to')
    parser.add_argument('-n', '--rows-count', type=int, default=10)
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args(argv)
    generate_petastorm_dataset(args.output_url, args.rows_count, seed=args.seed)
    print('wrote {} rows to {}'.format(args.rows_count, args.output_url))


if __name__ == '__main__':
    main()
