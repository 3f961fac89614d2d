"""A ``tf.data`` read of a plain Parquet store with ``petastorm_tpu_torch``:
the twin of ``tensorflow_hello_world.py`` (``make_batch_reader`` ->
``tf_utils.make_petastorm_dataset``, one element a rowgroup)."""

import argparse

from petastorm_tpu_torch.reader import make_batch_reader
from petastorm_tpu_torch.tf_utils import make_petastorm_dataset


def tensorflow_hello_world(dataset_url='file:///tmp/external_dataset', count=2):
    """Print the first ids of the first ``count`` batches; returns each
    batch's ids."""
    batches = []
    with make_batch_reader(dataset_url) as reader:
        dataset = make_petastorm_dataset(reader)
        for batch in dataset.take(count):
            print('batch ids:', batch.id.numpy()[:5])
            batches.append(batch.id.numpy())
    return batches


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('-d', '--dataset-url', default='file:///tmp/external_dataset')
    args = parser.parse_args(argv)
    return tensorflow_hello_world(args.dataset_url)


if __name__ == '__main__':
    main()
