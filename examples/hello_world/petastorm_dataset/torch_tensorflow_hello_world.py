"""A ``tf.data`` read of the hello world store with ``petastorm_tpu_torch``:
the twin of ``tensorflow_hello_world.py`` (``make_reader`` ->
``tf_utils.make_petastorm_dataset``, eager ``tf.data``)."""

import argparse

from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.tf_utils import make_petastorm_dataset


def tensorflow_hello_world(dataset_url='file:///tmp/hello_world_dataset', count=3):
    """Print the ids of the first ``count`` rows; returns them."""
    ids = []
    with make_reader(dataset_url) as reader:
        dataset = make_petastorm_dataset(reader)
        for sample in dataset.take(count):
            print(sample.id.numpy())
            ids.append(int(sample.id.numpy()))
    return ids


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('-d', '--dataset-url', default='file:///tmp/hello_world_dataset')
    args = parser.parse_args(argv)
    return tensorflow_hello_world(args.dataset_url)


if __name__ == '__main__':
    main()
