"""Train a small Keras CNN from an MNIST store through ``tf.data`` with
``petastorm_tpu_torch``: the twin of ``tf_example.py`` (``make_reader`` with
a ``TransformSpec`` -> ``tf_utils.make_petastorm_dataset`` -> ``model.fit``).

Run: ``python -m examples.mnist.torch_tf_example --dataset-url file:///tmp/mnist``
"""

import argparse

import numpy as np

from examples.mnist import DEFAULT_MNIST_DATA_PATH
from petastorm_tpu_torch.reader import make_reader
from petastorm_tpu_torch.tf_utils import make_petastorm_dataset
from petastorm_tpu_torch.transform import TransformSpec


def _transform_row(row):
    row['image'] = ((row['image'].astype(np.float32) - 127.5) / 127.5)[..., None]
    return row


TRANSFORM = TransformSpec(_transform_row,
                          edit_fields=[('image', np.float32, (28, 28, 1), False)],
                          selected_fields=['digit', 'image'])


def train_and_test(dataset_url, batch_size=64, epochs=1, steps=50):
    """``steps`` Adam steps an epoch on the train rows, then the test loss
    and accuracy over ``steps // 5`` batches; returns them."""
    import tensorflow as tf

    model = tf.keras.Sequential([
        tf.keras.Input(shape=(28, 28, 1)),
        tf.keras.layers.Conv2D(16, 3, activation='relu'),
        tf.keras.layers.MaxPooling2D(),
        tf.keras.layers.Flatten(),
        tf.keras.layers.Dense(64, activation='relu'),
        tf.keras.layers.Dense(10, activation='softmax'),
    ])
    model.compile(optimizer='adam', loss='sparse_categorical_crossentropy',
                  metrics=['accuracy'])

    base = dataset_url.rstrip('/')
    with make_reader('{}/train'.format(base), transform_spec=TRANSFORM,
                     num_epochs=None) as train_reader:
        with make_reader('{}/test'.format(base), transform_spec=TRANSFORM,
                         num_epochs=None) as test_reader:
            train_ds = (make_petastorm_dataset(train_reader)
                        .map(lambda row: (row.image, row.digit))
                        .batch(batch_size))
            test_ds = (make_petastorm_dataset(test_reader)
                       .map(lambda row: (row.image, row.digit))
                       .batch(batch_size))
            model.fit(train_ds, epochs=epochs, steps_per_epoch=steps, verbose=1)
            metrics = model.evaluate(test_ds, steps=max(1, steps // 5), verbose=0)
    print('test loss/accuracy:', metrics)
    return metrics


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--dataset-url',
                        default='file://{}'.format(DEFAULT_MNIST_DATA_PATH))
    parser.add_argument('--batch-size', type=int, default=64)
    parser.add_argument('--epochs', type=int, default=1)
    parser.add_argument('--steps', type=int, default=50)
    args = parser.parse_args(argv)
    return train_and_test(args.dataset_url, batch_size=args.batch_size, epochs=args.epochs,
                          steps=args.steps)


if __name__ == '__main__':
    main()
