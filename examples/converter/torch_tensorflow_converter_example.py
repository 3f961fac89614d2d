"""An in-memory table -> ``tf.data`` through ``petastorm_tpu_torch``'s
converter: the twin of ``tensorflow_converter_example.py`` (an Arrow table in
place of its pandas frame: the port needs no pandas). ``make_converter``
writes the table to a cached Parquet store once and
``converter.make_tf_dataset`` batches it for ``model.fit``.

Run: ``python -m examples.converter.torch_tensorflow_converter_example``
"""

import argparse

import numpy as np


def make_table(rows=512, seed=0):
    """Four float32 features and whether they sum above 0."""
    import pyarrow as pa
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, 4)).astype(np.float32)
    columns = {'x{}'.format(i): x[:, i] for i in range(4)}
    columns['y'] = (x.sum(axis=1) > 0).astype(np.int64)
    return pa.table(columns)


def run(cache_dir='/tmp/converter_cache_tf_torch', rows=512, steps=20):
    """A two-layer Keras classifier fit for ``steps`` batches of 64; returns
    the last loss. The converter's store is deleted afterwards."""
    import tensorflow as tf

    from petastorm_tpu_torch.converter import make_converter
    converter = make_converter(make_table(rows),
                               parent_cache_dir_url='file://{}'.format(cache_dir))
    model = tf.keras.Sequential([tf.keras.layers.Dense(16, activation='relu'),
                                 tf.keras.layers.Dense(2, activation='softmax')])
    model.compile(optimizer='adam', loss='sparse_categorical_crossentropy')
    try:
        with converter.make_tf_dataset(batch_size=64, num_epochs=None) as dataset:
            features = dataset.map(
                lambda row: (tf.stack([row.x0, row.x1, row.x2, row.x3], axis=1), row.y))
            history = model.fit(features, steps_per_epoch=steps, epochs=1, verbose=0)
    finally:
        converter.delete()
    loss = history.history['loss'][-1]
    print('final loss {:.4f}'.format(loss))
    return loss


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--cache-dir', default='/tmp/converter_cache_tf_torch')
    parser.add_argument('--rows', type=int, default=512)
    parser.add_argument('--steps', type=int, default=20)
    args = parser.parse_args(argv)
    return run(args.cache_dir, args.rows, args.steps)


if __name__ == '__main__':
    main()
