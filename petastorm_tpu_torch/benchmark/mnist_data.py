"""The MNIST-shaped store of ``bench.py`` (``build_dataset``), written through
the port's codecs (both packages read it): ``idx`` and ``digit`` int64 and a
``(28, 28)`` uint8 ``NdarrayCodec`` image per row, the reference's
``examples/mnist/schema.py`` shape, with synthetic content from a seed."""

import numpy as np

from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.etl.dataset_metadata import write_rows
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

MNIST_SCHEMA = Unischema('MnistBench', [
    UnischemaField('idx', np.int64, (), ScalarCodec(), False),
    UnischemaField('digit', np.int64, (), ScalarCodec(), False),
    UnischemaField('image', np.uint8, (28, 28), NdarrayCodec(), False),
])


def mnist_rows(rows, seed=0):
    """Row ``i``: ``idx = i``, then a digit and an image drawn in turn from
    ``RandomState(seed)``, in ``bench.py``'s order."""
    rng = np.random.RandomState(seed)
    return [{'idx': i, 'digit': int(rng.randint(10)),
             'image': rng.randint(0, 255, (28, 28), dtype=np.uint8)}
            for i in range(rows)]


def write_mnist_store(url, rows, n_files=4, rowgroup_size_mb=8, seed=0):
    """``rows`` rows of :func:`mnist_rows` in ``n_files`` files of
    ``rowgroup_size_mb`` rowgroups (``bench.py``: 50,000 rows, 8 MB, 4)."""
    write_rows(url, MNIST_SCHEMA, mnist_rows(rows, seed), rowgroup_size_mb=rowgroup_size_mb,
               n_files=n_files)
