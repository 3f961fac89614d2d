"""Loader micro-benchmark over a synthetic in-memory reader: the port of
``petastorm_tpu.benchmark.dummy_reader``. Times the reference API's
``DataLoader`` against ``TorchDataLoader`` across batch sizes with no IO,
isolating the adapters' overhead.

Run: ``python -m petastorm_tpu_torch.benchmark.dummy_reader [--device cpu]``
(batches go to the card unless ``--device cpu``).
"""

import time

import numpy as np

from petastorm_tpu_torch.codecs import ScalarCodec
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

BenchSchema = Unischema('DummyBench', [
    UnischemaField('id', np.int64, (), ScalarCodec(), False),
    UnischemaField('value', np.float32, (16,), None, False),
])


class DummyReader(object):
    """Infinite synthetic reader emitting precomputed rows (row mode)."""

    def __init__(self, num_distinct_rows=128):
        self.result_schema = BenchSchema
        self.is_batched_reader = False
        self.ngram = None
        self.last_row_consumed = False
        rng = np.random.RandomState(0)
        self._rows = [BenchSchema.make_namedtuple(
            id=i, value=rng.rand(16).astype(np.float32))
            for i in range(num_distinct_rows)]
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self):
        row = self._rows[self._i % len(self._rows)]
        self._i += 1
        return row

    def reset(self):
        pass

    def stop(self):
        pass

    def join(self):
        pass


def measure_loader(loader_factory, batches=100):
    """Rows/s through ``batches`` batches of the loader ``loader_factory``
    builds, after one warm-up batch. A batch on the card is synchronized
    before the clock stops."""
    loader = loader_factory()
    iterator = iter(loader)
    next(iterator)  # warmup
    start = time.perf_counter()
    rows = 0
    first = None
    for _ in range(batches):
        batch = next(iterator)
        first = batch[next(iter(batch))] if isinstance(batch, dict) else batch
        rows += len(first)
    if getattr(first, 'is_cuda', False):
        import torch
        torch.cuda.synchronize(first.device)
    return rows / (time.perf_counter() - start)


def main(argv=None):
    """Run the micro-benchmark over each adapter and print the rates."""
    import argparse

    from petastorm_tpu_torch.parallel.loader import TorchDataLoader
    from petastorm_tpu_torch.pytorch import DataLoader
    parser = argparse.ArgumentParser(description='loader overhead over a synthetic reader')
    parser.add_argument('--device', default=None, help='cuda (default) or cpu')
    args = parser.parse_args(argv)
    for batch_size in (16, 256, 1024):
        torch_rate = measure_loader(
            lambda: DataLoader(DummyReader(), batch_size=batch_size, device=args.device))
        loader_rate = measure_loader(
            lambda: TorchDataLoader(DummyReader(), batch_size=batch_size,
                                    device=args.device))
        print('batch={:5d}  DataLoader: {:>10.0f} rows/s   '
              'TorchDataLoader: {:>10.0f} rows/s'.format(batch_size, torch_rate,
                                                         loader_rate))
    return 0


if __name__ == '__main__':
    import sys
    sys.exit(main())
