"""wire-bench: micro-benchmarks of the port's data plane, the port of
``petastorm_tpu.benchmark.wire_bench``. Three host measurements:

- **serializer round trip**: in-process serialize + deserialize MB/s of a
  synthetic ``ColumnarBatch`` through :class:`PickleSerializer` and
  :class:`ArrowIpcSerializer` (the per-payload CPU cost, no transport).
- **transport**: a spawned :class:`~petastorm_tpu_torch.workers.process_pool.ProcessPool`
  streaming synthetic batches under three wire configurations, pickle over
  the pipe, Arrow IPC over the pipe and Arrow IPC over the shared-memory
  ring, with delivered MB/s and the pool's ``wire_bytes_copied_per_batch``
  for each, and the copy-reduction ratio of the ring against pickle over the
  pipe. The timed batches follow one warm-up batch a worker (the JAX pool's
  start waits for its workers; the port's does not).
- **cache**: a dummy-pool reader over a synthetic codec store with the
  :class:`~petastorm_tpu_torch.cache.ArrowIpcDiskCache`: the wall time of the
  cold (fill) epoch against the warm (mmap hit) epoch and their ratio.

The keys are the JAX package's. Its pool joins workers over ZeroMQ; the port's
over one ``multiprocessing.connection`` pipe a worker (as its
``pipe_result_bytes`` stands for ``zmq_result_bytes``). So here
``pickle_zmq_*`` means pickle over the pipe, ``arrow_zmq_*`` Arrow IPC over
the pipe, and ``copy_reduction_vs_pickle_zmq`` is the ring's ratio against
pickle over the pipe: a defined difference of the port.

Run: ``petastorm-tpu-torch-throughput wire-bench`` or ``python -m
petastorm_tpu_torch.benchmark.wire_bench``; one JSON line.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time
from typing import Any, Dict, Optional

import numpy as np

_DEFAULT_BATCH_ROWS = 2048
_DEFAULT_BATCH_COLS = 4
_DEFAULT_BATCHES = 24
_DEFAULT_CACHE_ROWS = 1500


def _make_batch(rows: int, cols: int, seed: int = 0) -> Any:
    from petastorm_tpu_torch.reader_worker import ColumnarBatch
    rng = np.random.RandomState(seed)
    columns = {'col_{}'.format(i): rng.rand(rows, 16).astype(np.float32)
               for i in range(cols)}
    columns['idx'] = np.arange(rows, dtype=np.int64)
    return ColumnarBatch(columns, rows, item_id=(0, 0, 0))


def _batch_payload_bytes(batch: Any) -> int:
    return sum(col.nbytes for col in batch.columns.values())


class WirePayloadWorker:
    """Pool worker that publishes one synthetic ColumnarBatch per ventilated item
    (the pool contract: exactly one result per item) — a pure transport load
    generator (no IO, no decode)."""

    def __init__(self, worker_id: int, publish_func: Any, args: Any) -> None:
        self.worker_id = worker_id
        self.publish_func = publish_func
        self.args = args

    def process(self, **kwargs: Any) -> None:
        """Publish one batch of ``rows`` x ``cols`` float32 columns."""
        # Absolute import (not the module global): when this module runs as
        # __main__, dill ships the class by value and globals don't follow.
        from petastorm_tpu_torch.benchmark.wire_bench import _make_batch
        self.publish_func(_make_batch(kwargs['rows'], kwargs['cols'],
                                      seed=kwargs.get('seed', 0)))

    def shutdown(self) -> None:
        """Nothing to release."""


def serializer_roundtrip_bench(rows: int = _DEFAULT_BATCH_ROWS,
                               cols: int = _DEFAULT_BATCH_COLS,
                               iters: int = 20) -> Dict[str, float]:
    """In-process serialize+deserialize MB/s for pickle vs arrow-ipc."""
    from petastorm_tpu_torch.workers.serializers import (ArrowIpcSerializer,
                                                         PickleSerializer)
    batch = _make_batch(rows, cols)
    payload = _batch_payload_bytes(batch)
    out: Dict[str, float] = {}
    for name, serializer in (('pickle', PickleSerializer()),
                             ('arrow', ArrowIpcSerializer())):
        serializer.deserialize(serializer.serialize(batch))  # warmup
        start = time.perf_counter()
        for _ in range(iters):
            frames = serializer.serialize(batch)
            serializer.deserialize([bytes(memoryview(f)) for f in frames])
        elapsed = time.perf_counter() - start
        out['roundtrip_{}_mb_s'.format(name)] = round(
            iters * payload / elapsed / (1 << 20), 2)
    return out


def _run_transport(serializer: Any, shm_transport: bool, rows: int, cols: int,
                   batches: int, workers: int) -> Dict[str, float]:
    from petastorm_tpu_torch.workers.process_pool import ProcessPool
    pool = ProcessPool(workers, payload_serializer=serializer,
                       shm_transport=shm_transport)
    payload = _batch_payload_bytes(_make_batch(rows, cols))
    try:
        pool.start(WirePayloadWorker, None)
        # the port's start() does not wait for the spawned interpreters: one
        # warm-up item a worker keeps their start-up out of the timed batches,
        # and the counters below are the timed batches' alone
        for i in range(workers):
            pool.ventilate(rows=rows, cols=cols, seed=i)
        for _ in range(workers):
            pool.get_results(timeout=60)
        before = pool.diagnostics
        for i in range(batches):
            pool.ventilate(rows=rows, cols=cols, seed=i)
        start = time.perf_counter()
        for _ in range(batches):
            pool.get_results(timeout=60)
        elapsed = time.perf_counter() - start
        after = pool.diagnostics
    finally:
        pool.stop()
        pool.join()
    delta = {key: after[key] - before[key]
             for key in ('wire_bytes_copied', 'wire_batches', 'shm_batches',
                         'shm_fallback_batches')}
    return {
        'mb_s': round(batches * payload / elapsed / (1 << 20), 2),
        'bytes_copied_per_batch': round(delta['wire_bytes_copied'] / delta['wire_batches'], 1)
        if delta['wire_batches'] else 0.0,
        'shm_batches': delta['shm_batches'],
        'shm_fallback_batches': delta['shm_fallback_batches'],
    }


def transport_bench(rows: int = _DEFAULT_BATCH_ROWS, cols: int = _DEFAULT_BATCH_COLS,
                    batches: int = _DEFAULT_BATCHES,
                    workers: int = 2) -> Dict[str, float]:
    """Spawned-pool transport comparison: pickle over the pipe, Arrow IPC
    over the pipe and Arrow IPC over the shm ring (the ``*_zmq`` keys name the
    pipe, see the module docstring).

    The headline counter is ``wire_bytes_copied_per_batch`` (bytes put into
    new host memory per delivered batch, wire receive + deserialize); the
    emitted ``copy_reduction_vs_pickle_zmq`` is that counter's ratio between
    pickle over the pipe and the ring."""
    from petastorm_tpu_torch.workers.serializers import (ArrowIpcSerializer,
                                                         PickleSerializer)
    out: Dict[str, float] = {}
    configs = (('pickle_zmq', PickleSerializer(), False),
               ('arrow_zmq', ArrowIpcSerializer(), False),
               ('arrow_shm', ArrowIpcSerializer(), True))
    for name, serializer, shm in configs:
        result = _run_transport(serializer, shm, rows, cols, batches, workers)
        for key, value in result.items():
            out['{}_{}'.format(name, key)] = value
    pickle_copies = out.get('pickle_zmq_bytes_copied_per_batch', 0.0)
    shm_copies = out.get('arrow_shm_bytes_copied_per_batch', 0.0)
    if shm_copies:
        out['copy_reduction_vs_pickle_zmq'] = round(
            pickle_copies / shm_copies, 2)
    return out


def cache_bench(rows: int = _DEFAULT_CACHE_ROWS,
                cache_dir: Optional[str] = None) -> Dict[str, float]:
    """Cold fill vs warm (mmap-hit) epoch over the ArrowIpcDiskCache.

    Builds a small NdarrayCodec store (decode cost per row is real work), then
    reads it twice through a dummy-pool reader sharing one cache: epoch 1 pays
    Parquet read + codec decode + cache write, epoch 2 serves decoded columns as
    zero-copy mmap views. Emits both wall times and the speedup ratio."""
    own_tmp = cache_dir is None
    base = cache_dir or tempfile.mkdtemp(prefix='ptt-wire-bench-')
    try:
        return _cache_bench_in(base, rows)
    finally:
        # any-path cleanup: a failed epoch must not leave tens of MB behind
        if own_tmp:
            shutil.rmtree(base, ignore_errors=True)


def _cache_bench_in(base: str, rows: int) -> Dict[str, float]:
    from petastorm_tpu_torch.reader import make_reader
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    url = os.path.join(base, 'store')
    schema = Unischema('WireBench', [
        UnischemaField('idx', np.int64, (), ScalarCodec(), False),
        UnischemaField('vec', np.float32, (48, 48), NdarrayCodec(), False),
    ])
    rng = np.random.RandomState(0)
    write_rows('file://' + url, schema,
               [{'idx': i, 'vec': rng.rand(48, 48).astype(np.float32)}
                for i in range(rows)],
               rowgroup_size_mb=1, n_files=2)

    def epoch() -> 'tuple[float, int]':
        reader = make_reader('file://' + url, reader_pool_type='dummy',
                             num_epochs=1, shuffle_row_groups=False,
                             cache_type='local-disk',
                             cache_location=os.path.join(base, 'cache'),
                             cache_size_limit=512 * (1 << 20),
                             cache_format='arrow-ipc')
        start = time.perf_counter()
        n = sum(batch.num_rows for batch in reader.iter_columnar())
        elapsed = time.perf_counter() - start
        hits = reader.diagnostics['cache_hits']
        reader.stop()
        reader.join()
        assert n == rows, (n, rows)
        return elapsed, hits

    cold_s, cold_hits = epoch()
    warm_s, warm_hits = epoch()
    return {
        'cache_cold_fill_s': round(cold_s, 4),
        'cache_warm_epoch_s': round(warm_s, 4),
        'cache_warm_speedup': round(cold_s / warm_s, 2) if warm_s else 0.0,
        'cache_cold_hits': cold_hits,
        'cache_warm_hits': warm_hits,
    }


def run_wire_bench(rows: int = _DEFAULT_BATCH_ROWS, cols: int = _DEFAULT_BATCH_COLS,
                   batches: int = _DEFAULT_BATCHES, workers: int = 2,
                   cache_rows: int = _DEFAULT_CACHE_ROWS,
                   include_transport: bool = True,
                   include_cache: bool = True) -> Dict[str, float]:
    """Run every wire-bench section and merge the JSON-safe result dict.

    ``include_transport=False`` skips the spawned-pool comparison (the only part
    that needs subprocesses), ``include_cache=False`` the store build."""
    out: Dict[str, float] = {}
    out.update(serializer_roundtrip_bench(rows, cols))
    if include_transport:
        out.update(transport_bench(rows, cols, batches, workers))
    if include_cache:
        out.update(cache_bench(cache_rows))
    return out


def main(argv: Optional[list] = None) -> int:
    """``wire-bench`` CLI entry: run the microbench and print one JSON line."""
    import argparse
    parser = argparse.ArgumentParser(
        description='petastorm_tpu_torch data-plane microbench')
    parser.add_argument('--rows', type=int, default=_DEFAULT_BATCH_ROWS,
                        help='rows per synthetic batch')
    parser.add_argument('--cols', type=int, default=_DEFAULT_BATCH_COLS,
                        help='float32[16] columns per synthetic batch')
    parser.add_argument('--batches', type=int, default=_DEFAULT_BATCHES,
                        help='batches per transport configuration')
    parser.add_argument('--workers', type=int, default=2)
    parser.add_argument('--cache-rows', type=int, default=_DEFAULT_CACHE_ROWS)
    parser.add_argument('--no-transport', action='store_true',
                        help='skip the spawned process-pool comparison')
    parser.add_argument('--no-cache', action='store_true',
                        help='skip the cold-vs-warm cache epochs')
    args = parser.parse_args(argv)
    result = run_wire_bench(rows=args.rows, cols=args.cols, batches=args.batches,
                            workers=args.workers, cache_rows=args.cache_rows,
                            include_transport=not args.no_transport,
                            include_cache=not args.no_cache)
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
