"""Reader throughput measurement: the port of ``petastorm_tpu.benchmark.throughput``.

A warm-up then a measured run of cycles, rows/s, psutil RSS and CPU%. The
``'torch'`` read method (``READ_TORCH``, in place of the JAX package's
``READ_JAX``) drives a
:class:`~petastorm_tpu_torch.parallel.loader.TorchDataLoader` onto the device
(``cuda`` unless ``device='cpu'``) and also reports the loader's input-stall
fraction.
"""

import logging
import re
import time
from collections import namedtuple

logger = logging.getLogger(__name__)

BenchmarkResult = namedtuple('BenchmarkResult',
                             ['time_mean', 'samples_per_second', 'memory_info', 'cpu',
                              'input_stall_fraction'])

READ_PYTHON = 'python'
READ_TORCH = 'torch'


def reader_throughput(dataset_url, field_regex=None, warmup_cycles_count=200,
                      measure_cycles_count=1000, pool_type='thread', loaders_count=3,
                      read_method=READ_PYTHON, shuffle_row_groups=True,
                      torch_batch_size=256, spawn_new_process=True,
                      profile_threads=False, ngram_length=None, ngram_ts_field=None,
                      ngram_delta_threshold=None, pack_field=None, pack_seq_len=None,
                      device=None):
    """Measure the read throughput of a dataset.

    ``read_method='python'`` iterates the reader's rows; ``'torch'`` drives a
    ``TorchDataLoader`` of ``torch_batch_size`` rows onto ``device`` (cycle =
    one batch; the card unless ``device='cpu'``) and reports its input-stall
    fraction. ``spawn_new_process`` (the default) measures in a fresh
    interpreter, so the RSS reading is the pipeline's alone.
    ``profile_threads`` wraps each thread-pool worker's items in cProfile and
    logs the aggregate at shutdown.

    ``ngram_length`` + ``ngram_ts_field`` measure NGram windows (cycle = one
    window of ``ngram_length`` timesteps, every field at every offset).
    ``pack_field`` + ``pack_seq_len`` measure packed-bin formation over a
    native Parquet list column inside ``make_batch_reader`` workers (cycle =
    one worker batch; the rate is bins/s)."""
    # the argument checks run before the spawn, so a bad combination raises
    # in the caller
    if profile_threads and pool_type != 'thread':
        raise ValueError('--profile-threads requires the thread pool')
    if ngram_length is None and (ngram_ts_field or ngram_delta_threshold is not None):
        raise ValueError('ngram_ts_field / ngram_delta_threshold require ngram_length')
    if ngram_length is not None:
        if not ngram_ts_field:
            raise ValueError('ngram_ts_field is required with ngram_length')
        if read_method != READ_PYTHON:
            raise ValueError('NGram benchmarking uses the python read method')
    if (pack_field is None) != (pack_seq_len is None):
        raise ValueError('pack_field and pack_seq_len must be given together')
    if pack_field is not None:
        if ngram_length is not None:
            raise ValueError('packing and NGram modes are mutually exclusive')
        if read_method != READ_PYTHON:
            raise ValueError('packing benchmarking uses the python read method')
        if profile_threads:
            # make_batch_reader takes pool_type/workers_count, not a built pool
            raise ValueError('profile_threads is not supported with pack_field')
        if field_regex and not any(re.fullmatch(pattern, pack_field)
                                   for pattern in field_regex):
            # fullmatch, as the schema view's field selection matches
            raise ValueError(
                'field_regex {!r} does not match pack_field {!r}; the packed column '
                'must be read for packing to run'.format(field_regex, pack_field))
    if read_method not in (READ_PYTHON, READ_TORCH):
        raise ValueError('Unknown read_method {!r}'.format(read_method))

    if spawn_new_process:
        from petastorm_tpu_torch.utils import run_in_subprocess
        return run_in_subprocess(reader_throughput, dataset_url, field_regex,
                                 warmup_cycles_count, measure_cycles_count, pool_type,
                                 loaders_count, read_method, shuffle_row_groups,
                                 torch_batch_size, False, profile_threads, ngram_length,
                                 ngram_ts_field, ngram_delta_threshold, pack_field,
                                 pack_seq_len, device)

    import psutil

    from petastorm_tpu_torch.reader import make_reader

    process = psutil.Process()
    reader_pool = None
    if profile_threads:
        from petastorm_tpu_torch.workers.thread_pool import ThreadPool
        reader_pool = ThreadPool(loaders_count, profiling_enabled=True)
    schema_fields = field_regex
    if ngram_length is not None:
        from petastorm_tpu_torch.ngram import NGram
        fields = field_regex if field_regex else ['.*']
        schema_fields = NGram({offset: list(fields) for offset in range(ngram_length)},
                              delta_threshold=(ngram_delta_threshold
                                               if ngram_delta_threshold is not None
                                               else (1 << 62)),
                              timestamp_field=ngram_ts_field)
    pool_kwargs = ({'reader_pool': reader_pool} if reader_pool is not None
                   else {'reader_pool_type': pool_type, 'workers_count': loaders_count})
    if pack_field is not None:
        from petastorm_tpu_torch.ops.packing import make_packing_transform
        from petastorm_tpu_torch.reader import make_batch_reader
        reader = make_batch_reader(
            dataset_url,
            # only the packed column need leave the Parquet files
            schema_fields=field_regex if field_regex else [pack_field],
            transform_spec=make_packing_transform(pack_field, pack_seq_len),
            shuffle_row_groups=shuffle_row_groups, num_epochs=None, **pool_kwargs)
    else:
        reader = make_reader(dataset_url, schema_fields=schema_fields,
                             shuffle_row_groups=shuffle_row_groups, num_epochs=None,
                             **pool_kwargs)
    stall = 0.0
    packed_units = 0
    loader = None
    try:
        if read_method == READ_PYTHON:
            iterator = iter(reader)
            rows_per_cycle = 1
        else:
            from petastorm_tpu_torch.parallel.loader import TorchDataLoader
            loader = TorchDataLoader(reader, batch_size=torch_batch_size, prefetch=2,
                                     device=device)
            iterator = iter(loader)
            rows_per_cycle = torch_batch_size

        for _ in range(warmup_cycles_count):
            next(iterator)
        process.cpu_percent()  # reset the cpu meter
        start = time.perf_counter()
        next_report = start + 5
        for cycle in range(measure_cycles_count):
            item = next(iterator)
            if pack_field is not None:
                # a batch-reader cycle is one worker batch of packed bins
                packed_units += len(getattr(item, pack_field))
            now = time.perf_counter()
            if now > next_report:
                logger.debug('cycle %d/%d, %.1f rows/s', cycle, measure_cycles_count,
                             (cycle + 1) * rows_per_cycle / (now - start))
                next_report = now + 5
        if read_method == READ_TORCH and loader.device.type == 'cuda':
            # the last batch's copy may still be in flight
            import torch
            torch.cuda.synchronize(loader.device)
        elapsed = time.perf_counter() - start
        cpu = process.cpu_percent()
        memory = process.memory_info()
        if read_method == READ_TORCH:
            stall = loader.stats.input_stall_fraction
        if pack_field is not None:
            rate = packed_units / elapsed
        else:
            rate = measure_cycles_count * rows_per_cycle / elapsed
        return BenchmarkResult(time_mean=elapsed / measure_cycles_count,
                               samples_per_second=rate, memory_info=memory, cpu=cpu,
                               input_stall_fraction=stall)
    finally:
        # the loader's stop ends its producer thread and the reader
        stopper = loader if loader is not None else reader
        stopper.stop()
        stopper.join()
