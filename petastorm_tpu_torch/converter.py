"""Dataset converter: an in-memory table or a Spark DataFrame -> a cached
Parquet store -> torch loaders. The counterpart of ``petastorm_tpu.converter``.

:func:`make_converter` takes a ``pyarrow.Table`` (or a pandas DataFrame, where
pandas imports) and writes it once under a parent cache directory, in a
directory named by a 24-hex content fingerprint that ``petastorm_tpu``
computes the same way, so one table gives one store directory in both
packages and either can reuse the other's store. A store counts only once its
``_SUCCESS`` marker exists: a directory without one is a crashed conversion
and is removed first. Stores are deleted by :meth:`DatasetConverter.delete`
or at interpreter exit. A pyspark DataFrame is written by Spark's executors
into a new directory there, then given the store metadata (a Unischema
inferred from the files), so ``make_reader`` reads it too; one query plan
converts once a session (``DataFrame.semanticHash``). pyspark is imported
only when a DataFrame's module already did.

:meth:`DatasetConverter.make_torch_loader` is the counterpart of
``make_jax_loader`` (a :class:`~petastorm_tpu_torch.parallel.loader.TorchDataLoader`
over ``make_batch_reader``), and :meth:`DatasetConverter.make_torch_dataloader`
yields the reference API's
:class:`~petastorm_tpu_torch.pytorch.BatchedDataLoader`, and
:meth:`DatasetConverter.make_tf_dataset` a ``tf.data`` pipeline over
:func:`~petastorm_tpu_torch.tf_utils.make_petastorm_dataset` (tensorflow
imported when it is called).
"""

import atexit
import hashlib
import logging
import os
import sys
import time
import uuid
import warnings

logger = logging.getLogger(__name__)

#: the environment variable naming the parent cache directory (the JAX
#: package's, so both packages share one cache)
CACHE_DIR_ENV = 'PETASTORM_TPU_CONVERTER_CACHE_DIR'

#: a median file size below this draws a warning: many small files read slowly
_MIN_RECOMMENDED_FILE_BYTES = 50 << 20

_active_converters = {}


def _cleanup_all():
    for converter in list(_active_converters.values()):
        converter.delete(silent=True)


atexit.register(_cleanup_all)


def _is_spark_dataframe(df):
    # a Spark DataFrame exists only once pyspark.sql was imported
    sql = sys.modules.get('pyspark.sql')
    return sql is not None and isinstance(df, sql.DataFrame)


def _to_arrow_table(df):
    import pyarrow as pa
    if isinstance(df, pa.Table):
        return df
    try:
        import pandas as pd
    except ImportError:
        pd = None
    if pd is not None and isinstance(df, pd.DataFrame):
        return pa.Table.from_pandas(df, preserve_index=False)
    raise TypeError('Unsupported dataframe type {!r}: pass a pyarrow.Table, a pandas '
                    'DataFrame, or a pyspark DataFrame'.format(type(df)))


def _table_fingerprint(table):
    """Content identity of a table: its schema, row count and every column
    buffer's bytes and size, hashed; ``petastorm_tpu``'s fingerprint."""
    h = hashlib.sha1()
    h.update(str(table.schema).encode('utf-8'))
    h.update(str(table.num_rows).encode('utf-8'))
    for column in table.columns:
        for chunk in column.chunks:
            for buf in chunk.buffers():
                if buf is not None:
                    h.update(memoryview(buf))
                    h.update(str(buf.size).encode())
    return h.hexdigest()[:24]


class DatasetConverter(object):
    """A materialized store with loader factories."""

    def __init__(self, cache_dir_url, file_urls, dataset_size):
        self.cache_dir_url = cache_dir_url
        self.file_urls = file_urls
        self.dataset_size = dataset_size

    def __len__(self):
        return self.dataset_size

    def make_torch_loader(self, batch_size, mesh=None, partition_spec=None,
                          loader_kwargs=None, **reader_kwargs):
        """A :class:`~petastorm_tpu_torch.parallel.loader.TorchDataLoader`
        over ``make_batch_reader`` of the store (on the card unless
        ``loader_kwargs`` holds ``device='cpu'``). Without ``cur_shard`` and
        ``shard_count`` the shard is the distributed runtime's."""
        from petastorm_tpu_torch.parallel.loader import TorchDataLoader, resolve_device
        from petastorm_tpu_torch.reader import make_batch_reader
        loader_kwargs = dict(loader_kwargs or {})
        # the device is checked before the reader starts its workers
        loader_kwargs['device'] = resolve_device(loader_kwargs.get('device'))
        self._check_shard_args(reader_kwargs)
        reader = make_batch_reader(self.file_urls, **reader_kwargs)
        try:
            return TorchDataLoader(reader, batch_size, mesh=mesh,
                                   partition_spec=partition_spec, **loader_kwargs)
        except BaseException:
            reader.stop()
            reader.join()
            raise

    def make_tf_dataset(self, batch_size=32, shuffle_row_count=None, prefetch=None,
                        **reader_kwargs):
        """A context manager yielding a ``tf.data`` pipeline over
        ``make_batch_reader`` of the store: unbatch, shuffle (with
        ``shuffle_row_count``), batch, prefetch (``tf.data.AUTOTUNE`` by
        default); the reader stops on exit."""
        return _TfDatasetContextManager(self, batch_size, shuffle_row_count, prefetch,
                                        reader_kwargs)

    def make_torch_dataloader(self, batch_size=32, shuffling_queue_capacity=0, device=None,
                              **reader_kwargs):
        """A context manager yielding a
        :class:`~petastorm_tpu_torch.pytorch.BatchedDataLoader` over the store
        (batches on ``device``, the card by default); the reader stops on
        exit."""
        return _TorchLoaderContextManager(self, batch_size, shuffling_queue_capacity,
                                          device, reader_kwargs)

    def _check_shard_args(self, reader_kwargs):
        """Fill ``cur_shard``/``shard_count`` from the distributed runtime when
        not given; warn when given ones disagree with it."""
        from petastorm_tpu_torch.parallel.mesh import distributed_shard_info
        cur_shard = reader_kwargs.get('cur_shard')
        shard_count = reader_kwargs.get('shard_count')
        detected_shard, detected_count = distributed_shard_info()
        if detected_count is not None:
            if shard_count is None:
                reader_kwargs['cur_shard'] = detected_shard
                reader_kwargs['shard_count'] = detected_count
            elif (cur_shard, shard_count) != (detected_shard, detected_count):
                warnings.warn('cur_shard/shard_count ({}, {}) disagree with the '
                              'distributed runtime ({}, {})'
                              .format(cur_shard, shard_count, detected_shard,
                                      detected_count))
        return reader_kwargs

    def delete(self, silent=False):
        """Remove the materialized store. ``silent`` logs a failure instead
        of raising it."""
        try:
            from petastorm_tpu_torch.fs_utils import (delete_path,
                                                      get_filesystem_and_path_or_paths)
            fs, path = get_filesystem_and_path_or_paths(self.cache_dir_url)
            delete_path(fs, path)
        except Exception:
            if not silent:
                raise
            logger.warning('Failed to delete converter store %s (silent=True); '
                           'the materialized files may linger',
                           self.cache_dir_url, exc_info=True)
        _active_converters.pop(self.cache_dir_url, None)
        # a deleted store is never served to a later conversion of its plan
        for key, converter in list(_spark_plan_converters.items()):
            if converter is self:
                del _spark_plan_converters[key]


class _TfDatasetContextManager(object):
    def __init__(self, converter, batch_size, shuffle_row_count, prefetch, reader_kwargs):
        self._converter = converter
        self._batch_size = batch_size
        self._shuffle = shuffle_row_count
        self._prefetch = prefetch
        self._reader_kwargs = reader_kwargs
        self._reader = None

    def __enter__(self):
        import tensorflow as tf
        from petastorm_tpu_torch.reader import make_batch_reader
        from petastorm_tpu_torch.tf_utils import make_petastorm_dataset
        self._converter._check_shard_args(self._reader_kwargs)
        _wait_file_available(self._converter.file_urls)
        self._reader = make_batch_reader(self._converter.file_urls, **self._reader_kwargs)
        dataset = make_petastorm_dataset(self._reader).unbatch()
        if self._shuffle:
            dataset = dataset.shuffle(self._shuffle)
        dataset = dataset.batch(self._batch_size)
        return dataset.prefetch(self._prefetch if self._prefetch is not None
                                else tf.data.AUTOTUNE)

    def __exit__(self, exc_type, exc_val, exc_tb):
        self._reader.stop()
        self._reader.join()


class _TorchLoaderContextManager(object):
    def __init__(self, converter, batch_size, shuffling_queue_capacity, device,
                 reader_kwargs):
        self._converter = converter
        self._batch_size = batch_size
        self._capacity = shuffling_queue_capacity
        self._device = device
        self._reader_kwargs = reader_kwargs
        self._reader = None

    def __enter__(self):
        from petastorm_tpu_torch.parallel.loader import resolve_device
        from petastorm_tpu_torch.pytorch import BatchedDataLoader
        from petastorm_tpu_torch.reader import make_batch_reader
        device = resolve_device(self._device)
        self._converter._check_shard_args(self._reader_kwargs)
        _wait_file_available(self._converter.file_urls)
        self._reader = make_batch_reader(self._converter.file_urls, **self._reader_kwargs)
        return BatchedDataLoader(self._reader, batch_size=self._batch_size,
                                 shuffling_queue_capacity=self._capacity, device=device)

    def __exit__(self, exc_type, exc_val, exc_tb):
        self._reader.stop()
        self._reader.join()


def _wait_file_available(urls, timeout_s=30):
    """Wait until every file in ``urls`` is visible (an eventually consistent
    store may list files late); raise after ``timeout_s``."""
    from petastorm_tpu_torch.fs_utils import get_filesystem_and_path_or_paths, path_exists
    fs, paths = get_filesystem_and_path_or_paths(list(urls))
    deadline = time.time() + timeout_s
    missing = list(paths)
    while missing:
        missing = [p for p in missing if not path_exists(fs, p)]
        if not missing:
            return
        if time.time() > deadline:
            raise RuntimeError('Files not available after {}s: {}'
                               .format(timeout_s, missing[:3]))
        time.sleep(1)


def _parent_cache_dir(parent_cache_dir_url):
    url = parent_cache_dir_url or os.environ.get(CACHE_DIR_ENV)
    if not url:
        raise ValueError('No converter cache dir configured: pass '
                         'parent_cache_dir_url or set ${}'.format(CACHE_DIR_ENV))
    return url.rstrip('/')


def make_converter(df, parent_cache_dir_url=None, rowgroup_size_mb=32, compression=None,
                   rows_per_file=None):
    """Materialize ``df`` (a ``pyarrow.Table``, or a pandas DataFrame) as a
    Parquet store under ``parent_cache_dir_url`` (default
    ``$PETASTORM_TPU_CONVERTER_CACHE_DIR``) and return a
    :class:`DatasetConverter`. The same content reuses the cached store. A
    pyspark DataFrame is written by Spark (parquet block size
    ``rowgroup_size_mb``) and reused for the same query plan in this
    session."""
    if _is_spark_dataframe(df):
        return _make_converter_spark(df, _parent_cache_dir(parent_cache_dir_url),
                                     rowgroup_size_mb)
    import pyarrow as pa
    table = _to_arrow_table(df)
    parent = _parent_cache_dir(parent_cache_dir_url)
    cache_dir = '{}/{}'.format(parent, _table_fingerprint(table))

    from petastorm_tpu_torch.fs_utils import (delete_path, get_filesystem_and_path_or_paths,
                                              path_exists)
    fs, cache_path = get_filesystem_and_path_or_paths(cache_dir)
    success_marker = cache_path + '/_SUCCESS'
    if path_exists(fs, success_marker):
        logger.info('Converter cache hit: %s', cache_dir)
    else:
        if path_exists(fs, cache_path):
            # a directory without _SUCCESS is a crashed conversion: its part
            # files would otherwise join the store
            logger.warning('Removing partial converter cache %s', cache_dir)
            delete_path(fs, cache_path)
        fs.create_dir(cache_path, recursive=True)
        from petastorm_tpu_torch.etl.dataset_metadata import write_table_files
        write_table_files(fs, cache_path, table.schema, table.to_batches(),
                          rowgroup_size_mb=rowgroup_size_mb, rows_per_file=rows_per_file,
                          compression=compression or 'snappy')
        with fs.open_output_stream(success_marker) as sink:
            sink.write(b'')
    file_infos = fs.get_file_info(pa.fs.FileSelector(cache_path))
    parquet = [info for info in file_infos if info.base_name.endswith('.parquet')]
    files = sorted(info.path for info in parquet)
    sizes = sorted(info.size for info in parquet)
    if sizes and sizes[len(sizes) // 2] < _MIN_RECOMMENDED_FILE_BYTES:
        logger.warning('Median converter file size %d bytes < recommended %d; consider '
                       'fewer, larger files', sizes[len(sizes) // 2],
                       _MIN_RECOMMENDED_FILE_BYTES)
    converter = DatasetConverter(cache_dir, files, table.num_rows)
    _active_converters[cache_dir] = converter
    return converter


#: live Spark-branch converters by query-plan hash: dedup within this session
#: only, since a plan hash names the query, not the data it read
_spark_plan_converters = {}


def _make_converter_spark(df, parent, rowgroup_size_mb):
    """The Spark DataFrame branch: the executors write the Parquet files (the
    data need not fit this process), then the store metadata (a Unischema
    inferred from those files, and the rowgroup index) is embedded through
    :func:`~petastorm_tpu_torch.etl.dataset_metadata.materialize_dataset`, so
    the store is a full one, as the table branch's is."""
    try:
        plan_key = df.semanticHash()
    except Exception:  # noqa: BLE001 - best effort; None turns the dedup off
        plan_key = None
    if plan_key is not None and plan_key in _spark_plan_converters:
        converter = _spark_plan_converters[plan_key]
        logger.info('Converter reuse (same spark plan this session): %s',
                    converter.cache_dir_url)
        return converter
    cache_dir = '{}/{}'.format(parent, uuid.uuid4().hex)
    df.write.option('parquet.block.size', rowgroup_size_mb << 20).parquet(cache_dir)
    from petastorm_tpu_torch.etl.dataset_metadata import materialize_dataset, open_dataset
    from petastorm_tpu_torch.unischema import Unischema
    schema = Unischema.from_arrow_schema(open_dataset(cache_dir).arrow_dataset.schema)
    with materialize_dataset(cache_dir, schema):
        pass   # the executors wrote the files; leaving embeds the metadata
    files = sorted(f.path for f in open_dataset(cache_dir).arrow_dataset.get_fragments())
    converter = DatasetConverter(cache_dir, files, df.count())
    _active_converters[cache_dir] = converter
    if plan_key is not None:
        _spark_plan_converters[plan_key] = converter
    return converter
