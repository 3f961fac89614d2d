"""Rowgroup cache: a copy of ``petastorm_tpu.cache``, so repeated epochs over
a store read decoded rowgroups from local disk instead of Parquet.

A file per key, under 256 shard directories, written to a private temp file
and published by an atomic ``os.replace``; the total size is capped by
``size_limit_bytes`` with least-recently-touched (mtime) eviction down to 90%
of the cap. Two value formats:

- :class:`LocalDiskCache`: a whole-value pickle; every hit unpickles.
- :class:`ArrowIpcDiskCache`: decoded columns as one Arrow IPC stream plus a
  pickled sidecar (:mod:`~petastorm_tpu_torch.workers.serializers`), with a
  CRC-32 footer checked before any byte of the body is read. A hit
  memory-maps the file and serves numeric columns as read-only views of the
  map (``writable_hits=True`` copies each column out instead). Values that
  are not columnar are stored as an embedded pickle record.

An unreadable entry (truncated, corrupt) is deleted and served as a miss.
Both keep a ``stats`` dict: ``hits``, ``misses``, ``arrow_hits``,
``pickle_hits``, ``bytes_mmapped``, ``bytes_written`` and
``corrupt_entries``.

Telemetry: writing a filled value is the ``cache_store`` stage, and deleting
an unreadable entry one ``cache_corrupt`` observation (the worker times
``cache_hit``/``cache_miss`` around ``get``).

Defined difference: the JAX package's cache also has a circuit breaker (an
open breaker bypasses the cache) and autotuner knobs (``set_bypass``,
``set_writable_hits``); the port has neither yet, and no ``bypass_reads``
stat. Nothing of the
reader removes a cache directory (the JAX caches' ``cleanup=True`` option,
which no reader calls either, is left out).
"""

import hashlib
import logging
import os
import pickle
import struct
import tempfile
import threading
import time
import zlib

from petastorm_tpu_torch.errors import CacheCorruptionError
from petastorm_tpu_torch.telemetry.spans import record_stage, stage_span

logger = logging.getLogger(__name__)

#: Arrow-IPC entry header: magic, mode byte ('A' columnar / 'P' pickle),
#: uint64-LE length of the IPC stream (0 in pickle mode)
_ARROW_MAGIC = b'PTUAC001'
_HEADER = struct.Struct('<8scQ')
#: Arrow-IPC entry footer: magic, CRC-32 of the body, uint64-LE body length
_FOOTER_MAGIC = b'PTUCRC01'
_FOOTER = struct.Struct('<8sIQ')


class CacheBase(object):
    """Rowgroup-cache interface: ``get`` with a fill function."""

    def get(self, key, fill_cache_func):
        """The cached value of ``key``; on a miss, ``fill_cache_func()``'s
        result, stored."""
        raise NotImplementedError()


class NullCache(CacheBase):
    """Pass-through: always calls the fill function."""

    def get(self, key, fill_cache_func):
        return fill_cache_func()


def _new_cache_stats():
    return {'hits': 0, 'misses': 0, 'arrow_hits': 0, 'pickle_hits': 0,
            'bytes_mmapped': 0, 'bytes_written': 0, 'corrupt_entries': 0}


class LocalDiskCache(CacheBase):
    """File-per-key pickle cache under ``path``, bounded by
    ``size_limit_bytes`` with mtime-LRU eviction.

    :param path: cache root directory (created if absent).
    :param size_limit_bytes: total bytes before eviction starts.
    :param expected_row_size_bytes: sanity check: the limit must hold at least
        100 such rows.
    """

    #: this format's file suffix; eviction counts every known suffix, so two
    #: formats sharing a directory stay bounded together
    _SUFFIX = '.pkl'
    _ALL_SUFFIXES = ('.pkl', '.arrow')

    def __init__(self, path, size_limit_bytes, expected_row_size_bytes=0):
        if expected_row_size_bytes and size_limit_bytes < 100 * expected_row_size_bytes:
            raise ValueError('Cache size_limit_bytes={} is too small for rows of ~{} bytes'
                             .format(size_limit_bytes, expected_row_size_bytes))
        self._path = path
        self._size_limit_bytes = size_limit_bytes
        self._lock = threading.Lock()
        self.stats = _new_cache_stats()
        self._decode_failure_logged = False
        os.makedirs(path, exist_ok=True)
        # running byte total: one scan at the first store, then bumped per
        # store; the full rescan runs only when it crosses the limit
        self._approx_bytes = None

    def __getstate__(self):
        # shipped to process-pool workers: each process keeps its own lock
        state = self.__dict__.copy()
        del state['_lock']
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def _key_path(self, key):
        digest = hashlib.sha1(str(key).encode('utf-8')).hexdigest()
        return os.path.join(self._path, digest[:2], digest + self._SUFFIX)

    def _encode_value(self, value):
        return pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)

    def _decode_file(self, file_path):
        with open(file_path, 'rb') as f:
            value = pickle.load(f)
        with self._lock:
            self.stats['pickle_hits'] += 1
        return value

    def get(self, key, fill_cache_func):
        file_path = self._key_path(key)
        try:
            value = self._decode_file(file_path)
            os.utime(file_path, None)   # touched: most recently used
            with self._lock:
                self.stats['hits'] += 1
            return value
        except FileNotFoundError:
            pass
        except Exception:  # noqa: BLE001 - an unreadable entry is a miss
            # expected after a crash mid-write elsewhere; a systematic failure
            # would turn every epoch cold, so the first is logged loudly
            if not self._decode_failure_logged:
                self._decode_failure_logged = True
                logger.warning('cache entry %s is unreadable; deleting it and serving a '
                               'miss (further failures logged at DEBUG)', file_path,
                               exc_info=True)
            else:
                logger.debug('cache entry %s is unreadable', file_path, exc_info=True)
            delete_start = time.perf_counter()
            try:
                os.unlink(file_path)
            except OSError:
                pass   # a concurrent reader may have removed it already
            with self._lock:
                self.stats['corrupt_entries'] += 1
            record_stage('cache_corrupt', time.perf_counter() - delete_start)
        with self._lock:
            self.stats['misses'] += 1
        value = fill_cache_func()
        try:
            self._store(file_path, value)
        except OSError:
            # the value is in hand: a failed store must not fail the read
            logger.warning('failed to store cache entry %s; serving the value uncached',
                           file_path, exc_info=True)
        return value

    def _store(self, file_path, value):
        # cache_store: encode + write + publish
        with stage_span('cache_store'):
            os.makedirs(os.path.dirname(file_path), exist_ok=True)
            blob = self._encode_value(value)
            if len(blob) > self._size_limit_bytes:
                return   # one value larger than the cache: do not thrash
            # concurrent fillers of one key each write a private temp file and
            # publish it atomically: readers only ever see a whole entry
            fd, tmp_path = tempfile.mkstemp(dir=os.path.dirname(file_path))
            try:
                with os.fdopen(fd, 'wb') as f:
                    f.write(blob)
                os.replace(tmp_path, file_path)
            finally:
                try:
                    os.unlink(tmp_path)   # a no-op after os.replace
                except OSError:
                    pass
        with self._lock:
            self.stats['bytes_written'] += len(blob)
            if self._approx_bytes is None:
                self._approx_bytes = sum(size for _, size, _ in self._iter_entries())
            else:
                self._approx_bytes += len(blob)
            over_limit = self._approx_bytes > self._size_limit_bytes
        if over_limit:
            self._evict()

    def _iter_entries(self):
        for shard in os.listdir(self._path):
            shard_path = os.path.join(self._path, shard)
            if not os.path.isdir(shard_path):
                continue
            for name in os.listdir(shard_path):
                if not name.endswith(self._ALL_SUFFIXES):
                    continue   # another writer's temp file
                full = os.path.join(shard_path, name)
                try:
                    stat = os.stat(full)
                except OSError:
                    continue
                yield full, stat.st_size, stat.st_mtime

    def _evict(self):
        with self._lock:
            entries = list(self._iter_entries())
            total = sum(size for _, size, _ in entries)
            if total > self._size_limit_bytes:
                # least recently touched first, down to 90% of the limit
                entries.sort(key=lambda e: e[2])
                target = int(self._size_limit_bytes * 0.9)
                for full, size, _ in entries:
                    if total <= target:
                        break
                    try:
                        os.unlink(full)
                        total -= size
                    except OSError:
                        continue
            self._approx_bytes = total

    @property
    def size(self):
        """Bytes of the entries on disk."""
        return sum(size for _, size, _ in self._iter_entries())


class ArrowIpcDiskCache(LocalDiskCache):
    """Decoded-rowgroup cache with memory-mapped hits (see the module
    docstring). The constructor is :class:`LocalDiskCache`'s plus
    ``writable_hits``: False serves numeric columns as read-only views of the
    map, True as writable copies (still no Parquet read or decode)."""

    _SUFFIX = '.arrow'

    def __init__(self, path, size_limit_bytes, expected_row_size_bytes=0, writable_hits=False):
        super().__init__(path, size_limit_bytes, expected_row_size_bytes)
        self.writable_hits = writable_hits

    def _encode_value(self, value):
        from petastorm_tpu_torch.workers.serializers import columns_num_rows, encode_columnar
        body = None
        if isinstance(value, dict):
            try:
                ipc_buf, sidecar = encode_columnar(value, columns_num_rows(value))
                header = _HEADER.pack(_ARROW_MAGIC, b'A', len(ipc_buf))
                body = ipc_buf.to_pybytes() + sidecar
            except Exception:  # noqa: BLE001 - not columnar: a pickle record
                logger.debug('value for the arrow cache is not columnar; storing a '
                             'pickle record', exc_info=True)
        if body is None:
            header = _HEADER.pack(_ARROW_MAGIC, b'P', 0)
            body = pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)
        footer = _FOOTER.pack(_FOOTER_MAGIC, zlib.crc32(body) & 0xFFFFFFFF, len(body))
        return b''.join([header, body, footer])

    def _decode_file(self, file_path):
        import pyarrow as pa
        from petastorm_tpu_torch.workers.serializers import decode_columnar
        buf = pa.memory_map(file_path, 'r').read_buffer()
        total = len(buf)
        if total < _HEADER.size + _FOOTER.size:
            raise CacheCorruptionError('cache entry {} is {} bytes, shorter than its '
                                       'header and footer'.format(file_path, total))
        magic, mode, ipc_len = _HEADER.unpack_from(memoryview(buf)[:_HEADER.size])
        if magic != _ARROW_MAGIC:
            raise CacheCorruptionError('not an ArrowIpcDiskCache entry: {!r}'.format(magic))
        # the footer is checked before any byte of the body is interpreted
        footer_magic, crc, body_len = _FOOTER.unpack_from(
            memoryview(buf)[total - _FOOTER.size:])
        if footer_magic != _FOOTER_MAGIC:
            raise CacheCorruptionError('cache entry {} has no integrity footer'
                                       .format(file_path))
        if body_len != total - _HEADER.size - _FOOTER.size or ipc_len > body_len:
            raise CacheCorruptionError(
                'cache entry {} length mismatch: the footer claims {} body bytes, the '
                'file holds {}'.format(file_path, body_len,
                                       total - _HEADER.size - _FOOTER.size))
        body = buf.slice(_HEADER.size, body_len)
        if zlib.crc32(memoryview(body)) & 0xFFFFFFFF != crc:
            raise CacheCorruptionError('cache entry {} failed its CRC check'
                                       .format(file_path))
        if mode == b'P':
            value = pickle.loads(memoryview(body))
            with self._lock:
                self.stats['pickle_hits'] += 1
            return value
        columns = decode_columnar(body.slice(0, ipc_len), body.slice(ipc_len),
                                  writable=self.writable_hits)
        with self._lock:
            self.stats['arrow_hits'] += 1
            self.stats['bytes_mmapped'] += total
        return columns
