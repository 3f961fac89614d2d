"""Shared Parquet footer / row-group-metadata cache.

A reader fleet pointed at one dataset re-reads the same footers once per
worker per rowgroup on the seed path. This cache amortizes them twice over:

- an **in-process LRU** (``cache_capacity`` entries) serves every rowgroup
  piece of the same file from one footer read;
- an optional **atomic disk sidecar** (``cache_dir`` — the reader wires the
  dataset's local state home / shared disk-cache directory here, which is
  exactly the directory a co-located service fleet already shares) makes
  footers survive across processes and runs, so N clients of one dataset
  never re-read the same footers.

Entries are keyed ``(path, mtime_ns, size)``: a rewritten file (new mtime
or size) misses and refetches — the invalidation contract
``tests/test_storage.py`` pins down. Sidecar writes are atomic (temp file +
``os.replace``); a corrupt or truncated sidecar is treated as a miss, never
an error. No clocks — freshness derives entirely from filesystem stat
metadata. A copy of ``petastorm_tpu.storage.metadata_cache`` with its sidecar
format.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from collections import OrderedDict
from typing import Any, NamedTuple, Optional, Tuple

import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch.errors import MetadataError
from petastorm_tpu_torch.storage import storage_metrics

#: sidecar basename pattern (one file per dataset file, keyed by path hash)
SIDECAR_BASENAME = '_petastorm_tpu_footer_{digest}.bin'

#: tail bytes read first when the footer length is unknown (a policy can
#: widen this; one extra ranged read recovers from an under-estimate)
DEFAULT_FOOTER_READ_BYTES = 64 * 1024

_FOOTER_MAGIC = b'PAR1'


class FooterEntry(NamedTuple):
    """One cached footer: the parsed metadata, the raw footer tail bytes
    (thrift + 8-byte trailer — exactly what a planned sparse file must
    serve at ``[file_size - len(footer_bytes), file_size)``), and the file
    size the footer was read at."""

    metadata: Any
    footer_bytes: bytes
    file_size: int


def _stat_key(filesystem: Any, path: str) -> Tuple[str, int, int]:
    """The cache key ``(path, mtime_ns, size)`` from one filesystem stat.
    Filesystems that report no mtime key on 0 — size changes still
    invalidate."""
    info = filesystem.get_file_info(path)
    if isinstance(info, list):
        info = info[0]
    mtime_ns = getattr(info, 'mtime_ns', None)
    return str(path), int(mtime_ns or 0), int(info.size)


def read_footer_bytes(filesystem: Any, path: str, file_size: int,
                      footer_read_bytes: int = DEFAULT_FOOTER_READ_BYTES
                      ) -> bytes:
    """Read exactly the footer tail of ``path`` (thrift metadata + 8-byte
    trailer): one speculative tail read of ``footer_read_bytes``, one exact
    re-read only when the footer is larger than the guess."""
    handle = filesystem.open_input_file(path)
    try:
        guess = min(max(int(footer_read_bytes), 16), file_size)
        handle.seek(file_size - guess)
        tail = handle.read(guess)
        if len(tail) < 8 or tail[-4:] != _FOOTER_MAGIC:
            raise MetadataError(
                '{!r} is not a Parquet file (missing PAR1 trailer)'.format(
                    path))
        footer_len = int.from_bytes(tail[-8:-4], 'little')
        need = footer_len + 8
        if need > file_size:
            raise MetadataError(
                '{!r} declares a {}-byte footer larger than the {}-byte '
                'file — corrupt trailer'.format(path, footer_len, file_size))
        if need > len(tail):
            handle.seek(file_size - need)
            tail = handle.read(need)
        return tail[-need:]
    finally:
        handle.close()


class MetadataCache(object):
    """In-process LRU + disk-sidecar footer cache (module docstring).

    Thread-safe; one instance is shared by every rowgroup piece a worker
    process loads. Counters ``storage_footer_cache_hit`` / ``..._miss``
    count LRU-level lookups (a disk-sidecar fill counts as a miss — storage
    was spared, but a footer still had to be deserialized)."""

    def __init__(self, capacity: int = 256,
                 disk_dir: Optional[str] = None) -> None:
        self._capacity = max(int(capacity), 1)
        self._disk_dir = disk_dir
        self._lock = threading.Lock()
        self._entries: 'OrderedDict[Tuple[str, int, int], FooterEntry]' = \
            OrderedDict()

    # ------------------------------------------------------------- lookups

    def get(self, filesystem: Any, path: str,
            footer_read_bytes: int = DEFAULT_FOOTER_READ_BYTES
            ) -> FooterEntry:
        """The footer of ``path``, from (in order) the in-process LRU, the
        disk sidecar, or a ranged tail read — validated against the live
        ``(mtime, size)`` stat on every call."""
        key = _stat_key(filesystem, path)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                storage_metrics().inc('storage_footer_cache_hit')
                return entry
        storage_metrics().inc('storage_footer_cache_miss')
        footer = self._sidecar_load(key)
        if footer is None:
            footer = read_footer_bytes(filesystem, path, key[2],
                                       footer_read_bytes)
            self._sidecar_store(key, footer)
        metadata = pq.read_metadata(pa.BufferReader(footer))
        entry = FooterEntry(metadata=metadata, footer_bytes=footer,
                            file_size=key[2])
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self._capacity:
                self._entries.popitem(last=False)
        return entry

    # ------------------------------------------------------- disk sidecar

    def _sidecar_path(self, path: str) -> Optional[str]:
        if not self._disk_dir:
            return None
        digest = hashlib.sha1(path.encode('utf-8')).hexdigest()[:20]
        return os.path.join(self._disk_dir,
                            SIDECAR_BASENAME.format(digest=digest))

    def _sidecar_load(self, key: Tuple[str, int, int]) -> Optional[bytes]:
        """Footer bytes from the sidecar when its recorded ``(path, mtime,
        size)`` matches ``key``; None on absence, mismatch or corruption
        (a half-written or garbage sidecar is a miss, never an error)."""
        sidecar = self._sidecar_path(key[0])
        if sidecar is None:
            return None
        try:
            with open(sidecar, 'rb') as f:
                header_len = int.from_bytes(f.read(4), 'little')
                header = json.loads(f.read(header_len).decode('utf-8'))
                if (header.get('path') != key[0]
                        or int(header.get('mtime_ns', -1)) != key[1]
                        or int(header.get('size', -1)) != key[2]):
                    return None
                footer = f.read(int(header['footer_len']))
                if len(footer) != int(header['footer_len']):
                    return None
                return footer
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def _sidecar_store(self, key: Tuple[str, int, int],
                       footer: bytes) -> None:
        """Atomically persist ``footer`` (temp + ``os.replace``); a full
        disk or read-only sidecar directory degrades to in-process-only
        caching rather than failing the read."""
        sidecar = self._sidecar_path(key[0])
        if sidecar is None:
            return
        header = json.dumps({'path': key[0], 'mtime_ns': key[1],
                             'size': key[2],
                             'footer_len': len(footer)}).encode('utf-8')
        tmp = '{}.tmp.{}'.format(sidecar, os.getpid())
        try:
            with open(tmp, 'wb') as f:
                f.write(len(header).to_bytes(4, 'little'))
                f.write(header)
                f.write(footer)
            os.replace(tmp, sidecar)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
