"""The assembled ingest engine: a planned, sparse rowgroup source.

:class:`RowGroupSource` is what the worker read path
(``reader_worker._load_and_decode`` / ``_two_phase_load``) consumes in
place of ``fragment.to_table()`` when a storage policy is armed. Per
``read_columns`` call it:

1. plans the column-chunk byte ranges the NEW columns need (footer from the
   shared :class:`~petastorm_tpu_torch.storage.metadata_cache.MetadataCache`,
   coalesced under the policy's gap threshold);
2. executes the plan through the hedged
   :class:`~petastorm_tpu_torch.storage.fetcher.RangeFetcher` (one ``range_fetch``
   stage span per executed plan, its trace args carrying bytes/ranges/hedge
   totals into the cost ledger);
3. parses the rowgroup out of a **sparse segmented file** — a file-like
   view of the real file that serves the fetched segments plus the cached
   footer from memory (``rowgroup_read`` therefore times ONLY the Parquet
   decode, disjoint from ``range_fetch``). Reads pyarrow makes outside the
   plan (page indexes, bloom filters) fall back to serial ranged reads of
   the real file, so correctness never depends on planner completeness.

Columns already fetched by an earlier call are never re-fetched — the
two-phase predicate path reads every storage column exactly once, same as
the seed path. A copy of ``petastorm_tpu.storage.engine``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import time

import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch.errors import TransientIOError
from petastorm_tpu_torch.storage import StoragePolicy, storage_metrics
from petastorm_tpu_torch.storage.fetcher import RangeFetcher
from petastorm_tpu_torch.storage.metadata_cache import FooterEntry, MetadataCache
from petastorm_tpu_torch.storage.range_planner import plan_ranges
from petastorm_tpu_torch.telemetry.spans import record_stage, stage_span


class _SegmentedFile(object):
    """Read-only file-like view of a remote file assembled from in-memory
    segments, with a serial ranged-read fallback for unplanned regions.
    Wrapped in ``pa.PythonFile`` and handed to ``pq.ParquetFile`` — pyarrow
    sees an ordinary seekable file of the true size while almost every read
    is served from memory. Single-threaded by contract (pyarrow drives it
    from the calling thread)."""

    def __init__(self, size: int, segments: Sequence[Tuple[int, bytes]],
                 fallback_read: Any) -> None:
        self._size = size
        self._segments = sorted(segments)
        self._fallback_read = fallback_read
        self._pos = 0
        self.fallback_reads = 0
        self.closed = False

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def writable(self) -> bool:
        return False

    def size(self) -> int:
        return self._size

    def tell(self) -> int:
        return self._pos

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == 0:
            self._pos = offset
        elif whence == 1:
            self._pos += offset
        else:
            self._pos = self._size + offset
        return self._pos

    def close(self) -> None:
        self.closed = True

    def flush(self) -> None:
        return None

    def read(self, nbytes: int = -1) -> bytes:
        if nbytes is None or nbytes < 0:
            nbytes = self._size - self._pos
        start = self._pos
        stop = min(start + nbytes, self._size)
        self._pos = stop
        if stop <= start:
            return b''
        out = bytearray(stop - start)
        covered: List[Tuple[int, int]] = []
        for seg_start, data in self._segments:
            seg_stop = seg_start + len(data)
            lo, hi = max(seg_start, start), min(seg_stop, stop)
            if lo < hi:
                out[lo - start:hi - start] = data[lo - seg_start:
                                                 hi - seg_start]
                covered.append((lo, hi))
        for gap_start, gap_stop in _uncovered(start, stop, covered):
            self.fallback_reads += 1
            filled = self._fallback_read(gap_start, gap_stop - gap_start)
            if len(filled) != gap_stop - gap_start:
                raise TransientIOError(
                    'short fallback read at [{}, {})'.format(gap_start,
                                                             gap_stop))
            out[gap_start - start:gap_stop - start] = filled
        return bytes(out)


def _uncovered(start: int, stop: int,
               covered: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The sub-ranges of ``[start, stop)`` not covered by ``covered``
    (sorted, possibly-overlapping spans)."""
    gaps: List[Tuple[int, int]] = []
    cursor = start
    for lo, hi in sorted(covered):
        if lo > cursor:
            gaps.append((cursor, lo))
        cursor = max(cursor, hi)
    if cursor < stop:
        gaps.append((cursor, stop))
    return gaps


class RowGroupSource(object):
    """Planned reader for one fragment file (module docstring).

    ``row_group_id`` None means the whole file (the unsplit-piece case);
    otherwise the single rowgroup the work item names. One instance serves
    every ``read_columns`` call of one work item, accumulating fetched
    segments so no storage column is fetched twice."""

    def __init__(self, path: str, filesystem: Any, policy: StoragePolicy,
                 row_group_id: Optional[int],
                 metadata_cache: MetadataCache,
                 clock: Any = time.monotonic) -> None:
        self._path = path
        self._filesystem = filesystem
        self._policy = policy
        self._row_group_id = row_group_id
        self._entry: FooterEntry = metadata_cache.get(
            filesystem, path, policy.footer_read_bytes)
        self._fetcher = RangeFetcher(self._open, policy, clock=clock)
        footer_start = self._entry.file_size - len(self._entry.footer_bytes)
        self._segments: List[Tuple[int, bytes]] = [
            (footer_start, self._entry.footer_bytes)]
        self._have: Set[str] = set()
        self._fallback_lock = threading.Lock()
        self._fallback_handle: Optional[Any] = None

    # ------------------------------------------------------------ plumbing

    def _open(self) -> Any:
        return self._filesystem.open_input_file(self._path)

    def _row_group_ids(self) -> List[int]:
        if self._row_group_id is None:
            return list(range(self._entry.metadata.num_row_groups))
        return [int(self._row_group_id)]

    def _fallback_read(self, start: int, length: int) -> bytes:
        """Serial ranged read of the REAL file for a region the plan did
        not cover — the correctness net under pyarrow internals."""
        with self._fallback_lock:
            if self._fallback_handle is None:
                # the blocking open stays under the lock on purpose: fallback
                # reads share one seek+read handle, so they are serialized by
                # design, and opening outside the lock would race a second
                # open of the same file
                self._fallback_handle = self._open()  # pipecheck: disable=lock-discipline -- serialized-by-design shared handle; the blocking chain is chaos-injected open latency (test_util)
            self._fallback_handle.seek(start)
            return bytes(self._fallback_handle.read(length))

    @property
    def metadata(self) -> Any:
        """The cached ``pyarrow.parquet.FileMetaData`` footer."""
        return self._entry.metadata

    def schema_arrow(self) -> pa.Schema:
        """The file's Arrow schema (from the cached footer — what the
        empty-survivor predicate path builds its zero-row table from)."""
        schema: pa.Schema = self._entry.metadata.schema.to_arrow_schema()
        return schema

    # ----------------------------------------------------------- main read

    def read_columns(self, columns: Sequence[str]) -> pa.Table:
        """Read ``columns`` of the source's rowgroup(s) as an Arrow table
        (requested column order). Only columns not fetched by an earlier
        call are planned and fetched; the Parquet decode itself is timed as
        ``rowgroup_read``, disjoint from ``range_fetch``."""
        names = [str(name) for name in columns]
        fresh = [name for name in names if name not in self._have]
        if fresh:
            plan = plan_ranges(self._entry.metadata, self._row_group_ids(),
                               fresh, self._policy.coalesce_gap_bytes)
            if plan.coalesced_away > 0:
                storage_metrics().inc('storage_ranges_coalesced',
                                      plan.coalesced_away)
            fetched = self._fetcher.fetch(plan)
            record_stage('range_fetch', fetched.seconds,
                         trace_args=fetched.trace_args())
            for byte_range, data in fetched.segments.items():
                self._segments.append((byte_range.start, data))
            self._have.update(fresh)
        with stage_span('rowgroup_read'):
            sparse = _SegmentedFile(self._entry.file_size, self._segments,
                                    self._fallback_read)
            parquet_file = pq.ParquetFile(pa.PythonFile(sparse, mode='r'),
                                          metadata=self._entry.metadata)
            if self._row_group_id is None:
                table = parquet_file.read(columns=names)
            else:
                table = parquet_file.read_row_group(int(self._row_group_id),
                                                    columns=names)
        return table.select(names)
