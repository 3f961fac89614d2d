"""Footer-planned byte-range planning for Parquet column chunks.

Given a parsed Parquet footer (``pyarrow.parquet.FileMetaData``), a set of
row groups and the top-level storage columns a read needs, emit exactly the
byte ranges of the matching column chunks — then **coalesce** ranges whose
gap is at most ``gap_bytes`` into merged GETs: on an object store the gap
bytes are cheaper to over-read than a second request round-trip is to pay.
Pure planning — no I/O, no clocks — so the unit matrix in
``tests/test_storage.py`` can cover the merge geometry exhaustively. A
copy of ``petastorm_tpu.storage.range_planner``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, NamedTuple, Sequence, Tuple

from petastorm_tpu_torch.errors import MetadataError


class ByteRange(NamedTuple):
    """A half-open ``[start, stop)`` byte span of the Parquet file."""

    start: int
    stop: int

    @property
    def length(self) -> int:
        return self.stop - self.start


@dataclass(frozen=True)
class RangePlan:
    """One planned fetch: the coalesced ranges plus the accounting the
    telemetry/cost plumbing reports (raw range count before coalescing,
    total bytes the merged GETs will move, the columns covered)."""

    ranges: Tuple[ByteRange, ...]
    raw_ranges: int
    total_bytes: int
    columns: Tuple[str, ...]

    @property
    def coalesced_away(self) -> int:
        """Raw ranges merged away by coalescing (>= 0)."""
        return self.raw_ranges - len(self.ranges)


def _chunk_range(column_chunk: Any) -> ByteRange:
    """The byte span of one column chunk: dictionary page (when present)
    through the end of the compressed data pages. Offset 0 is never a valid
    chunk start (the 4-byte magic lives there) — pyarrow reports 0 for an
    absent dictionary page on some writers, so it is filtered alongside
    None."""
    offsets = [off for off in (column_chunk.dictionary_page_offset,
                               column_chunk.data_page_offset)
               if off is not None and off > 0]
    if not offsets:
        raise MetadataError(
            'column chunk {!r} has no page offsets in the footer — the '
            'file metadata is unreadable by the range planner'.format(
                column_chunk.path_in_schema))
    start = min(offsets)
    return ByteRange(start, start + column_chunk.total_compressed_size)


def column_chunk_ranges(metadata: Any, row_group_ids: Sequence[int],
                        columns: Sequence[str]) -> List[ByteRange]:
    """Raw (uncoalesced) byte ranges of every column chunk in
    ``row_group_ids`` whose top-level field name is in ``columns``
    (``path_in_schema`` is dotted for nested fields; one top-level column
    may map to several chunks). Raises :class:`MetadataError` when a
    requested column matches no chunk — a planner/projection bug must
    surface, not silently fetch nothing."""
    wanted = {str(name) for name in columns}
    seen = set()
    ranges: List[ByteRange] = []
    for row_group_id in row_group_ids:
        row_group = metadata.row_group(row_group_id)
        for index in range(row_group.num_columns):
            chunk = row_group.column(index)
            top_level = chunk.path_in_schema.split('.')[0]
            if top_level in wanted:
                seen.add(top_level)
                ranges.append(_chunk_range(chunk))
    missing = wanted - seen
    if missing and row_group_ids:
        raise MetadataError(
            'columns {} matched no column chunk in row groups {} — '
            'projection and footer disagree'.format(
                sorted(missing), list(row_group_ids)))
    return ranges


def coalesce_ranges(ranges: Sequence[ByteRange],
                    gap_bytes: int) -> Tuple[ByteRange, ...]:
    """Merge overlapping/adjacent/near-adjacent ranges: any two whose gap
    is at most ``gap_bytes`` become one. Output is sorted and disjoint."""
    if not ranges:
        return ()
    merged: List[ByteRange] = []
    for current in sorted(ranges):
        if merged and current.start - merged[-1].stop <= max(gap_bytes, 0):
            previous = merged[-1]
            merged[-1] = ByteRange(previous.start,
                                   max(previous.stop, current.stop))
        else:
            merged.append(current)
    return tuple(merged)


def plan_ranges(metadata: Any, row_group_ids: Sequence[int],
                columns: Sequence[str], gap_bytes: int) -> RangePlan:
    """Plan one fetch: raw chunk ranges for ``columns`` over
    ``row_group_ids``, coalesced under ``gap_bytes``. An empty projection
    plans an empty fetch (zero ranges) rather than erroring — the
    two-phase predicate path legitimately asks for nothing when every
    field was already read."""
    raw = column_chunk_ranges(metadata, row_group_ids, columns)
    merged = coalesce_ranges(raw, gap_bytes)
    return RangePlan(ranges=merged, raw_ranges=len(raw),
                     total_bytes=sum(r.length for r in merged),
                     columns=tuple(str(name) for name in columns))
