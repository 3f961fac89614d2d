"""Token stores for the long-context LM path, written through the port's
codecs (both packages read them):

- :func:`write_token_store`: fixed-length rows of a rolled 16-token pattern
  (learnable, compressible), the content of ``bench.py``'s token store;
- :func:`write_packed_store`: ragged documents packed at write time by
  :func:`~petastorm_tpu_torch.ops.packing.pack_sequences` into bins with
  ``tokens``, ``tokens_segments`` and ``tokens_positions`` columns;
- :func:`write_ragged_store`: a plain Parquet store (no Unischema) of ragged
  documents, ``doc_id`` int64 and ``tokens`` ``list<int32>``, one rowgroup per
  list of documents, for packing at read time
  (:func:`~petastorm_tpu_torch.ops.packing.make_packing_transform`);
  :func:`full_bin_rowgroups` draws rowgroups that pack into full bins;
- :func:`write_frame_store`: streams of fixed-length token frames, one
  rowgroup a stream, indexed by stream (for NGram windows of consecutive
  frames read through a rowgroup selector).
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.etl.dataset_metadata import (materialize_dataset,
                                                      rows_to_arrow_table, write_rows)
from petastorm_tpu_torch.etl.rowgroup_indexers import SingleFieldIndexer
from petastorm_tpu_torch.etl.rowgroup_indexing import build_rowgroup_index
from petastorm_tpu_torch.ops.packing import pack_sequences
from petastorm_tpu_torch.unischema import Unischema, UnischemaField


def token_rows(rows, seq_len):
    """Row ``i`` is a 16-token pattern (drawn from seed 0) tiled to
    ``seq_len`` and rolled by ``i``."""
    base = np.random.RandomState(0).randint(0, 255, size=16, dtype=np.int32)
    tiled = np.tile(base, seq_len // 16 + 1)[:seq_len]
    return [np.roll(tiled, i).astype(np.int32) for i in range(rows)]


def write_token_store(url, rows, seq_len, n_files=2, rowgroup_size_mb=32):
    """A store of ``rows`` rows ``{'doc_id': int64, 'tokens': int32 (seq_len,)}``
    in ``n_files`` files; returns the token rows."""
    schema = Unischema('Tokens', [
        UnischemaField('doc_id', np.int64, (), ScalarCodec(), False),
        UnischemaField('tokens', np.int32, (seq_len,), NdarrayCodec(), False),
    ])
    tokens = token_rows(rows, seq_len)
    write_rows(url, schema, [{'doc_id': i, 'tokens': t} for i, t in enumerate(tokens)],
               rowgroup_size_mb=rowgroup_size_mb, n_files=n_files)
    return tokens


def ragged_documents(count, min_len, max_len, vocab, seed):
    """``count`` documents with lengths uniform in ``[min_len, max_len]`` and
    tokens uniform in ``[0, vocab)``, drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(min_len, max_len + 1, size=count)
    return [rng.randint(0, vocab, size=n).astype(np.int32) for n in lengths]


def write_packed_store(url, documents, seq_len, n_files=1, rowgroup_size_mb=32):
    """Pack ``documents`` into ``seq_len`` bins and store one row per bin with
    int32 ``(seq_len,)`` fields ``tokens``, ``tokens_segments`` and
    ``tokens_positions`` (plus an int64 ``bin_id``); returns the packed arrays."""
    packed = pack_sequences(documents, seq_len)
    schema = Unischema('PackedTokens', [
        UnischemaField('bin_id', np.int64, (), ScalarCodec(), False),
        UnischemaField('tokens', np.int32, (seq_len,), NdarrayCodec(), False),
        UnischemaField('tokens_segments', np.int32, (seq_len,), NdarrayCodec(), False),
        UnischemaField('tokens_positions', np.int32, (seq_len,), NdarrayCodec(), False),
    ])
    rows = [{'bin_id': i, 'tokens': packed['tokens'][i],
             'tokens_segments': packed['segments'][i],
             'tokens_positions': packed['positions'][i]}
            for i in range(len(packed['tokens']))]
    write_rows(url, schema, rows, rowgroup_size_mb=rowgroup_size_mb, n_files=n_files)
    return packed


def _split_length(total, min_len, max_len, rng):
    """Lengths in ``[min_len, max_len]`` summing to ``total`` (needs
    ``max_len >= 2 * min_len`` and ``total >= min_len``)."""
    lengths = []
    while total > max_len:
        n = rng.randint(min_len, min(max_len, total - min_len) + 1)
        lengths.append(n)
        total -= n
    return lengths + [total]


def full_bin_rowgroups(rowgroups, bins, seq_len, min_len, max_len, vocab, seed):
    """``rowgroups`` lists of documents (int32 tokens in ``[0, vocab)``, lengths
    in ``[min_len, max_len]``, drawn from ``seed``) whose lengths sum to
    exactly ``bins * seq_len``, ordered bin by bin so that first-fit packing
    (:func:`~petastorm_tpu_torch.ops.packing.pack_sequences`) fills exactly
    ``bins`` bins with no padding."""
    rng = np.random.RandomState(seed)
    return [[rng.randint(0, vocab, size=n).astype(np.int32)
             for _ in range(bins) for n in _split_length(seq_len, min_len, max_len, rng)]
            for _ in range(rowgroups)]


def write_ragged_store(url, rowgroups, n_files=1):
    """A plain Parquet store with one rowgroup per list of documents in
    ``rowgroups``: ``doc_id`` int64 (numbered across the store) and ``tokens``
    ``list<int32>``, spread over ``n_files`` files; no Unischema metadata."""
    if not url.startswith('file://'):
        raise ValueError('write_ragged_store writes local stores (file://), got {!r}'
                         .format(url))
    path = url[len('file://'):]
    os.makedirs(path, exist_ok=True)
    schema = pa.schema([pa.field('doc_id', pa.int64(), nullable=False),
                        pa.field('tokens', pa.list_(pa.int32()), nullable=False)])
    per_file = -(-len(rowgroups) // n_files)
    doc_id = 0
    for file_index in range(n_files):
        chunk = rowgroups[file_index * per_file:(file_index + 1) * per_file]
        if not chunk:
            break
        with pq.ParquetWriter(os.path.join(path, 'part_{:05d}.parquet'.format(file_index)),
                              schema) as writer:
            for docs in chunk:
                table = pa.table({'doc_id': pa.array(np.arange(doc_id, doc_id + len(docs)),
                                                     pa.int64()),
                                  'tokens': pa.array(docs, pa.list_(pa.int32()))},
                                 schema=schema)
                writer.write_table(table, row_group_size=len(docs))
                doc_id += len(docs)


#: the rowgroup index :func:`write_frame_store` builds on ``stream_id``
FRAME_STREAM_INDEX = 'stream'

def frame_tokens(streams, frames, frame_len, vocab, seed):
    """``(streams, frames, frame_len)`` int32 tokens uniform in ``[0, vocab)``
    from ``seed``: frame ``f`` of stream ``s`` is ``[s, f]``."""
    return np.random.RandomState(seed).randint(0, vocab, size=(streams, frames, frame_len),
                                               dtype=np.int32)


def write_frame_store(url, streams, frames, frame_len, vocab, n_files, seed):
    """A store of ``streams`` streams of ``frames`` frames, one rowgroup a
    stream, streams spread in order over ``n_files`` files: ``stream_id``
    int64 (constant in a rowgroup), ``frame_id`` int64 (``stream * frames +
    f``: consecutive within a stream, so a frame id names its stream) and
    ``tokens`` int32 ``(frame_len,)`` (``NdarrayCodec``) from
    :func:`frame_tokens`. Builds the :data:`FRAME_STREAM_INDEX` rowgroup index
    on ``stream_id``; returns the tokens."""
    if not url.startswith('file://'):
        raise ValueError('write_frame_store writes local stores (file://), got {!r}'
                         .format(url))
    schema = Unischema('Frames', [
        UnischemaField('stream_id', np.int64, (), ScalarCodec(), False),
        UnischemaField('frame_id', np.int64, (), ScalarCodec(), False),
        UnischemaField('tokens', np.int32, (frame_len,), NdarrayCodec(), False),
    ])
    tokens = frame_tokens(streams, frames, frame_len, vocab, seed)
    path = url[len('file://'):]
    os.makedirs(path, exist_ok=True)
    per_file = -(-streams // n_files)
    with materialize_dataset(url, schema):
        for file_index in range(n_files):
            file_streams = range(file_index * per_file,
                                 min(streams, (file_index + 1) * per_file))
            if not file_streams:
                break
            with pq.ParquetWriter(os.path.join(path, 'part_{:05d}.parquet'.format(file_index)),
                                  schema.as_arrow_schema()) as writer:
                for stream in file_streams:
                    rows = [{'stream_id': stream, 'frame_id': stream * frames + f,
                             'tokens': tokens[stream, f]} for f in range(frames)]
                    writer.write_table(rows_to_arrow_table(schema, rows), row_group_size=frames)
    build_rowgroup_index(url, [SingleFieldIndexer(FRAME_STREAM_INDEX, 'stream_id')])
    return tokens
