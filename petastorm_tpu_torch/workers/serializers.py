"""The columnar byte layout of decoded rowgroups and the process pool's wire
serializers: a copy of ``petastorm_tpu.workers.serializers``.

Uniform numeric columns become ONE Arrow record batch in an IPC stream
(multi-dimensional columns as ``FixedSizeList``, their shapes and dtypes in the
schema metadata); every other column rides a pickled sidecar. The rowgroup
cache (:class:`~petastorm_tpu_torch.cache.ArrowIpcDiskCache`) stores this pair
on disk, and :class:`ArrowIpcSerializer` sends it from a process-pool worker to
the pool, with the batch's item id, cache hit, retries, quarantine record and
tripped breakers in the metadata. Decoding maps the numeric columns back as
zero-copy views of the stream's memory, or copies them (``writable=True``, what
the pool needs: its shm slots are reused once a result is read).
:class:`PickleSerializer` is the pool's other wire format."""

import json
import pickle

import numpy as np

_META_KEY = b'petastorm_tpu.columnar.v1'


def columns_num_rows(columns):
    """The row count of a ``{name: column}`` dict: the first column's length
    (0 for an empty dict)."""
    for col in columns.values():
        return len(col)
    return 0


def encode_columnar(columns, num_rows, meta_extra=None):
    """``{name: ndarray-or-list}`` -> ``(ipc_buffer, sidecar_bytes)``.
    ``meta_extra`` is a JSON-safe dict merged into the schema metadata."""
    import pyarrow as pa

    arrow_arrays = []
    arrow_names = []
    col_meta = {}
    sidecar_cols = {}
    for name, col in columns.items():
        if (isinstance(col, np.ndarray) and col.ndim >= 1
                and col.dtype.kind in 'iuf' and len(col) == num_rows):
            arr = np.ascontiguousarray(col)
            # explicit inner size: reshape(n, -1) cannot infer an axis when n == 0
            inner = int(np.prod(arr.shape[1:], dtype=np.int64)) if arr.ndim > 1 else 1
            flat = arr.reshape(len(arr), inner) if arr.ndim > 1 else arr
            pa_arr = pa.array(flat.ravel())
            if arr.ndim > 1:
                pa_arr = pa.FixedSizeListArray.from_arrays(pa_arr, flat.shape[1])
            arrow_arrays.append(pa_arr)
            arrow_names.append(name)
            col_meta[name] = {'dtype': arr.dtype.str, 'shape': list(arr.shape[1:])}
        else:
            sidecar_cols[name] = col
    meta = {'num_rows': int(num_rows), 'columns': col_meta}
    if meta_extra:
        meta.update(meta_extra)
    schema = pa.schema([pa.field(n, a.type) for n, a in zip(arrow_names, arrow_arrays)],
                       metadata={_META_KEY: json.dumps(meta).encode('utf-8')})
    batch = pa.record_batch(arrow_arrays, schema=schema)
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, schema) as writer:
        writer.write_batch(batch)
    return sink.getvalue(), pickle.dumps(sidecar_cols, protocol=5)


def decode_columnar(ipc_buffer, sidecar, writable=True):
    """The :func:`encode_columnar` pair back to ``{name: column}``.
    ``ipc_buffer`` is a ``pa.Buffer`` (e.g. a slice of a memory map). With
    ``writable=False`` numeric columns are READ-ONLY views of its memory,
    which they keep alive."""
    return decode_columnar_with_meta(ipc_buffer, sidecar, writable)[0]


def decode_columnar_with_meta(ipc_buffer, sidecar, writable=True, stats=None):
    """:func:`decode_columnar` returning ``(columns, meta)``, ``meta`` being the
    schema metadata with the ``meta_extra`` keys. ``ipc_buffer`` may also be
    bytes or a memoryview. ``stats['bytes_copied']`` counts the bytes copied
    into writable columns."""
    import pyarrow as pa

    if not isinstance(ipc_buffer, pa.Buffer):
        ipc_buffer = pa.py_buffer(ipc_buffer)
    with pa.ipc.open_stream(ipc_buffer) as reader:
        batch = reader.read_next_batch()
        meta = json.loads(batch.schema.metadata[_META_KEY].decode('utf-8'))
    columns = pickle.loads(memoryview(sidecar))
    for i, field in enumerate(batch.schema):
        col = batch.column(i)
        spec = meta['columns'][field.name]
        shape = tuple(spec['shape'])
        if shape:
            values = col.flatten().to_numpy(zero_copy_only=(len(col) > 0))
            values = values.reshape((len(col),) + shape)
        else:
            values = col.to_numpy(zero_copy_only=(len(col) > 0))
        values = values.astype(spec['dtype'], copy=False)
        if writable and not values.flags.writeable:
            values = values.copy()
            if stats is not None:
                stats['bytes_copied'] += values.nbytes
        columns[field.name] = values
    return columns, meta


_MARKER_ARROW = b'A'
_MARKER_PICKLE = b'P'


class PickleSerializer(object):
    """Whole-object pickle, the JAX package's ``PickleSerializer``: always
    correct, copies everything. One frame ``[b'P', pickle]``; receiving
    counts the payload's bytes as copied."""

    def __init__(self):
        #: receive-side counts: payloads, and bytes copied into new memory
        self.stats = {'batches': 0, 'bytes_copied': 0}

    def serialize(self, obj):
        return [_MARKER_PICKLE, pickle.dumps(obj, protocol=5)]

    def deserialize(self, frames):
        self.stats['batches'] += 1
        self.stats['bytes_copied'] += memoryview(frames[1]).nbytes
        return pickle.loads(frames[1])


class ArrowIpcSerializer(object):
    """The process pool's default wire format: a
    :class:`~petastorm_tpu_torch.reader_worker.ColumnarBatch` travels as
    ``[b'A', ipc_stream, pickled_sidecar]`` (:func:`encode_columnar`, with
    ``item_id``, ``cache_hit``, ``retries``, ``quarantine``, ``breakers`` and
    the ``telemetry``, ``trace`` and ``lineage`` sidecars in the metadata); anything else, an
    :class:`~petastorm_tpu_torch.ngram_worker.NGramWindows` for one, as one
    pickle. Receiving copies every column into ordinary writable arrays, so no
    array outlives the slot or frame it was read from."""

    def __init__(self):
        #: receive-side counts: payloads, and bytes copied into new memory
        self.stats = {'batches': 0, 'bytes_copied': 0}

    def serialize(self, obj):
        from petastorm_tpu_torch.reader_worker import ColumnarBatch
        if type(obj) is not ColumnarBatch:
            return [_MARKER_PICKLE, pickle.dumps(obj, protocol=5)]
        meta_extra = {
            'item_id': [int(part) for part in obj.item_id] if obj.item_id is not None
                       else None,
            'cache_hit': obj.cache_hit,
            'retries': int(obj.retries),
            'quarantine': obj.quarantine.as_dict() if obj.quarantine is not None else None,
            'breakers': obj.breakers,
            'telemetry': obj.telemetry,
            'trace': obj.trace,
            'lineage': obj.lineage,
        }
        ipc_buf, sidecar = encode_columnar(obj.columns, obj.num_rows, meta_extra)
        return [_MARKER_ARROW, ipc_buf, sidecar]

    def deserialize(self, frames):
        self.stats['batches'] += 1
        if bytes(frames[0]) == _MARKER_PICKLE:
            self.stats['bytes_copied'] += memoryview(frames[1]).nbytes
            return pickle.loads(frames[1])
        from petastorm_tpu_torch.reader_worker import ColumnarBatch
        from petastorm_tpu_torch.resilience import QuarantineRecord
        self.stats['bytes_copied'] += memoryview(frames[2]).nbytes
        columns, meta = decode_columnar_with_meta(frames[1], frames[2], writable=True,
                                                  stats=self.stats)
        item_id = meta['item_id']
        quarantine = meta['quarantine']
        return ColumnarBatch(columns, meta['num_rows'],
                             item_id=tuple(item_id) if item_id is not None else None,
                             cache_hit=meta['cache_hit'], retries=meta['retries'],
                             quarantine=(QuarantineRecord(**quarantine)
                                         if quarantine is not None else None),
                             breakers=meta['breakers'], telemetry=meta['telemetry'],
                             trace=meta['trace'], lineage=meta.get('lineage'))
