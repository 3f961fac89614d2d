"""The columnar byte layout of decoded rowgroups: a copy of the two columnar
functions of ``petastorm_tpu.workers.serializers``, which the port's
rowgroup cache (:class:`~petastorm_tpu_torch.cache.ArrowIpcDiskCache`) stores
on disk. Uniform numeric columns become ONE Arrow record batch in an IPC
stream (multi-dimensional columns as ``FixedSizeList``, their shapes and
dtypes in the schema metadata); every other column rides a pickled sidecar.
Decoding maps the numeric columns back as zero-copy views of the stream's
memory."""

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


def encode_columnar(columns, num_rows):
    """``{name: ndarray-or-list}`` -> ``(ipc_buffer, sidecar_bytes)``."""
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
    import pyarrow as pa

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
        columns[field.name] = values
    return columns
