"""Columnar decode plans: one whole-column kernel per output field, chosen once
per field set (a trimmed copy of ``petastorm_tpu.decode_engine``).

Kept: the decode plan with its partition / ship-raw / codec / shaped-list /
native kernels, the ship-raw contract of the device decode tail (the
``RAW_*`` constants and the DCT, npy and deflate ship-raw kernels), and the
``stack_if_uniform`` / ``arrow_to_numpy`` helpers, and
:func:`evaluate_predicate_mask`, which evaluates any predicate over its
decoded columns (the built-in classes in one vectorized call). The JAX
package's Arrow pushdown (``compile_predicate``) is not copied: it gives the
same masks, and no measured workload gains from it yet.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from petastorm_tpu_torch.codecs import (CompressedNdarrayCodec, DctImageCodec,
                                        NdarrayCodec, _cached_npy_meta,
                                        _column_blobs, _npz_raw_member)
from petastorm_tpu_torch.errors import DecodeFieldError
from petastorm_tpu_torch.predicates import (PredicateBase, in_intersection, in_negate,
                                            in_pseudorandom_split, in_reduce, in_set)
from petastorm_tpu_torch.telemetry import tracing as _tracing

#: decoded columns of one rowgroup: ``{field_name: ndarray | list}``
Columns = Dict[str, Any]

#: one compiled per-field kernel: ``(table, partition_keys, num_rows) -> column``
FieldKernel = Callable[[Any, Mapping[str, Any], int], Any]


def stack_if_uniform(values: Sequence[Any], field: Any) -> Any:
    """Stack per-row arrays into one ``(n,) + shape`` array when shapes are
    uniform; otherwise keep a list (ragged or null-bearing)."""
    if not values:
        return np.empty((0,) + tuple(d or 0 for d in (field.shape if field else ())))
    if field is not None and field.shape == ():
        first = values[0]
        if isinstance(first, (str, bytes)) or first is None:
            return np.array(values, dtype=object)
        return np.asarray(values)
    if any(v is None for v in values):
        return list(values)
    arrays = [np.asarray(v) for v in values]
    if len({a.shape for a in arrays}) == 1:
        return np.stack(arrays)
    return list(values)


def arrow_to_numpy(arrow_col: Any) -> Any:
    """Native column to numpy: scalars to typed arrays, strings/binary/decimal
    to object arrays, lists to lists of numpy arrays.

    A list of a primitive type keeps that type (``list<int32>`` gives int32
    arrays), sliced from one copy of the values per chunk: a defined
    difference from ``petastorm_tpu``, whose rows go through Python lists and
    come out int64 or float64."""
    import pyarrow.types as patypes
    col_type = arrow_col.type
    if patypes.is_list(col_type) or patypes.is_large_list(col_type):
        value_type = col_type.value_type
        if not (patypes.is_integer(value_type) or patypes.is_floating(value_type)
                or patypes.is_boolean(value_type)):
            return [None if v is None else np.asarray(v) for v in arrow_col.to_pylist()]
        chunks = getattr(arrow_col, 'chunks', [arrow_col])
        if any(chunk.values.null_count for chunk in chunks):
            return [None if v is None else np.asarray(v) for v in arrow_col.to_pylist()]
        out: List[Any] = []
        for chunk in chunks:
            # offsets index the unsliced child values of a sliced chunk
            values = np.array(chunk.values.to_numpy(zero_copy_only=False))
            offsets = chunk.offsets.to_numpy()
            nulls = chunk.is_null().to_numpy(zero_copy_only=False) if chunk.null_count else None
            out.extend(None if nulls is not None and nulls[i]
                       else values[offsets[i]:offsets[i + 1]] for i in range(len(chunk)))
        return out
    if (patypes.is_string(col_type) or patypes.is_large_string(col_type)
            or patypes.is_binary(col_type) or patypes.is_large_binary(col_type)
            or patypes.is_decimal(col_type)):
        return arrow_col.to_numpy(zero_copy_only=False).astype(object)
    return arrow_col.to_numpy(zero_copy_only=False)


def partition_column(field: Any, value: Any, num_rows: int) -> np.ndarray:
    """A partition-key constant materialized as a full column."""
    if field is not None and np.dtype(field.numpy_dtype).kind not in ('U', 'S', 'O'):
        return np.full(num_rows, np.dtype(field.numpy_dtype).type(value))
    return np.array([value] * num_rows, dtype=object)


# ---------------------------------------------------------- ship-raw contract
# Fields named in make_reader(device_decode_fields=...) skip host decode: their
# kernels pass the codec payload through in an uploadable form, plus small
# auxiliary columns with the per-cell metadata the device decode needs.

#: auxiliary column suffix: ``(n, 2)`` int32 pre-padding (height, width) of a
#: raw-shipped DCT field (``(0, 0)`` for null cells)
RAW_HW_SUFFIX = '__hw'
#: auxiliary column suffix: ``(n,)`` uint8 per-cell encoding of a raw-shipped
#: compressed-ndarray field (``RAW_ENC_*`` values)
RAW_ENC_SUFFIX = '__enc'

#: cell is a raw-deflate stream (inflate, then npy-unpack)
RAW_ENC_DEFLATE = 0
#: cell is stored ``.npy`` bytes (header + payload, no compression)
RAW_ENC_NPY = 1
#: cell is null (the frame entry is None)
RAW_ENC_NULL = 2


class ShipRawColumns:
    """Result of a ship-raw kernel: the payload column plus its auxiliary
    columns, merged into the batch under their own names."""

    __slots__ = ('columns',)

    def __init__(self, columns: Columns) -> None:
        self.columns = columns


def validate_device_field(field: Any) -> None:
    """Raise ``ValueError`` unless ``field`` can ship raw to the device
    (``DctImageCodec``, ``NdarrayCodec`` or ``CompressedNdarrayCodec``)."""
    if type(field.codec) in (DctImageCodec, NdarrayCodec, CompressedNdarrayCodec):
        return
    raise ValueError(
        'Field {!r} has codec {} which cannot ship raw to the device; '
        'device_decode_fields supports DctImageCodec, NdarrayCodec and '
        'CompressedNdarrayCodec'.format(
            field.name, type(field.codec).__name__ if field.codec is not None else None))


def _blob_view(blob: Any) -> np.ndarray:
    """One cell's bytes as a 1-D uint8 view."""
    if isinstance(blob, np.ndarray):
        return blob
    return np.frombuffer(blob, dtype=np.uint8)


def _ship_raw_dct_kernel(name: str) -> FieldKernel:
    """``DctImageCodec``: strip the ``DCT1`` header, pass the int16 coefficient
    blocks through (one slab when shapes are uniform, a list otherwise) and
    emit the pre-padding ``(h, w)`` as the ``__hw`` column."""
    magic = DctImageCodec._MAGIC

    def kernel(table: Any, partition_keys: Mapping[str, Any], num_rows: int) -> Any:
        blobs = _column_blobs(table.column(name))
        n = len(blobs)
        hw = np.zeros((n, 2), dtype=np.int32)
        header_cache: Dict[bytes, Any] = {}
        out: Optional[np.ndarray] = None
        cells: Optional[List[Any]] = None
        for i, blob in enumerate(blobs):
            arr: Optional[np.ndarray] = None
            if blob is not None:
                view = _blob_view(blob)
                if bytes(memoryview(view[:4])) != magic:
                    raise ValueError('field {!r} cell {} is not DCT-coded data'
                                     .format(name, i))
                head = bytes(memoryview(view[4:8]))
                hw[i, 0] = int.from_bytes(head[0:2], 'little')
                hw[i, 1] = int.from_bytes(head[2:4], 'little')
                payload = memoryview(view[8:])
                meta = _cached_npy_meta(payload, header_cache)
                if meta is None:
                    raise ValueError('field {!r} cell {} carries an unparseable '
                                     'coefficient payload'.format(name, i))
                shape, fortran, dtype, offset = meta
                if fortran or dtype.hasobject:
                    raise ValueError('field {!r} cell {} coefficient layout is '
                                     'not C-contiguous native'.format(name, i))
                count = int(np.prod(shape, dtype=np.int64))
                arr = np.frombuffer(payload, dtype=dtype, count=count,
                                    offset=offset).reshape(shape)
            if cells is None:
                if arr is not None:
                    if out is None and i == 0:
                        out = np.empty((n,) + arr.shape, dtype=arr.dtype)
                    if out is not None and arr.shape == out.shape[1:] \
                            and arr.dtype == out.dtype:
                        out[i] = arr
                        continue
                cells = [out[j] for j in range(i)] if out is not None else []
            cells.append(None if arr is None else arr.copy())
        column: Any = out if cells is None else cells
        return ShipRawColumns({name: column, name + RAW_HW_SUFFIX: hw})
    return kernel


def _ship_raw_npy_kernel(name: str) -> FieldKernel:
    """``NdarrayCodec``: the ``.npy`` blobs pass through byte for byte.
    Equal-length blobs with one shared header become a ``(n, blob_len)``
    uint8 matrix; anything else stays a list of 1-D uint8 arrays."""

    def kernel(table: Any, partition_keys: Mapping[str, Any], num_rows: int) -> Any:
        blobs = _column_blobs(table.column(name))
        n = len(blobs)
        views = [None if b is None else _blob_view(b) for b in blobs]
        lengths = {len(v) for v in views if v is not None}
        if n and not any(v is None for v in views) and len(lengths) == 1:
            matrix = np.empty((n, lengths.pop()), dtype=np.uint8)
            for i, view in enumerate(views):
                matrix[i] = view
            parsed = _cached_npy_meta(memoryview(matrix[0]), {})
            if parsed is not None:
                header_len = parsed[3]
                if (matrix[:, :header_len] == matrix[0, :header_len]).all():
                    return matrix
        return [None if v is None else v.copy() for v in views]
    return kernel


def _ship_raw_deflate_kernel(name: str) -> FieldKernel:
    """``CompressedNdarrayCodec``: each zip container is stripped to its raw
    member, a raw-deflate stream (enc 0) or stored ``.npy`` bytes (enc 1), with
    the per-cell encoding in the ``__enc`` column. Nothing inflates here."""

    def kernel(table: Any, partition_keys: Mapping[str, Any], num_rows: int) -> Any:
        blobs = _column_blobs(table.column(name))
        enc = np.full(len(blobs), RAW_ENC_NULL, dtype=np.uint8)
        frames: List[Any] = []
        for i, blob in enumerate(blobs):
            if blob is None:
                frames.append(None)
                continue
            parsed = _npz_raw_member(blob)
            if parsed is None:
                raise ValueError('field {!r} cell {} is not a '
                                 'savez_compressed container'.format(name, i))
            method, body = parsed
            enc[i] = RAW_ENC_NPY if method == 0 else RAW_ENC_DEFLATE
            frames.append(np.frombuffer(body, dtype=np.uint8).copy())
        return ShipRawColumns({name: frames, name + RAW_ENC_SUFFIX: enc})
    return kernel


def _ship_raw_kernel(name: str, field: Any) -> FieldKernel:
    validate_device_field(field)
    codec_type = type(field.codec)
    if codec_type is DctImageCodec:
        return _ship_raw_dct_kernel(name)
    if codec_type is NdarrayCodec:
        return _ship_raw_npy_kernel(name)
    return _ship_raw_deflate_kernel(name)


# -------------------------------------------------------------- decode plans

class DecodePlan:
    """An ordered list of whole-column kernels, one per output field, run once
    per rowgroup. Codec failures surface as :class:`DecodeFieldError` with the
    field name and fragment path."""

    __slots__ = ('_kernels', 'field_names')

    def __init__(self, kernels: List[Tuple[str, FieldKernel]]) -> None:
        self._kernels = kernels
        #: output field order, as compiled
        self.field_names = tuple(name for name, _ in kernels)

    def execute(self, table: Any, partition_keys: Optional[Mapping[str, Any]] = None,
                fragment_path: Optional[str] = None) -> Columns:
        """Run every kernel over ``table`` -> ``{name: ndarray-or-list}``.
        While the flight recorder is armed each field's kernel is one
        ``decode_field`` event on the timeline (two clock reads a field; no
        cost otherwise)."""
        partition_keys = partition_keys or {}
        columns: Columns = {}
        traced = _tracing.trace_enabled()
        for name, kernel in self._kernels:
            try:
                start = time.perf_counter() if traced else 0.0
                result = kernel(table, partition_keys, table.num_rows)
                if traced:
                    _tracing.trace_complete('decode_field', start,
                                            time.perf_counter() - start,
                                            args={'field': name})
            except Exception as exc:
                raise DecodeFieldError(
                    'Failed to decode field {!r} of fragment {!r}: {}'
                    .format(name, fragment_path, exc),
                    field_name=name, fragment_path=fragment_path) from exc
            if isinstance(result, ShipRawColumns):
                columns.update(result.columns)
            else:
                columns[name] = result
        return columns


def _codec_kernel(name: str, field: Any) -> FieldKernel:
    codec = field.codec

    def kernel(table: Any, partition_keys: Mapping[str, Any], num_rows: int) -> Any:
        decoded = codec.decode_arrow_column(field, table.column(name))
        if isinstance(decoded, np.ndarray):
            return decoded
        return stack_if_uniform(decoded, field)
    return kernel


def _shaped_pylist_kernel(name: str, field: Any) -> FieldKernel:
    dtype = field.numpy_dtype

    def kernel(table: Any, partition_keys: Mapping[str, Any], num_rows: int) -> Any:
        values = table.column(name).to_pylist()
        return stack_if_uniform(
            [None if v is None else np.asarray(v, dtype=dtype) for v in values], field)
    return kernel


def _native_kernel(name: str) -> FieldKernel:
    def kernel(table: Any, partition_keys: Mapping[str, Any], num_rows: int) -> Any:
        return arrow_to_numpy(table.column(name))
    return kernel


def _partition_kernel(name: str, field: Any) -> FieldKernel:
    def kernel(table: Any, partition_keys: Mapping[str, Any], num_rows: int) -> Any:
        return partition_column(field, partition_keys.get(name), num_rows)
    return kernel


def compile_decode_plan(schema: Any, field_names: Sequence[str],
                        partition_field_names: Any = (),
                        decode: bool = True,
                        device_decode_fields: Any = ()) -> DecodePlan:
    """The per-field kernel chain for one output field set: partition keys
    fill constants; ``device_decode_fields`` get ship-raw kernels; codec
    fields decode through their codec and codec-less tensor fields
    materialize and cast (both only when ``decode``: the batch reader emits
    stored values); everything else converts natively."""
    partition_names = set(partition_field_names)
    device_names = set(device_decode_fields)
    kernels: List[Tuple[str, FieldKernel]] = []
    for name in field_names:
        field = schema.fields.get(name)
        if name in partition_names:
            kernels.append((name, _partition_kernel(name, field)))
        elif name in device_names and field is not None:
            kernels.append((name, _ship_raw_kernel(name, field)))
        elif field is not None and field.codec is not None and decode:
            kernels.append((name, _codec_kernel(name, field)))
        elif field is not None and field.shape != () and decode:
            kernels.append((name, _shaped_pylist_kernel(name, field)))
        else:
            kernels.append((name, _native_kernel(name)))
    return DecodePlan(kernels)


# ----------------------------------------------- vectorized row-mode masks

def _vectorizable(predicate: PredicateBase) -> bool:
    """True when this EXACT predicate type (no subclasses — they may override
    ``do_include`` semantics) implements the whole-column array mode."""
    kind = type(predicate)
    if kind is in_negate:
        return _vectorizable(predicate.predicate)
    if kind is in_reduce:
        return (predicate.reduce_func in (all, any)
                and all(_vectorizable(p) for p in predicate.predicates))
    return kind in (in_set, in_intersection, in_pseudorandom_split)


def evaluate_predicate_mask(predicate: PredicateBase, columns: Columns,
                            num_rows: int) -> np.ndarray:
    """Row-mode predicate evaluation over decoded columns, without the per-row
    dict loop where possible: the built-in predicate classes evaluate in ONE
    vectorized ``do_include`` call over the whole columns; anything else
    (``in_lambda``, custom subclasses, ragged list columns) falls back to a
    zip-driven row loop that builds each row dict from pre-extracted columns."""
    if _vectorizable(predicate) and columns and all(
            isinstance(c, np.ndarray) and c.ndim >= 1 for c in columns.values()):
        mask = np.asarray(predicate.do_include(dict(columns)), dtype=bool)
        if mask.shape != (num_rows,):
            raise ValueError('Vectorized predicate returned mask of shape {}, '
                             'expected ({},)'.format(mask.shape, num_rows))
        return mask
    names = list(columns)
    cols = [columns[name] for name in names]
    mask = np.zeros(num_rows, dtype=bool)
    if not cols:
        # field-less predicate (e.g. in_lambda([], ...)): still one call per
        # row — the function may be stateful (row-independent sampling)
        for i in range(num_rows):
            mask[i] = bool(predicate.do_include({}))
        return mask
    for i, row_values in enumerate(zip(*cols)):
        mask[i] = bool(predicate.do_include(dict(zip(names, row_values))))
    return mask
