"""Field codecs: how a logical tensor/scalar field is stored inside a Parquet
column. A trimmed copy of ``petastorm_tpu.codecs`` with the same
``codec_name``s and byte formats, so stores written by either package read in
the other.

Kept: ``ScalarCodec``, ``NdarrayCodec``, ``CompressedNdarrayCodec``,
``CompressedImageCodec`` (OpenCV png/jpeg, ``cv2`` imported where an image is
encoded or decoded), ``DctImageCodec``, ``DctCoefficientsCodec`` and the JSON
codec registry. A schema naming any other codec fails to load with the codec
named.

``CompressedImageCodec`` decodes a column's images on a process-local pool of
decode threads (``cv2.imdecode`` releases the GIL): ``decode_thread_count()``
wide, ``PETASTORM_TPU_DECODE_THREADS`` when set (the autotuner's
``decode_threads`` knob turns it), else ``min(4, cpu_count)``.
"""

import os
import struct
import threading
import zipfile
import zlib
from io import BytesIO

import numpy as np
import pyarrow as pa


def decode_thread_count():
    """Decode fan-out width for GIL-releasing batched kernels:
    ``PETASTORM_TPU_DECODE_THREADS`` when set, else ``min(4, cpu_count)`` — 1
    disables the pool."""
    env = os.environ.get('PETASTORM_TPU_DECODE_THREADS')
    if env is not None:
        return max(1, int(env))
    return max(1, min(4, os.cpu_count() or 1))


#: below this many cells a thread fan-out costs more than it hides
_MIN_PARALLEL_CELLS = 16

_decode_pool_state = {'pool': None, 'threads': 0, 'pid': 0}
_decode_pool_lock = threading.Lock()


def _decode_pool(threads):
    """Process-local decode thread pool, rebuilt under a lock if the width knob
    or the pid changed; a superseded pool is shut down so its idle threads do
    not linger."""
    from concurrent.futures import ThreadPoolExecutor
    state = _decode_pool_state
    with _decode_pool_lock:
        if (state['pool'] is None or state['threads'] != threads
                or state['pid'] != os.getpid()):
            if state['pool'] is not None and state['pid'] == os.getpid():
                state['pool'].shutdown(wait=False)
            state['pool'] = ThreadPoolExecutor(
                max_workers=threads, thread_name_prefix='ptt-decode')
            state['threads'] = threads
            state['pid'] = os.getpid()
        return state['pool']


def _binary_chunk_blobs(chunk):
    """Zero-copy per-row ``uint8`` views into a binary chunk's data buffer, or
    None when the chunk is not binary-typed or contains nulls."""
    if chunk.null_count or len(chunk) == 0:
        return None
    if pa.types.is_large_binary(chunk.type):
        off_dtype = np.dtype(np.int64)
    elif pa.types.is_binary(chunk.type):
        off_dtype = np.dtype(np.int32)
    else:
        return None
    buffers = chunk.buffers()
    if buffers[1] is None or buffers[2] is None:
        return None
    offsets = np.frombuffer(buffers[1], dtype=off_dtype, count=len(chunk) + 1,
                            offset=chunk.offset * off_dtype.itemsize)
    data = np.frombuffer(buffers[2], dtype=np.uint8)
    bounds = offsets.tolist()
    return [data[lo:hi] for lo, hi in zip(bounds, bounds[1:])]


def _column_blobs(arrow_col):
    """Flatten a (Chunked)Array of binary blobs into one list of zero-copy views
    (``to_pylist`` bytes for null-bearing chunks)."""
    chunks = arrow_col.chunks if isinstance(arrow_col, pa.ChunkedArray) else [arrow_col]
    blobs = []
    for chunk in chunks:
        views = _binary_chunk_blobs(chunk)
        blobs.extend(chunk.to_pylist() if views is None else views)
    return blobs


def _is_compliant_shape(data_shape, field_shape):
    """True when ``data_shape`` matches ``field_shape``, None dims being wildcards."""
    if len(data_shape) != len(field_shape):
        return False
    return all(f is None or d == f for d, f in zip(data_shape, field_shape))


class FieldCodec(object):
    """Abstract codec: encodes one logical field value into its stored Parquet
    representation and back."""

    #: registry name used in JSON schema serialization
    codec_name = None

    def encode(self, unischema_field, value):
        raise NotImplementedError()

    def decode(self, unischema_field, value):
        raise NotImplementedError()

    def decode_column(self, unischema_field, values):
        """Decode a whole column of encoded cells (None cells pass through)."""
        return [None if v is None else self.decode(unischema_field, v) for v in values]

    def decode_arrow_column(self, unischema_field, arrow_col):
        """Decode straight from the Arrow column: a stacked ndarray or a
        per-cell list like :meth:`decode_column`."""
        return self.decode_column(unischema_field, arrow_col.to_pylist())

    def arrow_type(self, unischema_field):
        """Arrow storage type of the encoded column."""
        raise NotImplementedError()

    def to_config(self):
        """JSON-safe dict describing this codec; inverse of :func:`codec_from_config`."""
        return {'codec': self.codec_name}

    def __str__(self):
        return '{}()'.format(type(self).__name__)

    def __eq__(self, other):
        return isinstance(other, FieldCodec) and self.to_config() == other.to_config()

    def __ne__(self, other):
        return not self == other

    def __hash__(self):
        return hash(tuple(sorted(self.to_config().items(), key=lambda kv: kv[0])))


def _parse_npy_header(blob):
    """Parse a ``.npy`` blob's header. Returns (header_len, shape, fortran_order,
    dtype), or None for unknown format versions / malformed headers."""
    f = BytesIO(blob)
    try:
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        elif version == (2, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
        else:
            return None
    except (ValueError, SyntaxError):
        return None
    return f.tell(), shape, fortran, dtype


_NUMPY_TO_ARROW = {
    np.dtype('bool'): pa.bool_(),
    np.dtype('int8'): pa.int8(),
    np.dtype('uint8'): pa.uint8(),
    np.dtype('int16'): pa.int16(),
    np.dtype('uint16'): pa.uint16(),
    np.dtype('int32'): pa.int32(),
    np.dtype('uint32'): pa.uint32(),
    np.dtype('int64'): pa.int64(),
    np.dtype('uint64'): pa.uint64(),
    np.dtype('float16'): pa.float16(),
    np.dtype('float32'): pa.float32(),
    np.dtype('float64'): pa.float64(),
}


def arrow_type_for_numpy(numpy_dtype):
    """Arrow type for a numpy dtype, including strings and datetimes."""
    dtype = np.dtype(numpy_dtype)
    if dtype in _NUMPY_TO_ARROW:
        return _NUMPY_TO_ARROW[dtype]
    if dtype.kind == 'S':
        return pa.binary()
    if dtype.kind == 'U' or dtype == np.dtype(object):
        return pa.string()
    if dtype.kind == 'M':
        return pa.timestamp('ns')
    raise ValueError('No Arrow mapping for numpy dtype {}'.format(dtype))


_PARSEABLE_ARROW_TYPES = {
    'bool': pa.bool_(), 'int8': pa.int8(), 'uint8': pa.uint8(), 'int16': pa.int16(),
    'uint16': pa.uint16(), 'int32': pa.int32(), 'uint32': pa.uint32(),
    'int64': pa.int64(), 'uint64': pa.uint64(), 'halffloat': pa.float16(),
    'float': pa.float32(), 'double': pa.float64(), 'string': pa.string(),
    'binary': pa.binary(), 'large_string': pa.large_string(),
    'timestamp[ns]': pa.timestamp('ns'), 'timestamp[us]': pa.timestamp('us'),
    'date32[day]': pa.date32(),
}


def _parse_arrow_type(type_str):
    """Parse ``str(pa.DataType)`` back into a DataType for the types ScalarCodec emits."""
    if type_str in _PARSEABLE_ARROW_TYPES:
        return _PARSEABLE_ARROW_TYPES[type_str]
    if type_str.startswith('decimal128'):
        inner = type_str[type_str.index('(') + 1:type_str.index(')')]
        precision, scale = (int(x) for x in inner.split(','))
        return pa.decimal128(precision, scale)
    raise ValueError('Cannot parse Arrow type {!r}'.format(type_str))


class ScalarCodec(FieldCodec):
    """Stores a scalar field as a native Parquet column of ``arrow_dtype``
    (default: the field's own numpy dtype)."""

    codec_name = 'scalar'

    def __init__(self, arrow_dtype=None):
        if arrow_dtype is None or isinstance(arrow_dtype, pa.DataType):
            self._arrow_dtype = arrow_dtype
        else:
            self._arrow_dtype = arrow_type_for_numpy(arrow_dtype)
        if self._arrow_dtype is not None:
            # fail at write time: the JSON schema store round-trips str(type)
            _parse_arrow_type(str(self._arrow_dtype))

    def encode(self, unischema_field, value):
        if isinstance(value, np.ndarray) and value.ndim > 0:
            raise TypeError('Expected a scalar value for field {}, got array of shape {}'
                            .format(unischema_field.name, value.shape))
        if isinstance(value, np.generic):
            return value.item()
        return value

    def decode(self, unischema_field, value):
        dtype = unischema_field.numpy_dtype
        if np.dtype(dtype).kind in ('U', 'S', 'O'):
            return value
        return np.dtype(dtype).type(value)

    def decode_arrow_column(self, unischema_field, arrow_col):
        """Numeric/bool/datetime columns convert through Arrow's ``to_numpy``
        in one shot."""
        dtype = np.dtype(unischema_field.numpy_dtype)
        if dtype.kind in ('U', 'S', 'O', 'M') or arrow_col.null_count:
            return self.decode_column(unischema_field, arrow_col.to_pylist())
        return arrow_col.to_numpy(zero_copy_only=False).astype(dtype, copy=False)

    def arrow_type(self, unischema_field):
        if self._arrow_dtype is not None:
            return self._arrow_dtype
        return arrow_type_for_numpy(unischema_field.numpy_dtype)

    def to_config(self):
        config = {'codec': self.codec_name}
        if self._arrow_dtype is not None:
            config['arrow_dtype'] = str(self._arrow_dtype)
        return config

    @classmethod
    def from_config(cls, config):
        arrow_dtype = config.get('arrow_dtype')
        if arrow_dtype is not None:
            arrow_dtype = _parse_arrow_type(arrow_dtype)
        return cls(arrow_dtype)


def _ndarray_to_npy_bytes(value):
    memfile = BytesIO()
    np.save(memfile, value)
    return memfile.getvalue()


def _npy_bytes_to_ndarray(blob):
    return np.ascontiguousarray(np.load(BytesIO(bytes(blob)), allow_pickle=False))


def _check_value(unischema_field, value):
    expected = np.dtype(unischema_field.numpy_dtype)
    if value.dtype != expected:
        raise ValueError('Unexpected dtype {} for field {} (expected {})'
                         .format(value.dtype, unischema_field.name, expected))
    if not _is_compliant_shape(value.shape, unischema_field.shape):
        raise ValueError('Unexpected shape {} for field {} (expected {})'
                         .format(value.shape, unischema_field.name, unischema_field.shape))


def _cached_npy_meta(payload, cache):
    """``(shape, fortran, dtype, offset)`` of an npy blob, memoized by header
    prefix (the npy header is 64-byte aligned, so ``payload[:64]`` is an O(1)
    dict key, with full-prefix equality confirmed inside the bucket). None for
    unparseable headers."""
    probe = bytes(payload[:64])
    for prefix, meta in cache.get(probe, ()):
        if payload[:len(prefix)] == prefix:
            return meta
    parsed = _parse_npy_header(bytes(payload))
    if parsed is None:
        return None
    offset, shape, fortran, dtype = parsed
    meta = (shape, fortran, dtype, offset)
    if len(cache) < 1024:
        cache.setdefault(probe, []).append((bytes(payload[:offset]), meta))
    return meta


class NdarrayCodec(FieldCodec):
    """Stores a numpy tensor as an uncompressed ``.npy`` byte blob."""

    codec_name = 'ndarray'

    def encode(self, unischema_field, value):
        _check_value(unischema_field, value)
        return _ndarray_to_npy_bytes(value)

    def decode(self, unischema_field, value):
        return _npy_bytes_to_ndarray(value)

    def decode_column(self, unischema_field, values):
        """Blobs of one dtype/shape share a header: parse it once, then
        ``np.frombuffer`` the rest."""
        header_cache = {}
        out = []
        for blob in values:
            if blob is None:
                out.append(None)
                continue
            view = memoryview(blob)
            meta = _cached_npy_meta(view, header_cache)
            if meta is None or meta[1] or meta[2].hasobject:
                out.append(self.decode(unischema_field, blob))
                continue
            shape, _, dtype, offset = meta
            out.append(np.frombuffer(view, dtype=dtype, offset=offset)
                       .reshape(shape).copy())
        return out

    def decode_arrow_column(self, unischema_field, arrow_col):
        return self.decode_column(unischema_field, _column_blobs(arrow_col))

    def arrow_type(self, unischema_field):
        return pa.binary()


def _npz_raw_member(blob):
    """Parse the single-member zip container of a ``np.savez_compressed`` blob
    WITHOUT inflating: returns ``(method, body)`` where ``method`` is the zip
    compression method (8 = deflate: ``body`` is the raw-deflate stream; 0 =
    stored: ``body`` is the member's ``.npy`` bytes). None for any unexpected
    container layout."""
    head = bytes(memoryview(blob)[:30])
    if len(head) < 30 or head[:4] != b'PK\x03\x04':
        return None
    flags = int.from_bytes(head[6:8], 'little')
    method = int.from_bytes(head[8:10], 'little')
    name_len = int.from_bytes(head[26:28], 'little')
    extra_len = int.from_bytes(head[28:30], 'little')
    body = memoryview(blob)[30 + name_len + extra_len:]
    if method == 8:
        if flags & 0x08:
            # sizes only in the trailing data descriptor: the deflate stream
            # is self-delimiting, so its consumer stops at BFINAL
            return 8, body
        size = int.from_bytes(head[18:22], 'little')
        return 8, body[:size]
    if method == 0 and not flags & 0x08:
        size = int.from_bytes(head[18:22], 'little')
        return 0, body[:size]
    return None


def _npz_npy_payload(blob):
    """The raw ``.npy`` member bytes of a ``np.savez_compressed`` container
    (deflate bodies inflate in one raw ``zlib`` call), or None for any
    unexpected layout."""
    parsed = _npz_raw_member(blob)
    if parsed is None:
        return None
    method, body = parsed
    if method == 8:
        try:
            return zlib.decompressobj(-15).decompress(body)
        except zlib.error:
            return None
    return bytes(body)


class CompressedNdarrayCodec(FieldCodec):
    """Stores a numpy tensor as a one-member deflate zip (``np.savez_compressed``
    layout: member ``arr.npy``).

    :param stored: write-side only. False (default) encodes through
        ``np.savez_compressed`` exactly like ``petastorm_tpu``. True writes the
        member at zlib level 0, an all-stored deflate stream: the form the
        device decode tail inflates on the card (zlib's default level turns
        even random float payloads into Huffman blocks, which inflate on the
        host). Both forms decode with the same reader, so the flag is not part
        of the stored schema."""

    codec_name = 'compressed_ndarray'

    def __init__(self, stored=False):
        self._stored = stored

    def encode(self, unischema_field, value):
        _check_value(unischema_field, value)
        memfile = BytesIO()
        if self._stored:
            with zipfile.ZipFile(memfile, 'w', zipfile.ZIP_DEFLATED,
                                 compresslevel=0) as archive:
                archive.writestr('arr.npy', _ndarray_to_npy_bytes(value))
        else:
            np.savez_compressed(memfile, arr=value)
        return memfile.getvalue()

    def decode(self, unischema_field, value):
        payload = _npz_npy_payload(value)
        if payload is not None:
            return _npy_bytes_to_ndarray(payload)
        with np.load(BytesIO(bytes(value)), allow_pickle=False) as data:
            return np.ascontiguousarray(data['arr'])

    def decode_arrow_column(self, unischema_field, arrow_col):
        return self.decode_column(unischema_field, _column_blobs(arrow_col))

    def arrow_type(self, unischema_field):
        return pa.binary()


class CompressedImageCodec(FieldCodec):
    """png or jpeg image compression through OpenCV. A 3-channel image is
    stored in OpenCV's BGR channel order and comes back as RGB, so the stored
    bytes are those the reference petastorm and ``petastorm_tpu`` write."""

    codec_name = 'compressed_image'

    def __init__(self, image_codec='png', quality=80):
        if image_codec not in ('png', 'jpeg'):
            raise ValueError('image_codec must be "png" or "jpeg", got {!r}'
                             .format(image_codec))
        self._image_codec = '.' + image_codec
        self._quality = int(quality)

    @property
    def image_codec(self):
        return self._image_codec[1:]

    @property
    def quality(self):
        return self._quality

    def encode(self, unischema_field, value):
        import cv2
        expected = np.dtype(unischema_field.numpy_dtype)
        if value.dtype != expected:
            raise ValueError('Unexpected dtype {} for field {} (expected {})'
                             .format(value.dtype, unischema_field.name, expected))
        if not _is_compliant_shape(value.shape, unischema_field.shape):
            raise ValueError('Unexpected shape {} for field {} (expected {})'
                             .format(value.shape, unischema_field.name,
                                     unischema_field.shape))
        if self._image_codec == '.jpeg' and value.dtype != np.uint8:
            raise ValueError('jpeg compression supports only uint8 images '
                             '(field {})'.format(unischema_field.name))
        image_bgr = value
        if value.ndim == 3 and value.shape[2] == 3:
            image_bgr = cv2.cvtColor(value, cv2.COLOR_RGB2BGR)
        params = [cv2.IMWRITE_JPEG_QUALITY, self._quality] \
            if self._image_codec == '.jpeg' else []
        success, buf = cv2.imencode(self._image_codec, image_bgr, params)
        if not success:
            raise RuntimeError('cv2.imencode failed for field {}'
                               .format(unischema_field.name))
        return buf.tobytes()

    def decode(self, unischema_field, value):
        import cv2
        buf = value if isinstance(value, np.ndarray) else np.frombuffer(value, np.uint8)
        image = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
        if image is None:
            raise ValueError('cv2.imdecode failed for field {}'.format(unischema_field.name))
        if image.ndim == 3 and image.shape[2] == 3:
            image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
        return np.ascontiguousarray(image.astype(unischema_field.numpy_dtype, copy=False))

    def decode_arrow_column(self, unischema_field, arrow_col):
        """One ``cv2.imdecode`` a cell over zero-copy blob views, fanned
        across the decode threads for a column of at least
        ``_MIN_PARALLEL_CELLS`` cells."""
        blobs = _column_blobs(arrow_col)

        def decode_one(blob):
            return None if blob is None else self.decode(unischema_field, blob)

        threads = decode_thread_count()
        if threads > 1 and len(blobs) >= _MIN_PARALLEL_CELLS:
            return list(_decode_pool(threads).map(decode_one, blobs))
        return [decode_one(blob) for blob in blobs]

    def arrow_type(self, unischema_field):
        return pa.binary()

    def to_config(self):
        return {'codec': self.codec_name, 'image_codec': self.image_codec,
                'quality': self._quality}

    @classmethod
    def from_config(cls, config):
        return cls(image_codec=config['image_codec'], quality=config['quality'])

    def __str__(self):
        return 'CompressedImageCodec({!r}, quality={})'.format(self.image_codec,
                                                              self._quality)


class DctImageCodec(FieldCodec):
    """JPEG-style DCT-domain image storage: quantized 8x8 DCT coefficient blocks
    (int16) behind a ``DCT1`` + ``<HH`` (height, width) header. ``decode`` runs
    the numpy IDCT (:func:`~petastorm_tpu_torch.ops.image_decode.dct_decode_image`);
    the device decode tail ships the coefficients raw and runs the IDCT on the
    card instead."""

    codec_name = 'dct_image'
    _MAGIC = b'DCT1'

    def __init__(self, quality=75):
        self._quality = int(quality)

    @property
    def quality(self):
        return self._quality

    def encode(self, unischema_field, value):
        from petastorm_tpu_torch.ops.image_decode import dct_encode_image
        expected = np.dtype(unischema_field.numpy_dtype)
        if value.dtype != expected or expected != np.uint8:
            raise ValueError('DctImageCodec requires uint8 images (field {}, got {})'
                             .format(unischema_field.name, value.dtype))
        if not _is_compliant_shape(value.shape, unischema_field.shape):
            raise ValueError('Unexpected shape {} for field {} (expected {})'
                             .format(value.shape, unischema_field.name,
                                     unischema_field.shape))
        coeffs = dct_encode_image(value, quality=self._quality)
        header = self._MAGIC + struct.pack('<HH', value.shape[0], value.shape[1])
        return header + _ndarray_to_npy_bytes(coeffs)

    def _split(self, unischema_field, value):
        value = bytes(value)
        if value[:4] != self._MAGIC:
            raise ValueError('Field {} is not DCT-coded data'.format(unischema_field.name))
        h, w = struct.unpack('<HH', value[4:8])
        return (h, w), value[8:]

    def decode(self, unischema_field, value):
        from petastorm_tpu_torch.ops.image_decode import dct_decode_image
        (h, w), npy = self._split(unischema_field, value)
        return dct_decode_image(_npy_bytes_to_ndarray(npy), quality=self._quality,
                                orig_hw=(h, w))

    def arrow_type(self, unischema_field):
        return pa.binary()

    def to_config(self):
        return {'codec': self.codec_name, 'quality': self._quality}

    @classmethod
    def from_config(cls, config):
        return cls(quality=config['quality'])

    def __str__(self):
        return 'DctImageCodec(quality={})'.format(self._quality)


class DctCoefficientsCodec(DctImageCodec):
    """Read-side reinterpretation of a :class:`DctImageCodec` field: decodes
    only to the raw int16 coefficient blocks ``[H/8, W/8, 8, 8, C]``."""

    codec_name = 'dct_coefficients'

    def decode(self, unischema_field, value):
        _, npy = self._split(unischema_field, value)
        return _npy_bytes_to_ndarray(npy)


_CODEC_REGISTRY = {
    ScalarCodec.codec_name: ScalarCodec,
    NdarrayCodec.codec_name: NdarrayCodec,
    CompressedNdarrayCodec.codec_name: CompressedNdarrayCodec,
    CompressedImageCodec.codec_name: CompressedImageCodec,
    DctImageCodec.codec_name: DctImageCodec,
    DctCoefficientsCodec.codec_name: DctCoefficientsCodec,
}


def codec_from_config(config):
    """Reconstruct a codec from its ``to_config()`` dict (the JSON schema store)."""
    name = config['codec']
    if name not in _CODEC_REGISTRY:
        raise ValueError('Unknown codec {!r} (this package reads {})'
                         .format(name, sorted(_CODEC_REGISTRY)))
    cls = _CODEC_REGISTRY[name]
    if hasattr(cls, 'from_config'):
        return cls.from_config(config)
    return cls()
