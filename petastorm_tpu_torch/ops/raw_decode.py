"""Raw-payload decode for the device decode tail.

When a reader ships codec payloads raw (``make_reader(device_decode_fields=...)``)
the loader uploads packed or compressed bytes and finishes decode on the card:

- **npy-unpack** (:func:`bitcast_rows`, :func:`unpack_npy_rows`): a packed
  ``(n, stride)`` uint8 matrix of equal-layout ``.npy`` payloads becomes a typed
  ``(n,) + shape`` tensor through a slice and ``Tensor.view(dtype)``. 8-byte
  integers stay 64-bit: ``petastorm_tpu`` keeps only their low 32-bit word under
  JAX's default x32 mode, so the two packages agree on such fields only where
  the values fit in 32 bits. ``float64`` payloads are plain views here, where
  JAX under x32 refuses them.
- **stored inflate** (:func:`parse_stored_deflate_layout`,
  :func:`plan_stored_batch`, :func:`stored_inflate`): a raw-deflate stream whose
  blocks are all *stored* (BTYPE=00, what zlib level 0 emits) is a list of
  framed byte ranges. The host parses the 5-byte block headers into a segment
  table of one ``(src_offset, dst_offset, length)`` row per stored block, and
  kernel K1 performs the gather-copy on the card. Huffman-coded streams return
  None from the parser and inflate on the host. The planner may skip each
  frame's leading inflated bytes (the ``.npy`` header), so the table writes
  the payloads straight into a dense ``(n, row_bytes)`` matrix and the unpack
  that follows is a :func:`bitcast_rows` view.

Kernel K1 (``csrc/stored_copy.cu``) replaces the Pallas kernel
``_stored_copy_kernel`` of ``petastorm_tpu/ops/raw_decode.py``. The TPU kernel
walks a table of rows of at most 1024 bytes as a sequential grid, with a
read-modify-write of a fixed 1024-byte VMEM window and a zero-fill by its
first step. The port's planner keeps one row per stored block (up to 65535
bytes), and K1 tiles the output instead of the table: each thread owns 16-byte
output words, finds the row that covers each word by a binary search over the
sorted destination offsets, and writes every output byte exactly once, zero
where no row writes. The port's planner therefore differs from the JAX
package's (rows are whole blocks, and the header skip), while both tables map
the same source bytes to the same inflated bytes.

:func:`stored_inflate_plain` is the plain PyTorch version of K1: the CPU tests
and the CPU path use it (the wrapper takes it only for tensors on the CPU),
and ``chip_smoke.py`` holds the kernel against it on the card. Nothing on the
CUDA path calls it.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

_TORCH_DTYPES = {
    np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16, np.dtype(np.uint16): torch.uint16,
    np.dtype(np.int32): torch.int32, np.dtype(np.uint32): torch.uint32,
    np.dtype(np.int64): torch.int64, np.dtype(np.uint64): torch.uint64,
    np.dtype(np.float16): torch.float16, np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64, np.dtype(np.bool_): torch.bool,
}


def torch_dtype(numpy_dtype: Any) -> torch.dtype:
    """The torch dtype of a little-endian or byte-order-free numpy dtype."""
    dtype = np.dtype(numpy_dtype)
    if dtype.byteorder == '>':
        raise ValueError('big-endian dtype {} has no torch view'.format(dtype))
    try:
        return _TORCH_DTYPES[dtype.newbyteorder('=')]
    except KeyError:
        raise ValueError('dtype {} has no torch counterpart'.format(dtype)) from None


# ------------------------------------------------------------------ npy unpack

def bitcast_rows(buf: torch.Tensor, dtype_str: str,
                 row_shape: Tuple[int, ...]) -> torch.Tensor:
    """Reinterpret a ``(n, stride)`` uint8 byte matrix as a typed
    ``(n,) + row_shape`` tensor on its own device. Bool payloads become
    ``buf != 0``, like ``petastorm_tpu``'s unpack."""
    dtype = np.dtype(dtype_str)
    n = buf.shape[0]
    if dtype == np.bool_:
        arr = buf != 0
    else:
        itemsize = dtype.itemsize
        viewable = (buf.stride(-1) == 1 and buf.storage_offset() % itemsize == 0
                    and all(s % itemsize == 0 for s in buf.stride()[:-1]))
        arr = (buf if viewable else buf.contiguous()).view(torch_dtype(dtype))
    return arr.reshape((n,) + tuple(row_shape))


def unpack_npy_rows(packed: torch.Tensor, header_len: int, dtype_str: str,
                    row_shape: Tuple[int, ...]) -> torch.Tensor:
    """``(n, blob_len)`` uint8 matrix of equal-header ``.npy`` blobs -> typed
    ``(n,) + row_shape`` tensor: drop the shared header, then
    :func:`bitcast_rows`."""
    return bitcast_rows(packed[:, header_len:], dtype_str, row_shape)


# -------------------------------------------------------------- stored inflate

def parse_stored_deflate_layout(frame: Any) -> Optional[List[Tuple[int, int]]]:
    """Scan one raw-deflate stream; if EVERY block is stored (BTYPE=00), return
    its payload segments as ``[(src_offset, length), ...]``; else None.

    Stored blocks are byte-aligned (the 3 header bits are followed by a pad to
    the next byte boundary, then LEN/NLEN and LEN literal bytes), so an
    all-stored stream is fully described by byte offsets. The block headers
    are read through a memoryview of the frame, which is never copied.
    Malformed streams (truncation, LEN/NLEN mismatch) also return None; the
    caller keeps the host zlib path, which raises its own precise error."""
    buf = memoryview(frame).cast('B')
    size = len(buf)
    pos = 0
    segments: List[Tuple[int, int]] = []
    while True:
        if pos >= size:
            return None  # truncated before a final block
        header = buf[pos]
        if (header >> 1) & 0x3 != 0:
            return None  # Huffman-coded block: host inflate territory
        if pos + 5 > size:
            return None
        length = buf[pos + 1] | buf[pos + 2] << 8
        nlen = buf[pos + 3] | buf[pos + 4] << 8
        if length ^ 0xFFFF != nlen or pos + 5 + length > size:
            return None
        if length:
            segments.append((pos + 5, length))
        pos += 5 + length
        if header & 0x1:
            return segments


def plan_stored_batch(frames: List[Any], skip: Optional[Sequence[int]] = None
                      ) -> Optional[Tuple[np.ndarray, List[int]]]:
    """Build the device copy plan for a batch of raw-deflate frames that are
    ALL stored-block-only.

    :param frames: the raw-deflate streams (buffers; read, never copied).
    :param skip: optional per-frame count of leading inflated bytes to leave
        out (the ``.npy`` header): a stored block inside the skip yields no
        row, and one that spans its end is clipped.
    :returns: ``(segments, frame_lengths)``, where ``segments`` is an
        ``(m, 3)`` int32 table of ``(src_offset, dst_offset, length)``, one
        row per stored block (up to 65535 bytes), sorted by ``dst_offset``
        with no two destination ranges overlapping; ``src_offset`` indexes the
        CONCATENATION of the frames and ``dst_offset`` the concatenation of
        their inflated payloads after the skip. ``frame_lengths`` holds the
        bytes each frame writes (its inflated size less its skip). Callers
        needing a dense ``(n, len)`` view must check they are uniform: a
        total divisible by ``n`` does not imply that. None when any frame
        contains a non-stored block: callers inflate on the host."""
    rows: List[int] = []
    frame_lengths: List[int] = []
    src_base = 0
    dst_base = 0
    for index, frame in enumerate(frames):
        layout = parse_stored_deflate_layout(frame)
        if layout is None:
            return None
        todo = int(skip[index]) if skip is not None else 0
        frame_len = 0
        for src_off, length in layout:
            if todo >= length:
                todo -= length
                continue
            rows += (src_base + src_off + todo, dst_base + frame_len, length - todo)
            frame_len += length - todo
            todo = 0
        frame_lengths.append(frame_len)
        dst_base += frame_len
        src_base += memoryview(frame).nbytes
    return np.array(rows, dtype=np.int32).reshape(-1, 3), frame_lengths


def check_stored_plan(segments: np.ndarray, src_len: int, out_len: int) -> None:
    """Raise unless the host segment table is one K1 may take: every row lies
    inside a source of ``src_len`` bytes and an output of ``out_len`` bytes,
    and the rows are sorted by destination offset with no two destination
    ranges overlapping (K1 finds the row of an output byte by a binary
    search over the destination offsets)."""
    if segments.ndim != 2 or segments.shape[1] != 3:
        raise ValueError('segment table must be (m, 3), got {}'.format(segments.shape))
    if not len(segments):
        return
    # few numpy calls: the check runs on every batch
    if segments.min() < 0:
        raise ValueError('segment table holds negative offsets or lengths')
    src_off, dst_off, length = segments.astype(np.int64).T
    dst_end = dst_off + length
    if (dst_end[:-1] > dst_off[1:]).any():
        raise ValueError('segment table rows are not sorted by destination offset '
                         'or their destination ranges overlap')
    # sorted and disjoint, so the last row ends last in the output
    if (src_off + length).max() > src_len or dst_end[-1] > out_len:
        raise ValueError('segment table reaches past the source ({} bytes) or the '
                         'output ({} bytes)'.format(src_len, out_len))


def stored_inflate_plain(packed_src: torch.Tensor, segments: Any,
                         out_len: int) -> torch.Tensor:
    """Plain PyTorch version of K1 on any device: expand the segment table into
    per-byte source and destination indices and ``index_put`` the bytes into
    a zeroed output. Trusts the table: :func:`stored_inflate` checks it."""
    device = packed_src.device
    out = torch.zeros(out_len, dtype=torch.uint8, device=device)
    segs = torch.as_tensor(segments).to(device=device, dtype=torch.int64)
    if not len(segs) or out_len == 0:
        return out
    lengths = segs[:, 2]
    starts = torch.cumsum(lengths, 0) - lengths
    total = int(lengths.sum())
    within = torch.arange(total, device=device) - torch.repeat_interleave(starts, lengths)
    src_idx = torch.repeat_interleave(segs[:, 0], lengths) + within
    dst_idx = torch.repeat_interleave(segs[:, 1], lengths) + within
    out.index_put_((dst_idx,), packed_src[src_idx])
    return out


def stored_inflate(packed_src: torch.Tensor, segments: np.ndarray, out_len: int,
                   device_segments: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inflate a stored-block-only deflate batch on the source's device.

    :param packed_src: uint8 ``(s,)`` tensor, the concatenated raw frames.
    :param segments: the host int32 ``(m, 3)`` numpy table from
        :func:`plan_stored_batch`. It is checked with :func:`check_stored_plan`
        against ``s`` and ``out_len`` before anything runs: K1 trusts the
        rows it is given.
    :param out_len: total inflated length.
    :param device_segments: optional copy of ``segments`` already on the
        source's device (the loader uploads it with the batch), int32
        ``(m, 3)`` and contiguous. Without it the table is uploaded here, on
        the current stream, from pinned memory.
    :returns: uint8 ``(out_len,)`` tensor of the inflated payloads, zero
        where no row writes.

    On a CUDA tensor this launches K1 once on the current stream, which
    writes every output byte, so the output needs no zero-fill; each launch
    made outside a CUDA graph capture is counted in
    ``stored_inflate.launches``, and a build or launch failure
    raises. On a CPU tensor it runs :func:`stored_inflate_plain`. Any other
    device raises."""
    device = packed_src.device
    if device.type not in ('cuda', 'cpu'):
        raise ValueError('stored_inflate runs on cuda or cpu tensors, got {}'.format(device))
    if packed_src.dtype != torch.uint8 or packed_src.dim() != 1:
        raise ValueError('packed_src must be a 1-D uint8 tensor')
    if not isinstance(segments, np.ndarray) or segments.dtype != np.int32:
        raise ValueError('segments must be the host int32 numpy table of plan_stored_batch')
    check_stored_plan(segments, int(packed_src.numel()), out_len)
    if device_segments is not None and (
            device_segments.device != device or device_segments.dtype != torch.int32
            or tuple(device_segments.shape) != segments.shape
            or not device_segments.is_contiguous()):
        raise ValueError('device_segments must be a contiguous int32 {} tensor on {}'
                         .format(segments.shape, device))
    if device.type == 'cpu':
        return stored_inflate_plain(packed_src, segments, out_len)
    if not packed_src.is_contiguous():
        raise ValueError('stored_inflate needs a contiguous packed_src')
    out = torch.empty(out_len, dtype=torch.uint8, device=device)
    if out_len == 0:
        return out
    m = int(segments.shape[0])
    segs = device_segments
    if segs is None and m:
        # a pinned copy lets the upload run on the stream; the caching host
        # allocator keeps it alive until the copy has completed
        segs = torch.from_numpy(np.ascontiguousarray(segments)).pin_memory().to(
            device, non_blocking=True)
    from petastorm_tpu_torch import cuda_build
    kernel = cuda_build.load('stored_copy')
    # the launch goes to the current device: switch to the tensors' device
    with torch.cuda.device(device):
        status = kernel(packed_src.data_ptr(), segs.data_ptr() if m else None, m,
                        out.data_ptr(), out_len, torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError('stored_copy kernel launch failed: cudaError {}'.format(status))
    if not torch.cuda.is_current_stream_capturing():
        stored_inflate.launches += 1   # a captured call only records the launch
    return out


#: launches of K1 since the count was last set to 0
stored_inflate.launches = 0
