"""Parity of the port's raw-payload decode (petastorm_tpu_torch.ops.raw_decode)
with petastorm_tpu.ops.raw_decode: the stored-deflate planner (one row per
stored block, with an optional per-frame header skip, against the JAX
package's 1024-byte chunks), the plain version of kernel K1 against the
Pallas stored_inflate (interpret mode on the CPU), and the npy bitcast
unpack."""

import zlib

import numpy as np
import pytest
import torch

from petastorm_tpu.ops import raw_decode as jax_raw
from petastorm_tpu_torch.ops import raw_decode

FRAME_SIZES = (3000, 70000, 1, 0, 1024)


def _stored_frames(sizes, seed=0):
    rng = np.random.RandomState(seed)
    payloads = [rng.randint(0, 256, n, dtype=np.uint8).tobytes() for n in sizes]
    frames = []
    for payload in payloads:
        comp = zlib.compressobj(0, zlib.DEFLATED, -15)
        frames.append(comp.compress(payload) + comp.flush())
    return payloads, frames


def _byte_map(segs):
    """A segment table expanded to its per-byte ``(src, dst)`` pairs, in
    destination order."""
    pairs = [(src + i, dst + i) for src, dst, length in segs.tolist() for i in range(length)]
    return np.array(sorted(pairs, key=lambda pair: pair[1]), dtype=np.int64).reshape(-1, 2)


def test_plan_stored_batch_identical_to_jax():
    """The port's table (one row per stored block) maps the same source bytes
    to the same destination bytes as the JAX package's 1024-byte chunks."""
    _, frames = _stored_frames(FRAME_SIZES)
    segs, lengths = raw_decode.plan_stored_batch(frames)
    jax_segs, jax_lengths = jax_raw.plan_stored_batch(frames)
    assert segs.dtype == jax_segs.dtype == np.int32
    np.testing.assert_array_equal(_byte_map(segs), _byte_map(jax_segs))
    assert lengths == jax_lengths == list(FRAME_SIZES)
    # one row per stored block: the 70000-byte frame is two blocks
    assert len(segs) == 5 and (segs[:, 2] <= 65535).all()
    assert (np.diff(segs[:, 1]) > 0).all()
    huffman = zlib.compressobj(6, zlib.DEFLATED, -15)
    mixed = frames + [huffman.compress(b'a' * 1000) + huffman.flush()]
    assert raw_decode.plan_stored_batch(mixed) is None
    assert jax_raw.plan_stored_batch(mixed) is None


def test_plain_stored_inflate_bit_exact_against_pallas():
    """The plain K1 on the port's table equals the Pallas kernel (interpret
    mode) on the JAX package's table byte for byte, on frames of 3000, 70000
    (several stored blocks), 1, 0 and 1024 bytes. Each package's kernel takes
    its own planner's table: the Pallas kernel's 1024-byte window cannot take
    the port's whole-block rows."""
    payloads, frames = _stored_frames(FRAME_SIZES)
    segs, lengths = raw_decode.plan_stored_batch(frames)
    jax_segs, _ = jax_raw.plan_stored_batch(frames)
    packed = np.frombuffer(b''.join(frames), dtype=np.uint8)
    out_len = sum(lengths)
    want = np.asarray(jax_raw.stored_inflate(packed, jax_segs, out_len))
    got = raw_decode.stored_inflate(torch.from_numpy(packed.copy()), segs, out_len)
    assert got.dtype == torch.uint8 and got.shape == (out_len,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numpy().tobytes() == b''.join(payloads)
    assert raw_decode.stored_inflate.launches == 0  # the CPU path launches nothing


def test_stored_inflate_plain_zero_fills_uncovered_output():
    src = torch.arange(10, dtype=torch.uint8)
    segs = np.array([[2, 5, 3]], dtype=np.int32)
    out = raw_decode.stored_inflate(src, segs, 10)
    assert out.tolist() == [0, 0, 0, 0, 0, 2, 3, 4, 0, 0]


def test_header_skipping_plan_matches_jax_with_headers_sliced_off():
    """With a per-frame skip the table writes each frame's bytes after its
    first ``skip`` straight to a dense matrix: equal to JAX's stored_inflate
    output with each frame's leading bytes sliced off. The skips cut inside a
    block, at a block's edge (65531, where the 70000-byte frame's first block
    ends) and past a whole block."""
    sizes = (3000, 70000, 70000, 200)
    skips = [128, 65531, 65600, 0]
    payloads, frames = _stored_frames(sizes, seed=3)
    segs, lengths = raw_decode.plan_stored_batch(frames, skip=skips)
    assert lengths == [size - skip for size, skip in zip(sizes, skips)]
    packed = np.frombuffer(b''.join(frames), dtype=np.uint8)
    jax_segs, jax_lengths = jax_raw.plan_stored_batch(frames)
    full = np.asarray(jax_raw.stored_inflate(packed, jax_segs, sum(jax_lengths)))
    starts = np.cumsum([0] + jax_lengths[:-1])
    want = np.concatenate([full[start + skip:start + size]
                           for start, skip, size in zip(starts, skips, sizes)])
    got = raw_decode.stored_inflate(torch.from_numpy(packed.copy()), segs, sum(lengths))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numpy().tobytes() == b''.join(p[s:] for p, s in zip(payloads, skips))


@pytest.mark.parametrize('offset', range(16))
def test_plain_stored_inflate_at_every_source_offset(offset):
    """The source starts at each offset 0-15 from an aligned base (the
    alignments K1 realigns in registers): the plain version still reads the
    right bytes, and writes 0 in the gaps a spread-out table leaves."""
    payloads, frames = _stored_frames((3000, 70000, 1, 17), seed=offset)
    segs, lengths = raw_decode.plan_stored_batch(frames)
    src = np.concatenate([np.full(offset, 0xAB, np.uint8),
                          np.frombuffer(b''.join(frames), dtype=np.uint8)])
    gap = 5
    spread = segs + np.array([offset, 0, 0], dtype=np.int32)
    spread[:, 1] += gap * np.arange(1, len(segs) + 1, dtype=np.int32)
    out_len = sum(lengths) + gap * (len(segs) + 1)
    got = raw_decode.stored_inflate(torch.from_numpy(src), spread, out_len).numpy()
    want = np.zeros(out_len, np.uint8)
    for (_, dst, length), (src_off, _, _) in zip(spread.tolist(), segs.tolist()):
        want[dst:dst + length] = np.frombuffer(b''.join(frames), np.uint8)[src_off:
                                                                          src_off + length]
    np.testing.assert_array_equal(got, want)
    assert got[:gap].tolist() == [0] * gap and got[-gap:].tolist() == [0] * gap


def test_check_stored_plan_rejects_unsorted_or_overlapping_rows():
    raw_decode.check_stored_plan(np.array([[0, 0, 4], [4, 6, 2]], dtype=np.int32), 8, 8)
    for rows in ([[0, 4, 4], [4, 0, 4]], [[0, 0, 5], [4, 4, 4]]):
        with pytest.raises(ValueError, match='not sorted'):
            raw_decode.check_stored_plan(np.array(rows, dtype=np.int32), 8, 8)


def test_stored_inflate_checks_the_device_table():
    """A device copy of the table must match the host table's shape and be a
    contiguous int32 tensor on the source's device; the host table is still
    checked row by row."""
    src = torch.arange(8, dtype=torch.uint8)
    segs = np.array([[0, 0, 8]], dtype=np.int32)
    out = raw_decode.stored_inflate(src, segs, 8, device_segments=torch.from_numpy(segs))
    assert out.tolist() == list(range(8))
    for bad in (torch.zeros((2, 3), dtype=torch.int32), torch.zeros((1, 3), dtype=torch.int64),
                torch.zeros((1, 6), dtype=torch.int32)[:, ::2]):
        with pytest.raises(ValueError, match='device_segments'):
            raw_decode.stored_inflate(src, segs, 8, device_segments=bad)
    with pytest.raises(ValueError, match='reaches past'):
        raw_decode.stored_inflate(src, segs, 7, device_segments=torch.from_numpy(segs))


def test_stored_inflate_refuses_other_devices():
    src = torch.empty(8, dtype=torch.uint8, device='meta')
    segs = np.zeros((1, 3), dtype=np.int32)
    with pytest.raises(ValueError, match='cuda or cpu'):
        raw_decode.stored_inflate(src, segs, 8)


def test_check_stored_plan_rejects_out_of_bounds_rows():
    segs = np.array([[0, 0, 4], [4, 4, 4]], dtype=np.int32)
    raw_decode.check_stored_plan(segs, 8, 8)
    with pytest.raises(ValueError, match='reaches past'):
        raw_decode.check_stored_plan(segs, 7, 8)
    with pytest.raises(ValueError, match='reaches past'):
        raw_decode.check_stored_plan(segs, 8, 7)
    with pytest.raises(ValueError, match='negative'):
        raw_decode.check_stored_plan(np.array([[0, -1, 1]], dtype=np.int32), 8, 8)


@pytest.mark.parametrize('row,match', [
    ([4, 0, 5], 'reaches past'),       # source range ends past the 8 bytes
    ([0, 6, 4], 'reaches past'),       # output range ends past the 8 bytes
    ([-1, 0, 1], 'negative'),
])
def test_stored_inflate_refuses_a_table_out_of_bounds(row, match):
    """The wrapper checks every row before anything runs: K1 trusts its table."""
    src = torch.arange(8, dtype=torch.uint8)
    with pytest.raises(ValueError, match=match):
        raw_decode.stored_inflate(src, np.array([row], dtype=np.int32), 8)


def test_stored_inflate_takes_only_the_host_int32_table():
    src = torch.arange(8, dtype=torch.uint8)
    for segs in (torch.tensor([[0, 0, 8]], dtype=torch.int32),
                 np.array([[0, 0, 8]], dtype=np.int64)):
        with pytest.raises(ValueError, match='host int32 numpy table'):
            raw_decode.stored_inflate(src, segs, 8)


@pytest.mark.parametrize('dtype_str,shape', [
    ('|i1', (5,)), ('<i2', (2, 2)), ('<i4', (3,)), ('<f4', (3, 2)), ('|b1', (6,)),
    ('|u1', (4,)),
])
def test_bitcast_rows_matches_jax(dtype_str, shape):
    import jax
    rng = np.random.RandomState(1)
    nbytes = int(np.prod(shape)) * np.dtype(dtype_str).itemsize
    buf = rng.randint(0, 255, size=(7, nbytes), dtype=np.uint8)
    if dtype_str == '|b1':
        buf = (buf % 2).astype(np.uint8)
    want = np.asarray(jax_raw.bitcast_rows(jax.device_put(buf), dtype_str, shape))
    got = raw_decode.bitcast_rows(torch.from_numpy(buf.copy()), dtype_str, shape)
    assert got.shape == (7,) + shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('dtype_str', ['<i8', '<u8', '<f8'])
def test_bitcast_rows_keeps_8_byte_types(dtype_str):
    """8-byte payloads keep their width (JAX under x32 keeps only the low word
    of integers and refuses float64), so they are held against the host view."""
    rng = np.random.RandomState(2)
    buf = rng.randint(0, 255, size=(5, 24), dtype=np.uint8)
    got = raw_decode.bitcast_rows(torch.from_numpy(buf.copy()), dtype_str, (3,))
    want = buf.view(np.dtype(dtype_str)).reshape(5, 3)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_unpack_npy_rows_strips_header_of_strided_matrix():
    """A header slice leaves a strided view; the unpack must still read the
    right payload bytes."""
    from io import BytesIO
    rows = [np.arange(6, dtype=np.float32).reshape(2, 3) + i for i in range(4)]
    blobs = []
    for row in rows:
        f = BytesIO()
        np.save(f, row)
        blobs.append(np.frombuffer(f.getvalue(), dtype=np.uint8))
    matrix = torch.from_numpy(np.stack(blobs))
    header_len = len(blobs[0]) - rows[0].nbytes
    got = raw_decode.unpack_npy_rows(matrix, header_len, '<f4', (2, 3))
    np.testing.assert_array_equal(got.numpy(), np.stack(rows))


@pytest.mark.cuda
def test_stored_inflate_kernel_matches_plain_on_card():
    """K1 on the card equals its plain version byte for byte."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (K1 has no CPU mode)')
    _, frames = _stored_frames(FRAME_SIZES + (8320,) * 16)
    segs, lengths = raw_decode.plan_stored_batch(frames)
    packed = torch.from_numpy(np.frombuffer(b''.join(frames), dtype=np.uint8).copy())
    src = packed.cuda()
    got = raw_decode.stored_inflate(src, segs, sum(lengths))
    want = raw_decode.stored_inflate_plain(src, segs, sum(lengths))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
