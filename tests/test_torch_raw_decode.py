"""Parity of the port's raw-payload decode (petastorm_tpu_torch.ops.raw_decode)
with petastorm_tpu.ops.raw_decode: the stored-deflate planner, the plain
version of kernel K1 against the Pallas stored_inflate (interpret mode on the
CPU), and the npy bitcast unpack."""

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


def test_plan_stored_batch_identical_to_jax():
    _, frames = _stored_frames(FRAME_SIZES)
    segs, lengths = raw_decode.plan_stored_batch(frames)
    jax_segs, jax_lengths = jax_raw.plan_stored_batch(frames)
    assert segs.dtype == jax_segs.dtype == np.int32
    np.testing.assert_array_equal(segs, jax_segs)
    assert lengths == jax_lengths == list(FRAME_SIZES)
    huffman = zlib.compressobj(6, zlib.DEFLATED, -15)
    mixed = frames + [huffman.compress(b'a' * 1000) + huffman.flush()]
    assert raw_decode.plan_stored_batch(mixed) is None
    assert jax_raw.plan_stored_batch(mixed) is None


def test_plain_stored_inflate_bit_exact_against_pallas():
    """The plain K1 equals the Pallas kernel (interpret mode) byte for byte on
    frames of 3000, 70000 (several stored blocks), 1, 0 and 1024 bytes."""
    payloads, frames = _stored_frames(FRAME_SIZES)
    segs, lengths = raw_decode.plan_stored_batch(frames)
    packed = np.frombuffer(b''.join(frames), dtype=np.uint8)
    out_len = sum(lengths)
    want = np.asarray(jax_raw.stored_inflate(packed, segs, out_len))
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
