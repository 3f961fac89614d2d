"""Kernel K1 (csrc/stored_copy.cu) against its plain version on a CUDA card.
The file imports nothing of JAX, so on the machine with the card it runs
alone:

    python -m pytest --noconftest -m cuda tests/test_torch_stored_copy.py

Without a card every test skips. K1 must equal ``stored_inflate_plain`` bit
for bit. Every output is allocated over memory that held 0xAB just before
(the caching allocator hands the freed block to the next allocation of its
size), so a byte K1 failed to write shows."""

import zlib

import numpy as np
import pytest
import torch

from petastorm_tpu_torch.ops import raw_decode

#: inflated frame sizes: 0 and 1 byte, around a 16-byte word, around K1's
#: 8 KiB output tile, a whole stored block and one of several blocks
FRAME_SIZES = (0, 1, 15, 16, 17, 3, 8191, 8193, 20000, 65535, 70000, 1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (K1 has no CPU mode)')
    return torch.device('cuda')


def _frames(sizes, seed):
    rng = np.random.RandomState(seed)
    frames = []
    for size in sizes:
        comp = zlib.compressobj(0, zlib.DEFLATED, -15)
        frames.append(comp.compress(rng.randint(0, 256, size, dtype=np.uint8).tobytes())
                      + comp.flush())
    return frames


def _over_0xab(card, run, out_len):
    """``run()`` with the allocator's next block of ``out_len`` bytes holding
    0xAB; checks that the output took that block."""
    filler = torch.full((out_len,), 0xAB, dtype=torch.uint8, device=card)
    address = filler.data_ptr()
    del filler
    out = run()
    assert out.data_ptr() == address
    return out


def _check(card, src, segs, out_len, device_table=True):
    src = torch.from_numpy(src).to(card)
    dev_segs = torch.from_numpy(segs).to(card) if device_table else None
    got = _over_0xab(card, lambda: raw_decode.stored_inflate(
        src, segs, out_len, device_segments=dev_segs), out_len)
    want = raw_decode.stored_inflate_plain(src, segs, out_len)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize('src_align', range(16))
def test_k1_matches_plain_at_every_alignment(card, src_align):
    """Source at each alignment 0-15, and for each, destinations at every
    alignment 0-15 with gaps of 0-7 bytes between the rows, over rows that
    cross word and tile edges, and 0- and 1-byte frames."""
    frames = _frames(FRAME_SIZES, seed=src_align)
    segs, lengths = raw_decode.plan_stored_batch(frames)
    src = np.concatenate([np.full(src_align, 0xCD, np.uint8),
                          np.frombuffer(b''.join(frames), dtype=np.uint8)])
    for dst_align in range(16):
        moved = segs.astype(np.int64)
        moved[:, 0] += src_align
        gaps = np.arange(len(segs)) % 8
        moved[:, 1] += dst_align + np.cumsum(gaps)
        out_len = int(moved[-1, 1] + moved[-1, 2]) + 9
        _check(card, src, moved.astype(np.int32), out_len)


@pytest.mark.cuda
def test_k1_header_skipping_plan(card):
    """The decode tail's table: 128-byte headers skipped, payloads written as
    a dense matrix, frames of several stored blocks."""
    frames = _frames((300000,) * 6, seed=1)
    segs, lengths = raw_decode.plan_stored_batch(frames, skip=[128] * 6)
    assert lengths == [300000 - 128] * 6
    _check(card, np.frombuffer(b''.join(frames), dtype=np.uint8).copy(), segs, sum(lengths))


@pytest.mark.cuda
def test_k1_empty_table_writes_zeros(card):
    for out_len in (1, 16, 100, 8192 * 3 + 5):
        _check(card, np.zeros(4, np.uint8), np.zeros((0, 3), np.int32), out_len)


@pytest.mark.cuda
def test_k1_wrapper_uploads_a_host_table(card):
    frames = _frames(FRAME_SIZES, seed=2)
    segs, lengths = raw_decode.plan_stored_batch(frames)
    src = torch.from_numpy(np.frombuffer(b''.join(frames), dtype=np.uint8).copy()).to(card)
    got = raw_decode.stored_inflate(src, segs, sum(lengths))
    want = raw_decode.stored_inflate_plain(src, segs, sum(lengths))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_k1_wrapper_with_device_table_is_one_launch(card):
    """With the table already on the card the wrapper launches K1 once, and
    the card runs nothing else for it: no copy from the host, no memset."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    frames = _frames((8320,) * 16, seed=3)
    segs, lengths = raw_decode.plan_stored_batch(frames, skip=[128] * 16)
    src = torch.from_numpy(np.frombuffer(b''.join(frames), dtype=np.uint8).copy()).to(card)
    dev_segs = torch.from_numpy(segs).to(card)
    raw_decode.stored_inflate(src, segs, sum(lengths), device_segments=dev_segs)
    torch.cuda.synchronize()
    before = raw_decode.stored_inflate.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = raw_decode.stored_inflate(src, segs, sum(lengths), device_segments=dev_segs)
        torch.cuda.synchronize()
    assert raw_decode.stored_inflate.launches == before + 1
    device_events = [(event.key, event.count) for event in prof.key_averages()
                     if event.device_type == DeviceType.CUDA]
    assert device_events == [(device_events[0][0], 1)]
    assert 'stored_copy_kernel' in device_events[0][0]
    assert torch.equal(out, raw_decode.stored_inflate_plain(src, segs, sum(lengths)))
