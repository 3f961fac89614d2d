"""The port's shared-memory transport against the JAX package's: the payload
CRC, the slot descriptor's bytes, the ring's layout (a JAX writer attached to
the port's ring is read back by the port), the writer's slot accounting, the
capacity check on ``/dev/shm`` and the wire serializer's payloads, which both
packages decode alike. In-process: nothing here spawns a worker."""

import os
from collections import namedtuple

import numpy as np
import pyarrow as pa
import pytest

from petastorm_tpu.workers import integrity as jax_integrity
from petastorm_tpu.workers import shm_ring as jax_ring
from petastorm_tpu_torch.workers import integrity, shm_ring
from petastorm_tpu_torch.workers.shm_ring import (ShmCapacityError, ShmRing, ShmRingWriter,
                                                  ShmSlotDescriptor)


def _frames(seed):
    rng = np.random.RandomState(seed)
    return [b'A', rng.bytes(1000), bytearray(rng.bytes(37)),
            memoryview(rng.bytes(4096)), pa.py_buffer(rng.bytes(5))]


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_payload_checksum_is_the_jax_crc(seed):
    frames = _frames(seed)
    got = integrity.payload_checksum(frames)
    assert got == jax_integrity.payload_checksum(frames)
    joined = b''.join(bytes(memoryview(f)) for f in frames)
    assert got == integrity.payload_checksum([joined])


@pytest.mark.parametrize('crc', [None, 0, 0xFFFFFFFF, 123456789])
def test_descriptor_bytes_round_trip_across_packages(crc):
    port = ShmSlotDescriptor(3, 2, 13, [1, 1000, 37], crc=crc)
    jax = jax_ring.ShmSlotDescriptor(3, 2, 13, [1, 1000, 37], crc=crc)
    assert port.to_bytes() == jax.to_bytes()
    back = ShmSlotDescriptor.from_bytes(jax.to_bytes())
    assert (back.worker_slot, back.generation, back.ring_slot, back.frame_lengths,
            back.crc, back.total_bytes) == (3, 2, 13, [1, 1000, 37], crc, 1038)


def _segment_exists(name):
    return os.path.exists(os.path.join(shm_ring.SHM_DIR, name))


def test_a_jax_writer_on_the_port_ring_reads_back_with_its_crc():
    ring = ShmRing(2, slots_per_worker=2, slot_bytes=8192)
    try:
        assert ring.name.startswith(shm_ring.RING_NAME_PREFIX) and _segment_exists(ring.name)
        assert ring.worker_spec()['data_offset'] == 2 * jax_ring.HEARTBEAT_BYTES
        spec = ring.worker_spec()
        jax_writer = jax_ring.ShmRingWriter(ring.name, 1, 4, spec['slots_per_worker'],
                                            spec['slot_bytes'], spec['data_offset'])
        port_writer = ShmRingWriter(ring.name, 0, 0, spec['slots_per_worker'],
                                    spec['slot_bytes'], spec['data_offset'])
        frames = _frames(5)[:4]
        for writer in (jax_writer, port_writer):
            descriptor = ShmSlotDescriptor.from_bytes(writer.try_write(frames).to_bytes())
            views = ring.view(descriptor)
            assert [bytes(v) for v in views] == [bytes(memoryview(f)) for f in frames]
            assert integrity.payload_checksum(views) == descriptor.crc
            for view in views:
                view.release()
        jax_writer.stamp_heartbeat(41)
        port_writer.stamp_heartbeat(7)
        assert (ring.heartbeat(0), ring.heartbeat(1)) == (7, 41)
        jax_writer.close()
        port_writer.close()
    finally:
        ring.close_and_unlink()
    assert not _segment_exists(ring.name)
    ring.close_and_unlink()


def test_writer_slot_accounting_and_refusals():
    ring = ShmRing(2, slots_per_worker=2, slot_bytes=1024)
    writer = ShmRingWriter(ring.name, 1, 0, 2, 1024, ring.data_offset)
    try:
        assert writer.try_write([b'x' * 1025]) is None
        first = writer.try_write([b'a' * 10])
        second = writer.try_write([b'b' * 20])
        assert {first.ring_slot, second.ring_slot} == {2, 3}
        assert first.crc == integrity.payload_checksum([b'a' * 10])
        assert writer.free_slots == 0 and writer.try_write([b'c']) is None
        writer.release(0)             # another worker's slot: ignored
        assert writer.free_slots == 0
        writer.release(first.ring_slot)
        writer.release(first.ring_slot)
        assert writer.free_slots == 1
        third = writer.try_write([b'c' * 5])
        assert third.ring_slot == first.ring_slot
        assert bytes(ring.view(third)[0]) == b'c' * 5
        with pytest.raises(ValueError, match='outside the ring'):
            ring.view(ShmSlotDescriptor(0, 0, 4, [1]))
        with pytest.raises(ValueError, match='slot size'):
            ring.view(ShmSlotDescriptor(0, 0, 1, [2048]))
    finally:
        writer.close()
        ring.close_and_unlink()


def test_the_corruption_hook_flips_one_byte_of_the_first_writes(tmp_path, monkeypatch):
    monkeypatch.setenv(integrity.TEST_SHM_CORRUPT_ENV, '{}:1'.format(tmp_path))
    ring = ShmRing(1, slots_per_worker=2, slot_bytes=1024)
    writer = ShmRingWriter(ring.name, 0, 0, 2, 1024, ring.data_offset)
    try:
        crcs = []
        for payload in (b'p' * 64, b'q' * 64):
            descriptor = writer.try_write([payload])
            crcs.append(integrity.payload_checksum(ring.view(descriptor)) == descriptor.crc)
        assert crcs == [False, True]
    finally:
        writer.close()
        ring.close_and_unlink()


_StatVfs = namedtuple('_StatVfs', 'f_bavail f_frsize')


def test_a_ring_larger_than_dev_shm_is_refused(monkeypatch):
    ring_bytes = shm_ring.ring_bytes(2, 4, 1 << 20)
    assert ring_bytes == 2 * 64 + 8 * (1 << 20)
    monkeypatch.setattr(os, 'statvfs', lambda path: _StatVfs(ring_bytes // 4096 - 1, 4096))
    assert shm_ring.shm_free_bytes() < ring_bytes
    with pytest.raises(ShmCapacityError, match='SIGBUS'):
        ShmRing(2, slots_per_worker=4, slot_bytes=1 << 20)
    monkeypatch.setattr(os, 'statvfs', lambda path: _StatVfs(ring_bytes // 4096 + 1, 4096))
    ShmRing(2, slots_per_worker=4, slot_bytes=1 << 20).close_and_unlink()


def test_process_pool_with_shm_required_raises_before_it_spawns(monkeypatch):
    from petastorm_tpu_torch.workers.process_pool import ProcessPool
    from petastorm_tpu_torch.workers.worker_base import WorkerBase
    monkeypatch.setattr(os, 'statvfs', lambda path: _StatVfs(1, 4096))
    pool = ProcessPool(2, shm_transport=True)
    with pytest.raises(ShmCapacityError):
        pool.start(WorkerBase)
    assert pool.processes == [] and pool.ring_name is None


def _batches():
    from petastorm_tpu.reader_worker import ColumnarBatch as JaxBatch
    from petastorm_tpu.resilience import QuarantineRecord as JaxRecord
    from petastorm_tpu_torch.reader_worker import ColumnarBatch
    from petastorm_tpu_torch.resilience import QuarantineRecord
    rng = np.random.RandomState(0)
    columns = {'id': np.arange(6), 'img': rng.randint(0, 255, (6, 4, 4, 3)).astype(np.uint8),
               'vec': rng.randn(6, 3).astype(np.float32),
               'name': ['r{}'.format(i) for i in range(6)],
               'ragged': [np.arange(i) for i in range(6)]}
    record = dict(piece_index=2, fragment_path='/s/part_1.parquet', row_group_id=0,
                  error_type='ArrowInvalid', error='bad', attempts=1, epoch=1, reason='error')
    port = [ColumnarBatch(columns, 6, item_id=(1, 2, 0), cache_hit=True, retries=2,
                          breakers={'fs:/s': {'state': 'open'}}),
            ColumnarBatch({}, 0, item_id=(1, 3, 0), quarantine=QuarantineRecord(**record))]
    jax = [JaxBatch(columns, 6, item_id=(1, 2, 0), cache_hit=True, retries=2,
                    breakers={'fs:/s': {'state': 'open'}}),
           JaxBatch({}, 0, item_id=(1, 3, 0), quarantine=JaxRecord(**record))]
    return port, jax


def _same_batch(got, want):
    assert sorted(got.columns) == sorted(want.columns)
    for name, col in want.columns.items():
        if isinstance(col, np.ndarray):
            np.testing.assert_array_equal(got.columns[name], col)
            assert got.columns[name].dtype == col.dtype
        else:
            assert [np.asarray(v).tolist() for v in got.columns[name]] == \
                [np.asarray(v).tolist() for v in col]
    assert (got.num_rows, tuple(got.item_id), got.cache_hit, got.retries, got.breakers) == \
        (want.num_rows, tuple(want.item_id), want.cache_hit, want.retries, want.breakers)
    assert ((got.quarantine and got.quarantine.as_dict())
            == (want.quarantine and want.quarantine.as_dict()))


def test_wire_payloads_decode_alike_in_both_packages():
    from petastorm_tpu.workers.serializers import ArrowIpcSerializer as JaxSerializer
    from petastorm_tpu_torch.workers.serializers import ArrowIpcSerializer
    port_batches, jax_batches = _batches()
    port, jax = ArrowIpcSerializer(), JaxSerializer()
    for port_batch, jax_batch in zip(port_batches, jax_batches):
        _same_batch(port.deserialize(port.serialize(port_batch)), port_batch)
        _same_batch(port.deserialize(jax.serialize(jax_batch)), port_batch)
        _same_batch(jax.deserialize(port.serialize(port_batch)), jax_batch)


def test_a_payload_read_from_a_slot_is_a_writable_copy():
    from petastorm_tpu_torch.ngram_worker import NGramWindows
    from petastorm_tpu_torch.workers.serializers import ArrowIpcSerializer
    serializer = ArrowIpcSerializer()
    batch = _batches()[0][0]
    windows = NGramWindows({'id': np.arange(5)}, np.array([0, 2]), item_id=(0, 1, 0),
                           retries=1)
    ring = ShmRing(1, slots_per_worker=2, slot_bytes=1 << 16)
    writer = ShmRingWriter(ring.name, 0, 0, 2, 1 << 16, ring.data_offset)
    try:
        for payload in (batch, windows):
            descriptor = writer.try_write(serializer.serialize(payload))
            views = ring.view(descriptor)
            got = serializer.deserialize(views)
            for view in views:
                view.release()          # would raise BufferError if a column aliased it
            writer.release(descriptor.ring_slot)
            assert type(got) is type(payload) and got.item_id == payload.item_id
            assert got.retries == payload.retries
            for name, col in payload.columns.items():
                if isinstance(col, np.ndarray):
                    np.testing.assert_array_equal(got.columns[name], col)
                    assert got.columns[name].flags.writeable
        np.testing.assert_array_equal(got.starts, windows.starts)
    finally:
        writer.close()
        ring.close_and_unlink()
