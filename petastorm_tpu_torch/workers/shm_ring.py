"""The shared-memory slot ring under the process pool: a copy of
``petastorm_tpu.workers.shm_ring`` with a capacity check.

The pool owns one ``multiprocessing.shared_memory`` segment cut into fixed
slots, split statically among the worker slots: worker ``w`` owns ring slots
``[w * k, (w + 1) * k)`` for ``k = slots_per_worker``. A worker serializes a
result into one of its free slots and sends only a small descriptor
(:class:`ShmSlotDescriptor`) over its pipe; the pool checks the CRC, copies the
result out of the slot and sends the slot back with a ``release`` message.

- **Backpressure**: a worker with no free slot waits (bounded) for a release
  before it sends the frames over the pipe instead.
- **One owner**: workers attach without registering the segment with their
  resource tracker, so a killed worker cannot unlink it, and the pool's
  :meth:`ShmRing.close_and_unlink` always removes it.
- **Respawn safety**: a descriptor carries its worker's generation; the pool
  drops a descriptor of a generation it has replaced.
- **Integrity**: a descriptor carries the CRC-32 of the frames it names,
  summed over the source frames while they are copied in.
- **Liveness**: the segment starts with one 8-byte heartbeat word a worker
  (a cache line each), stamped by the worker's heartbeat thread and read by the
  pool's watchdog without any message.

The capacity check is the port's own: a ring larger than the free space of
``/dev/shm`` would let a worker write past the tmpfs and die of SIGBUS, so
:class:`ShmRing` refuses to create it and raises :class:`ShmCapacityError`.
"""

import json
import os
import secrets
import struct
import zlib

from petastorm_tpu_torch.workers.integrity import corrupt_for_test

#: default payload capacity of one slot; a larger result goes over the pipe
DEFAULT_SLOT_BYTES = 32 << 20
#: default slots of each worker: the transport's in-flight bound a worker
DEFAULT_SLOTS_PER_WORKER = 4
#: bytes a worker at the head of the segment for its heartbeat word
HEARTBEAT_BYTES = 64
#: where ``multiprocessing.shared_memory`` keeps its segments on Linux
SHM_DIR = '/dev/shm'
#: prefix of the ring's segment name, so a segment can be found by name
RING_NAME_PREFIX = 'ptt-ring-'
_HEARTBEAT_WORD = struct.Struct('<q')


class ShmCapacityError(OSError):
    """The ring does not fit into the free space of ``/dev/shm``."""


def shm_free_bytes():
    """Free bytes of ``/dev/shm`` (None where the directory does not exist)."""
    try:
        stat = os.statvfs(SHM_DIR)
    except (AttributeError, OSError):
        return None
    return stat.f_bavail * stat.f_frsize


def ring_bytes(workers_count, slots_per_worker, slot_bytes):
    """Size of the segment: the heartbeat words, then the slots."""
    return workers_count * (HEARTBEAT_BYTES + slots_per_worker * slot_bytes)


class ShmSlotDescriptor(object):
    """Descriptor of one payload in the ring: the producing worker slot, its
    generation, the ring slot, the byte length of each frame (back to back in
    the slot) and the CRC-32 of the payload (None only from a JAX writer that
    skips it)."""

    __slots__ = ('worker_slot', 'generation', 'ring_slot', 'frame_lengths', 'crc')

    def __init__(self, worker_slot, generation, ring_slot, frame_lengths, crc=None):
        self.worker_slot = worker_slot
        self.generation = generation
        self.ring_slot = ring_slot
        self.frame_lengths = list(frame_lengths)
        self.crc = crc

    @property
    def total_bytes(self):
        return sum(self.frame_lengths)

    def to_bytes(self):
        spec = {'w': self.worker_slot, 'g': self.generation,
                's': self.ring_slot, 'lens': self.frame_lengths}
        if self.crc is not None:
            spec['crc'] = self.crc
        return json.dumps(spec).encode('utf-8')

    @classmethod
    def from_bytes(cls, blob):
        spec = json.loads(bytes(blob).decode('utf-8'))
        crc = spec.get('crc')
        return cls(int(spec['w']), int(spec['g']), int(spec['s']),
                   [int(n) for n in spec['lens']],
                   crc=int(crc) if crc is not None else None)


class ShmRing(object):
    """The pool's side of the segment: creates it, reads slots, unlinks it."""

    def __init__(self, workers_count, slots_per_worker=DEFAULT_SLOTS_PER_WORKER,
                 slot_bytes=DEFAULT_SLOT_BYTES):
        if workers_count < 1 or slots_per_worker < 1 or slot_bytes < 1024:
            raise ValueError('ShmRing needs >=1 worker, >=1 slot/worker and '
                             '>=1KiB slots')
        from multiprocessing import shared_memory
        self.workers_count = workers_count
        self.slots_per_worker = slots_per_worker
        self.slot_bytes = slot_bytes
        #: payload slots start after the heartbeat words
        self.data_offset = workers_count * HEARTBEAT_BYTES
        total = ring_bytes(workers_count, slots_per_worker, slot_bytes)
        free = shm_free_bytes()
        if free is not None and total > free:
            raise ShmCapacityError(
                'the shm ring needs {} bytes ({} workers x {} slots x {} bytes) but {} '
                'has {} free; a worker writing past it would die of SIGBUS'.format(
                    total, workers_count, slots_per_worker, slot_bytes, SHM_DIR, free))
        self.name = RING_NAME_PREFIX + secrets.token_hex(8)
        self._shm = shared_memory.SharedMemory(name=self.name, create=True, size=total)
        self._closed = False

    def heartbeat(self, worker_slot):
        """The heartbeat counter last stamped by worker ``worker_slot`` (0
        before its first stamp)."""
        return _HEARTBEAT_WORD.unpack_from(self._shm.buf, worker_slot * HEARTBEAT_BYTES)[0]

    def view(self, descriptor):
        """Memoryviews of the descriptor's frames in the slot, in frame order."""
        if descriptor.ring_slot >= self.workers_count * self.slots_per_worker:
            raise ValueError('descriptor names slot {} outside the ring'
                             .format(descriptor.ring_slot))
        if descriptor.total_bytes > self.slot_bytes:
            raise ValueError('descriptor claims {} bytes > slot size {}'
                             .format(descriptor.total_bytes, self.slot_bytes))
        offset = self.data_offset + descriptor.ring_slot * self.slot_bytes
        views = []
        for length in descriptor.frame_lengths:
            views.append(self._shm.buf[offset:offset + length])
            offset += length
        return views

    def close_and_unlink(self):
        """Unmap the segment and remove it from ``/dev/shm`` (idempotent)."""
        if self._closed:
            return
        self._closed = True
        try:
            self._shm.close()
        finally:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass

    def worker_spec(self):
        """What a worker needs to attach its writer."""
        return {'name': self.name, 'slots_per_worker': self.slots_per_worker,
                'slot_bytes': self.slot_bytes, 'data_offset': self.data_offset}


class ShmRingWriter(object):
    """A worker's attachment: writes frames into its own slots and tracks which
    of them await a release. ``checksum=False`` skips the CRC: descriptors
    carry ``crc=None`` and the pool does not verify them."""

    def __init__(self, name, worker_slot, generation, slots_per_worker, slot_bytes,
                 data_offset=0, checksum=True):
        from multiprocessing import shared_memory
        self.worker_slot = worker_slot
        self.generation = generation
        self.slot_bytes = slot_bytes
        self._data_offset = data_offset
        self.checksum = checksum
        self._first_slot = worker_slot * slots_per_worker
        self._slots_per_worker = slots_per_worker
        self._free = list(range(self._first_slot, self._first_slot + slots_per_worker))
        try:
            self._shm = shared_memory.SharedMemory(name=name, track=False)
        except TypeError:
            # Python < 3.13 registers an attached segment with this process's
            # resource tracker (starting one), which would unlink it when the
            # worker exits; the pool is its only owner, so nothing registers
            from multiprocessing import resource_tracker
            register = resource_tracker.register
            resource_tracker.register = lambda name, rtype: None
            try:
                self._shm = shared_memory.SharedMemory(name=name)
            finally:
                resource_tracker.register = register

    @property
    def free_slots(self):
        return len(self._free)

    def fits(self, frames):
        return sum(memoryview(f).nbytes for f in frames) <= self.slot_bytes

    def stamp_heartbeat(self, value):
        """Write this worker's liveness counter (one aligned 8-byte store)."""
        _HEARTBEAT_WORD.pack_into(self._shm.buf, self.worker_slot * HEARTBEAT_BYTES, value)

    def try_write(self, frames):
        """Copy ``frames`` back to back into a free slot and return its
        descriptor; None when no slot is free or they do not fit."""
        if not self._free or not self.fits(frames):
            return None
        ring_slot = self._free.pop()
        base = self._data_offset + ring_slot * self.slot_bytes
        offset = base
        lengths = []
        crc = 0 if self.checksum else None
        for frame in frames:
            view = memoryview(frame).cast('B')
            self._shm.buf[offset:offset + view.nbytes] = view
            if crc is not None:
                crc = zlib.crc32(view, crc) & 0xFFFFFFFF
            offset += view.nbytes
            lengths.append(view.nbytes)
        corrupt_for_test(self._shm.buf, base, offset - base)
        return ShmSlotDescriptor(self.worker_slot, self.generation, ring_slot, lengths,
                                 crc=crc)

    def release(self, ring_slot):
        """The pool read the slot: it may be reused. A release outside this
        writer's slots is ignored."""
        if not self._first_slot <= ring_slot < self._first_slot + self._slots_per_worker:
            return
        if ring_slot not in self._free:
            self._free.append(ring_slot)

    def slot_range(self):
        """``(first_slot, slots_per_worker)`` of this writer's slots."""
        return self._first_slot, self._slots_per_worker

    def close(self):
        """Unmap the segment (the pool unlinks it)."""
        try:
            self._shm.close()
        except BufferError:
            pass
