"""Payload integrity of the shared-memory transport: a copy of
``petastorm_tpu.workers.integrity``.

A slot of the shm ring hands the consumer bytes that no kernel checksum
protects end to end: a torn write by a worker that died mid-copy, or a bit flip,
would flow straight into training arrays. Every slot descriptor therefore
carries the CRC-32 (:func:`zlib.crc32`) of its payload, which the pool checks
before it reads a byte. The chained form sums several frames without joining
them.

:func:`corrupt_for_test` flips one byte of a freshly written slot when the
``PETASTORM_TPU_TORCH_TEST_SHM_CORRUPT`` environment variable names a state
directory (``<state_dir>:<times>``): the first ``times`` slot writes across all
worker processes are corrupted, claimed through ``O_CREAT | O_EXCL`` marker
files, so a test of the CRC path is exact whatever the interleaving.
"""

import os
import zlib
from typing import Union

#: one frame of a payload
Frame = Union[bytes, bytearray, memoryview]

#: environment variable of the test-only corruption hook: ``<state_dir>:<times>``
TEST_SHM_CORRUPT_ENV = 'PETASTORM_TPU_TORCH_TEST_SHM_CORRUPT'


def payload_checksum(frames):
    """Chained CRC-32 over ``frames`` in order (that of their concatenation),
    as an unsigned 32-bit int."""
    crc = 0
    for frame in frames:
        crc = zlib.crc32(frame, crc)
    return crc & 0xFFFFFFFF


def _claim_marker(state_dir, prefix):
    """The next global sequence number for ``prefix`` in ``state_dir``."""
    index = 0
    while True:
        marker = os.path.join(state_dir, '{}.{}'.format(prefix, index))
        try:
            fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            index += 1
            continue
        os.close(fd)
        return index


def corrupt_for_test(buf, offset, length):
    """Flip the middle byte of ``buf[offset:offset + length]`` for each of the
    first ``times`` calls across processes when :data:`TEST_SHM_CORRUPT_ENV` is
    set; True when a byte was flipped. One environment lookup otherwise."""
    spec = os.environ.get(TEST_SHM_CORRUPT_ENV)
    if not spec or length <= 0:
        return False
    state_dir, _, times = spec.rpartition(':')
    if _claim_marker(state_dir, 'shm-corrupt') >= int(times):
        return False
    target = offset + length // 2
    buf[target] = buf[target] ^ 0xFF
    return True
