"""The program each process-pool worker runs: a fresh interpreter started as
``python -m petastorm_tpu_torch.workers.process_worker_main <bootstrap> <fd>``
(spawned, never forked: the parent may hold a CUDA context, which a forked
child cannot use). The port's counterpart of
``petastorm_tpu.workers.process_worker_main`` on the standard library.

``<bootstrap>`` is a pickle file (deleted once read) holding the pickled
worker class, its setup and the wire serializer, the parent's pid, the shm
ring's spec and the heartbeat interval; ``<fd>`` is this worker's end of a
duplex socket pair to the pool, used as a ``multiprocessing.connection``
connection. Messages are pickled tuples:

- pool -> worker: ``('work', token, item_blob, shm_allowed, attempt)``,
  ``('release', ring_slot)``, ``('stop',)``;
- worker -> pool: ``('started', pid)``, ``('ready',)``,
  ``('result', token, n)`` followed by ``n`` raw frames,
  ``('result_shm', token, descriptor)``, ``('done', token, attempt)``,
  ``('error', token, pickled_error)`` and ``('heartbeat', seq)``.

Dispatch is pull-based: the worker sends ``ready``, gets one item, publishes
its result and acks it with ``done``. With the ring attached a result is
written into one of this worker's slots and only its descriptor is sent; with
no free slot the worker waits (bounded) for the pool's releases, then sends
the frames over the pipe. ``shm_allowed`` is False while the pool's shm
breaker is open. A daemon thread stamps a heartbeat every
``heartbeat_interval_s``: into this worker's word of the ring, else as
``heartbeat`` messages. Another thread exits the process when the parent
dies.

Telemetry: serializing a result is the ``serialize`` stage and waiting for a
free slot ``shm_slot_wait``; both are recorded during a publish, so they ride
the NEXT result's ``telemetry`` sidecar (one item late, the same process
total). The ``attempt`` of each work message is installed as the item's
dispatch attempt for its trace context.

This module and what it imports load no torch: a worker is a reader process
and holds no CUDA context.
"""

import collections
import os
import pickle
import sys
import threading
import time
import traceback

from petastorm_tpu_torch.telemetry.spans import stage_span
from petastorm_tpu_torch.telemetry.tracing import set_dispatch_attempt

#: bounded wait for a slot release before a result goes over the pipe; the pool
#: releases every slot it reads, so this only runs out when it stalls
_SLOT_WAIT_S = 10.0


def load_codec(name):
    """The pickler of user objects: ``dill`` where the pool used it."""
    if name == 'dill':
        import dill
        return dill
    return pickle


def _watch_parent(parent_pid):
    """Exit when the parent dies, so no orphan worker lingers."""
    while True:
        if os.getppid() != parent_pid:
            os._exit(0)
        time.sleep(1)


class _Channel(object):
    """This worker's end of the pipe. Sends hold a lock: the heartbeat thread
    sends too, and a result's header and frames must stay together."""

    def __init__(self, conn):
        self.conn = conn
        self._lock = threading.Lock()

    def send(self, message, frames=()):
        with self._lock:
            self.conn.send(message)
            for frame in frames:
                self.conn.send_bytes(frame)


def _heartbeat_loop(stop_event, ring_writer, channel, interval_s):
    seq = 0
    while not stop_event.wait(interval_s):
        seq += 1
        try:
            if ring_writer is not None:
                ring_writer.stamp_heartbeat(seq)
            else:
                channel.send(('heartbeat', seq))
        except Exception:  # noqa: BLE001 - liveness must never kill a worker
            pass


def _error_blob(exc):
    """The pickled ``(exception, traceback text)`` of a failed item (a
    ``RuntimeError`` with its repr when the exception does not pickle)."""
    text = traceback.format_exc()
    try:
        return pickle.dumps((exc, text))
    except Exception:  # noqa: BLE001 - any exception must reach the pool
        return pickle.dumps((RuntimeError(repr(exc)), text))


def main(bootstrap_path, fd):
    from multiprocessing.connection import Connection

    with open(bootstrap_path, 'rb') as f:
        bootstrap = pickle.load(f)
    try:
        os.unlink(bootstrap_path)
    except OSError:
        pass
    channel = _Channel(Connection(int(fd)))
    conn = channel.conn
    codec = load_codec(bootstrap['codec'])
    worker_class = codec.loads(bootstrap['worker_class'])
    worker_args = codec.loads(bootstrap['worker_args'])
    serializer = codec.loads(bootstrap['serializer'])
    worker_id = bootstrap['worker_id']
    threading.Thread(target=_watch_parent, args=(bootstrap['parent_pid'],),
                     daemon=True).start()

    ring_writer = None
    shm_spec = bootstrap['shm']
    if shm_spec is not None:
        from petastorm_tpu_torch.workers.shm_ring import ShmRingWriter
        ring_writer = ShmRingWriter(shm_spec['name'], worker_id, bootstrap['generation'],
                                    shm_spec['slots_per_worker'], shm_spec['slot_bytes'],
                                    data_offset=shm_spec['data_offset'])
    heartbeat_stop = threading.Event()
    heartbeat_thread = None
    interval_s = bootstrap['heartbeat_interval_s']
    if interval_s:
        heartbeat_thread = threading.Thread(
            target=_heartbeat_loop, args=(heartbeat_stop, ring_writer, channel, interval_s),
            daemon=True)
        heartbeat_thread.start()

    deferred = collections.deque()
    current = {'token': None, 'shm': True}

    def wait_for_slot(frames):
        deadline = time.monotonic() + _SLOT_WAIT_S
        descriptor = None
        while descriptor is None and time.monotonic() < deadline:
            # every slot awaits its release: take the pool's releases, and
            # keep anything else for the main loop
            if conn.poll(0.1):
                message = conn.recv()
                if message[0] == 'release':
                    ring_writer.release(message[1])
                else:
                    deferred.append(message)
            descriptor = ring_writer.try_write(frames)
        return descriptor

    def publish(result):
        with stage_span('serialize'):
            frames = serializer.serialize(result)
        if ring_writer is not None and current['shm'] and ring_writer.fits(frames):
            descriptor = ring_writer.try_write(frames)
            if descriptor is None:
                with stage_span('shm_slot_wait'):
                    descriptor = wait_for_slot(frames)
            if descriptor is not None:
                channel.send(('result_shm', current['token'], descriptor.to_bytes()))
                return
        channel.send(('result', current['token'], len(frames)), frames)

    try:
        worker = worker_class(worker_id, publish, worker_args)
        channel.send(('started', os.getpid()))
        channel.send(('ready',))
        while True:
            try:
                message = deferred.popleft() if deferred else conn.recv()
            except EOFError:
                break   # the pool closed its end
            kind = message[0]
            if kind == 'stop':
                break
            if kind == 'release':
                if ring_writer is not None:
                    ring_writer.release(message[1])
                continue
            _, token, blob, current['shm'], attempt = message
            current['token'] = token
            set_dispatch_attempt(attempt)
            try:
                worker.process(**codec.loads(blob))
                channel.send(('done', token, attempt))
            except Exception as exc:  # noqa: BLE001 - re-raised in the pool's consumer
                channel.send(('error', token, _error_blob(exc)))
            current['token'] = None
            channel.send(('ready',))
        worker.shutdown()
    finally:
        heartbeat_stop.set()
        if heartbeat_thread is not None:
            heartbeat_thread.join(timeout=2 * interval_s + 1)
        if ring_writer is not None:
            ring_writer.close()
        conn.close()


if __name__ == '__main__':
    main(sys.argv[1], sys.argv[2])
