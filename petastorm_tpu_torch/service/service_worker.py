"""Stateless decode worker for the disaggregated input service. A copy of
``petastorm_tpu.service.service_worker`` over the port's reader worker,
without the incident plane (no ``w_incident`` frames yet).

Entry point executed inside each service worker process, started as
``python -m petastorm_tpu_torch.service.service_worker <bootstrap>``: connect a
DEALER to the dispatcher's worker ROUTER, ``register`` a
:class:`~petastorm_tpu_torch.service.wire.WorkerDescriptor`, then pull work —
``w_ready`` up, ``work`` assignments down — until ``w_stop`` (or the parent
process dies, the same orphan watchdog as the process pool's workers).

The worker is *stateless by contract*: everything dataset-specific arrives
over the wire. A client's ``open`` blob (a pickled dict of the worker class,
its setup and the wire serializer, each pickled with the client's codec —
``dill`` where it imports, else ``pickle``; in practice
:class:`~petastorm_tpu_torch.reader_worker.RowGroupWorker` plus its
``WorkerSetup``) is attached by the dispatcher to the first ``work`` message
each worker sees per setup; the worker instantiates and memoizes the runtime
per setup id (a bounded LRU — old clients' runtimes are shut down, not
hoarded). When the service is configured with a shared cache directory, the
setup's cache is replaced with one fleet-wide
:class:`~petastorm_tpu_torch.cache.ArrowIpcDiskCache`, so a rowgroup decoded
for one job is a warm mmap hit for every other job reading the same dataset —
the amortization argument of the tf.data-service paper (arXiv 2210.14826).

Results ride the :mod:`~petastorm_tpu_torch.workers.serializers` wire codec as
``w_result`` frames over TCP; when the dispatcher flags the owning client as
co-located (same host token) and shm is enabled, the serialized frames are
written into a fresh one-shot shared-memory segment named ``ptt-svc-*``
instead and only a CRC-carrying
:class:`~petastorm_tpu_torch.service.wire.ShmResultDescriptor` crosses the
wire — the client maps, verifies, copies out and unlinks. A janitor unlinks
any segment nobody claimed within a grace window, so dropped duplicates and
dead clients cannot leak ``/dev/shm``.

Heartbeats ride a private DEALER socket (``w_heartbeat`` sequence stamps):
the dispatcher detects stamp *change* on its own clock and deregisters a
worker whose stamp stalls, re-queuing its in-flight items. Every few
heartbeats the same socket also carries a ``w_metrics`` frame — the worker's
CUMULATIVE telemetry registry snapshot
(:class:`~petastorm_tpu_torch.service.wire.WorkerMetricsUpdate`), a
consumer-side tee of the stage-time sidecars each published batch already
carries.

This module and what it imports load no torch: a worker is a reader process
and holds no CUDA context."""

from __future__ import annotations

import collections
import logging
import os
import pickle
import secrets
import sys
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from petastorm_tpu_torch.service.wire import (ShmResultDescriptor, WorkerDescriptor,
                                              WorkerMetricsUpdate, host_token)
# the process pool's worker helpers: the parent watch, the pickler of user
# objects by name and the pickled error of a failed item
from petastorm_tpu_torch.workers.process_worker_main import (_error_blob, _watch_parent,
                                                             load_codec)

logger = logging.getLogger(__name__)

#: name prefix of every one-shot result segment in /dev/shm (leak checks scan
#: for it; apart from the process pool ring's ``ptt-ring-``)
SHM_SEGMENT_PREFIX = 'ptt-svc-'
#: memoized per-setup runtimes kept per worker (old clients evict LRU)
_SETUP_CACHE_LIMIT = 8
#: heartbeats between ``w_metrics`` snapshots (snapshots are a few hundred
#: bytes, but there is no point re-shipping an unchanged registry every
#: 0.5s stamp)
_METRICS_EVERY_N_BEATS = 4
#: seconds an unclaimed one-shot shm segment survives before the janitor
#: unlinks it (covers dropped duplicate results and departed clients)
_SHM_GRACE_S = 60.0
#: how long to wait for the dispatcher's ``registered`` ack before retrying
_REGISTER_TIMEOUT_MS = 2000


def _heartbeat_loop(stop_event: threading.Event, context: Any, endpoint: str,
                    worker_id: int, interval_s: float,
                    metrics_snapshot_fn: Callable[[], Dict[str, Any]]) -> None:
    """Stamp liveness on a PRIVATE DEALER socket (ZMQ sockets are not
    thread-safe — the main thread owns the work socket). Dropped sends are
    fine: the dispatcher only needs *some* stamp to land inside its (much
    longer) staleness window. Every ``_METRICS_EVERY_N_BEATS`` stamps the
    same socket also carries the worker's cumulative telemetry snapshot as a
    ``w_metrics`` frame — best-effort like the stamps."""
    import zmq
    socket = context.socket(zmq.DEALER)
    socket.setsockopt(zmq.SNDHWM, 8)
    socket.setsockopt(zmq.LINGER, 0)
    socket.connect(endpoint)
    seq = 0
    try:
        while not stop_event.wait(interval_s):
            seq += 1
            try:
                socket.send_multipart(
                    [b'w_heartbeat', b'%d' % worker_id, b'%d' % seq],
                    zmq.NOBLOCK)
            except Exception:  # noqa: BLE001 - liveness must never kill a worker
                pass
            if seq % _METRICS_EVERY_N_BEATS != 1:
                continue
            try:
                update = WorkerMetricsUpdate(worker_id, seq, metrics_snapshot_fn())
                socket.send_multipart([b'w_metrics', update.to_bytes()],
                                      zmq.NOBLOCK)
            except Exception:  # noqa: BLE001 - the metrics plane must never kill a worker
                pass
    finally:
        socket.close(linger=0)


class _ShmPublisher(object):
    """One-shot shared-memory result segments for co-located clients.

    Each published result gets a fresh ``ptt-svc-*`` segment (created,
    unregistered from this process's resource tracker — the CLIENT owns the
    unlink after reading). The janitor reclaims segments nobody consumed
    within the grace window; ``close`` unlinks everything still tracked."""

    def __init__(self, grace_s: float = _SHM_GRACE_S) -> None:
        self._grace_s = grace_s
        self._created: Deque[Tuple[str, float]] = collections.deque()

    def write(self, frames: List[Any],
              checksum: bool = True) -> Optional[ShmResultDescriptor]:
        """Write serialized ``frames`` back-to-back into a fresh segment;
        returns the descriptor, or None when shared memory is unavailable
        (the caller falls back to wire frames)."""
        from multiprocessing import resource_tracker, shared_memory
        views = [memoryview(frame) for frame in frames]
        lengths = [view.nbytes for view in views]
        total = sum(lengths)
        try:
            segment = shared_memory.SharedMemory(
                name=SHM_SEGMENT_PREFIX + secrets.token_hex(8), create=True,
                size=max(total, 1))
        except Exception:  # noqa: BLE001 - no /dev/shm: degrade to the TCP wire
            logger.warning('one-shot shm segment unavailable; publishing '
                           'over the wire', exc_info=True)
            return None
        resource_tracker.unregister(segment._name, 'shared_memory')  # type: ignore[attr-defined]
        try:
            offset = 0
            for view, length in zip(views, lengths):
                segment.buf[offset:offset + length] = view.cast('B')
                offset += length
            crc: Optional[int] = None
            if checksum:
                from petastorm_tpu_torch.workers.integrity import payload_checksum
                crc = payload_checksum(views)
        except Exception:  # noqa: BLE001 - a torn copy must not leak the segment
            # Unregistered above, so nothing else will ever reclaim it:
            # close AND unlink before degrading this one result to the wire.
            logger.warning('one-shot shm segment write failed; publishing '
                           'over the wire', exc_info=True)
            segment.close()
            try:
                segment.unlink()
            except OSError:
                pass
            return None
        name = segment.name
        segment.close()
        self._created.append((name, time.monotonic()))
        return ShmResultDescriptor(name, lengths, crc)

    @staticmethod
    def _unlink(name: str) -> None:
        from multiprocessing import shared_memory
        try:
            # attaching registers the name with this process's resource
            # tracker, and unlink() unregisters it again
            segment = shared_memory.SharedMemory(name=name)
        except FileNotFoundError:
            return  # the client consumed and unlinked it — the normal path
        try:
            segment.unlink()
        except FileNotFoundError:
            pass
        finally:
            segment.close()

    def janitor(self) -> None:
        """Unlink segments past the grace window (nobody claimed them)."""
        now = time.monotonic()
        while self._created and now - self._created[0][1] > self._grace_s:
            name, _ = self._created.popleft()
            self._unlink(name)

    def close(self) -> None:
        """Unlink every segment still tracked (worker shutdown)."""
        while self._created:
            name, _ = self._created.popleft()
            self._unlink(name)


class _SetupRuntime(object):
    """One client setup materialized on this worker: the decode worker
    instance, the wire serializer its results ship through and the codec its
    work items are pickled with."""

    __slots__ = ('worker', 'serializer', 'codec')

    def __init__(self, worker: Any, serializer: Any, codec: Any) -> None:
        self.worker = worker
        self.serializer = serializer
        self.codec = codec


def _build_runtime(setup_blob: bytes, worker_id: int,
                   publish: Callable[[Any], None],
                   shared_cache: Any) -> _SetupRuntime:
    """Materialize a client's ``open`` payload into a runtime; when the fleet
    ships a shared cache, it replaces the setup's own (the service owns cache
    placement — that is the whole point of disaggregation)."""
    spec = pickle.loads(setup_blob)
    codec = load_codec(spec['codec'])
    worker_class = codec.loads(spec['worker_class'])
    worker_args = codec.loads(spec['worker_args'])
    serializer = codec.loads(spec['serializer'])
    if shared_cache is not None and hasattr(worker_args, 'cache'):
        worker_args.cache = shared_cache
    worker = worker_class(worker_id, publish, worker_args)
    return _SetupRuntime(worker, serializer, codec)


def main(bootstrap_path: str) -> None:
    """Service-worker process entry: load the pickled bootstrap file, connect
    to the dispatcher's worker endpoint, register, and pull/process work items
    until ``w_stop`` (or parent death)."""
    with open(bootstrap_path, 'rb') as f:
        bootstrap = pickle.load(f)
    try:
        os.unlink(bootstrap_path)
    except OSError:
        pass

    import zmq

    worker_id = int(bootstrap['worker_id'])
    endpoint = bootstrap['worker_endpoint']
    heartbeat_interval_s = float(bootstrap.get('heartbeat_interval_s', 0.5))
    shm_results = bool(bootstrap.get('shm_results', True))
    parent_pid = bootstrap.get('parent_pid')
    if parent_pid is not None:
        threading.Thread(target=_watch_parent, args=(parent_pid,),
                         daemon=True).start()

    shared_cache: Any = None
    cache_dir = bootstrap.get('cache_dir')
    if cache_dir:
        from petastorm_tpu_torch.cache import ArrowIpcDiskCache
        shared_cache = ArrowIpcDiskCache(
            cache_dir, int(bootstrap.get('cache_size_limit') or 10 << 30),
            int(bootstrap.get('cache_row_size_estimate') or 0))

    context = zmq.Context()
    socket = context.socket(zmq.DEALER)
    heartbeat_stop = threading.Event()
    heartbeat_thread: Optional[threading.Thread] = None
    shm_publisher: Optional[_ShmPublisher] = None
    # One try/finally over registration and the work loop: an uncaught
    # error must still close the socket and terminate the context, or
    # zmq teardown hangs the exiting process and the fleet only notices
    # via the staleness watchdog instead of the exit code.
    try:
        socket.connect(endpoint)
        descriptor = WorkerDescriptor(
            worker_id=worker_id, pid=os.getpid(), host=host_token(),
            heartbeat_interval_s=heartbeat_interval_s, shm_results=shm_results)
        registered = False
        while not registered:
            socket.send_multipart([b'register', descriptor.to_bytes()])
            if not socket.poll(_REGISTER_TIMEOUT_MS, zmq.POLLIN):
                continue  # dispatcher not up yet — re-announce
            frames = socket.recv_multipart()
            registered = frames[0] == b'registered'

        # Fleet metrics plane (module docstring): this worker's registry tees
        # the stage-time sidecars of every published batch (merge_stage_times
        # is read-only over the sidecar dict — the owning client's copy is
        # untouched) and ships cumulative snapshots on the heartbeat socket.
        from petastorm_tpu_torch.telemetry import MetricsRegistry
        from petastorm_tpu_torch.telemetry.spans import stage_span
        from petastorm_tpu_torch.telemetry.tracing import set_dispatch_attempt
        worker_metrics = MetricsRegistry()

        if heartbeat_interval_s > 0:
            heartbeat_thread = threading.Thread(
                target=_heartbeat_loop,
                args=(heartbeat_stop, context, endpoint, worker_id,
                      heartbeat_interval_s, worker_metrics.snapshot),
                daemon=True)
            heartbeat_thread.start()

        shm_publisher = _ShmPublisher() if shm_results else None
        runtimes: 'collections.OrderedDict[bytes, _SetupRuntime]' = \
            collections.OrderedDict()
        current_token = [b'']
        current_attempt = [b'0']
        current_colocated = [False]
        current_serializer: List[Any] = [None]

        def publish(result: Any) -> None:
            stage_times = getattr(result, 'telemetry', None)
            if stage_times:
                worker_metrics.merge_stage_times(stage_times)
            with stage_span('serialize'):
                frames = current_serializer[0].serialize(result)
            if shm_publisher is not None and current_colocated[0]:
                shm_descriptor = shm_publisher.write(frames)
                if shm_descriptor is not None:
                    socket.send_multipart(
                        [b'w_result_shm', current_token[0], current_attempt[0],
                         shm_descriptor.to_bytes()])
                    return
            socket.send_multipart(
                [b'w_result', current_token[0], current_attempt[0]]
                + list(frames))

        socket.send_multipart([b'w_ready'])
        stopping = False
        idle_polls = 0
        while not stopping:
            if not socket.poll(1000, zmq.POLLIN):
                if shm_publisher is not None:
                    shm_publisher.janitor()
                # Idle re-announce: a dispatcher that restarted while we sat
                # idle never sees a w_ready from us and so never learns we
                # exist. Periodically re-offer readiness — a live dispatcher
                # that already knows us treats the duplicate as a no-op
                # (identity already in its ready set), a restarted one
                # answers with w_rejoin below.
                idle_polls += 1
                if idle_polls >= 5:
                    idle_polls = 0
                    socket.send_multipart([b'w_ready'])
                continue
            idle_polls = 0
            frames = socket.recv_multipart()
            kind = frames[0]
            if kind == b'w_stop':
                stopping = True
                continue
            if kind == b'registered':
                continue  # duplicate ack from the registration retry loop
            if kind == b'w_rejoin':
                # a restarted dispatcher does not know this identity: replay the
                # registration handshake inline (no blocking retry loop — the
                # dispatcher is demonstrably alive, it just answered us)
                socket.send_multipart([b'register', descriptor.to_bytes()])
                socket.send_multipart([b'w_ready'])
                continue
            if kind != b'work' or len(frames) < 7:
                continue  # unknown kind from a newer dispatcher: ignore
            token, setup_id, blob = frames[1], frames[2], frames[3]
            attempt, colocate_flag = frames[4], frames[5]
            setup_blob = frames[6]
            runtime = runtimes.get(setup_id)
            if runtime is None:
                if not setup_blob:
                    # the dispatcher believed this worker knew the setup (e.g. a
                    # pre-restart identity collision) — ask for a re-ship
                    socket.send_multipart([b'w_need_setup', token])
                    socket.send_multipart([b'w_ready'])
                    continue
                try:
                    runtime = _build_runtime(setup_blob, worker_id, publish,
                                             shared_cache)
                except Exception as exc:  # noqa: BLE001 - ship to the owning client
                    socket.send_multipart([b'w_error', token, attempt,
                                           _error_blob(exc)])
                    socket.send_multipart([b'w_ready'])
                    continue
                runtimes[setup_id] = runtime
                while len(runtimes) > _SETUP_CACHE_LIMIT:
                    _, evicted = runtimes.popitem(last=False)
                    evicted.worker.shutdown()
            else:
                runtimes.move_to_end(setup_id)
            current_token[0] = token
            current_attempt[0] = attempt
            current_colocated[0] = colocate_flag == b'1'
            current_serializer[0] = runtime.serializer
            set_dispatch_attempt(int(attempt))
            try:
                # the kwargs decode belongs INSIDE the error funnel: a poison
                # blob (pickler version skew, client-only modules) must fail
                # that one item to its owner, not kill this worker — the
                # dispatcher would re-queue it onto the next worker and fell
                # the whole fleet
                kwargs = runtime.codec.loads(blob)
                runtime.worker.process(**kwargs)
                socket.send_multipart([b'w_done', token, attempt])
            except Exception as exc:  # noqa: BLE001 - ship to the owning client
                socket.send_multipart([b'w_error', token, attempt,
                                       _error_blob(exc)])
            current_token[0] = b''
            current_colocated[0] = False
            if shm_publisher is not None:
                shm_publisher.janitor()
            socket.send_multipart([b'w_ready'])

        socket.send_multipart([b'w_leave'])
        for runtime in runtimes.values():
            runtime.worker.shutdown()
    finally:
        heartbeat_stop.set()
        if heartbeat_thread is not None:
            heartbeat_thread.join(timeout=2 * heartbeat_interval_s + 1)
        if shm_publisher is not None:
            shm_publisher.close()
        socket.close(linger=1000)
        context.term()


if __name__ == '__main__':
    main(sys.argv[1])
