"""The process worker pool: the port's counterpart of
``petastorm_tpu.workers.process_pool`` on the standard library.

Each worker is a fresh interpreter (``subprocess`` with ``sys.executable -m
petastorm_tpu_torch.workers.process_worker_main``; spawned, never forked,
since the parent may already hold a CUDA context) joined to the pool by one
duplex ``multiprocessing.connection`` pipe, a socket pair. The pool waits on
all the pipes with ``multiprocessing.connection.wait``. A pipe belongs to one
worker, so each message is attributed to its worker without any identity on
the wire: that is what respawn needs. The JAX package's ZeroMQ trio
(ROUTER/DEALER dispatch, PUB control, PULL results) maps onto it one to one.

What the design keeps from the JAX pool:

- **Pull-based dispatch.** A worker asks for work (``ready``) and gets one
  item; the pool knows which items each worker holds.
- **Respawn and re-ventilation.** When a worker dies while work remains, the
  pool starts a replacement (at most ``max_worker_respawns`` in all) and puts
  the dead worker's unacked items back at the front of the queue, under a new
  attempt number, so an ack the dead worker flushed cannot retire them.
- **Duplicates dropped.** The first result of an item is delivered; any later
  one (a re-ventilated item whose first result already arrived) is counted in
  ``results_dropped`` and dropped.
- **The hang watchdog.** While the consumer is starved, a worker holding
  items whose heartbeat has not changed for ``hang_timeout_s`` is SIGKILLed,
  and so is one holding an item past ``item_deadline_s``; the death path then
  respawns it. With a hang-result factory (the reader installs one under
  ``on_error='skip'``) the overdue item is quarantined instead of dispatched
  again: an empty stand-in carrying ``QuarantineRecord(reason='hang')`` is
  delivered in its place.
- **The shm ring** (:mod:`~petastorm_tpu_torch.workers.shm_ring`). Workers
  write results into their slots and send a descriptor; the pool checks its
  generation (a descriptor of a replaced worker is dropped unread,
  ``shm_stale_drops``) and its CRC, copies the result out and releases the
  slot. A CRC failure kills the producing worker (its items are redone) and
  counts against the shm :class:`~petastorm_tpu_torch.resilience.CircuitBreaker`;
  while it is open, results travel as frames over the pipes.
- **A clean** :meth:`join`: the ring is closed and unlinked whatever deaths
  occurred.
- **Telemetry.** The pool's own registry (``ProcessPool.telemetry``, merged
  into ``Reader.telemetry_snapshot()``) holds the consumer-side stages
  ``shm_map``, ``shm_release`` and ``pool_wait``, the per-batch
  ``wire_bytes_copied`` histogram and the ``breaker_open``, ``watchdog_reap``
  and ``shm_crc_fail`` counters. The workers' stages and trace events ride
  each result's sidecars. The telemetry and tracing switches of this process
  pass to the workers it spawns (an explicit ``PETASTORM_TPU_TELEMETRY`` or
  ``PETASTORM_TPU_TRACE`` in the environment wins), and each work message
  carries its dispatch attempt, so a re-ventilated item's second life is
  another attempt on the merged timeline.

Defined differences from the JAX pool:

- The transport is the standard library's; ``zmq`` is not needed.
  ``diagnostics['pipe_result_bytes']`` is the JAX pool's ``zmq_result_bytes``
  (bytes that crossed the pipes: descriptors, and whole frames when a result
  did not go through the ring).
- User objects (the worker setup with its transform, the work items with
  their predicates) are pickled with ``dill`` where it imports, else with
  ``pickle``; then an object that does not pickle (a lambda) raises when the
  pool starts, naming it.
- ``shm_transport=None`` checks the free space of ``/dev/shm`` before making
  the ring; a ring that does not fit is not made, the results travel as frames
  and ``diagnostics['shm_capacity_fallbacks']`` counts it.
  ``shm_transport=True`` raises instead.
- ``results_queue_size`` is accepted for the JAX signature; results in flight
  are bounded by the pull-based dispatch, the pipes and the ring's slots.
- The ring has the JAX defaults (32 MiB slots, 4 a worker) and always checks
  CRCs; the JAX pool's slot-size, checksum and breaker arguments are not
  taken. ``payload_serializer`` is the JAX pool's (Arrow IPC by default,
  :class:`~petastorm_tpu_torch.workers.serializers.PickleSerializer` for
  whole-object pickles).
"""

import collections
import logging
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import threading
import time
from multiprocessing.connection import Connection, wait

from petastorm_tpu_torch.telemetry import tracing as _tracing
from petastorm_tpu_torch.telemetry.registry import (BYTES_UNIT, MetricsRegistry,
                                                    telemetry_enabled)
from petastorm_tpu_torch.workers import (EmptyResultError, TimeoutWaitingForResultError,
                                         WorkerTerminationError)

logger = logging.getLogger(__name__)

_WORKER_STARTUP_TIMEOUT_S = 60
_WORKER_MODULE = 'petastorm_tpu_torch.workers.process_worker_main'
#: default total respawn budget: a rowgroup that kills every worker fails loudly
DEFAULT_MAX_WORKER_RESPAWNS = 3
#: watchdog defaults: stamp cadence, and how long a stamp may stay unchanged
#: (while its worker holds items) before the worker counts as hung
DEFAULT_HEARTBEAT_INTERVAL_S = 0.5
DEFAULT_HANG_TIMEOUT_S = 30.0
#: shm breaker defaults: consecutive CRC failures before results go over the
#: pipes, and the cooldown before a half-open probe uses the ring again
DEFAULT_SHM_BREAKER_THRESHOLD = 3
DEFAULT_SHM_BREAKER_RECOVERY_S = 30.0


def _codec():
    """``(name, module)`` of the pickler of user objects: dill where it imports."""
    try:
        import dill
        return 'dill', dill
    except ImportError:
        return 'pickle', pickle


def _attributes(obj):
    names = list(getattr(obj, '__dict__', {}))
    for cls in type(obj).__mro__:
        names.extend(getattr(cls, '__slots__', ()))
    return [(name, getattr(obj, name)) for name in names if hasattr(obj, name)]


def _unpicklable_part(obj, path, dumps, depth=3):
    """``(path, object)`` of the innermost attribute of ``obj`` that ``dumps``
    refuses (``obj`` itself when none of its attributes is to blame)."""
    if depth:
        values = (obj.items() if isinstance(obj, dict) else _attributes(obj))
        for name, value in values:
            try:
                dumps(value)
            except Exception:  # noqa: BLE001 - any failure names the culprit
                return _unpicklable_part(value, '{}.{}'.format(path, name), dumps,
                                         depth - 1)
    return path, obj


class _Worker(object):
    """One spawned worker: its slot, generation, process and pipe."""

    __slots__ = ('slot', 'generation', 'process', 'conn', 'send_lock')

    def __init__(self, slot, generation, process, conn):
        self.slot = slot
        self.generation = generation
        self.process = process
        self.conn = conn
        self.send_lock = threading.Lock()


class ProcessPool(object):
    """Spawned-process worker pool (see the module docstring)."""

    def __init__(self, workers_count, results_queue_size=50, payload_serializer=None,
                 max_worker_respawns=DEFAULT_MAX_WORKER_RESPAWNS, shm_transport=None,
                 heartbeat_interval_s=DEFAULT_HEARTBEAT_INTERVAL_S,
                 hang_timeout_s=DEFAULT_HANG_TIMEOUT_S, item_deadline_s=None):
        """``max_worker_respawns``: the pool's budget of worker restarts (0:
        the first death fails the read). ``shm_transport``: None (use the ring
        when ``/dev/shm`` can hold it), True (require it), False (frames over
        the pipes only). Workers stamp a heartbeat every
        ``heartbeat_interval_s`` (0 or None: no stamps); a worker holding items
        whose stamp stalls for ``hang_timeout_s`` (None: no staleness reap) or
        whose item overruns ``item_deadline_s`` (None: no deadline) is
        SIGKILLed and respawned within ``max_worker_respawns``.
        ``payload_serializer`` is the results' wire format: None for
        :class:`~petastorm_tpu_torch.workers.serializers.ArrowIpcSerializer`
        frames, or a
        :class:`~petastorm_tpu_torch.workers.serializers.PickleSerializer`
        for whole-object pickles."""
        from petastorm_tpu_torch.resilience import CircuitBreaker
        from petastorm_tpu_torch.workers.serializers import ArrowIpcSerializer
        from petastorm_tpu_torch.workers.shm_ring import (DEFAULT_SLOT_BYTES,
                                                          DEFAULT_SLOTS_PER_WORKER)
        self.workers_count = workers_count
        #: consumer-side telemetry (see the module docstring)
        self.telemetry = MetricsRegistry()
        self._serializer = (payload_serializer if payload_serializer is not None
                            else ArrowIpcSerializer())
        self._max_worker_respawns = max_worker_respawns
        self._shm_transport = shm_transport
        self._ring = None
        #: the ring's shape; set_shm_slot_config changes it for the next ring
        self._shm_slots_per_worker = DEFAULT_SLOTS_PER_WORKER
        self._shm_slot_bytes = DEFAULT_SLOT_BYTES
        #: the ring's segment name (kept after join, to check it is gone)
        self.ring_name = None
        self._shm_capacity_fallbacks = 0
        self._ventilator = None
        self._workers = []                  # slot -> current _Worker
        self._conns = {}                    # open pipe -> its _Worker (dead ones until EOF)
        self._stopped = False
        self._started = False
        # one receiver at a time: the consumer's get_results, or join's drain
        self._recv_lock = threading.Lock()
        self._next_liveness_check = 0.0

        self._heartbeat_interval_s = heartbeat_interval_s or 0
        self._hang_timeout_s = hang_timeout_s
        if (hang_timeout_s is not None and self._heartbeat_interval_s
                and hang_timeout_s < 4 * self._heartbeat_interval_s):
            raise ValueError('hang_timeout_s ({}) must be >= 4x heartbeat_interval_s ({}) '
                             'or staleness cannot be told from stamp jitter'
                             .format(hang_timeout_s, heartbeat_interval_s))
        self._item_deadline_s = item_deadline_s
        self._hb_state = {}                 # slot -> [last stamp, monotonic time it changed]
        self._dispatch_time = {}            # token -> monotonic dispatch time
        self._hang_results = collections.deque()
        self._hang_result_factory = None
        self._workers_hung_reaped = 0
        self._next_hang_check = 0.0
        self._shm_crc_failures = 0
        self._shm_breaker = CircuitBreaker('shm_transport',
                                           failure_threshold=DEFAULT_SHM_BREAKER_THRESHOLD,
                                           recovery_timeout_s=DEFAULT_SHM_BREAKER_RECOVERY_S,
                                           on_transition=self._count_breaker_open)

        # dispatch bookkeeping, under _state_lock: ventilate() runs on the
        # ventilator thread, the rest on the consumer thread
        self._state_lock = threading.Lock()
        self._codec_name, self._codec = None, None
        self._next_token = 0
        self._items = {}                    # token -> pickled kwargs, until acked
        self._pending = collections.deque() # tokens awaiting a worker
        self._assigned = {}                 # token -> _Worker holding it
        self._attempt = {}                  # token -> current dispatch attempt
        self._ready = collections.deque()   # _Workers awaiting work
        self._slot_generation = []
        # tokens whose result was delivered but whose 'done' has not arrived:
        # any further result for them is a duplicate of a re-ventilated item
        self._delivered = set()
        self._workers_respawned = 0
        self._results_dropped = 0
        self._wire_batches = 0
        self._shm_batches = 0
        self._shm_fallback_batches = 0
        self._shm_stale_drops = 0
        self._shm_bytes_mapped = 0
        self._pipe_result_bytes = 0

    def _count_breaker_open(self, name, old_state, new_state):
        if new_state == 'open' and telemetry_enabled():
            self.telemetry.inc('breaker_open')

    # ------------------------------------------------------------------ lifecycle

    def _dumps(self, obj, what):
        """Pickle a user object for the workers; one that does not pickle
        raises here, named."""
        if self._codec is None:
            self._codec_name, self._codec = _codec()
        try:
            return self._codec.dumps(obj)
        except Exception as exc:  # noqa: BLE001 - re-raised with the culprit named
            path, culprit = _unpicklable_part(obj, what, self._codec.dumps)
            raise TypeError(
                "reader_pool_type='process' sends {} to its spawned workers, but {} = {!r} "
                'does not pickle with {} ({}: {}); use a module-level function{}'.format(
                    what, path, culprit, self._codec_name, type(exc).__name__, exc,
                    ' or install dill' if self._codec_name == 'pickle' else '')) from exc

    def check_picklable(self, obj, what):
        """Raise now, naming ``obj``, if it cannot reach the workers (the reader
        checks the predicate every work item carries)."""
        self._dumps(obj, what)

    def start(self, worker_class, worker_args=None, ventilator=None):
        if self._started:
            raise RuntimeError('ProcessPool already started')
        self._started = True
        self._bootstrap = {
            'worker_class': self._dumps(worker_class, 'the worker class'),
            'worker_args': self._dumps(worker_args, 'worker_args'),
            'serializer': self._dumps(self._serializer, 'the payload serializer'),
            'parent_pid': os.getpid(),
            'heartbeat_interval_s': self._heartbeat_interval_s,
            'shm': None,
        }
        self._bootstrap['codec'] = self._codec_name   # set by the first _dumps
        if self._shm_transport is not False:
            self._make_ring()
        if self._ring is not None:
            self._bootstrap['shm'] = self._ring.worker_spec()
        # spawned interpreters resolve this package and the user's modules as
        # the parent does
        self._child_env = dict(os.environ)
        paths = [p for p in sys.path if p]
        if self._child_env.get('PYTHONPATH'):
            paths.append(self._child_env['PYTHONPATH'])
        self._child_env['PYTHONPATH'] = os.pathsep.join(paths)
        # this process's switches (set_telemetry_enabled, trace=) reach the
        # workers; an explicit environment setting wins
        self._child_env.setdefault('PETASTORM_TPU_TELEMETRY',
                                   '1' if telemetry_enabled() else '0')
        self._child_env.setdefault('PETASTORM_TPU_TRACE',
                                   '1' if _tracing.trace_enabled() else '0')
        self._slot_generation = [0] * self.workers_count
        try:
            for slot in range(self.workers_count):
                self._workers.append(self._spawn_worker(slot, 0))
                self._hb_state[slot] = [0, time.monotonic()]
            self._await_started()
        except BaseException:
            self.stop()
            self.join()
            raise
        if ventilator is not None:
            self._ventilator = ventilator
            self._ventilator.start()

    def _make_ring(self):
        from petastorm_tpu_torch.workers.shm_ring import ShmCapacityError, ShmRing
        try:
            self._ring = ShmRing(self.workers_count, self._shm_slots_per_worker,
                                 self._shm_slot_bytes)
        except ShmCapacityError as exc:
            if self._shm_transport:
                raise
            self._shm_capacity_fallbacks += 1
            logger.warning('%s; results travel as frames over the pipes instead', exc)
        except Exception as exc:  # noqa: BLE001 - the automatic mode falls back to frames
            if self._shm_transport:
                raise
            logger.warning('shared-memory transport unavailable (%r); results travel '
                           'as frames over the pipes instead', exc)
        if self._ring is not None:
            self.ring_name = self._ring.name

    def _await_started(self):
        """Wait for every first-generation worker's ``started``."""
        deadline = time.monotonic() + _WORKER_STARTUP_TIMEOUT_S
        waiting = {worker.conn: worker for worker in self._workers}
        while waiting:
            if time.monotonic() > deadline:
                raise WorkerTerminationError(
                    'Only {} of {} workers started within {}s'.format(
                        self.workers_count - len(waiting), self.workers_count,
                        _WORKER_STARTUP_TIMEOUT_S))
            for conn in wait(list(waiting), timeout=0.2):
                worker = waiting[conn]
                message = self._recv(worker)
                if message is None:
                    raise WorkerTerminationError(
                        'Worker {} (pid {}) exited with code {} before it started'.format(
                            worker.slot, worker.process.pid, worker.process.poll()))
                if message[0] == 'started':
                    del waiting[conn]
                elif message[0] == 'ready':
                    self._ready.append(worker)

    def _spawn_worker(self, slot, generation):
        parent_end, child_end = socket.socketpair()
        bootstrap = dict(self._bootstrap, worker_id=slot, generation=generation)
        fd, path = tempfile.mkstemp(prefix='petastorm-tpu-torch-worker-')
        with os.fdopen(fd, 'wb') as f:
            pickle.dump(bootstrap, f)
        try:
            process = subprocess.Popen(
                [sys.executable, '-m', _WORKER_MODULE, path, str(child_end.fileno())],
                env=self._child_env, pass_fds=(child_end.fileno(),))
        finally:
            child_end.close()
        worker = _Worker(slot, generation, process, Connection(parent_end.detach()))
        self._conns[worker.conn] = worker
        return worker

    # ------------------------------------------------------------------ messaging

    def _send(self, worker, message):
        """Send to one worker; a dead worker's broken pipe is the liveness
        check's business."""
        try:
            with worker.send_lock:
                worker.conn.send(message)
        except OSError:
            pass

    def _recv(self, worker):
        """One message of ``worker`` with its frames, or None once its pipe is
        closed (the pipe is then dropped)."""
        try:
            message = worker.conn.recv()
            if message[0] == 'result':
                message = message + ([worker.conn.recv_bytes()
                                      for _ in range(message[2])],)
            return message
        except (EOFError, OSError):
            self._conns.pop(worker.conn, None)
            worker.conn.close()
            return None

    def _current(self, worker):
        return self._workers[worker.slot] is worker

    def ventilate(self, **kwargs):
        if self._stopped:
            raise WorkerTerminationError('Pool is stopped')
        # items are only queued here; the consumer thread hands them to workers
        # that ask for work
        blob = self._dumps(kwargs, 'a work item')
        with self._state_lock:
            token = self._next_token
            self._next_token += 1
            self._items[token] = blob
            self._pending.append(token)

    def _dispatch_pending(self):
        """Give pending items to ready workers; the flag says whether the
        result may use the ring (not while the shm breaker is open)."""
        while True:
            with self._state_lock:
                while self._pending and self._pending[0] not in self._items:
                    self._pending.popleft()   # retired while it waited to be redone
                if not self._pending or not self._ready:
                    return
                worker = self._ready.popleft()
                if not self._current(worker):
                    continue                  # a replaced worker's stale 'ready'
                token = self._pending.popleft()
                blob = self._items[token]
                self._assigned[token] = worker
                self._dispatch_time[token] = time.monotonic()
                attempt = self._attempt.setdefault(token, 0)
            shm_allowed = self._ring is not None and self._shm_breaker.allow()
            self._send(worker, ('work', token, blob, shm_allowed, attempt))

    def _release_slot(self, descriptor):
        """Give a read (or dropped) slot back to the worker that owns it."""
        worker = self._workers[descriptor.worker_slot]
        if worker.generation == descriptor.generation:
            release_start = time.perf_counter()
            self._send(worker, ('release', descriptor.ring_slot))
            if telemetry_enabled():
                self.telemetry.observe('shm_release', time.perf_counter() - release_start)

    def _handle_done(self, token, attempt):
        with self._state_lock:
            if token not in self._items or attempt != self._attempt.get(token, 0):
                # a superseded attempt's ack: only the current attempt retires
                # the item, or its redelivered result would be lost
                return
            del self._items[token]
            self._assigned.pop(token, None)
            self._dispatch_time.pop(token, None)
            self._attempt.pop(token, None)
            self._delivered.discard(token)
        if self._ventilator is not None:
            self._ventilator.processed_item()

    def _check_liveness(self):
        """Respawn dead workers while work remains (within the budget), or
        raise once it is spent. A death after all work finished is no error."""
        all_work_done = self._ventilator is not None and self._ventilator.completed()
        for worker in list(self._workers):
            if worker.process.poll() is None or all_work_done:
                continue
            if self._workers_respawned >= self._max_worker_respawns:
                self.stop()
                raise WorkerTerminationError(
                    'Worker {} (pid {}) exited with code {} while results were still '
                    'expected, and the respawn budget ({}) is exhausted'.format(
                        worker.slot, worker.process.pid, worker.process.returncode,
                        self._max_worker_respawns))
            self._respawn(worker)

    def _respawn(self, dead):
        """Replace ``dead`` and put the items it held back at the front of the
        queue (the oldest work: the consumer may be waiting on exactly these)."""
        requeued = []
        with self._state_lock:
            for token, worker in list(self._assigned.items()):
                if worker is not dead:
                    continue
                del self._assigned[token]
                self._dispatch_time.pop(token, None)
                # a new attempt: an ack the dead worker flushed cannot retire it
                reaped_attempt = self._attempt.get(token, 0)
                self._attempt[token] = reaped_attempt + 1
                self._pending.appendleft(token)
                requeued.append((self._items.get(token), reaped_attempt))
            self._slot_generation[dead.slot] += 1
            generation = self._slot_generation[dead.slot]
            self._workers_respawned += 1
            self._hb_state[dead.slot] = [0, time.monotonic()]
        logger.warning('Worker %d (pid %d) died with exit code %s mid-epoch; respawning '
                       '(%d/%d respawns used) and re-ventilating %d in-flight item(s)',
                       dead.slot, dead.process.pid, dead.process.returncode,
                       self._workers_respawned, self._max_worker_respawns, len(requeued))
        if _tracing.trace_enabled():
            # the dead worker took its unpublished events with it: this
            # instant (old attempt) and the replacement's spans (attempt + 1)
            # show the item's two lives on the merged timeline
            for blob, reaped_attempt in requeued:
                _tracing.trace_instant(
                    'worker_respawn', ctx=self._blob_trace_ctx(blob, reaped_attempt),
                    args={'worker_slot': dead.slot, 'exit_code': dead.process.returncode,
                          'new_attempt': reaped_attempt + 1})
        self._workers[dead.slot] = self._spawn_worker(dead.slot, generation)

    def set_shm_slot_config(self, slots_per_worker=None, slot_bytes=None):
        """Update the shm ring's shape, a **deferred** knob: the live ring is
        never resized under its workers, the shape applies to the next ring
        this pool makes (its ``start()``). Returns the ``(slots_per_worker,
        slot_bytes)`` now configured."""
        if slots_per_worker is not None:
            slots_per_worker = int(slots_per_worker)
            if slots_per_worker < 1:
                raise ValueError('slots_per_worker must be >= 1, got {}'
                                 .format(slots_per_worker))
            self._shm_slots_per_worker = slots_per_worker
        if slot_bytes is not None:
            slot_bytes = int(slot_bytes)
            if slot_bytes < 4096:
                raise ValueError('slot_bytes must be >= 4096, got {}'.format(slot_bytes))
            self._shm_slot_bytes = slot_bytes
        return self._shm_slots_per_worker, self._shm_slot_bytes

    def _blob_trace_ctx(self, blob, attempt):
        """The causal trace context ``(epoch, rowgroup, attempt)`` of a work
        item's pickled kwargs (anomaly paths only: the hot path never loads
        blobs), or None."""
        if blob is None:
            return None
        try:
            kwargs = self._codec.loads(blob)
        except Exception:  # noqa: BLE001 - an undecodable blob only costs the marker its context
            return None
        piece = kwargs.get('piece_index')
        if piece is None:
            return None
        return int(kwargs.get('epoch_index', 0)), int(piece), int(attempt)

    # ----------------------------------------------------------- hang watchdog

    def set_hang_result_factory(self, factory):
        """Install the deadline quarantine hook: ``factory(item_kwargs,
        elapsed_s)`` returns the stand-in delivered in place of an overdue
        item. Without it an overdue item is dispatched again."""
        self._hang_result_factory = factory

    def _heartbeat_stale_s(self, slot, now):
        """Seconds since worker ``slot``'s stamp last changed, or None when
        stamping is off; change detection is the pool's, so no clocks are
        compared across processes."""
        if not self._heartbeat_interval_s:
            return None
        state = self._hb_state.setdefault(slot, [0, now])
        if self._ring is not None:
            value = self._ring.heartbeat(slot)
            if value != state[0]:
                self._hb_state[slot] = [value, now]
                return 0.0
        return now - state[1]

    def _check_hangs(self):
        """Reap hung-but-alive workers. Runs only while the consumer is starved
        (all messages read), so staleness measures the workers."""
        if self._hang_timeout_s is None and self._item_deadline_s is None:
            return
        now = time.monotonic()
        if now < self._next_hang_check:
            return
        self._next_hang_check = now + 0.5
        with self._state_lock:
            held = collections.defaultdict(list)
            for token, worker in self._assigned.items():
                held[worker.slot].append(token)
            dispatch_time = dict(self._dispatch_time)
        for worker in list(self._workers):
            if worker.process.poll() is not None:
                continue
            stale_s = self._heartbeat_stale_s(worker.slot, now)
            tokens = held.get(worker.slot)
            if not tokens:
                continue
            heartbeat_hung = (self._hang_timeout_s is not None and stale_s is not None
                              and stale_s > self._hang_timeout_s)
            overdue = []
            if self._item_deadline_s is not None:
                overdue = [token for token in tokens
                           if now - dispatch_time.get(token, now) > self._item_deadline_s]
            if heartbeat_hung or overdue:
                self._reap_hung_worker(worker, overdue, stale_s, now, dispatch_time)

    def _reap_hung_worker(self, worker, overdue, stale_s, now, dispatch_time):
        """SIGKILL a hung worker (the death path respawns it and redoes its
        items); with a hang-result factory its overdue items are quarantined
        first, so a rowgroup that hangs workers is not dispatched again."""
        self._workers_hung_reaped += 1
        if telemetry_enabled():
            self.telemetry.inc('watchdog_reap')
        if _tracing.trace_enabled():
            # the hung worker published nothing: these instants, tagged with
            # the reaped attempts, are its footprint on the merged timeline
            reap_args = {'worker_slot': worker.slot, 'pid': worker.process.pid,
                         'stale_s': None if stale_s is None else round(stale_s, 3)}
            with self._state_lock:
                pairs = [(self._items.get(token), self._attempt.get(token, 0))
                         for token in overdue]
            for blob, attempt in pairs or [(None, 0)]:
                _tracing.trace_instant('watchdog_reap',
                                       ctx=self._blob_trace_ctx(blob, attempt),
                                       args=reap_args)
        logger.error('Worker %d (pid %d) is hung (heartbeat stale %.1fs, %d item(s) past '
                     'the %s s item deadline); reaping it (hung-reap #%d, which uses the '
                     'respawn budget)', worker.slot, worker.process.pid,
                     -1.0 if stale_s is None else stale_s, len(overdue),
                     self._item_deadline_s, self._workers_hung_reaped)
        if self._hang_result_factory is not None:
            for token in overdue:
                with self._state_lock:
                    blob = self._items.pop(token, None)
                    self._assigned.pop(token, None)
                    self._dispatch_time.pop(token, None)
                    self._attempt.pop(token, None)
                if blob is None:
                    continue
                elapsed = now - dispatch_time.get(token, now)
                self._hang_results.append(
                    self._hang_result_factory(self._codec.loads(blob), elapsed))
                # retired as a 'done' would retire it
                if self._ventilator is not None:
                    self._ventilator.processed_item()
        worker.process.kill()

    # ------------------------------------------------------------------ results

    def get_results(self, timeout=None):
        """The next result. Raises EmptyResultError once all ventilated work is
        done, or once the pool was stopped (a consumer still waiting returns);
        re-raises a worker's exception."""
        if self._stopped:
            # a stopped pool answers at once: join() drains the pipes without
            # the lock, so a consumer never waits out its drain
            raise EmptyResultError()
        with self._recv_lock:
            return self._get_result(timeout)  # pipecheck: disable=lock-discipline -- one receiver at a time by design: the lock serializes the consumers' pipe reads, each wait is a 0.1 s poll that rechecks the stop, and join() never holds it while it blocks

    def _get_result(self, timeout):
        deadline = None if timeout is None else time.monotonic() + timeout
        wait_start = time.perf_counter()
        while True:
            if self._stopped:
                raise EmptyResultError()
            if self._hang_results:
                return self._hang_results.popleft()
            now = time.monotonic()
            if now >= self._next_liveness_check:
                # on the hot path too: survivors keep producing while a dead
                # worker's items would otherwise vanish
                self._next_liveness_check = now + 0.1
                self._check_liveness()
            self._dispatch_pending()
            conns = list(self._conns)
            ready = wait(conns, timeout=0.1) if conns else []
            if not ready:
                self._check_hangs()
                if self._hang_results:
                    continue
                if self._ventilator is not None and self._ventilator.error is not None:
                    self.stop()
                    raise self._ventilator.error
                if self._ventilator is not None and self._ventilator.completed():
                    raise EmptyResultError()
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutWaitingForResultError()
                if not conns:
                    time.sleep(0.1)
                continue
            for conn in ready:
                worker = self._conns.get(conn)
                if worker is None:
                    continue
                message = self._recv(worker)
                if message is None:
                    continue
                result = self._handle(worker, message)
                if result is not None:
                    if telemetry_enabled():
                        self.telemetry.observe('pool_wait', time.perf_counter() - wait_start)
                    return result[0]

    def _handle(self, worker, message):
        """One message; returns ``(result,)`` to deliver, else None."""
        kind = message[0]
        if kind == 'ready':
            if self._current(worker):
                with self._state_lock:
                    self._ready.append(worker)
            return None
        if kind == 'heartbeat':
            state = self._hb_state.get(worker.slot)
            if self._current(worker) and (state is None or state[0] != message[1]):
                self._hb_state[worker.slot] = [message[1], time.monotonic()]
            return None
        if kind == 'done':
            self._handle_done(message[1], message[2])
            return None
        if kind == 'error':
            exc, text = pickle.loads(message[2])
            logger.error('Worker failure re-raised in consumer:\n%s', text)
            self.stop()
            raise exc
        if kind == 'result':
            return self._handle_frames(message[1], message[3])
        if kind == 'result_shm':
            return self._handle_shm_result(message[1], message[2])
        return None   # 'started': a respawned worker joining

    def _handle_frames(self, token, frames):
        frame_bytes = sum(len(frame) for frame in frames)
        with self._state_lock:
            self._wire_batches += 1
            self._pipe_result_bytes += frame_bytes
            shm_fallback = self._ring is not None
            if shm_fallback:
                self._shm_fallback_batches += 1
            if token not in self._items or token in self._delivered:
                self._results_dropped += 1
                return None
            self._delivered.add(token)
        if shm_fallback and _tracing.trace_enabled():
            # anomaly marker: this result rode the pipe though the ring is on
            # (oversized, slot-starved, or the shm breaker open)
            _tracing.trace_instant('shm_fallback', args={'token': token})
        copied_before = self._serializer.stats['bytes_copied']
        result = self._serializer.deserialize(frames)
        if telemetry_enabled():
            # bytes copied into new host memory for THIS batch: the frames
            # plus the serializer's copies on receive
            self.telemetry.observe(
                'wire_bytes_copied',
                frame_bytes + self._serializer.stats['bytes_copied'] - copied_before,
                unit=BYTES_UNIT)
        return (result,)

    def _handle_shm_result(self, token, blob):
        """Check the descriptor's generation, drop a duplicate, check the CRC,
        copy the result out of the slot and release the slot."""
        from petastorm_tpu_torch.workers.integrity import payload_checksum
        from petastorm_tpu_torch.workers.shm_ring import ShmSlotDescriptor
        descriptor = ShmSlotDescriptor.from_bytes(blob)
        with self._state_lock:
            self._wire_batches += 1
            self._pipe_result_bytes += len(blob)
            if self._slot_generation[descriptor.worker_slot] != descriptor.generation:
                # written by a worker since replaced, which may be reusing the
                # slot: never read it (its item is being redone)
                self._shm_stale_drops += 1
                return None
            duplicate = token not in self._items or token in self._delivered
            if duplicate:
                self._results_dropped += 1
        if duplicate or self._ring is None:
            self._release_slot(descriptor)
            return None
        map_start = time.perf_counter()
        copied_before = self._serializer.stats['bytes_copied']
        views = self._ring.view(descriptor)
        try:
            if descriptor.crc is not None and payload_checksum(views) != descriptor.crc:
                self._on_shm_corruption(descriptor, token)
                return None
            with self._state_lock:
                self._delivered.add(token)
                self._shm_batches += 1
                self._shm_bytes_mapped += descriptor.total_bytes
                attempt = self._attempt.get(token, 0)
            result = self._serializer.deserialize(views)
            self._shm_breaker.record_success()
            map_s = time.perf_counter() - map_start
            if _tracing.trace_enabled():
                # the consumer-side leg of the rowgroup's trace, tagged with
                # the delivered batch's (epoch, rowgroup, attempt)
                item_id = getattr(result, 'item_id', None)
                ctx = (None if item_id is None
                       else (int(item_id[0]), int(item_id[1]), attempt))
                _tracing.trace_complete('shm_map', map_start, map_s, ctx=ctx)
            if telemetry_enabled():
                # shm_map: slot view + CRC check + deserialize; copied bytes:
                # the descriptor plus the serializer's copies on receive
                self.telemetry.observe('shm_map', map_s)
                self.telemetry.observe(
                    'wire_bytes_copied',
                    len(blob) + self._serializer.stats['bytes_copied'] - copied_before,
                    unit=BYTES_UNIT)
        finally:
            # the result is a copy: no view outlives this call, and the slot
            # goes back to its worker (not after a CRC failure: that worker is
            # being killed, and its replacement starts with every slot free)
            for view in views:
                view.release()
        self._release_slot(descriptor)
        return (result,)

    def _on_shm_corruption(self, descriptor, token):
        """A slot failed its CRC: drop it unread, invalidate the producer's ack
        of the item, kill the producer (the death path redoes its items) and
        count a failure on the shm breaker."""
        with self._state_lock:
            self._shm_crc_failures += 1
            reaped_attempt = self._attempt.get(token, 0)
            self._attempt[token] = reaped_attempt + 1
            blob = self._items.get(token)
        if telemetry_enabled():
            self.telemetry.inc('shm_crc_fail')
        if _tracing.trace_enabled():
            _tracing.trace_instant('shm_crc_drop',
                                   ctx=self._blob_trace_ctx(blob, reaped_attempt),
                                   args={'worker_slot': descriptor.worker_slot,
                                         'ring_slot': descriptor.ring_slot, 'token': token})
        self._shm_breaker.record_failure()
        logger.error('shm frame from worker %d (ring slot %d, token %d) failed its CRC '
                     '(#%d); dropping it unread, reaping the worker (shm breaker %r)',
                     descriptor.worker_slot, descriptor.ring_slot, token,
                     self._shm_crc_failures, self._shm_breaker.state)
        worker = self._workers[descriptor.worker_slot]
        if worker.generation == descriptor.generation and worker.process.poll() is None:
            worker.process.kill()

    # ----------------------------------------------------------------- shutdown

    def stop(self):
        if self._stopped:
            return
        self._stopped = True
        if self._ventilator is not None:
            self._ventilator.stop()
        for worker in self._workers:
            self._send(worker, ('stop',))

    def join(self):
        if not self._stopped:
            raise RuntimeError('join() must be preceded by stop()')
        # a consumer inside _get_result sees the stop within one 0.1 s poll and
        # leaves, and none enters once the pool is stopped: after taking the
        # lock once, the drain owns the pipes and blocks without it
        with self._recv_lock:
            conns = dict(self._conns)
        self._drain_until_exit(time.monotonic() + 10, conns)
        for conn in conns:
            conn.close()
        self._conns.clear()
        for worker in self._workers:
            if worker.process.poll() is None:
                logger.warning('Worker %d (pid %d) did not exit within 10s of stop(); '
                               'sending SIGKILL', worker.slot, worker.process.pid)
                worker.process.kill()
                try:
                    worker.process.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    logger.error('Worker %d (pid %d) is unreaped after SIGKILL',
                                 worker.slot, worker.process.pid)
        # after every worker is gone: no segment outlives the pool
        if self._ring is not None:
            self._ring.close_and_unlink()
            self._ring = None

    def _drain_until_exit(self, deadline, by_conn):
        """Wait for the workers to exit, reading their pipes (``by_conn``,
        pipe -> worker) meanwhile: a worker blocked on a full pipe or waiting
        for a slot release can then finish, see the stop and exit."""
        from petastorm_tpu_torch.workers.shm_ring import ShmSlotDescriptor
        while any(worker.process.poll() is None for worker in self._workers):
            if time.monotonic() >= deadline:
                return
            # _recv closes a pipe at its EOF
            by_conn = {conn: worker for conn, worker in by_conn.items() if not conn.closed}
            for conn in wait(list(by_conn), timeout=0.2) if by_conn else ():
                message = self._recv(by_conn[conn])
                if message is not None and message[0] == 'result_shm':
                    descriptor = ShmSlotDescriptor.from_bytes(message[2])
                    if self._ring is not None:
                        self._release_slot(descriptor)
            if not by_conn:
                time.sleep(0.05)

    # ------------------------------------------------------------------ introspection

    @property
    def processes(self):
        """The current workers' ``subprocess.Popen`` handles, by slot."""
        return [worker.process for worker in self._workers]

    @property
    def diagnostics(self):
        with self._state_lock:
            wire_batches = self._wire_batches
            bytes_copied = self._pipe_result_bytes + self._serializer.stats['bytes_copied']
            return {
                'workers_alive': sum(1 for w in self._workers if w.process.poll() is None),
                'workers_respawned': self._workers_respawned,
                'workers_hung_reaped': self._workers_hung_reaped,
                'results_dropped': self._results_dropped,
                'in_flight_items': len(self._items),
                'shm_enabled': self._ring is not None,
                'shm_capacity_fallbacks': self._shm_capacity_fallbacks,
                'shm_batches': self._shm_batches,
                'shm_fallback_batches': self._shm_fallback_batches,
                'shm_stale_drops': self._shm_stale_drops,
                'shm_crc_failures': self._shm_crc_failures,
                'shm_bytes_mapped': self._shm_bytes_mapped,
                'shm_breaker': self._shm_breaker.as_dict(),
                'pipe_result_bytes': self._pipe_result_bytes,
                'wire_batches': wire_batches,
                # bytes copied into new host memory: what crossed the pipes,
                # plus the serializer's copies on receive
                'wire_bytes_copied': bytes_copied,
                'wire_bytes_copied_per_batch':
                    round(bytes_copied / wire_batches, 1) if wire_batches else 0.0,
            }
