"""Client transport for the disaggregated input service: the ``ServicePool``.
A copy of ``petastorm_tpu.service.service_client`` whose user objects go by
``dill`` where it imports, else by ``pickle``, as the process pool's do.

:class:`ServicePool` implements the pool interface the port's reader calls
(``start`` / ``ventilate`` / ``get_results`` / ``stop`` / ``join`` /
``diagnostics`` / ``workers_count`` / ``telemetry`` / ``check_picklable`` /
``set_cost_hint_fn``), so the ``Reader`` runtime — ``on_error`` modes, the
quarantine ledger, telemetry and trace sidecars, checkpoint accounting —
works unchanged when ``make_reader`` points at a ``service_url`` instead of
building a pool in this process: the same call, a different placement.

Transport: one DEALER socket to the dispatcher's client ROUTER, driven
entirely from the consumer thread (``ventilate`` only enqueues locally — ZMQ
sockets are not thread-safe). The client:

- ``hello``s at construction (learns the fleet size and its admission
  window; an unreachable dispatcher raises
  :class:`~petastorm_tpu_torch.errors.TransientIOError` immediately);
- ``open``s its pickled worker setup once per reader at ``start``;
- ``submit``s work items up to its admission window, honoring explicit
  ``busy`` rejections with a short backoff (the dispatcher's admission
  control is the real backpressure — the client never spins on it);
- receives ``result`` frames (the shared wire codec deserializes them — all
  batch sidecars arrive intact) or ``result_shm`` descriptors on the
  co-located fast path (map, CRC-verify, copy out, unlink; an unattachable
  or corrupt segment triggers a counted ``shm_fail`` redelivery request
  instead of a lost row);
- re-arms submits that the dispatcher never acknowledged and records the
  failures on a transport :class:`~petastorm_tpu_torch.resilience.CircuitBreaker`
  — a dead dispatcher fails the read loudly once the breaker opens, instead
  of hanging forever.

Worker failures ride back as pickled ``(exception, traceback)`` and re-raise
in the consumer, exactly like the process pool's. A worker SIGKILLed
mid-item is reaped by the dispatcher's heartbeat watchdog, which re-queues
the worker's items and a fresh result arrives on the same token (duplicate
results are dropped dispatcher-side, stale acks cannot retire redeliveries —
the process pool's protocol, across the network)."""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
import uuid
from typing import Any, Deque, Dict, List, Optional, Set, Tuple

from petastorm_tpu_torch.errors import TransientIOError
from petastorm_tpu_torch.service.wire import (ShmResultDescriptor, client_endpoint,
                                        encode_cost, host_token)
from petastorm_tpu_torch.telemetry.registry import (MetricsRegistry,
                                              telemetry_enabled)
from petastorm_tpu_torch.workers import EmptyResultError, TimeoutWaitingForResultError
from petastorm_tpu_torch.workers.process_pool import _codec, _unpicklable_part

logger = logging.getLogger(__name__)

#: how long the constructor waits for the dispatcher's ``welcome``
DEFAULT_CONNECT_TIMEOUT_S = 5.0
#: an unacknowledged ``submit`` older than this is re-armed and counts a
#: transport-breaker failure
DEFAULT_RESPONSE_TIMEOUT_S = 10.0
#: pause after a ``busy`` rejection before the next submit attempt
BUSY_BACKOFF_S = 0.05
#: transport breaker: consecutive unacknowledged requests before the read
#: fails fast, and the cooldown before a retry probe
TRANSPORT_BREAKER_THRESHOLD = 3
TRANSPORT_BREAKER_RECOVERY_S = 30.0
#: env override for the response timeout (chaos harness / tests shrink it
#: so dispatcher-crash recovery is detected in seconds, not the 10s default)
RESPONSE_TIMEOUT_ENV = 'PETASTORM_TPU_SERVICE_RESPONSE_TIMEOUT_S'


def fetch_service_state(service_url: str,
                        timeout_s: float = 2.0) -> Dict[str, Any]:
    """One ``state`` request/reply against a dispatcher: the scheduler
    snapshot (clients, workers, queue depths, fair-share debts). Raises
    :class:`TransientIOError` when the service does not answer in time —
    doctor turns that into its unreachable WARNING.

    A HALF-UP dispatcher — socket bound, pump not started yet (the
    start-sequence window, or a wedged pump thread) — accepts the TCP
    connection but answers nothing. Instead of blocking the full timeout,
    an anonymous ``hello`` probe rides behind the ``state`` request after a
    short grace; if the TCP link is up but both stay unanswered at the
    deadline, the caller gets ``{'state': 'starting'}`` rather than an
    exception (doctor renders that as a starting service, not a dead
    one)."""
    import zmq
    context = zmq.Context()
    socket = context.socket(zmq.DEALER)
    socket.setsockopt(zmq.LINGER, 0)
    monitor = socket.get_monitor_socket(
        zmq.EVENT_CONNECTED | zmq.EVENT_CONNECT_DELAYED
        | zmq.EVENT_CONNECT_RETRIED)
    connected = False
    probe_sent = False
    try:
        socket.connect(client_endpoint(service_url))
        socket.send_multipart([b'state'])
        deadline = time.monotonic() + timeout_s
        probe_at = time.monotonic() + min(0.5, timeout_s / 2.0)
        while time.monotonic() < deadline:
            if not connected and monitor.poll(0, zmq.POLLIN):
                event = monitor.recv_multipart()
                if int.from_bytes(event[0][:2], 'little') \
                        == zmq.EVENT_CONNECTED:
                    connected = True
            if connected and not probe_sent \
                    and time.monotonic() >= probe_at:
                # cheap liveness probe: an empty-name hello is answered
                # without registering a client (dispatcher probe path)
                socket.send_multipart([b'hello', b'',
                                       host_token().encode('utf-8'), b'0'])
                probe_sent = True
            if not socket.poll(50, zmq.POLLIN):
                continue
            frames = socket.recv_multipart()
            kind = frames[0]
            if kind == b'state' and len(frames) >= 2:
                out = json.loads(frames[1].decode('utf-8'))
                assert isinstance(out, dict)
                return out
            if kind == b'welcome':
                # the probe answered but state has not: keep waiting for it
                continue
        if connected:
            return {'state': 'starting', 'service_url': service_url}
        raise TransientIOError(
            'input service at {} did not answer a state request within {}s'
            .format(service_url, timeout_s))
    finally:
        try:
            socket.disable_monitor()
        except Exception:  # noqa: BLE001 - monitor teardown is best-effort across pyzmq versions
            pass
        monitor.close(linger=0)
        socket.close(linger=0)
        context.term()


class ServicePool(object):
    """Pool-interface adapter over the service dispatcher (module docstring).

    Build one per reader — ``make_reader(..., service_url=...)`` does — and
    use it exactly like a
    :class:`~petastorm_tpu_torch.workers.process_pool.ProcessPool`.
    ``window`` caps this client's in-flight items (the dispatcher clamps it
    to its own admission window); ``payload_serializer`` must match what the
    service workers publish with (the default
    :class:`~petastorm_tpu_torch.workers.serializers.ArrowIpcSerializer` — it
    is shipped to the workers inside the ``open`` blob, so they always
    agree)."""

    def __init__(self, service_url: str, window: Optional[int] = None,
                 payload_serializer: Any = None, client_name: Optional[str] = None,
                 connect_timeout_s: float = DEFAULT_CONNECT_TIMEOUT_S,
                 response_timeout_s: float = DEFAULT_RESPONSE_TIMEOUT_S,
                 breaker: Any = None) -> None:
        from petastorm_tpu_torch.resilience import default_board
        from petastorm_tpu_torch.workers.serializers import ArrowIpcSerializer
        self.service_url = service_url
        self._serializer = (payload_serializer if payload_serializer is not None
                            else ArrowIpcSerializer())
        self._client_name = client_name or 'reader-{}-{}'.format(
            os.getpid(), uuid.uuid4().hex[:6])
        env_timeout = os.environ.get(RESPONSE_TIMEOUT_ENV)
        if env_timeout:
            try:
                response_timeout_s = float(env_timeout)
            except ValueError:
                logger.warning('ignoring non-numeric %s=%r',
                               RESPONSE_TIMEOUT_ENV, env_timeout)
        self._response_timeout_s = response_timeout_s
        # On the process-global board (not instance-owned like the pool's shm
        # breaker): its tripped state then rides the existing breakers
        # plumbing into Reader.diagnostics['breakers'] and doctor's
        # resilience block with zero extra wiring.
        self._breaker = breaker if breaker is not None else \
            default_board().breaker(
                'service:{}'.format(service_url),
                failure_threshold=TRANSPORT_BREAKER_THRESHOLD,
                recovery_timeout_s=TRANSPORT_BREAKER_RECOVERY_S)
        self.telemetry = MetricsRegistry()
        self._codec_name, self._codec = _codec()
        self._lock = threading.Lock()
        self._ventilator: Any = None
        self._stopped = False
        self._setup_id = uuid.uuid4().hex.encode('ascii')
        self._setup_opened = False
        #: kept for ``rejoin``: a restarted (or TTL-collecting) dispatcher
        #: lost our registration and setup — we re-``hello``/``open`` from
        #: these and resubmit, so an epoch survives a dispatcher restart
        self._open_blob: Optional[bytes] = None
        self._hello_window = window or 0
        self._last_rejoin = 0.0
        self._next_token = 0
        #: token -> pickled kwargs; kept until the result is delivered so the
        #: item can be re-armed after transport failures
        self._items: Dict[int, bytes] = {}
        #: optional measured-cost pricer installed by a cost-scheduled reader
        #: (the reader's cost scheduler); None => submits
        #: carry no cost frame, the dispatcher charges the uniform unit
        self._cost_hint_fn: Optional[Any] = None
        #: token -> cost hint, dropped with the item
        self._item_costs: Dict[int, float] = {}
        self._pending: Deque[int] = collections.deque()
        #: tokens submitted and not yet resolved by a result
        self._inflight: Set[int] = set()
        #: token -> deadline for the dispatcher's accept/busy ack
        self._await_ack: Dict[int, float] = {}
        self._busy_until = 0.0
        #: reply-starvation watchdog (see ``_check_starvation``): when the
        #: dispatcher goes silent while we hold in-flight work, probe it,
        #: then re-arm the in-flight items and record a breaker failure
        self._last_reply = time.monotonic()
        self._starvation_probe_sent = False
        # ------------------------------------------------------- counters
        self._busy_rejections = 0
        self._results_dropped = 0
        self._resubmitted = 0
        self._shm_batches = 0
        self._wire_batches = 0
        self._shm_result_bytes = 0
        self._wire_result_bytes = 0
        self._unacked_timeouts = 0
        self._starvation_resubmits = 0
        self._rejoins = 0
        #: ledger-epoch handshake state: the epoch the dispatcher reported at
        #: welcome; a ``ledger_state`` reply with a DIFFERENT epoch (or known=False)
        #: means our in-flight tokens died with a previous incarnation
        self._ledger_epoch: Optional[int] = None
        self._ledger_rearms = 0

        import zmq
        self._context = zmq.Context()
        self._socket = self._context.socket(zmq.DEALER)
        self._socket.setsockopt(zmq.LINGER, 0)
        self._socket.connect(client_endpoint(service_url))
        self._socket.send_multipart([
            b'hello', self._client_name.encode('utf-8'),
            host_token().encode('utf-8'), b'%d' % (window or 0)])
        welcome = self._await_reply(b'welcome', connect_timeout_s)
        if welcome is None:
            self._socket.close(linger=0)
            self._context.term()
            raise TransientIOError(
                'input service at {} did not answer hello within {}s — is '
                'the dispatcher running?'.format(service_url,
                                                 connect_timeout_s))
        body = json.loads(welcome[1].decode('utf-8'))
        self._window = int(body['window'])
        if 'ledger_epoch' in body:
            self._ledger_epoch = int(body['ledger_epoch'])
        #: registered decode workers at hello time (fleet may grow/shrink);
        #: the Reader sizes its in-flight ventilation window from this
        self.workers_count = max(1, int(body['workers']))

    # ------------------------------------------------------------ messaging

    def _learn_window(self, window: int) -> None:
        """Adopt the dispatcher-side window piggybacked on accept/busy
        replies: the service autotuner retunes per-client windows live, and
        without re-learning it a raised window could never admit more
        in-flight work from this client (nor a lowered one end the busy churn
        before the next hello). Consumer
        thread only, like every other socket-path mutation here."""
        if window > 0 and window != self._window:
            self._window = window

    def _await_reply(self, expected_kind: bytes,
                     timeout_s: float) -> Optional[List[bytes]]:
        """Wait for one message of ``expected_kind`` (construction/start
        handshakes only — anything else arriving this early is dropped)."""
        import zmq
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if not self._socket.poll(100, zmq.POLLIN):
                continue
            frames = self._socket.recv_multipart()
            kind = frames[0]
            if kind == expected_kind:
                return frames
        return None

    # ------------------------------------------------------------ lifecycle

    def _dumps(self, obj: Any, what: str) -> bytes:
        """Pickle a user object for the fleet's workers; one that does not
        pickle raises here, named."""
        try:
            blob: bytes = self._codec.dumps(obj)
            return blob
        except Exception as exc:  # noqa: BLE001 - re-raised with the culprit named
            path, culprit = _unpicklable_part(obj, what, self._codec.dumps)
            raise TypeError(
                'service_url sends {} to the service\'s workers, but {} = {!r} '
                'does not pickle with {} ({}: {}); use a module-level function{}'
                .format(what, path, culprit, self._codec_name,
                        type(exc).__name__, exc,
                        ' or install dill' if self._codec_name == 'pickle'
                        else '')) from exc

    def check_picklable(self, obj: Any, what: str) -> None:
        """Raise now, naming ``obj``, if it cannot reach the workers (the
        reader checks the predicate every work item carries)."""
        self._dumps(obj, what)

    def start(self, worker_class: Any, worker_args: Any = None,
              ventilator: Any = None) -> None:
        """Ship the pickled worker setup (``open``) and start the ventilator.
        No processes are spawned — the fleet already runs server-side. A
        setup that does not pickle raises here, named."""
        import pickle
        blob = pickle.dumps({
            'codec': self._codec_name,
            'worker_class': self._dumps(worker_class, 'the worker class'),
            'worker_args': self._dumps(worker_args, 'worker_args'),
            'serializer': self._dumps(self._serializer, 'the payload serializer')})
        self._open_blob = blob
        self._socket.send_multipart([b'open', self._setup_id, blob])
        if self._await_reply(b'opened', self._response_timeout_s) is None:
            raise TransientIOError(
                'input service at {} did not acknowledge the worker setup '
                'within {}s'.format(self.service_url,
                                    self._response_timeout_s))
        self._setup_opened = True
        if ventilator is not None:
            self._ventilator = ventilator
            self._ventilator.start()

    def set_cost_hint_fn(self, fn: Any) -> None:
        """Install the reader's cost pricer: ``fn(item_kwargs) -> float``
        (median-relative measured cost). Every later submit ships the hint
        so the dispatcher's DRR charges real cost and routes heavy items
        least-loaded. Call before ``start`` — pricing is read on the
        ventilation path."""
        self._cost_hint_fn = fn

    def ventilate(self, **kwargs: Any) -> None:
        """Enqueue one work item locally; the consumer thread submits it to
        the dispatcher inside ``get_results`` (single-threaded socket use)."""
        if self._stopped:
            raise RuntimeError('ServicePool is stopped')
        blob = self._dumps(kwargs, 'a work item')
        cost: Optional[float] = None
        if self._cost_hint_fn is not None:
            try:
                cost = float(self._cost_hint_fn(kwargs))
            except Exception:  # noqa: BLE001 - a broken pricer must not drop the work item; it just rides uncosted
                logger.warning('cost hint fn failed for piece %r; submitting '
                               'uncosted', kwargs.get('piece_index'),
                               exc_info=True)
                cost = None
        with self._lock:
            token = self._next_token
            self._next_token += 1
            self._items[token] = blob
            if cost is not None:
                self._item_costs[token] = cost
            self._pending.append(token)

    # -------------------------------------------------------------- submits

    def _flush_submits(self) -> None:
        """Send pending items up to the admission window (consumer thread).
        A ``busy`` backoff pauses all submits briefly — the dispatcher told
        us the window is full, so hammering it only burns cycles."""
        now = time.monotonic()
        if now < self._busy_until:
            return
        while True:
            with self._lock:
                if not self._pending:
                    return
                if len(self._inflight) >= self._window:
                    return
                token = self._pending.popleft()
                blob = self._items.get(token)
                if blob is None:
                    continue
                self._inflight.add(token)
                self._await_ack[token] = now + self._response_timeout_s
                cost = self._item_costs.get(token)
            frames = [b'submit', b'%d' % token, self._setup_id, blob]
            if cost is not None:
                frames.append(encode_cost(cost))
            self._socket.send_multipart(frames)

    def _check_unacked(self) -> None:
        """Re-arm submits the dispatcher never acknowledged and record the
        failure on the transport breaker; an open breaker fails the read
        fast instead of waiting out a dead dispatcher forever."""
        now = time.monotonic()
        overdue = []
        with self._lock:
            for token, deadline in list(self._await_ack.items()):
                if now > deadline:
                    overdue.append(token)
                    del self._await_ack[token]
                    self._inflight.discard(token)
                    if token in self._items:
                        self._pending.appendleft(token)
        for _ in overdue:
            self._unacked_timeouts += 1
            self._breaker.record_failure()
        if overdue and not self._breaker.allow():
            raise TransientIOError(
                'input service at {} stopped acknowledging submissions '
                '({} unacknowledged); transport breaker is {}'.format(
                    self.service_url, len(overdue), self._breaker.state))

    def _rearm_inflight(self) -> None:
        """Re-pend every in-flight token (front of the queue, ventilation
        order preserved). The dispatcher restart / starvation paths call
        this when those tokens died with a previous dispatcher incarnation;
        a straggler result for an old token is dropped by the token dedup
        on whichever side sees it first, so re-arming is duplicate-safe."""
        with self._lock:
            for token in sorted(self._inflight, reverse=True):
                if token in self._items:
                    self._pending.appendleft(token)
            self._inflight.clear()
            self._await_ack.clear()

    def _check_starvation(self) -> None:
        """Dead-dispatcher detector for the post-accept phase: submit acks
        alone cannot see a dispatcher that died (or restarted) AFTER
        accepting our window. When nothing at all has arrived for one
        response window while we hold in-flight work, send a ``ledger_sync``
        probe — a RESTARTED dispatcher's ``ledger_state`` reply says it does
        not know us (or serves a new ledger epoch) and triggers the precise
        re-arm in ``get_results``, while a merely-slow dispatcher's reply
        resets the clock. After a second fully-silent window (a DEAD
        dispatcher answers nothing, not even the probe), assume the
        in-flight items are lost: re-arm them (duplicates are dropped
        server-side), record a transport-breaker failure, and fail the read
        fast once the breaker opens."""
        with self._lock:
            inflight = len(self._inflight)
        if not inflight:
            self._starvation_probe_sent = False
            return
        now = time.monotonic()
        silent = now - self._last_reply
        if silent <= self._response_timeout_s:
            return
        if not self._starvation_probe_sent:
            self._socket.send_multipart([b'ledger_sync'])
            self._starvation_probe_sent = True
            return
        if silent <= 2 * self._response_timeout_s:
            return
        self._rearm_inflight()
        self._starvation_resubmits += 1
        self._starvation_probe_sent = False
        self._last_reply = now
        self._breaker.record_failure()
        if not self._breaker.allow():
            raise TransientIOError(
                'input service at {} went silent with {} item(s) in flight; '
                'transport breaker is {}'.format(self.service_url, inflight,
                                                 self._breaker.state))

    # -------------------------------------------------------------- results

    def get_results(self, timeout: Optional[float] = None) -> Any:
        """Next result batch; raises ``EmptyResultError`` when all ventilated
        work completed, re-raises worker exceptions shipped over the wire."""
        import zmq
        deadline = None if timeout is None else time.monotonic() + timeout
        wait_start = time.perf_counter()
        while True:
            if self._stopped:
                raise RuntimeError('ServicePool is stopped')
            self._flush_submits()
            if not self._socket.poll(100, zmq.POLLIN):
                self._check_unacked()
                self._check_starvation()
                if self._ventilator is not None and getattr(
                        self._ventilator, 'error', None):
                    self.stop()
                    raise self._ventilator.error
                with self._lock:
                    drained = (not self._pending and not self._inflight)
                if drained and self._ventilator is not None \
                        and self._ventilator.completed():
                    raise EmptyResultError()
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutWaitingForResultError()
                continue
            frames = self._socket.recv_multipart()
            kind = frames[0]
            self._last_reply = time.monotonic()
            self._starvation_probe_sent = False
            if kind == b'accept':
                with self._lock:
                    self._await_ack.pop(int(bytes(frames[1])), None)
                if len(frames) >= 3:
                    self._learn_window(int(bytes(frames[2])))
                self._breaker.record_success()
                continue
            if kind == b'busy':
                token = int(bytes(frames[1]))
                with self._lock:
                    self._await_ack.pop(token, None)
                    self._inflight.discard(token)
                    if token in self._items:
                        self._pending.appendleft(token)
                if len(frames) >= 3:
                    self._learn_window(int(bytes(frames[2])))
                self._busy_until = time.monotonic() + BUSY_BACKOFF_S
                self._busy_rejections += 1
                if telemetry_enabled():
                    self.telemetry.inc('service_busy')
                continue
            if kind == b'rejoin':
                # the dispatcher does not know us (restart / TTL collection).
                # A dispatcher that does not know us cannot hold ANY of our
                # tokens (TTL collection requires an empty in-flight set;
                # a restart lost them all) — re-arm every in-flight item,
                # not just the bounced one, then re-hello + re-open before
                # the resubmits flush
                self._rearm_inflight()
                self._rejoin()
                continue
            if kind == b'ledger_state' and len(frames) >= 2:
                # ledger-epoch handshake reply (our starvation probe): a
                # dispatcher that does not know us, or one serving a new
                # ledger epoch, is a fresh incarnation — its predecessor
                # took our in-flight tokens with it
                body = json.loads(frames[1].decode('utf-8'))
                epoch = body.get('epoch')
                restarted = (not body.get('known')
                             or (self._ledger_epoch is not None
                                 and epoch != self._ledger_epoch))
                if epoch is not None:
                    self._ledger_epoch = int(epoch)
                if restarted:
                    self._ledger_rearms += 1
                    self._rearm_inflight()
                    self._rejoin()
                continue
            if kind == b'result':
                result = self._handle_result(int(bytes(frames[1])),
                                             frames[2:])
                if result is None:
                    continue
                if telemetry_enabled():
                    self.telemetry.observe('pool_wait',
                                           time.perf_counter() - wait_start)
                return result[0]
            if kind == b'result_shm':
                result = self._handle_shm_result(int(bytes(frames[1])),
                                                 frames[2])
                if result is None:
                    continue
                if telemetry_enabled():
                    self.telemetry.observe('pool_wait',
                                           time.perf_counter() - wait_start)
                return result[0]
            if kind == b'error':
                import pickle
                exc, tb = pickle.loads(frames[2])
                logger.error('Service worker failure re-raised in consumer:'
                             '\n%s', tb)
                self.stop()
                raise exc
            # welcome/opened/state stragglers from handshake retries: ignore
            # (but adopt a straggler welcome's ledger epoch — it is the
            # freshest statement of which dispatcher incarnation we talk to)
            if kind == b'welcome' or kind == b'opened' or kind == b'state':
                if kind == b'welcome' and len(frames) >= 2:
                    try:
                        body = json.loads(frames[1].decode('utf-8'))
                        if 'ledger_epoch' in body:
                            self._ledger_epoch = int(body['ledger_epoch'])
                    except (ValueError, KeyError):
                        pass
                continue

    def _resolve_token(self, token: int) -> bool:
        """Retire a token on result delivery; False = duplicate, drop it."""
        with self._lock:
            if token not in self._items:
                self._results_dropped += 1
                return False
            del self._items[token]
            self._item_costs.pop(token, None)
            self._inflight.discard(token)
            self._await_ack.pop(token, None)
        if self._ventilator is not None:
            self._ventilator.processed_item()
        return True

    def _handle_result(self, token: int,
                       payload: List[bytes]) -> Optional[Tuple[Any]]:
        if not self._resolve_token(token):
            return None
        self._wire_batches += 1
        self._wire_result_bytes += sum(memoryview(frame).nbytes for frame in payload)
        self._breaker.record_success()
        return (self._serializer.deserialize(payload),)

    def _handle_shm_result(self, token: int,
                           descriptor_blob: bytes) -> Optional[Tuple[Any]]:
        """Co-located fast path: map the one-shot segment, CRC-verify, copy
        out during deserialize, unlink. Failure to attach or verify requests
        a redelivery (``shm_fail``) — a lost segment is never a lost row."""
        descriptor = ShmResultDescriptor.from_bytes(descriptor_blob)
        from multiprocessing import shared_memory
        try:
            segment = shared_memory.SharedMemory(name=descriptor.name)
        except (FileNotFoundError, OSError):
            logger.warning('could not attach one-shot shm segment %s; '
                           'requesting redelivery', descriptor.name)
            self._request_redelivery(token)
            return None
        views: List[memoryview] = []
        buf: Optional[memoryview] = None
        try:
            buf = memoryview(segment.buf)
            offset = 0
            for length in descriptor.frame_lengths:
                views.append(buf[offset:offset + length])
                offset += length
            if descriptor.crc is not None:
                from petastorm_tpu_torch.workers.integrity import payload_checksum
                if payload_checksum(views) != descriptor.crc:
                    logger.error('one-shot shm segment %s failed CRC '
                                 'verification; requesting redelivery',
                                 descriptor.name)
                    self._request_redelivery(token)
                    return None
            if not self._resolve_token(token):
                return None
            result = self._serializer.deserialize(views)
            self._shm_batches += 1
            self._shm_result_bytes += descriptor.total_bytes
            self._breaker.record_success()
            return (result,)
        finally:
            # writable-receive contract (serializers.ArrowIpcSerializer):
            # nothing may keep aliasing the segment after deserialize, so
            # every view releases before the close + unlink
            for view in views:
                try:
                    view.release()
                except BufferError:  # pragma: no cover - a consumer kept a ref
                    pass
            if buf is not None:
                try:
                    buf.release()
                except BufferError:  # pragma: no cover
                    pass
            segment.close()
            try:
                segment.unlink()
            except FileNotFoundError:
                pass

    def _rejoin(self) -> None:
        """Re-register with a dispatcher that lost our state (throttled:
        many bounced submits must not trigger a hello storm). Ordering on
        the one DEALER socket guarantees the re-submits flushed afterwards
        arrive after the hello/open."""
        now = time.monotonic()
        if now - self._last_rejoin < 1.0:
            return
        self._last_rejoin = now
        self._rejoins += 1
        logger.warning('input service at %s lost this client\'s '
                       'registration (restart?); re-joining', self.service_url)
        self._socket.send_multipart([
            b'hello', self._client_name.encode('utf-8'),
            host_token().encode('utf-8'), b'%d' % self._hello_window])
        if self._open_blob is not None:
            self._socket.send_multipart([b'open', self._setup_id,
                                         self._open_blob])

    def _request_redelivery(self, token: int) -> None:
        """Ask the dispatcher to redeliver (wire-pinned) after a failed shm
        handoff. The token stays in-flight HERE: either the dispatcher still
        owns it (requeue delivers a fresh result) or it was already retired
        by the racing ``w_done`` — then the starvation watchdog re-arms it.
        Re-pending locally as well would decode the item twice."""
        self._socket.send_multipart([b'shm_fail', b'%d' % token])
        self._resubmitted += 1
        if telemetry_enabled():
            self.telemetry.inc('service_resubmit')

    # ------------------------------------------------------------- shutdown

    def stop(self) -> None:
        """Stop consuming; the dispatcher learns of our departure in
        ``join`` (``bye``) — nothing server-side needs tearing down."""
        self._stopped = True
        if self._ventilator is not None:
            self._ventilator.stop()

    def join(self) -> None:
        """Say ``bye`` (the dispatcher drops our queue) and release the
        socket. The fleet itself outlives every client by design."""
        if self._context is None:
            return
        try:
            self._socket.send_multipart([b'bye'])
        except Exception:  # noqa: BLE001 - departure is best-effort; the dispatcher GCs silent clients via its own accounting
            pass
        self._socket.close(linger=200)
        self._context.term()
        self._context = None

    # ---------------------------------------------------------- diagnostics

    @property
    def diagnostics(self) -> Dict[str, Any]:
        """Client-transport counters (the JAX package's, plus the payload
        bytes that arrived through one-shot segments and over the wire) and
        a fresh dispatcher ``state`` snapshot under ``'service'`` (``{'reachable': False}`` when the
        dispatcher stops answering) — how fleet-wide queue depths and
        fair-share debts surface in ``Reader.diagnostics``."""
        serializer_stats = dict(getattr(self._serializer, 'stats', None) or {})
        with self._lock:
            diag: Dict[str, Any] = {
                'service_url': self.service_url,
                'workers_alive': self.workers_count,
                'in_flight_items': len(self._items),
                'busy_rejections': self._busy_rejections,
                'results_dropped': self._results_dropped,
                'service_resubmitted': self._resubmitted,
                'service_shm_batches': self._shm_batches,
                'wire_batches': self._wire_batches,
                'service_shm_result_bytes': self._shm_result_bytes,
                'wire_result_bytes': self._wire_result_bytes,
                'unacked_timeouts': self._unacked_timeouts,
                'starvation_resubmits': self._starvation_resubmits,
                'rejoins': self._rejoins,
                'ledger_epoch': self._ledger_epoch,
                'ledger_rearms': self._ledger_rearms,
                'service_breaker': self._breaker.as_dict(),
                'sidecar_columns': serializer_stats.get('sidecar_columns', 0),
            }
        try:
            state = fetch_service_state(self.service_url, timeout_s=1.0)
            state['reachable'] = True
            workers = state.get('workers')
            if isinstance(workers, list):
                diag['workers_alive'] = len(workers)
        except Exception as exc:  # noqa: BLE001 - diagnostics must describe an unreachable service, not raise on it
            state = {'reachable': False, 'detail': repr(exc)}
        diag['service'] = state
        return diag
