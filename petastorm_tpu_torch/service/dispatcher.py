"""The service dispatcher: fair-share broker between reader clients and decode workers.
A copy of ``petastorm_tpu.service.dispatcher``, with its incident and run-history
planes (``incidents=``, ``history=``).

Socket topology (docs/service.md):

    client DEALER  <─>  ROUTER (client endpoint, ``service_url`` port)
    worker DEALER  <─>  ROUTER (worker endpoint, ``port + 1``)

Clients ``hello``/``open`` (register + ship a pickled worker setup), then
``submit`` rowgroup work items; workers ``register`` (a
:class:`~petastorm_tpu_torch.service.wire.WorkerDescriptor`), announce idleness with
``w_ready`` and receive ``work`` assignments — the same pull-based dispatch as
the in-process pool (``workers/process_pool.py``), so nothing ever queues in a
dead worker's socket buffer and every assignment is attributable.

Scheduling is **deficit round robin** per client
(:class:`FairShareScheduler`): each visit tops a client's deficit up by one
quantum and serves while the deficit covers the next item, so N clients with
pending work split the worker fleet evenly regardless of how fast each one
submits — the skewed-demand fairness the tf.data-service model calls for
(arXiv 2210.14826). **Admission control** bounds each client to a fixed
in-flight window (queued + assigned); a submit beyond it is rejected with an
explicit ``busy`` reply the client backs off on, so one greedy reader can
neither queue unboundedly nor starve the fleet.

**Elastic workers**: workers join (``register``) and leave (``w_leave``, or
just vanish) at any time. Liveness rides the PR-4 watchdog model: workers
stamp ``w_heartbeat`` sequence numbers, the dispatcher detects *change*
consumer-side (no cross-process clocks), and a worker whose stamp stalls past
its staleness window is deregistered — its in-flight items re-enter the owning
clients' queues (attempt-bumped, so a stale straggler ack can never retire a
redelivered item: the exact protocol ``process_pool.py`` uses). An item
re-queued more than ``max_item_attempts`` times fails loudly to its client
instead of poisoning the fleet forever.

The ``state`` request returns a JSON snapshot (clients, workers, queue depths,
fair-share debts) surfaced through ``Reader.diagnostics['service']``, doctor,
and the ``petastorm-tpu-torch-throughput serve`` CLI."""

from __future__ import annotations

import collections
import hashlib
import json
import logging
import math
import pickle
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Set, Tuple

from petastorm_tpu_torch.service.wire import (MAX_COST_HINT, MIN_COST_HINT,
                                        WorkerDescriptor, decode_cost)

logger = logging.getLogger(__name__)

#: client-side message kinds (client ROUTER): requests up, replies/results down
MSG_HELLO, MSG_WELCOME = b'hello', b'welcome'
MSG_OPEN, MSG_OPENED = b'open', b'opened'
MSG_SUBMIT, MSG_ACCEPT, MSG_BUSY = b'submit', b'accept', b'busy'
#: submit from an identity this dispatcher does not know (restart, or a
#: TTL-collected idle client): the client must re-``hello``/``open`` and
#: resubmit — how an epoch survives a dispatcher restart
MSG_REJOIN = b'rejoin'
MSG_RESULT, MSG_RESULT_SHM, MSG_ERROR = b'result', b'result_shm', b'error'
MSG_SHM_FAIL, MSG_BYE, MSG_STATE = b'shm_fail', b'bye', b'state'
#: ledger-epoch handshake (docs/service.md "Dispatcher crash with a
#: ledger"): a client probes with ``ledger_sync``; the ``ledger_state``
#: reply says whether this dispatcher knows the client and which ledger
#: epoch it serves — an unknown/epoch-changed answer means the client's
#: in-flight tokens died with the previous incarnation and must re-arm
MSG_LEDGER_SYNC, MSG_LEDGER_STATE = b'ledger_sync', b'ledger_state'
#: worker-side message kinds (worker ROUTER): registration/results up, work down
MSG_REGISTER, MSG_REGISTERED = b'register', b'registered'
MSG_W_READY, MSG_WORK, MSG_W_STOP = b'w_ready', b'work', b'w_stop'
MSG_W_HEARTBEAT, MSG_W_RESULT, MSG_W_RESULT_SHM = (b'w_heartbeat', b'w_result',
                                                   b'w_result_shm')
#: cumulative worker telemetry snapshot riding the heartbeat socket (the
#: fleet metrics plane — docs/observability.md "Live metrics plane")
MSG_W_METRICS = b'w_metrics'
#: worker-captured incident-bundle reference riding the heartbeat socket
#: (the fleet incident plane — docs/observability.md "Incident autopsy
#: plane")
MSG_W_INCIDENT = b'w_incident'
MSG_W_DONE, MSG_W_ERROR = b'w_done', b'w_error'
MSG_W_NEED_SETUP, MSG_W_LEAVE = b'w_need_setup', b'w_leave'
#: worker-side restart re-adoption: a ``w_ready`` from an identity this
#: dispatcher never registered (it belongs to the previous incarnation)
#: is answered with ``w_rejoin`` — the worker re-``register``s and the
#: fleet heals without respawning a single process
MSG_W_REJOIN = b'w_rejoin'

#: default per-client in-flight window (queued + assigned) before ``busy``
DEFAULT_ADMISSION_WINDOW = 16
#: default DRR quantum (deficit credit per scheduling visit). Items are
#: charged their MEASURED cost when the submit carries a cost hint from the
#: client's cost-aware scheduler (docs/performance.md "Cost-aware
#: scheduling") and unit cost otherwise — so with hints, a client burning
#: heavy rowgroups is served proportionally fewer of them per round.
DEFAULT_QUANTUM = 1.0
#: clamp for submit cost hints: one pathological ledger entry must neither
#: monopolize the deficit budget nor make an item effectively free. The
#: bounds are wire.py's MIN_COST_HINT/MAX_COST_HINT (aliased above): a
#: two-sided wire contract — the client scheduler prices into the SAME
#: range, and one shared constant keeps the sides from drifting apart.
MIN_ITEM_COST = MIN_COST_HINT
MAX_ITEM_COST = MAX_COST_HINT
#: a (clamped, median-relative) item cost at or above this routes via the
#: least-loaded ready worker instead of FIFO — heavy rowgroups spread across
#: the fleet instead of piling onto whichever worker asked first
HEAVY_ITEM_COST = 2.0
#: same-cause incident references landing within this window collapse into
#: ONE fleet incident (docs/observability.md "Incident autopsy plane")
INCIDENT_CORRELATION_WINDOW_S = 30.0
#: bound on the correlated fleet-incident list kept in ``state()``
MAX_FLEET_INCIDENTS = 32
#: how long a worker's heartbeat stamp may go unchanged before it counts as
#: departed (floored at 4x its own declared heartbeat interval, the same
#: jitter margin the in-process watchdog enforces)
DEFAULT_STALE_TIMEOUT_S = 15.0
#: re-dispatch budget per work item across worker deaths — a rowgroup that
#: kills every worker it lands on must fail loudly, not roam the fleet forever
DEFAULT_MAX_ITEM_ATTEMPTS = 5
#: how long a client may go completely silent (no hello/submit/shm_fail)
#: before the dispatcher garbage-collects its record + setups — an alive
#: client that got collected anyway simply ``rejoin``s on its next submit
DEFAULT_CLIENT_TTL_S = 900.0
#: dataset token the dispatcher's run-history records are keyed by — the
#: service serves many datasets, so its longitudinal series is keyed by the
#: service itself, not any one dataset (telemetry/history.py)
SERVICE_DATASET_TOKEN = 'service'


class _ClientState(object):
    """Dispatcher-side record of one connected reader client."""

    __slots__ = ('key', 'name', 'host', 'window', 'requested_window',
                 'queue', 'assigned', 'deficit', 'served', 'busy_rejections',
                 'last_seen', 'setup_ids')

    def __init__(self, key: bytes, name: str, host: str, window: int,
                 now: float, requested_window: Optional[int] = None) -> None:
        self.key = key
        self.name = name
        self.host = host
        self.window = window
        #: the window the client ASKED for at hello (None = follow the
        #: admission cap): a raised cap lifts follow-the-cap clients with it,
        #: but never silently widens a client that asked for less
        self.requested_window = requested_window
        self.queue: Deque[int] = collections.deque()
        self.assigned: Set[int] = set()
        self.deficit = 0.0
        self.served = 0
        self.busy_rejections = 0
        self.last_seen = now
        self.setup_ids: Set[bytes] = set()

    def in_flight(self) -> int:
        """Items this client currently owns inside the service."""
        return len(self.queue) + len(self.assigned)


class _WorkerState(object):
    """Dispatcher-side record of one registered decode worker."""

    __slots__ = ('key', 'descriptor', 'assigned', 'known_setups',
                 'hb_seq', 'hb_changed_at', 'cost_in_flight', 'cost_served')

    def __init__(self, key: bytes, descriptor: WorkerDescriptor,
                 now: float) -> None:
        self.key = key
        self.descriptor = descriptor
        self.assigned: Set[int] = set()
        self.known_setups: Set[bytes] = set()
        self.hb_seq = -1
        self.hb_changed_at = now
        #: measured cost currently assigned / retired on this worker — the
        #: least-loaded routing signal for heavy items (module constants)
        self.cost_in_flight = 0.0
        self.cost_served = 0.0


class _TokenState(object):
    """One submitted work item, alive until done-acked (or failed)."""

    __slots__ = ('token', 'client_key', 'client_token', 'setup_id', 'blob',
                 'attempt', 'worker_key', 'delivered', 'shm_ok', 'cost')

    def __init__(self, token: int, client_key: bytes, client_token: bytes,
                 setup_id: bytes, blob: bytes, cost: float = 1.0) -> None:
        self.token = token
        self.client_key = client_key
        self.client_token = client_token
        self.setup_id = setup_id
        self.blob = blob
        self.attempt = 0
        self.worker_key: Optional[bytes] = None
        self.delivered = False
        #: measured (median-relative) cost charged by the DRR; 1.0 when the
        #: submit carried no hint — the historical uniform-unit behavior
        self.cost = cost
        #: cleared on the first shm delivery failure (``shm_fail``): the
        #: redelivery must ride plain wire frames — a false co-location match
        #: (same hostname, different namespaces) would otherwise loop forever
        self.shm_ok = True


class Assignment(object):
    """One scheduling decision: which worker runs which item, with everything
    the dispatcher needs to build the ``work`` message (the setup blob is
    attached only the first time this worker sees this setup)."""

    __slots__ = ('worker_key', 'token', 'setup_id', 'blob', 'attempt',
                 'colocated', 'setup_blob')

    def __init__(self, worker_key: bytes, token: int, setup_id: bytes,
                 blob: bytes, attempt: int, colocated: bool,
                 setup_blob: Optional[bytes]) -> None:
        self.worker_key = worker_key
        self.token = token
        self.setup_id = setup_id
        self.blob = blob
        self.attempt = attempt
        self.colocated = colocated
        self.setup_blob = setup_blob


class FairShareScheduler(object):
    """Socket-free scheduling core: DRR fair share, admission control, token
    lifecycle and worker liveness — everything the dispatcher decides, none of
    what it transports. All clocks are injected (``clock``) so the fairness
    and staleness behavior is unit-testable deterministically."""

    def __init__(self, admission_window: int = DEFAULT_ADMISSION_WINDOW,
                 quantum: float = DEFAULT_QUANTUM,
                 stale_timeout_s: float = DEFAULT_STALE_TIMEOUT_S,
                 max_item_attempts: int = DEFAULT_MAX_ITEM_ATTEMPTS,
                 item_deadline_s: Optional[float] = None,
                 client_ttl_s: float = DEFAULT_CLIENT_TTL_S,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if quantum <= 0:
            raise ValueError('quantum must be > 0, got {!r}'.format(quantum))
        if admission_window < 1:
            raise ValueError('admission_window must be >= 1')
        self.admission_window = admission_window
        self.quantum = quantum
        self.stale_timeout_s = stale_timeout_s
        self.max_item_attempts = max_item_attempts
        #: optional per-item wall-clock budget (the service-side analog of the
        #: pool's ``item_deadline_s`` watchdog): a worker holding one item
        #: longer is treated exactly like a stale-heartbeat worker — its
        #: heartbeat thread keeps stamping through a wedged decode, so
        #: liveness alone cannot see a hung item
        self.item_deadline_s = item_deadline_s
        self.client_ttl_s = client_ttl_s
        self._clock = clock
        self._lock = threading.RLock()
        self._clients: Dict[bytes, _ClientState] = {}
        self._workers: Dict[bytes, _WorkerState] = {}
        self._worker_id_index: Dict[int, bytes] = {}
        self._tokens: Dict[int, _TokenState] = {}
        self._next_token = 0
        self._active: Deque[bytes] = collections.deque()  # clients w/ queued work
        self._ready_workers: Deque[bytes] = collections.deque()
        self._setups: Dict[bytes, bytes] = {}
        self._assign_time: Dict[int, float] = {}
        # ------------------------------------------------- durable ledger
        #: optional TokenLedger (service/ledger.py) the dispatcher arms;
        #: every lifecycle edge below journals through ``_journal`` so a
        #: restarted dispatcher can replay the epoch's token history
        self.journal: Any = None
        #: the ledger epoch this scheduler serves (0 = unarmed/first life);
        #: reported in the ``ledger_state`` handshake so re-adopting clients
        #: can tell a restart from a slow dispatcher
        self.ledger_epoch = 0
        #: pre-crash delivered tokens recovered by replay: a straggler
        #: ``w_result`` for one of these is a duplicate even though no live
        #: _TokenState remembers it — the dispatcher-side dedup that used to
        #: die with the process
        self._replay_delivered: Set[int] = set()
        self.replay_info: Optional[Dict[str, Any]] = None
        # -------------------------------------------- elastic resharding
        #: token -> preferred worker id from the last reshard; honored when
        #: that worker is ready, falls back to the normal pick otherwise
        self._preferred_worker: Dict[int, int] = {}
        self.resharded = 0
        # ----------------------------------------------------- aggregates
        self.busy_rejections = 0
        self.results_dropped = 0
        self.items_requeued = 0
        self.items_failed = 0
        self.items_served = 0
        self.workers_registered_total = 0
        self.workers_departed = 0

    # -------------------------------------------------------------- ledger

    def _journal(self, kind: str, **fields: Any) -> None:
        """Append one lifecycle record to the armed TokenLedger (no-op when
        the ledger is off; a failing journal degrades durability, never
        dispatch — the writer already swallows I/O errors)."""
        journal = self.journal
        if journal is not None:
            journal.append_record(kind, **fields)

    def adopt_replay(self, replay: Any, epoch: int) -> None:
        """Adopt a ledger replay at startup: restore token-counter
        monotonicity and the delivered-token dedup set, and remember the
        ledger epoch the handshake reports. Clients and setup blobs are NOT
        rebuilt here — live clients re-adopt themselves via the
        ``ledger_sync`` handshake (the blobs only they hold)."""
        with self._lock:
            # Epoch-scope the token space: a corrupt journal replays only the
            # prefix before the bad frame, so ``replay.next_token`` can be
            # stale — a restarted dispatcher would reissue token numbers, and
            # a ZMQ-buffered straggler w_result from the dead incarnation
            # would then route to the wrong client request. Basing each
            # incarnation at ``epoch << 40`` keeps token ranges disjoint
            # across restarts (the ledger bumps the epoch on every open).
            self._next_token = max(self._next_token, replay.next_token,
                                   epoch << 40)
            self._replay_delivered = set(replay.delivered)
            self.ledger_epoch = epoch
            self.resharded = replay.resharded
            self.replay_info = replay.as_dict()

    # ----------------------------------------------------------- resharding

    def reshard(self, reason: str) -> Optional[Dict[str, Any]]:
        """Re-split the UNDELIVERED work across the current worker set after
        an elastic join/leave: walk clients in sorted-name order and each
        client's queue in ventilation order (the lineage contract — the
        order is never reshuffled, only the token->worker placement moves)
        and deal tokens round-robin across sorted worker ids. Returns a
        summary for the reshard trace/incident event, or None when there is
        nothing to re-split."""
        with self._lock:
            worker_ids = sorted(w.descriptor.worker_id
                                for w in self._workers.values())
            self._preferred_worker.clear()
            if not worker_ids:
                return None
            undelivered: List[int] = []
            for key in sorted(self._clients,
                              key=lambda k: self._clients[k].name):
                undelivered.extend(self._clients[key].queue)
            if not undelivered:
                return None
            for index, token in enumerate(undelivered):
                self._preferred_worker[token] = \
                    worker_ids[index % len(worker_ids)]
            self.resharded += 1
            summary = {'reason': reason, 'workers': len(worker_ids),
                       'undelivered': len(undelivered),
                       'resharded': self.resharded}
        self._journal('reshard', **summary)
        return summary

    # ------------------------------------------------------------- autotune

    def set_admission_window(self, value: int) -> int:
        """Bounded runtime retune of the admission cap (docs/autotuning.md):
        new clients hello against the new cap; live clients whose window
        exceeds it are clamped down, and clients that follow the cap (hello'd
        without a window, or asked for more than the cap allows) are lifted
        with it — but a client that asked for less than the new cap is never
        silently widened past its request. Returns the applied value."""
        with self._lock:
            value = max(1, int(value))
            self.admission_window = value
            for client in self._clients.values():
                requested = client.requested_window
                client.window = min(requested or value, value)
            return value

    def set_client_windows(self, value: int) -> int:
        """Runtime retune of every live client's in-flight depth, clamped to
        ``[1, admission_window]`` (docs/autotuning.md) — the per-client half
        of the service autotuner. Returns the applied value."""
        with self._lock:
            value = max(1, min(int(value), self.admission_window))
            for client in self._clients.values():
                client.window = value
            return value

    def effective_client_window(self) -> int:
        """The smallest live client window (the admission cap when no client
        is connected) — the service-client-window knob's current value."""
        with self._lock:
            if not self._clients:
                return self.admission_window
            return min(client.window for client in self._clients.values())

    def autotune_snapshot(self) -> Dict[str, Any]:
        """A telemetry-shaped snapshot of the scheduler's control signals
        (cumulative counters + current gauges) for the autotune controller's
        window deltas and ``attribute_bottleneck``'s service advisories."""
        with self._lock:
            return {
                'histograms': {},
                'counters': {'service_busy': self.busy_rejections,
                             'service_resubmit': self.items_requeued},
                'gauges': {
                    'service_queue_depth': float(sum(
                        len(c.queue) for c in self._clients.values())),
                    'service_ready_workers': float(len(self._ready_workers)),
                    'service_workers': float(len(self._workers)),
                    'service_admission_window': float(self.admission_window),
                    # inlined effective_client_window (we already hold _lock)
                    'service_client_window': float(
                        min((c.window for c in self._clients.values()),
                            default=self.admission_window)),
                },
            }

    # ------------------------------------------------------------- clients

    def add_client(self, key: bytes, name: str, host: str,
                   window: Optional[int] = None) -> int:
        """Register (or re-register) a client; returns its effective window."""
        with self._lock:
            effective = min(window or self.admission_window,
                            self.admission_window)
            self._clients[key] = _ClientState(key, name, host, effective,
                                              self._clock(),
                                              requested_window=window)
            self._journal('client', name=name, host=host, window=effective)
            return effective

    def client_window(self, key: bytes) -> int:
        """The client's CURRENT in-flight window — piggybacked on every
        accept/busy reply so live clients adopt dispatcher-side retuning
        (the autotune window knobs would otherwise move a limit connected
        clients never observe; docs/autotuning.md)."""
        with self._lock:
            client = self._clients.get(key)
            return client.window if client is not None else self.admission_window

    def has_client(self, key: bytes) -> bool:
        """True when ``key`` is a registered client. A submit from an
        unregistered identity (dispatcher restart, or a TTL-collected idle
        client) gets a ``rejoin`` reply instead of a misleading ``busy``."""
        with self._lock:
            return key in self._clients

    def remove_client(self, key: bytes) -> None:
        """Drop a departed client: its queued items and setups die, its
        assigned items finish on the workers and their results are dropped
        on delivery."""
        with self._lock:
            client = self._clients.pop(key, None)
            if client is None:
                return
            for token in client.queue:
                self._tokens.pop(token, None)
                self._preferred_worker.pop(token, None)
            for setup_id in client.setup_ids:
                self._setups.pop(setup_id, None)
            try:
                self._active.remove(key)
            except ValueError:
                pass

    def expired_clients(self) -> List[bytes]:
        """Clients silent past ``client_ttl_s`` with nothing in flight —
        garbage for the caller to :meth:`remove_client` (a live client that
        gets collected anyway just ``rejoin``s on its next submit)."""
        with self._lock:
            now = self._clock()
            return [key for key, client in self._clients.items()
                    if not client.in_flight()
                    and now - client.last_seen > self.client_ttl_s]

    def add_setup(self, client_key: bytes, setup_id: bytes,
                  blob: bytes) -> None:
        """Store a client's dilled worker setup for lazy per-worker shipping
        (owned by the client — collected with it)."""
        with self._lock:
            self._setups[setup_id] = blob
            client = self._clients.get(client_key)
            if client is not None:
                client.setup_ids.add(setup_id)
                client.last_seen = self._clock()
            self._journal(
                'setup', setup=setup_id.decode('ascii', 'replace'),
                digest=hashlib.blake2b(blob, digest_size=8).hexdigest(),
                client=client.name if client is not None else None)

    def submit(self, client_key: bytes, client_token: bytes, setup_id: bytes,
               blob: bytes, cost: float = 1.0) -> Optional[int]:
        """Admission-checked submit: returns the global token, or None when
        the client's window is full (the caller replies ``busy``). ``cost``
        is the client's measured-cost hint (clamped; 1.0 = the historical
        uniform unit) — what the DRR charges and the heavy-routing keys on."""
        with self._lock:
            client = self._clients.get(client_key)
            if client is None:
                return None
            client.last_seen = self._clock()
            if client.in_flight() >= client.window:
                client.busy_rejections += 1
                self.busy_rejections += 1
                return None
            token = self._next_token
            self._next_token += 1
            cost = max(MIN_ITEM_COST, min(MAX_ITEM_COST, float(cost)))
            self._tokens[token] = _TokenState(token, client_key, client_token,
                                              setup_id, blob, cost=cost)
            client.queue.append(token)
            if client.key not in self._active:
                self._active.append(client.key)
            self._journal('issued', token=token, client=client.name,
                          cost=cost)
            return token

    # ------------------------------------------------------------- workers

    def add_worker(self, key: bytes, descriptor: WorkerDescriptor) -> bool:
        """Register a worker (elastic join — any time, including mid-epoch).
        Idempotent per identity: a re-sent ``register`` (slow-ack retry) must
        neither reset the worker's assignment record nor double-count it.
        Returns True only for a NEW registration — the edge the caller
        reshards on."""
        with self._lock:
            if key in self._workers:
                return False
            self._workers[key] = _WorkerState(key, descriptor, self._clock())
            self._worker_id_index[descriptor.worker_id] = key
            self.workers_registered_total += 1
            return True

    def remove_worker(self, key: bytes) -> List[Tuple[int, bytes, bytes]]:
        """Deregister a worker (leave, or reaped as stale) and re-queue its
        in-flight items at the FRONT of their owners' queues (oldest work
        first, same as the pool's respawn path). Returns the items that
        exhausted their attempt budget as ``(token, client_key,
        client_token)`` — the caller fails those loudly to their clients."""
        failed: List[Tuple[int, bytes, bytes]] = []
        with self._lock:
            worker = self._workers.pop(key, None)
            if worker is None:
                return failed
            if self._worker_id_index.get(worker.descriptor.worker_id) == key:
                del self._worker_id_index[worker.descriptor.worker_id]
            try:
                self._ready_workers.remove(key)
            except ValueError:
                pass
            self.workers_departed += 1
            for token in sorted(worker.assigned):
                state = self._tokens.get(token)
                self._assign_time.pop(token, None)
                if state is None:
                    continue
                state.worker_key = None
                # a stale ack from the departed worker can never retire the
                # redelivered attempt (echoed-attempt protocol, process_pool.py)
                state.attempt += 1
                if state.attempt >= self.max_item_attempts:
                    del self._tokens[token]
                    self._preferred_worker.pop(token, None)
                    client = self._clients.get(state.client_key)
                    if client is not None:
                        client.assigned.discard(token)
                    self.items_failed += 1
                    self._journal('quarantined', token=token)
                    failed.append((token, state.client_key,
                                   state.client_token))
                    continue
                client = self._clients.get(state.client_key)
                if client is None:
                    del self._tokens[token]
                    continue
                client.assigned.discard(token)
                client.queue.appendleft(token)
                if client.key not in self._active:
                    # oldest work first: schedule this client ahead of the
                    # regular rotation
                    self._active.appendleft(client.key)
                self.items_requeued += 1
        return failed

    def worker_ready(self, key: bytes) -> bool:
        """A worker announced itself idle; it may receive one assignment.
        Returns False for an UNKNOWN identity — a live worker left over from
        a previous dispatcher incarnation, which the caller answers with
        ``w_rejoin`` so it re-registers instead of idling forever."""
        with self._lock:
            if key not in self._workers:
                return False
            if key not in self._ready_workers:
                self._ready_workers.append(key)
            return True

    def heartbeat(self, worker_id: int, seq: int) -> None:
        """Record a worker's liveness stamp (change-detected on our clock —
        no cross-process clock comparison, the PR-4 discipline)."""
        with self._lock:
            key = self._worker_id_index.get(worker_id)
            worker = self._workers.get(key) if key is not None else None
            if worker is not None and worker.hb_seq != seq:
                worker.hb_seq = seq
                worker.hb_changed_at = self._clock()

    def stale_workers(self) -> List[bytes]:
        """Workers to reap: heartbeat stamp unchanged past the staleness
        window (departed or process-wide wedged), or — when an
        ``item_deadline_s`` is set — holding an item past its wall-clock
        budget (a wedged *decode* keeps heartbeating from its independent
        stamp thread, so item progress needs its own detector, exactly as in
        the in-process pool's two-detector watchdog). The caller removes
        them; re-queue + the attempt budget take it from there."""
        with self._lock:
            now = self._clock()
            stale = []
            for key, worker in self._workers.items():
                interval = worker.descriptor.heartbeat_interval_s or 0.0
                window = max(self.stale_timeout_s, 4 * interval)
                if now - worker.hb_changed_at > window:
                    stale.append(key)
                    continue
                if self.item_deadline_s is not None and any(
                        now - self._assign_time.get(token, now)
                        > self.item_deadline_s
                        for token in worker.assigned):
                    stale.append(key)
            return stale

    # ----------------------------------------------------------- scheduling

    def next_assignment(self) -> Optional[Assignment]:
        """One DRR scheduling step: pick the next (client, item) pair and a
        ready worker for it, or None when either side is empty.

        Each visit to the head-of-rotation client serves it if its deficit
        covers its head item's MEASURED cost, else tops the deficit up by
        ``quantum`` and rotates — so over any window, every client with
        pending work is served in proportion to its quantum, and a client
        burning heavy rowgroups is served proportionally fewer of them
        (deficit round robin; unit cost when no submit hint was shipped —
        the historical behavior). Heavy items (cost >= ``HEAVY_ITEM_COST``)
        route via the least-loaded ready worker instead of FIFO."""
        with self._lock:
            if not self._ready_workers:
                return None
            # a heavy head item needs up to ceil(MAX/quantum) deficit top-ups;
            # the guard must allow that many full rotations before giving up
            guard = ((1 + int(math.ceil(MAX_ITEM_COST / self.quantum)))
                     * (len(self._active) + 1))
            while self._active and guard > 0:
                guard -= 1
                key = self._active[0]
                client = self._clients.get(key)
                if client is None or not client.queue:
                    self._active.popleft()
                    if client is not None:
                        client.deficit = 0.0
                    continue
                state = self._tokens.get(client.queue[0])
                if state is None:  # superseded while queued
                    client.queue.popleft()
                    continue
                cost = state.cost
                if client.deficit < cost:
                    client.deficit += self.quantum
                    if client.deficit < cost:
                        self._active.rotate(-1)
                        continue
                worker_key = self._pick_worker_for(state.token, cost)
                if worker_key is None:
                    return None
                client.deficit -= cost
                token = client.queue.popleft()
                self._preferred_worker.pop(token, None)
                if not client.queue:
                    self._active.popleft()
                    client.deficit = 0.0
                else:
                    self._active.rotate(-1)
                worker = self._workers[worker_key]
                state.worker_key = worker_key
                worker.assigned.add(token)
                worker.cost_in_flight += cost
                client.assigned.add(token)
                self._assign_time[token] = self._clock()
                colocated = (worker.descriptor.shm_results
                             and worker.descriptor.host == client.host
                             and state.shm_ok)
                setup_blob: Optional[bytes] = None
                if state.setup_id not in worker.known_setups:
                    setup_blob = self._setups.get(state.setup_id)
                    if setup_blob is not None:
                        # only a SHIPPED setup counts as known — a missing
                        # blob must keep triggering w_need_setup until the
                        # attempt budget fails the item loudly
                        worker.known_setups.add(state.setup_id)
                return Assignment(worker_key, token, state.setup_id,
                                  state.blob, state.attempt, colocated,
                                  setup_blob)
            return None

    def _pick_worker_for(self, token: int,
                         cost: float = 1.0) -> Optional[bytes]:
        """Honor the last reshard's placement for ``token`` when that worker
        is ready; fall back to the ordinary pick (FIFO / least-loaded)
        otherwise — a reshard preference is a balance hint, never a stall."""
        preferred = self._preferred_worker.get(token)
        if preferred is not None:
            key = self._worker_id_index.get(preferred)
            if key is not None and key in self._ready_workers:
                self._ready_workers.remove(key)
                return key
        return self._pick_worker(cost)

    def _pick_worker(self, cost: float = 1.0) -> Optional[bytes]:
        """The ready worker for one item: FIFO for ordinary items (the
        historical order), least-loaded — smallest (in-flight cost, retired
        cost) — for heavy ones, so consecutive heavy rowgroups spread across
        the fleet instead of piling onto whichever worker asked first."""
        if cost >= HEAVY_ITEM_COST and len(self._ready_workers) > 1:
            best_key: Optional[bytes] = None
            best_score: Optional[Tuple[float, float]] = None
            for key in self._ready_workers:
                worker = self._workers.get(key)
                if worker is None:
                    continue
                score = (worker.cost_in_flight, worker.cost_served)
                if best_score is None or score < best_score:
                    best_key, best_score = key, score
            if best_key is not None:
                self._ready_workers.remove(best_key)
                return best_key
            self._ready_workers.clear()
            return None
        while self._ready_workers:
            key = self._ready_workers.popleft()
            if key in self._workers:
                return key
        return None

    def _bump_or_requeue(self, token: int) -> Optional[Tuple[int, bytes,
                                                             bytes]]:
        """Shared re-delivery path (worker lacked the setup, client lost a
        shm segment): bump the attempt and re-queue at the front — or, once
        the attempt budget is spent, retire the item and return ``(token,
        client_key, client_token)`` for the caller to fail loudly. Called
        under ``_lock``."""
        state = self._tokens.get(token)
        if state is None:
            return None
        state.worker_key = None
        state.delivered = False
        state.attempt += 1
        self._assign_time.pop(token, None)
        client = self._clients.get(state.client_key)
        if client is None:
            del self._tokens[token]
            return None
        if state.attempt >= self.max_item_attempts:
            del self._tokens[token]
            self._preferred_worker.pop(token, None)
            client.assigned.discard(token)
            self.items_failed += 1
            self._journal('quarantined', token=token)
            return (token, state.client_key, state.client_token)
        client.assigned.discard(token)
        if token not in client.queue:
            client.queue.appendleft(token)
            if client.key not in self._active:
                self._active.appendleft(client.key)
        self.items_requeued += 1
        return None

    def forget_setups(self, worker_key: bytes,
                      token: int) -> Optional[Tuple[int, bytes, bytes]]:
        """A worker reported it lacks a setup the dispatcher believed it had
        (``w_need_setup`` — e.g. the blob raced its registration reset):
        clear its record and re-queue the item so the next dispatch re-ships
        it. Returns the failure route once the item's attempt budget is
        spent (a setup that can never be shipped must fail loudly, not spin
        between dispatcher and worker forever)."""
        with self._lock:
            worker = self._workers.get(worker_key)
            if worker is not None:
                worker.known_setups.clear()
                worker.assigned.discard(token)
                state = self._tokens.get(token)
                if state is not None:
                    worker.cost_in_flight = max(0.0, worker.cost_in_flight
                                                - state.cost)
            return self._bump_or_requeue(token)

    # --------------------------------------------------------- result flow

    def result_route(self, token: int) -> Optional[Tuple[bytes, bytes]]:
        """Where to forward a worker result: ``(client_key, client_token)``,
        or None when the token is retired/superseded (duplicate from a
        re-dispatched item whose first result already went out — dropped and
        counted, exactly like the pool's ``results_dropped``)."""
        with self._lock:
            state = self._tokens.get(token)
            if state is None:
                # includes tokens whose delivery the LEDGER remembers from a
                # previous dispatcher life: a pre-crash straggler result is a
                # duplicate even though no live record holds it
                self._replay_delivered.discard(token)
                self.results_dropped += 1
                return None
            if state.delivered:
                self.results_dropped += 1
                return None
            if self._clients.get(state.client_key) is None:
                self.results_dropped += 1
                return None
            state.delivered = True
            self._journal('delivered', token=token)
            return state.client_key, state.client_token

    def retire(self, token: int, attempt: Optional[int]) -> None:
        """A ``w_done`` ack: retire the item iff the echoed attempt is
        current (a stale ack from a since-removed worker must neither retire
        an undelivered redelivery nor double-retire one)."""
        with self._lock:
            state = self._tokens.get(token)
            if state is None:
                return
            if attempt is not None and attempt != state.attempt:
                return
            del self._tokens[token]
            self._assign_time.pop(token, None)
            self._preferred_worker.pop(token, None)
            client = self._clients.get(state.client_key)
            self._journal('retired', token=token,
                          client=client.name if client is not None else None)
            if client is not None:
                client.assigned.discard(token)
                client.served += 1
                self.items_served += 1
            if state.worker_key is not None:
                worker = self._workers.get(state.worker_key)
                if worker is not None:
                    worker.assigned.discard(token)
                    worker.cost_in_flight = max(0.0, worker.cost_in_flight
                                                - state.cost)
                    worker.cost_served += state.cost

    def fail(self, token: int) -> Optional[Tuple[bytes, bytes]]:
        """Terminal worker error for an item: retire it and return the owning
        ``(client_key, client_token)`` to forward the error to."""
        with self._lock:
            state = self._tokens.pop(token, None)
            self._assign_time.pop(token, None)
            self._preferred_worker.pop(token, None)
            if state is None:
                return None
            self._journal('failed', token=token)
            client = self._clients.get(state.client_key)
            if client is not None:
                client.assigned.discard(token)
            if state.worker_key is not None:
                worker = self._workers.get(state.worker_key)
                if worker is not None:
                    worker.assigned.discard(token)
                    worker.cost_in_flight = max(0.0, worker.cost_in_flight
                                                - state.cost)
            if client is None:
                return None
            return state.client_key, state.client_token

    def requeue_token(self, token: int) -> Optional[Tuple[int, bytes, bytes]]:
        """Client-requested redelivery (``shm_fail``: it could not attach or
        verify a co-located segment) — put the item back at the front of its
        queue, pinned to the plain-wire transport from now on (a false
        co-location match must converge to TCP, not loop). Returns the
        failure route once the attempt budget is spent."""
        with self._lock:
            state = self._tokens.get(token)
            if state is None:
                return None
            state.shm_ok = False
            if state.worker_key is not None:
                worker = self._workers.get(state.worker_key)
                if worker is not None:
                    worker.assigned.discard(token)
                    worker.cost_in_flight = max(0.0, worker.cost_in_flight
                                                - state.cost)
            return self._bump_or_requeue(token)

    # ------------------------------------------------------------ snapshot

    def worker_count(self) -> int:
        """Currently-registered decode workers."""
        with self._lock:
            return len(self._workers)

    def worker_keys(self) -> List[bytes]:
        """Identities of every registered worker (stop-broadcast routing)."""
        with self._lock:
            return list(self._workers)

    def worker_id_of(self, key: bytes) -> Optional[int]:
        """The registered worker id behind a socket identity (None when
        unknown) — how the dispatcher maps departures onto the fleet
        metrics-plane entries it should drop."""
        with self._lock:
            worker = self._workers.get(key)
            return worker.descriptor.worker_id if worker is not None else None

    def has_worker_id(self, worker_id: int) -> bool:
        """True while ``worker_id`` names a REGISTERED worker — the guard
        that keeps a departed worker's straggler ``w_metrics`` frame from
        resurrecting its entry on the scrape surface."""
        with self._lock:
            return worker_id in self._worker_id_index

    def state(self) -> Dict[str, Any]:
        """JSON-safe snapshot: clients (queue depth / in-flight / served /
        fair-share debt), workers (assigned / heartbeat age), and the
        aggregate admission + requeue counters — the ``state`` reply body."""
        with self._lock:
            now = self._clock()
            return {
                'workers': [{
                    'worker_id': w.descriptor.worker_id,
                    'pid': w.descriptor.pid,
                    'host': w.descriptor.host,
                    'shm_results': w.descriptor.shm_results,
                    'assigned': len(w.assigned),
                    'heartbeat_age_s': round(now - w.hb_changed_at, 3),
                    'cost_in_flight': round(w.cost_in_flight, 3),
                    'cost_served': round(w.cost_served, 3),
                } for w in self._workers.values()],
                'clients': [{
                    'name': c.name,
                    'host': c.host,
                    'window': c.window,
                    'queued': len(c.queue),
                    'in_flight': c.in_flight(),
                    'served': c.served,
                    'deficit': round(c.deficit, 3),
                    'busy_rejections': c.busy_rejections,
                } for c in self._clients.values()],
                'queue_depth': sum(len(c.queue)
                                   for c in self._clients.values()),
                'in_flight': len(self._tokens),
                'ready_workers': len(self._ready_workers),
                'busy_rejections': self.busy_rejections,
                'results_dropped': self.results_dropped,
                'items_requeued': self.items_requeued,
                'items_failed': self.items_failed,
                'items_served': self.items_served,
                'admission_window': self.admission_window,
                'workers_registered_total': self.workers_registered_total,
                'workers_departed': self.workers_departed,
                'resharded': self.resharded,
                'ledger_epoch': self.ledger_epoch,
            }


def choose_service_knob(prev: Dict[str, Any], cur: Dict[str, Any],
                        rate: float, eligible: List[Any]) -> Optional[str]:
    """The service controller's knob chooser (docs/autotuning.md): admission
    signals instead of stage histograms. A window with fresh ``busy``
    rejections while the queue is shallow means clients are throttled below
    what the fleet could absorb — retune the live client windows; a queue deep
    past the fleet's absorption rate points at the admission cap."""
    ids = {knob.knob_id for knob in eligible}
    busy_delta = (int((cur.get('counters') or {}).get('service_busy', 0))
                  - int((prev.get('counters') or {}).get('service_busy', 0)))
    gauges = cur.get('gauges') or {}
    queue_depth = float(gauges.get('service_queue_depth', 0.0))
    workers = max(1.0, float(gauges.get('service_workers', 1.0)))
    admission = float(gauges.get('service_admission_window', 0.0))
    client_window = float(gauges.get('service_client_window', admission))
    if busy_delta > 0 and queue_depth <= 2 * workers:
        # clients throttled below fleet capacity. The common fleet has every
        # client AT the admission cap (hello without a window = follow the
        # cap) — the client-window knob is pinned there, so the cap itself is
        # the knob to raise (follow-the-cap clients are lifted with it and
        # adopt it via the accept/busy piggyback).
        if client_window < admission and 'service_client_window' in ids:
            return 'service_client_window'
        if 'service_admission_window' in ids:
            return 'service_admission_window'
    if queue_depth > 8 * workers and 'service_admission_window' in ids:
        return 'service_admission_window'
    return None


class Dispatcher(object):
    """ZMQ front of the scheduler: binds the client + worker ROUTERs, pumps
    messages on a daemon thread, and translates scheduler decisions into
    ``work`` sends. All socket use stays on the dispatcher thread (ROUTER
    sends are not thread-safe); :meth:`state` reads the scheduler snapshot
    under its own lock from any thread.

    ``autotune`` (docs/autotuning.md): ``True`` or an
    :class:`~petastorm_tpu_torch.autotune.AutotunePolicy` arms the same controller
    core the reader uses — driven from the pump thread (no extra thread), it
    retunes the admission window and live per-client in-flight depth from the
    scheduler's queue-depth/``service_busy`` signals, with the process breaker
    board as the interlock. Off (None) by default."""

    def __init__(self, host: str = '127.0.0.1', port: Optional[int] = None,
                 admission_window: int = DEFAULT_ADMISSION_WINDOW,
                 quantum: float = DEFAULT_QUANTUM,
                 stale_timeout_s: float = DEFAULT_STALE_TIMEOUT_S,
                 max_item_attempts: int = DEFAULT_MAX_ITEM_ATTEMPTS,
                 item_deadline_s: Optional[float] = None,
                 client_ttl_s: float = DEFAULT_CLIENT_TTL_S,
                 autotune: Any = None,
                 metrics_port: Optional[int] = None,
                 incidents: Any = None,
                 ledger: Optional[str] = None,
                 history: Any = None) -> None:
        self._host = host
        self._port = port
        #: durable token ledger (service/ledger.py): a journal path arms it;
        #: ``start`` replays the journal (behind the ledger-replay breaker)
        #: before the first frame is served
        self._ledger_path = ledger
        self._ledger: Any = None
        #: set by :meth:`crash` — the pump exits WITHOUT the stop broadcast
        #: or the heartbeat drain, exactly like a SIGKILL would leave things
        self._crashed = False
        # Fleet metrics plane (docs/observability.md "Live metrics plane"):
        # latest cumulative telemetry snapshot per worker (seq-guarded,
        # delivered as w_metrics frames on the heartbeat socket), merged at
        # scrape time into one fleet-wide surface. Guarded by its own lock —
        # the pump thread writes, the scrape threads read.
        self._metrics_port = metrics_port
        self._metrics_server: Any = None
        self._worker_metrics: Dict[int, Tuple[int, Dict[str, Any]]] = {}
        self._worker_metrics_lock = threading.Lock()
        # Fleet incident plane (docs/observability.md "Incident autopsy
        # plane"): the dispatcher owns its own recorder (stale-worker reaps
        # and attempt-budget exhaustion are dispatcher-observed edges),
        # adopts inline bundles shipped by workers as w_incident frames, and
        # correlates same-cause references across workers into one fleet
        # incident.
        self._incident_recorder: Any = None
        self._incident_registry: Any = None
        self._worker_incident_seq: Dict[int, int] = {}
        self._fleet_incidents: List[Dict[str, Any]] = []
        self._incident_lock = threading.Lock()
        from petastorm_tpu_torch.telemetry.incident import resolve_incident_policy
        incident_policy = resolve_incident_policy(incidents)
        if incident_policy is not None:
            from petastorm_tpu_torch.telemetry.incident import (
                IncidentRecorder, default_incident_home)
            from petastorm_tpu_torch.telemetry.registry import MetricsRegistry
            self._incident_registry = MetricsRegistry()
            self._incident_recorder = IncidentRecorder(
                default_incident_home(None), incident_policy,
                registry=self._incident_registry)
            self._incident_recorder.add_source(
                'service_state', lambda: self.scheduler.state())
            self._incident_recorder.add_source(
                'metrics', self.fleet_metrics_snapshot)
        self.scheduler = FairShareScheduler(
            admission_window=admission_window, quantum=quantum,
            stale_timeout_s=stale_timeout_s,
            max_item_attempts=max_item_attempts,
            item_deadline_s=item_deadline_s, client_ttl_s=client_ttl_s)
        self._context: Any = None
        self._client_socket: Any = None
        self._worker_socket: Any = None
        self._thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        self._next_stale_check = 0.0
        self._autotune: Any = None
        from petastorm_tpu_torch.autotune.policy import resolve_policy
        autotune_policy = resolve_policy(autotune)
        if autotune_policy is not None:
            from petastorm_tpu_torch.autotune.controller import AutotuneController
            from petastorm_tpu_torch.autotune.knobs import (KnobCatalog,
                                                      build_service_knobs)
            scheduler = self.scheduler
            self._autotune = AutotuneController(
                KnobCatalog(build_service_knobs(scheduler)),
                metric_fn=lambda: float(scheduler.items_served),
                snapshot_fn=scheduler.autotune_snapshot,
                policy=autotune_policy,
                choose_fn=choose_service_knob,
                name='service')
        # Longitudinal observatory (docs/observability.md "Longitudinal
        # observatory"): one structured run record at stop() plus a live
        # regression sentinel over the pump's items-served series. The
        # dispatcher has no dataset home, so persisting records needs an
        # explicit store path (``history=HistoryPolicy(path=...)`` or a
        # path string); ``history=True`` still arms the sentinel.
        self._history: Any = None
        self._sentinel: Any = None
        self._history_written = False
        self._started_at: Optional[float] = None
        from petastorm_tpu_torch.telemetry.history import resolve_history_policy
        self._history_policy = resolve_history_policy(history)
        if self._history_policy is not None:
            from petastorm_tpu_torch.telemetry.sentinel import (
                RegressionSentinel, resolve_sentinel_policy)
            if self._history_policy.path:
                from petastorm_tpu_torch.telemetry.history import RunHistorian
                self._history = RunHistorian(
                    self._history_policy.path,
                    policy=self._history_policy,
                    registry=self._incident_registry)
            sentinel_policy = resolve_sentinel_policy(
                self._history_policy.sentinel)
            if sentinel_policy is not None:
                self._sentinel = RegressionSentinel(
                    sentinel_policy, owner='dispatcher',
                    registry=self._incident_registry,
                    incidents=self._incident_recorder,
                    dataset_token=SERVICE_DATASET_TOKEN)
                if self._incident_recorder is not None:
                    self._incident_recorder.add_source(
                        'sentinel', self._sentinel.report)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> str:
        """Bind both ROUTERs and start the pump thread; returns the
        ``service_url`` clients connect to. When a ledger path is armed the
        journal is replayed FIRST (behind the ledger-replay breaker): token
        monotonicity and the delivered-dedup set are restored before any
        client or worker frame can race them."""
        import zmq
        from petastorm_tpu_torch.service.wire import WORKER_PORT_OFFSET
        if self._ledger_path:
            self._arm_ledger()
        self._context = zmq.Context()
        self._client_socket = self._context.socket(zmq.ROUTER)
        self._worker_socket = self._context.socket(zmq.ROUTER)
        if self._port is not None:
            self._client_socket.bind('tcp://{}:{}'.format(self._host,
                                                          self._port))
            self._worker_socket.bind('tcp://{}:{}'.format(
                self._host, self._port + WORKER_PORT_OFFSET))
        else:
            # adjacent-port pair from the ephemeral range: retry until a port
            # P with P+1 also free is found (bounded — ranges are sparse)
            last_error: Optional[Exception] = None
            for _ in range(32):
                port = self._client_socket.bind_to_random_port(
                    'tcp://{}'.format(self._host))
                try:
                    self._worker_socket.bind('tcp://{}:{}'.format(
                        self._host, port + WORKER_PORT_OFFSET))
                    self._port = port
                    break
                except zmq.ZMQError as exc:
                    last_error = exc
                    self._client_socket.unbind('tcp://{}:{}'.format(
                        self._host, port))
            else:
                raise RuntimeError('could not find an adjacent free port '
                                   'pair: {!r}'.format(last_error))
        self._started_at = time.monotonic()
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name='petastorm-tpu-torch-dispatcher')
        self._thread.start()
        if self._metrics_port is not None:
            from petastorm_tpu_torch.telemetry.http_exporter import (
                MetricsHttpServer, service_state_text)
            self._metrics_server = MetricsHttpServer(
                snapshot_fn=self.fleet_metrics_snapshot,
                labeled_fn=self.worker_metrics_snapshots,
                label='worker',
                extra_text_fn=lambda: service_state_text(
                    self.scheduler.state()),
                health_fn=lambda: {
                    'workers': self.scheduler.worker_count(),
                    'service_url': self.service_url},
                port=int(self._metrics_port), host=self._host)
            self._metrics_server.start()
        return self.service_url

    def _arm_ledger(self) -> None:
        """Open + replay the durable token ledger behind the ledger-replay
        breaker: a journal that corrupts consecutive replays must not wedge
        every restart — once the breaker opens, the journal is DISCARDED and
        the fleet degrades to replay-from-clients (loud: incident bundle +
        CRC drop counter), never to a wrong order."""
        from petastorm_tpu_torch.resilience import (
            LEDGER_REPLAY_BREAKER_THRESHOLD, LEDGER_REPLAY_BREAKER_RECOVERY_S,
            default_board)
        from petastorm_tpu_torch.service.ledger import TokenLedger
        from petastorm_tpu_torch.telemetry.tracing import trace_instant
        breaker = default_board().breaker(
            'ledger:replay',
            failure_threshold=LEDGER_REPLAY_BREAKER_THRESHOLD,
            recovery_timeout_s=LEDGER_REPLAY_BREAKER_RECOVERY_S)
        self._ledger = TokenLedger(self._ledger_path)
        replay = self._ledger.open(discard=not breaker.allow())
        if replay.result == 'corrupt':
            breaker.record_failure()
            logger.error(
                'dispatcher: ledger journal %s failed CRC replay (%d '
                'frame(s) dropped, %d record(s) recovered); degrading to '
                'replay-from-clients', self._ledger_path,
                replay.frames_dropped, replay.records)
            if self._incident_registry is not None:
                self._incident_registry.inc('ledger_frames_dropped',
                                            replay.frames_dropped)
            if self._incident_recorder is not None:
                path = self._incident_recorder.trigger(
                    'ledger_corrupt', args=replay.as_dict())
                self._correlate_incident(
                    None, {'bundle': path, 'kind': 'ledger_corrupt',
                           'cause': 'corruption'})
        elif replay.result == 'ok' and replay.records:
            breaker.record_success()
        self.scheduler.adopt_replay(replay, self._ledger.epoch)
        self.scheduler.journal = self._ledger
        trace_instant('ledger_replay', args=replay.as_dict())

    @property
    def service_url(self) -> str:
        """The URL readers pass as ``make_reader(service_url=...)``."""
        return 'tcp://{}:{}'.format(self._host, self._port)

    def state(self) -> Dict[str, Any]:
        """The scheduler snapshot (same dict the ``state`` request returns),
        plus the ``autotune`` controller report when retuning is armed and
        the correlated ``incidents`` view when the incident plane is."""
        state = self.scheduler.state()
        # a reply at all means the pump is live — fetch_service_state's
        # hello-probe path reports 'starting' for a bound-but-silent socket
        state['state'] = 'serving'
        state['ledger'] = self.ledger_state()
        if self._autotune is not None:
            state['autotune'] = self._autotune.report()
        if self._incident_recorder is not None:
            state['incidents'] = self.incidents_state()
        if self._history is not None:
            state['history'] = self._history.state()
        if self._sentinel is not None:
            state['sentinel'] = self._sentinel.report()
        return state

    def ledger_state(self) -> Dict[str, Any]:
        """The durable-ledger status block for ``state()`` and doctor:
        armed flag, journal path/epoch, last replay result and the frames
        the CRC dropped."""
        if self._ledger is None:
            return {'armed': False}
        out: Dict[str, Any] = self._ledger.state()
        return out

    # ----------------------------------------------------- run history plane

    def build_history_record(self) -> Optional[Dict[str, Any]]:
        """The structured run record this dispatcher would append at
        ``stop()`` (docs/observability.md "Longitudinal observatory"):
        service config/knob fingerprints, items-served rate, incident
        counters. None when built without ``history``. Knob values are read
        live — call before the autotuner would restore anything."""
        if self._history_policy is None:
            return None
        from petastorm_tpu_torch.telemetry.history import (build_run_record,
                                                     fingerprint)
        elapsed = 0.0
        if self._started_at is not None:
            elapsed = max(time.monotonic() - self._started_at, 0.0)
        scheduler = self.scheduler
        knobs: Dict[str, float] = {}
        try:
            from petastorm_tpu_torch.autotune.knobs import build_service_knobs
            knobs = {knob.knob_id: float(knob.get())
                     for knob in build_service_knobs(scheduler)}
        except Exception:  # noqa: BLE001 - the record is advisory; a dead knob target must not fail stop()
            logger.debug('history: service knob capture failed',
                         exc_info=True)
        fingerprints: Dict[str, Optional[str]] = {
            'config': fingerprint({
                'admission_window': scheduler.admission_window,
                'quantum': scheduler.quantum,
                'stale_timeout_s': scheduler.stale_timeout_s,
                'max_item_attempts': scheduler.max_item_attempts,
                'item_deadline_s': scheduler.item_deadline_s,
                'client_ttl_s': scheduler.client_ttl_s,
                'ledger': bool(self._ledger_path),
            }),
            'knobs': fingerprint(knobs) if knobs else None,
        }
        incidents: Optional[Dict[str, Any]] = None
        if self._incident_recorder is not None:
            incidents = self._incident_recorder.report()
        return build_run_record(
            'dispatcher', SERVICE_DATASET_TOKEN, elapsed,
            int(scheduler.items_served),
            snapshot=self.fleet_metrics_snapshot(),
            fingerprints=fingerprints, knobs=knobs,
            incidents=incidents)

    def _write_history_record(self) -> None:
        """Append this run's record to the longitudinal store — idempotent,
        best-effort, skipped entirely without an explicit store path (the
        dispatcher has no dataset home to default into)."""
        if self._history is None or self._history_written:
            return
        self._history_written = True
        try:
            record = self.build_history_record()
            if record is not None:
                self._history.append(record)
        except Exception:  # noqa: BLE001 - history is advisory; a service that served must not fail over its memory
            logger.warning('dispatcher: could not record this run in the '
                           'history store', exc_info=True)

    def history_report(self) -> Optional[Dict[str, Any]]:
        """The historian's store status (path, appended count, dropped
        frames); None when built without a history store path."""
        if self._history is None:
            return None
        out: Dict[str, Any] = self._history.state()
        return out

    # -------------------------------------------------------- metrics plane

    def record_worker_metrics(self, worker_id: int, seq: int,
                              snapshot: Dict[str, Any]) -> None:
        """Adopt one worker's cumulative telemetry snapshot (``w_metrics``);
        a stale ``seq`` never rolls a fresher view backwards, and a frame
        from an UNREGISTERED worker (a departed worker's straggler, same as
        ``scheduler.heartbeat``'s unknown-id drop) never resurrects a
        popped entry."""
        if not self.scheduler.has_worker_id(worker_id):
            return
        with self._worker_metrics_lock:
            current = self._worker_metrics.get(worker_id)
            if current is not None and current[0] >= seq:
                return
            self._worker_metrics[worker_id] = (seq, snapshot)

    def worker_metrics_snapshots(self) -> Dict[str, Dict[str, Any]]:
        """Latest per-worker snapshots keyed by worker id (the per-worker
        labeled block of the fleet scrape)."""
        with self._worker_metrics_lock:
            return {str(worker_id): snapshot
                    for worker_id, (_seq, snapshot)
                    in self._worker_metrics.items()}

    def fleet_metrics_snapshot(self) -> Dict[str, Any]:
        """ONE fleet-wide registry snapshot: the scheduler's control-signal
        gauges/counters merged (additively, per worker) with every worker's
        latest heartbeat snapshot — plus the dispatcher-side incident
        counters when the incident plane is armed — what ``/metrics``
        renders as the aggregate block (docs/observability.md "Live metrics
        plane")."""
        from petastorm_tpu_torch.telemetry.registry import merge_snapshots
        with self._worker_metrics_lock:
            snapshots = [snapshot for _seq, snapshot
                         in self._worker_metrics.values()]
        if self._incident_registry is not None:
            snapshots.append(self._incident_registry.snapshot())
        return merge_snapshots(self.scheduler.autotune_snapshot(), *snapshots)

    # ------------------------------------------------------- incident plane

    def record_worker_incident(self, worker_id: int, seq: int,
                               reference: Dict[str, Any]) -> None:
        """Adopt one worker-shipped incident reference (``w_incident``):
        unknown-worker stragglers are dropped (same guard as
        :meth:`record_worker_metrics` — a departed worker's late frame must
        not resurrect it), a stale ``seq`` is dropped, inline bundles are
        materialized into the dispatcher's home, and the reference joins the
        fleet correlation."""
        if self._incident_recorder is None:
            return
        if not self.scheduler.has_worker_id(worker_id):
            return
        with self._incident_lock:
            current = self._worker_incident_seq.get(worker_id)
            if current is not None and current >= seq:
                return
            self._worker_incident_seq[worker_id] = seq
        adopted = self._incident_recorder.adopt(reference)
        if adopted is not None:
            reference = dict(reference, bundle=adopted)
        self._correlate_incident(worker_id, reference)

    def _correlate_incident(self, worker_id: Optional[int],
                            reference: Dict[str, Any]) -> None:
        """Fold one incident reference into the fleet view: same-cause
        incidents landing within the correlation window collapse into ONE
        fleet incident spanning every reporting worker — a dataset-wide
        storage outage reads as one event, not workers-many."""
        cause = str(reference.get('cause') or 'unknown')
        kind = str(reference.get('kind') or 'unknown')
        bundle = reference.get('bundle')
        now = time.monotonic()
        with self._incident_lock:
            for entry in self._fleet_incidents:
                if (entry['cause'] == cause
                        and now - entry['_last_monotonic']
                        <= INCIDENT_CORRELATION_WINDOW_S):
                    entry['count'] += 1
                    entry['_last_monotonic'] = now
                    if kind not in entry['kinds']:
                        entry['kinds'].append(kind)
                    if (worker_id is not None
                            and worker_id not in entry['workers']):
                        entry['workers'].append(worker_id)
                    if bundle and len(entry['bundles']) < 8:
                        entry['bundles'].append(str(bundle))
                    return
            self._fleet_incidents.append({
                'cause': cause, 'kinds': [kind], 'count': 1,
                'workers': [worker_id] if worker_id is not None else [],
                'bundles': [str(bundle)] if bundle else [],
                '_first_monotonic': now, '_last_monotonic': now})
            del self._fleet_incidents[:-MAX_FLEET_INCIDENTS]

    def incidents_state(self) -> Dict[str, Any]:
        """The fleet incident view for ``state()``: correlated same-cause
        groups (ages on the dispatcher's clock) plus the capture/rate-limit
        counters and the dispatcher's retained-bundle summary."""
        now = time.monotonic()
        with self._incident_lock:
            fleet = [{'cause': entry['cause'], 'kinds': list(entry['kinds']),
                      'count': entry['count'],
                      'workers': list(entry['workers']),
                      'bundles': list(entry['bundles']),
                      'first_age_s': round(now - entry['_first_monotonic'], 3),
                      'last_age_s': round(now - entry['_last_monotonic'], 3)}
                     for entry in self._fleet_incidents]
        state: Dict[str, Any] = {'fleet': fleet}
        if self._incident_recorder is not None:
            state.update(self._incident_recorder.report())
        return state

    @property
    def metrics_url(self) -> Optional[str]:
        """The fleet scrape endpoint base URL, or None without
        ``metrics_port``."""
        if self._metrics_server is None:
            return None
        url: str = self._metrics_server.url
        return url

    def stop(self) -> None:
        """Stop the pump thread; ``w_stop`` is broadcast to registered
        workers from the pump thread on its way out."""
        if self._metrics_server is not None:
            self._metrics_server.stop()
            self._metrics_server = None
        # record BEFORE the incident recorder closes so the record's
        # incident counters see the final capture totals, and before the
        # pump exits so items_served is this run's true total
        self._write_history_record()
        if self._incident_recorder is not None:
            self._incident_recorder.close()
        self._stop_event.set()

    def crash(self) -> None:
        """Crash simulation (chaos harness / tests): stop the pump WITHOUT
        the worker-tail drain or the ``w_stop`` broadcast — workers and
        clients are left exactly as a SIGKILL of the dispatcher process
        would leave them, except the sockets can be rebound in-process. The
        ledger handle closes abruptly (no terminal record — that is the
        crash-consistency property being exercised)."""
        self._crashed = True
        if self._metrics_server is not None:
            self._metrics_server.stop()
            self._metrics_server = None
        if self._incident_recorder is not None:
            self._incident_recorder.close()
        self._stop_event.set()
        self.join()
        if self._ledger is not None:
            self._ledger.close()
            self._ledger = None

    def join(self, timeout: float = 10.0) -> None:
        """Wait for the pump thread and release the sockets."""
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        if self._ledger is not None:
            self._ledger.close()
        if self._context is not None:
            for sock in (self._client_socket, self._worker_socket):
                if sock is not None:
                    sock.close(linger=0)
            self._context.term()
            self._context = None

    # ----------------------------------------------------------------- pump

    def _pump(self) -> None:
        import zmq
        poller = zmq.Poller()
        poller.register(self._client_socket, zmq.POLLIN)
        poller.register(self._worker_socket, zmq.POLLIN)
        while not self._stop_event.is_set():
            events = dict(poller.poll(100))
            if self._client_socket in events:
                for _ in range(64):  # drain a bounded burst per tick
                    try:
                        frames = self._client_socket.recv_multipart(
                            zmq.NOBLOCK)
                    except zmq.Again:
                        break
                    try:
                        self._handle_client(frames)
                    except Exception:  # noqa: BLE001 - one malformed client frame must not take the whole service down
                        logger.exception('dispatcher: dropping malformed '
                                         'client message')
            if self._worker_socket in events:
                for _ in range(64):
                    try:
                        frames = self._worker_socket.recv_multipart(
                            zmq.NOBLOCK)
                    except zmq.Again:
                        break
                    try:
                        self._handle_worker(frames)
                    except Exception:  # noqa: BLE001 - one malformed worker frame must not take the whole service down
                        logger.exception('dispatcher: dropping malformed '
                                         'worker message')
            self._check_stale()
            if self._autotune is not None:
                try:
                    # window-gated: the controller core decides at most once
                    # per policy window, the pump just offers it the tick
                    self._autotune.maybe_step()
                except Exception:  # noqa: BLE001 - the tuner must never kill the dispatch loop it tunes
                    logger.exception('dispatcher: autotune step failed; '
                                     'pump keeps dispatching')
            if self._sentinel is not None and self._started_at is not None:
                # items-served is the service's rows analog; between window
                # closes this costs one float compare per pump tick
                elapsed = time.monotonic() - self._started_at
                if self._sentinel.due(elapsed):
                    try:
                        self._sentinel.observe_sample(
                            elapsed, int(self.scheduler.items_served))
                        self._sentinel.export_gauges()
                    except Exception:  # noqa: BLE001 - the sentinel must never kill the dispatch loop it watches
                        logger.exception('dispatcher: sentinel window '
                                         'failed; pump keeps dispatching')
            self._dispatch_ready()
        if not self._crashed:
            self._drain_worker_tail()
            self._broadcast_stop()

    def _drain_worker_tail(self) -> None:
        """Final heartbeat-socket drain before the stop broadcast: a worker
        mid-``w_incident`` (or mid-metrics) ship when stop lands would
        otherwise lose those frames AND look like a straggler to the fleet
        reaper. Bounded — shutdown must not hang on a chatty socket."""
        import zmq
        deadline = time.monotonic() + 0.25
        while time.monotonic() < deadline:
            if not self._worker_socket.poll(50, zmq.POLLIN):
                break  # quiet socket: nothing is mid-flight
            for _ in range(64):
                try:
                    frames = self._worker_socket.recv_multipart(zmq.NOBLOCK)
                except zmq.ZMQError:
                    break
                try:
                    self._handle_worker(frames)
                except Exception:  # noqa: BLE001 - the drain is best-effort; a malformed tail frame must not block shutdown
                    pass

    def _broadcast_stop(self) -> None:
        for key in self.scheduler.worker_keys():
            try:
                self._worker_socket.send_multipart([key, MSG_W_STOP])
            except Exception:  # noqa: BLE001 - shutdown is best-effort; the workers' parent watchdog is the backstop
                pass

    # -------------------------------------------------------- client frames

    def _handle_client(self, frames: List[bytes]) -> None:
        if len(frames) < 2:
            return
        identity = frames[0]
        kind = bytes(frames[1])
        if kind == MSG_SUBMIT and len(frames) >= 5:
            if not self.scheduler.has_client(identity):
                # restart / TTL-collected idle client: busy would be a lie
                # (the client would back off forever) — tell it to rejoin
                self._client_socket.send_multipart(
                    [identity, MSG_REJOIN, frames[2]])
                return
            # optional 6th frame: the client scheduler's measured-cost hint
            # (docs/performance.md "Cost-aware scheduling"); absent => 1.0,
            # the historical uniform unit cost
            cost = decode_cost(bytes(frames[5])) if len(frames) >= 6 else 1.0
            token = self.scheduler.submit(identity, bytes(frames[2]),
                                          bytes(frames[3]), frames[4],
                                          cost=cost)
            # every submit reply carries the client's CURRENT window so live
            # clients adopt autotune retuning (a raised window admits more
            # in-flight work; a lowered one ends the busy churn immediately)
            window = b'%d' % self.scheduler.client_window(identity)
            if token is None:
                self._client_socket.send_multipart(
                    [identity, MSG_BUSY, frames[2], window])
            else:
                self._client_socket.send_multipart(
                    [identity, MSG_ACCEPT, frames[2], window])
            return
        if kind == MSG_HELLO and len(frames) >= 5:
            name = bytes(frames[2]).decode('utf-8', 'replace')
            host = bytes(frames[3]).decode('utf-8', 'replace')
            window = int(bytes(frames[4]))
            if name:
                effective = self.scheduler.add_client(identity, name, host,
                                                      window or None)
            else:
                # anonymous probe (fetch_service_state's starting-detector):
                # answer without registering a client record
                effective = self.scheduler.admission_window
            body = json.dumps({
                'workers': self.scheduler.worker_count(),
                'window': effective,
                'host': self._host,
                'ledger_epoch': self.scheduler.ledger_epoch,
            }).encode('utf-8')
            self._client_socket.send_multipart([identity, MSG_WELCOME, body])
            return
        if kind == MSG_LEDGER_SYNC:
            # ledger-epoch handshake: the client's starvation probe (and its
            # post-rejoin resync). 'known' False or a changed epoch tells
            # the client its in-flight tokens died with the previous
            # dispatcher incarnation — it re-arms them instead of waiting
            body = json.dumps({
                'known': self.scheduler.has_client(identity),
                'epoch': self.scheduler.ledger_epoch,
                'ledger': self.ledger_state(),
            }).encode('utf-8')
            self._client_socket.send_multipart(
                [identity, MSG_LEDGER_STATE, body])
            return
        if kind == MSG_OPEN and len(frames) >= 4:
            self.scheduler.add_setup(identity, bytes(frames[2]), frames[3])
            self._client_socket.send_multipart(
                [identity, MSG_OPENED, frames[2]])
            return
        if kind == MSG_STATE:
            body = json.dumps(self.state()).encode('utf-8')
            self._client_socket.send_multipart([identity, MSG_STATE, body])
            return
        if kind == MSG_SHM_FAIL and len(frames) >= 3:
            # the client could not attach a co-located segment — redeliver
            # (wire-pinned); past the attempt budget, fail it loudly
            failed = self.scheduler.requeue_token(int(bytes(frames[2])))
            if failed is not None:
                self._send_attempt_exhausted(failed[1], failed[2])
            return
        if kind == MSG_BYE:
            self.scheduler.remove_client(identity)
            return
        logger.debug('dispatcher: unknown client message kind %r', kind)

    # -------------------------------------------------------- worker frames

    def _handle_worker(self, frames: List[bytes]) -> None:
        if len(frames) < 2:
            return
        identity = frames[0]
        kind = bytes(frames[1])
        if kind == MSG_W_HEARTBEAT and len(frames) >= 4:
            self.scheduler.heartbeat(int(bytes(frames[2])),
                                     int(bytes(frames[3])))
            return
        if kind == MSG_W_METRICS and len(frames) >= 3:
            from petastorm_tpu_torch.service.wire import WorkerMetricsUpdate
            update = WorkerMetricsUpdate.from_bytes(bytes(frames[2]))
            self.record_worker_metrics(update.worker_id, update.seq,
                                       update.snapshot)
            return
        if kind == MSG_W_INCIDENT and len(frames) >= 3:
            from petastorm_tpu_torch.service.wire import WorkerIncidentUpdate
            incident = WorkerIncidentUpdate.from_bytes(bytes(frames[2]))
            self.record_worker_incident(incident.worker_id, incident.seq,
                                        incident.reference)
            return
        if kind == MSG_W_RESULT and len(frames) >= 4:
            token = int(bytes(frames[2]))
            route = self.scheduler.result_route(token)
            if route is not None:
                client_key, client_token = route
                self._client_socket.send_multipart(
                    [client_key, MSG_RESULT, client_token] + frames[4:])
            return
        if kind == MSG_W_RESULT_SHM and len(frames) >= 5:
            token = int(bytes(frames[2]))
            route = self.scheduler.result_route(token)
            if route is not None:
                client_key, client_token = route
                self._client_socket.send_multipart(
                    [client_key, MSG_RESULT_SHM, client_token, frames[4]])
            return
        if kind == MSG_W_DONE and len(frames) >= 4:
            self.scheduler.retire(int(bytes(frames[2])),
                                  int(bytes(frames[3])))
            return
        if kind == MSG_W_ERROR and len(frames) >= 5:
            route = self.scheduler.fail(int(bytes(frames[2])))
            if route is not None:
                client_key, client_token = route
                self._client_socket.send_multipart(
                    [client_key, MSG_ERROR, client_token, frames[4]])
            return
        if kind == MSG_W_READY:
            if not self.scheduler.worker_ready(identity):
                # a live worker from a previous dispatcher incarnation
                # (restart): tell it to re-register — fleet heals in place
                self._worker_socket.send_multipart([identity, MSG_W_REJOIN])
            return
        if kind == MSG_REGISTER and len(frames) >= 3:
            descriptor = WorkerDescriptor.from_bytes(bytes(frames[2]))
            newly = self.scheduler.add_worker(identity, descriptor)
            logger.info('dispatcher: worker %d (pid %d, host %s) registered',
                        descriptor.worker_id, descriptor.pid, descriptor.host)
            self._worker_socket.send_multipart([identity, MSG_REGISTERED])
            if newly:
                self._note_reshard('worker-join')
            return
        if kind == MSG_W_NEED_SETUP and len(frames) >= 3:
            failed = self.scheduler.forget_setups(identity,
                                                  int(bytes(frames[2])))
            if failed is not None:
                self._send_attempt_exhausted(failed[1], failed[2])
            return
        if kind == MSG_W_LEAVE:
            self._depart_worker(identity, reason='left')
            return
        logger.debug('dispatcher: unknown worker message kind %r', kind)

    # ------------------------------------------------------------ decisions

    def _send_attempt_exhausted(self, client_key: bytes,
                                client_token: bytes) -> None:
        """Fail one item loudly to its owning client: the item burned its
        whole re-delivery budget (worker deaths, unshippable setup, lost shm
        segments) and re-queuing it again would only poison the fleet."""
        from petastorm_tpu_torch.errors import TransientIOError
        blob = pickle.dumps((
            TransientIOError(
                'work item re-dispatched {} times across service worker '
                'failures; giving up'.format(
                    self.scheduler.max_item_attempts)),
            'service dispatcher: attempt budget exhausted'))
        self._client_socket.send_multipart(
            [client_key, MSG_ERROR, client_token, blob])
        if self._incident_recorder is not None:
            path = self._incident_recorder.trigger(
                'service_poison_item',
                args={'max_item_attempts': self.scheduler.max_item_attempts})
            if path is not None:
                self._correlate_incident(
                    None, {'bundle': path, 'kind': 'service_poison_item',
                           'cause': 'hang'})

    def _depart_worker(self, key: bytes, reason: str) -> None:
        worker_id = self.scheduler.worker_id_of(key)
        if worker_id is not None:
            # the departed worker's series leave the scrape surface with it
            # (Prometheus convention: absent, not frozen-forever)
            with self._worker_metrics_lock:
                self._worker_metrics.pop(worker_id, None)
            with self._incident_lock:
                self._worker_incident_seq.pop(worker_id, None)
        if self._incident_recorder is not None and reason == 'went stale':
            # the dispatcher-side watchdog edge: a worker stopped stamping
            # (SIGKILL, hang, network partition) and its items re-queue
            path = self._incident_recorder.trigger(
                'watchdog_reap',
                args={'worker_id': worker_id, 'reason': reason})
            if path is not None:
                self._correlate_incident(
                    worker_id, {'bundle': path, 'kind': 'watchdog_reap',
                                'cause': 'hang'})
        failed = self.scheduler.remove_worker(key)
        if failed:
            logger.error('dispatcher: %d item(s) exhausted their attempt '
                         'budget when worker %s (%s)', len(failed),
                         key.hex(), reason)
        for _token, client_key, client_token in failed:
            self._send_attempt_exhausted(client_key, client_token)
        self._note_reshard('worker-leave' if reason == 'left'
                           else 'worker-stale')

    def _note_reshard(self, reason: str) -> None:
        """Re-split undelivered work after an elastic worker-set change and
        make the decision observable: a ``reshard`` trace instant on the
        flight recorder plus an incident-correlatable event — repeated
        membership churn then reads as ONE scheduling-skew incident, not
        scattered log lines."""
        summary = self.scheduler.reshard(reason)
        if summary is None:
            return
        from petastorm_tpu_torch.telemetry.tracing import trace_instant
        trace_instant('reshard', args=summary)
        logger.info('dispatcher: resharded %d undelivered item(s) across %d '
                    'worker(s) (%s)', summary['undelivered'],
                    summary['workers'], reason)
        if self._incident_recorder is not None:
            path = self._incident_recorder.trigger('reshard', args=summary)
            self._correlate_incident(
                None, {'bundle': path, 'kind': 'reshard',
                       'cause': 'scheduling-skew'})

    def _check_stale(self) -> None:
        now = time.monotonic()
        if now < self._next_stale_check:
            return
        self._next_stale_check = now + 0.5
        for key in self.scheduler.stale_workers():
            logger.warning('dispatcher: worker %s heartbeat went stale (or '
                           'an item passed its deadline); deregistering and '
                           're-queuing its items', key.hex())
            self._depart_worker(key, reason='went stale')
        for key in self.scheduler.expired_clients():
            logger.info('dispatcher: collecting idle client %s (silent past '
                        'the %gs TTL)', key.hex(),
                        self.scheduler.client_ttl_s)
            self.scheduler.remove_client(key)

    def _dispatch_ready(self) -> None:
        while True:
            assignment = self.scheduler.next_assignment()
            if assignment is None:
                return
            self._worker_socket.send_multipart([
                assignment.worker_key, MSG_WORK,
                b'%d' % assignment.token, assignment.setup_id,
                assignment.blob, b'%d' % assignment.attempt,
                b'1' if assignment.colocated else b'0',
                assignment.setup_blob if assignment.setup_blob is not None
                else b''])
