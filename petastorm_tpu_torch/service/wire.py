"""Service wire helpers: URL parsing and the registration / shm-result
descriptors. A copy of ``petastorm_tpu.service.wire``: the same URL forms,
cost clamp and descriptor byte layouts, so either package's dispatcher,
workers and clients read what the other's write.

The dispatcher, the service worker and the client transport speak a
kind-literal-prefixed multipart protocol (the same style as the process
pool's pipes); the literals live in the peer modules themselves. This module
holds what is shared and structural:

- :func:`parse_service_url` / :func:`worker_endpoint` — one URL names the
  whole service; the worker-registration ROUTER rides on ``port + 1``.
- :class:`WorkerDescriptor` — what a decode worker sends when it registers
  (``register`` message): identity, host token (co-location detection for the
  shm fast path), capacity, and its heartbeat cadence so the dispatcher can
  size the staleness window per worker.
- :class:`ShmResultDescriptor` — the one-shot shared-memory handoff for
  co-located clients: segment name, per-frame lengths, and a CRC-32 of the
  payload (:func:`petastorm_tpu_torch.workers.integrity.payload_checksum`)
  verified before deserialization, as the process pool's ring frames are.
- :class:`WorkerMetricsUpdate` — the fleet metrics-plane piggyback: a
  worker's CUMULATIVE telemetry registry snapshot riding its heartbeat socket
  as ``w_metrics`` frames; the dispatcher keeps the latest per worker
  (``seq``-guarded) and merges them at scrape time, so a dropped update loses
  freshness, never data.
- :class:`WorkerIncidentUpdate` — the ``w_incident`` body of the JAX
  package's incident plane, kept so the formats stay complete; the port's
  workers send none yet (the port has no incident plane).

Every descriptor serializes via ``to_bytes``/``from_bytes`` JSON specs."""

from __future__ import annotations

import json
import socket
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: offset of the worker-registration ROUTER port from the client port: one
#: ``service_url`` names the whole service
WORKER_PORT_OFFSET = 1

#: accepted URL schemes for ``service_url``
_SCHEMES = ('tcp://', 'petastorm-service://')


def parse_service_url(service_url: str) -> Tuple[str, int]:
    """``'tcp://host:port'`` (or ``petastorm-service://``) -> ``(host, port)``.

    The port is the CLIENT endpoint; workers register on
    ``port + WORKER_PORT_OFFSET`` (:func:`worker_endpoint`)."""
    rest = None
    for scheme in _SCHEMES:
        if service_url.startswith(scheme):
            rest = service_url[len(scheme):]
            break
    if rest is None or ':' not in rest:
        raise ValueError(
            'service_url must look like tcp://host:port, got {!r}'
            .format(service_url))
    host, _, port_text = rest.rpartition(':')
    try:
        port = int(port_text)
    except ValueError:
        raise ValueError('service_url port is not an integer: {!r}'
                         .format(service_url))
    if not host:
        raise ValueError('service_url has no host: {!r}'.format(service_url))
    return host, port


def client_endpoint(service_url: str) -> str:
    """The ZMQ endpoint reader clients connect to."""
    host, port = parse_service_url(service_url)
    return 'tcp://{}:{}'.format(host, port)


def worker_endpoint(service_url: str) -> str:
    """The ZMQ endpoint decode workers register on (``client port + 1``)."""
    host, port = parse_service_url(service_url)
    return 'tcp://{}:{}'.format(host, port + WORKER_PORT_OFFSET)


#: clamp for submit cost hints, shared by BOTH sides of the wire: the client
#: scheduler prices items into this range and the dispatcher re-clamps and
#: sizes its DRR guard from the same bound — one constant, so the two sides
#: cannot drift apart
MIN_COST_HINT = 0.25
MAX_COST_HINT = 4.0


def encode_cost(cost: float) -> bytes:
    """Wire form of a ``submit``'s measured-cost hint: the client's cost-aware scheduler prices each
    work item in median-relative units and the dispatcher's DRR charges that
    instead of a uniform unit cost. Plain decimal text, like the token and
    attempt frames."""
    return ('%.6f' % float(cost)).encode('ascii')


def decode_cost(blob: bytes, default: float = 1.0) -> float:
    """Parse a :func:`encode_cost` frame; a malformed or non-positive value
    degrades to ``default`` (uniform cost) — a bad hint must never reject
    the work item it rides on."""
    try:
        cost = float(blob)
    except ValueError:
        return default
    if not cost > 0.0:
        return default
    return cost


def host_token() -> str:
    """Co-location token compared between a client's hello and a worker's
    registration: equal tokens mean same host, so the one-shot shm result
    path is usable (a false match is survivable — the client falls back to
    re-submitting the item when the segment cannot be attached)."""
    return socket.gethostname()


class WorkerDescriptor(object):
    """Registration record a decode worker sends to the dispatcher."""

    __slots__ = ('worker_id', 'pid', 'host', 'capacity',
                 'heartbeat_interval_s', 'shm_results')

    def __init__(self, worker_id: int, pid: int, host: str, capacity: int = 1,
                 heartbeat_interval_s: float = 0.5,
                 shm_results: bool = False) -> None:
        self.worker_id = worker_id
        self.pid = pid
        self.host = host
        self.capacity = capacity
        self.heartbeat_interval_s = heartbeat_interval_s
        self.shm_results = shm_results

    def to_bytes(self) -> bytes:
        """JSON spec for the ``register`` message."""
        spec: Dict[str, Any] = {
            'worker_id': self.worker_id,
            'pid': self.pid,
            'host': self.host,
            'capacity': self.capacity,
            'heartbeat_interval_s': self.heartbeat_interval_s,
            'shm_results': self.shm_results,
        }
        return json.dumps(spec).encode('utf-8')

    @classmethod
    def from_bytes(cls, blob: bytes) -> 'WorkerDescriptor':
        """Decode a :meth:`to_bytes` spec."""
        spec = json.loads(blob.decode('utf-8'))
        return cls(worker_id=int(spec['worker_id']), pid=int(spec['pid']),
                   host=str(spec['host']), capacity=int(spec['capacity']),
                   heartbeat_interval_s=float(spec['heartbeat_interval_s']),
                   shm_results=bool(spec['shm_results']))


class ShmResultDescriptor(object):
    """One-shot shared-memory result handoff (co-located client fast path).

    The worker writes the serialized result frames back-to-back into a fresh
    ``multiprocessing.shared_memory`` segment and ships only this descriptor;
    the client maps the segment, verifies ``crc`` over the payload, copies the
    columns out during deserialization, and unlinks the segment. ``crc`` is
    ``None`` only when checksumming is disabled."""

    __slots__ = ('name', 'frame_lengths', 'crc')

    def __init__(self, name: str, frame_lengths: Sequence[int],
                 crc: Optional[int]) -> None:
        self.name = name
        self.frame_lengths = list(frame_lengths)
        self.crc = crc

    @property
    def total_bytes(self) -> int:
        """Payload size across all frames."""
        return sum(self.frame_lengths)

    def to_bytes(self) -> bytes:
        """JSON spec for the ``w_result_shm`` message."""
        spec: Dict[str, Any] = {
            'name': self.name,
            'frame_lengths': self.frame_lengths,
            'crc': self.crc,
        }
        return json.dumps(spec).encode('utf-8')

    @classmethod
    def from_bytes(cls, blob: bytes) -> 'ShmResultDescriptor':
        """Decode a :meth:`to_bytes` spec."""
        spec = json.loads(blob.decode('utf-8'))
        lengths: List[int] = [int(n) for n in spec['frame_lengths']]
        crc = spec['crc']
        return cls(name=str(spec['name']), frame_lengths=lengths,
                   crc=int(crc) if crc is not None else None)


class WorkerMetricsUpdate(object):
    """One worker's cumulative telemetry snapshot for the fleet metrics
    plane (``w_metrics`` message body — module docstring). ``seq`` orders
    updates so a late-delivered older snapshot can never roll a worker's
    fleet view backwards."""

    __slots__ = ('worker_id', 'seq', 'snapshot')

    def __init__(self, worker_id: int, seq: int,
                 snapshot: Dict[str, Any]) -> None:
        self.worker_id = worker_id
        self.seq = seq
        self.snapshot = snapshot

    def to_bytes(self) -> bytes:
        """JSON spec for the ``w_metrics`` message."""
        spec: Dict[str, Any] = {
            'worker_id': self.worker_id,
            'seq': self.seq,
            'snapshot': self.snapshot,
        }
        return json.dumps(spec).encode('utf-8')

    @classmethod
    def from_bytes(cls, blob: bytes) -> 'WorkerMetricsUpdate':
        """Decode a :meth:`to_bytes` spec."""
        spec = json.loads(blob.decode('utf-8'))
        snapshot = spec['snapshot']
        return cls(worker_id=int(spec['worker_id']), seq=int(spec['seq']),
                   snapshot=dict(snapshot) if snapshot else {})


class WorkerIncidentUpdate(object):
    """One worker-captured incident-bundle reference (``w_incident`` message
    body of the JAX package's incident plane; ``reference`` is its bundle
    reference dict — kind, cause, context, size, and the inlined bundle files
    when the bundle fit under the shipping cap). ``seq`` orders ships so a late-delivered older
    incident can never be double-adopted after a newer one."""

    __slots__ = ('worker_id', 'seq', 'reference')

    def __init__(self, worker_id: int, seq: int,
                 reference: Dict[str, Any]) -> None:
        self.worker_id = worker_id
        self.seq = seq
        self.reference = reference

    def to_bytes(self) -> bytes:
        """JSON spec for the ``w_incident`` message."""
        spec: Dict[str, Any] = {
            'worker_id': self.worker_id,
            'seq': self.seq,
            'reference': self.reference,
        }
        return json.dumps(spec).encode('utf-8')

    @classmethod
    def from_bytes(cls, blob: bytes) -> 'WorkerIncidentUpdate':
        """Decode a :meth:`to_bytes` spec."""
        spec = json.loads(blob.decode('utf-8'))
        reference = spec['reference']
        return cls(worker_id=int(spec['worker_id']), seq=int(spec['seq']),
                   reference=dict(reference) if reference else {})
