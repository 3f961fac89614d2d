"""Elastic topology plane: negotiated per-host rowgroup shards, a durable
CRC-framed membership journal, and host-failure resharding whose determinism
is provable from composed lineage digests. A copy of
``petastorm_tpu.parallel.topology``: the same journal frames, record kinds,
deals and digests, so each package replays the other's journal and composes
the other's manifests.

Static ``cur_shard``/``shard_count`` sharding freezes the host set at
construction: a host lost mid-epoch on a pod either wedges the epoch or
silently changes every sibling's sample stream. This module replaces the
static pair with a *negotiated* shard map keyed on the process topology
(an initialized ``torch.distributed`` group's rank and world size,
env-overridable with ``PETASTORM_TPU_PROCESS_INDEX`` /
``PETASTORM_TPU_PROCESS_COUNT`` so CPU tests simulate pods as plain
processes), recorded in a membership journal
on shared storage with the exact durability discipline of the dispatcher
token ledger (``service/ledger.py``): length+CRC32 framed JSON records,
one ``flush()`` per append, torn-tail-tolerant replay that stops at the
first bad frame and counts it, and atomic snapshot compaction.

The journal differs from the single-writer token ledger in one deliberate
way: every host appends to the same file, so in-place rotation (which
re-points the inode under concurrent writers) is unsafe. Compaction
therefore happens only at :meth:`MembershipJournal.open` — a natural
synchronization barrier, since hosts (re)open at epoch start — where the
replayed state is collapsed into one ``epoch`` snapshot record via
tempfile + fsync + ``os.replace``.

Determinism is proven, not promised: each host's lineage manifest header
carries the negotiated topology (count / index / shard map / reshard
generation), and :func:`compose_global_digest` folds the per-host item
streams into a single *topology-invariant* global digest — identical for
the same seed at 1, 2 or 4 hosts, and across a mid-epoch reshard, because
item identities are global and each rowgroup is delivered exactly once
per epoch regardless of which host carried it.

On host leave/lease-expiry the survivors re-deal ONLY undelivered
rowgroups, in ventilation order (the input service's reshard contract at
host scale): :func:`undelivered_items` subtracts journaled ``progress``
records from the epoch's global item set, and
:func:`reshard_assignments` round-robins the remainder over the
surviving members in enumeration order. Cross-topology checkpoint
restore (save on 4 hosts, resume on 2) goes through
:func:`merge_topology_states` — never through raw ``state_dict`` swaps.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import sys
import tempfile
import time
import zlib
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, FrozenSet, List, Optional, Sequence,
                    Tuple)

logger = logging.getLogger(__name__)

#: env overrides for the process identity — lets CPU tests (and torn-off
#: launchers) simulate a pod as plain processes without a distributed
#: runtime (mesh.distributed_shard_info consults the same pair)
PROCESS_INDEX_ENV = 'PETASTORM_TPU_PROCESS_INDEX'
PROCESS_COUNT_ENV = 'PETASTORM_TPU_PROCESS_COUNT'

#: membership journal sidecar basename (lives in the dataset's local state
#: home next to the cost ledger / lineage manifest sidecars)
TOPOLOGY_JOURNAL_BASENAME = '_petastorm_tpu_topology_journal.bin'

#: every record kind the journal writes / the replay folds (the two-sided
#: registry the JAX package's static analyzer checks writer and replay
#: against), mirroring LEDGER_RECORD_KINDS:
#: ``epoch``     — journal generation bump / compaction snapshot
#: ``join``      — a host announced itself with its process identity
#: ``leave``     — a host departed cleanly (reader stop)
#: ``lease``     — a host's liveness heartbeat (expiry => presumed dead)
#: ``progress``  — one globally-indexed item was delivered on some host
#: ``reshard``   — survivors re-dealt the undelivered remainder
TOPOLOGY_RECORD_KINDS = ('epoch', 'join', 'leave', 'lease', 'progress',
                         'reshard')

#: journal frame header: payload length + CRC32(payload) — identical wire
#: discipline to the dispatcher token ledger (service/ledger.py)
_FRAME_HEADER = struct.Struct('>II')

#: compact-at-open threshold (same default as the token ledger)
DEFAULT_ROTATE_BYTES = 4 << 20

#: membership lease duration: a host silent for longer is presumed dead
#: and its undelivered shard becomes re-dealable
DEFAULT_LEASE_S = 30.0

#: renew the lease after this fraction of the lease window has elapsed
_LEASE_RENEW_FRACTION = 0.5


def resolve_process_identity(process_index: Optional[int] = None,
                             process_count: Optional[int] = None
                             ) -> Tuple[int, int]:
    """The (process_index, process_count) identity this host negotiates
    with, resolved in precedence order: explicit pair > the
    ``PETASTORM_TPU_PROCESS_INDEX/_COUNT`` env pair > an initialized
    ``torch.distributed`` group of more than one rank > single-host
    ``(0, 1)``. Either source must supply BOTH
    values — a half-specified identity is a config error, not a guess."""
    if (process_index is None) != (process_count is None):
        raise ValueError(
            'process_index and process_count must be passed together, got '
            'process_index={!r} process_count={!r}'.format(
                process_index, process_count))
    if process_index is None:
        env_index = os.environ.get(PROCESS_INDEX_ENV)
        env_count = os.environ.get(PROCESS_COUNT_ENV)
        if (env_index is None) != (env_count is None):
            raise ValueError(
                '{} and {} must be set together, got index={!r} count={!r}'
                .format(PROCESS_INDEX_ENV, PROCESS_COUNT_ENV,
                        env_index, env_count))
        if env_index is not None and env_count is not None:
            process_index, process_count = int(env_index), int(env_count)
    if process_index is None or process_count is None:
        # a group exists only in a process that imported torch: one that did
        # not (a process-pool worker) is not made to load it here
        dist = sys.modules.get('torch.distributed')
        try:
            if (dist is not None and dist.is_available() and dist.is_initialized()
                    and dist.get_world_size() > 1):
                process_index = int(dist.get_rank())
                process_count = int(dist.get_world_size())
        except Exception:  # noqa: BLE001 - no usable group = single host
            pass
    if process_index is None or process_count is None:
        return 0, 1
    if process_count < 1:
        raise ValueError('process_count must be >= 1, got {!r}'
                         .format(process_count))
    if not 0 <= process_index < process_count:
        raise ValueError('process_index must be in [0, {}), got {!r}'
                         .format(process_count, process_index))
    return process_index, process_count


@dataclass(frozen=True)
class TopologyPolicy:
    """The ``topology=`` kwarg contract of ``make_reader`` (``True`` means
    this default policy). ``journal_path`` overrides the membership journal
    location (default: the dataset's local-state-home sidecar — required
    explicitly for remote stores with no cache). ``process_index`` /
    ``process_count`` pin the identity (default: negotiated — env pair,
    then ``torch.distributed``). ``host_id`` names this member in the journal (default:
    ``host-<process_index>``). ``assignment`` pins an explicit global
    rowgroup-index shard (the recovery path after a reshard); with
    ``generation`` > 0 the reader records itself as a reshard survivor."""

    journal_path: Optional[str] = None
    process_index: Optional[int] = None
    process_count: Optional[int] = None
    host_id: Optional[str] = None
    lease_s: float = DEFAULT_LEASE_S
    assignment: Optional[Tuple[int, ...]] = None
    generation: int = 0

    def __post_init__(self) -> None:
        """Validate bounds at construction time (frozen-policy idiom)."""
        if (self.process_index is None) != (self.process_count is None):
            raise ValueError(
                'process_index and process_count must be set together, got '
                'process_index={!r} process_count={!r}'.format(
                    self.process_index, self.process_count))
        if self.process_count is not None:
            if self.process_count < 1:
                raise ValueError('process_count must be >= 1, got {!r}'
                                 .format(self.process_count))
            if (self.process_index is None
                    or not 0 <= self.process_index < self.process_count):
                raise ValueError(
                    'process_index must be in [0, {}), got {!r}'.format(
                        self.process_count, self.process_index))
        if self.lease_s <= 0:
            raise ValueError('lease_s must be > 0, got {!r}'
                             .format(self.lease_s))
        if self.generation < 0:
            raise ValueError('generation must be >= 0, got {!r}'
                             .format(self.generation))
        if self.assignment is not None:
            object.__setattr__(self, 'assignment',
                               tuple(int(i) for i in self.assignment))


def resolve_topology_policy(value: Any) -> Optional[TopologyPolicy]:
    """Accept ``None``/``False`` (static sharding, byte-identical seed
    path), ``True`` (default policy), a journal path string, or a
    :class:`TopologyPolicy` — the ``topology=`` kwarg contract."""
    if value is None or value is False:
        return None
    if value is True:
        return TopologyPolicy()
    if isinstance(value, str):
        return TopologyPolicy(journal_path=value)
    if isinstance(value, TopologyPolicy):
        return value
    raise TypeError('topology= accepts None/False, True, a journal path, '
                    'or a TopologyPolicy; got {!r}'.format(value))


def default_topology_journal_path(dataset_url_or_path: str,
                                  cache_location: Optional[str] = None
                                  ) -> Optional[str]:
    """Where the membership journal lives for one dataset:
    ``local_state_home(...)/_petastorm_tpu_topology_journal.bin``, or None
    when the dataset has no local state home (remote store, no cache) —
    the caller must then pass ``TopologyPolicy(journal_path=...)``."""
    from petastorm_tpu_torch.dataset_state import sidecar_path
    return sidecar_path(dataset_url_or_path, TOPOLOGY_JOURNAL_BASENAME,
                        cache_location)


def deal_assignment(process_index: int, process_count: int,
                    num_rowgroups: int) -> Tuple[int, ...]:
    """The initial (generation-0) deal: global rowgroup indices
    ``i % process_count == process_index`` — exactly the static modulo
    split ``Reader._partition_row_groups`` applies, so an undisturbed
    topology-armed pod reads the same per-host streams as static
    ``cur_shard``/``shard_count`` and the composed digest matches the
    single-host run by construction."""
    return tuple(range(process_index, num_rowgroups, process_count))


# --------------------------------------------------------------- replay


@dataclass
class TopologyReplay:
    """Everything a journal replay reconstructs: the membership roster with
    lease expiries, the globally-indexed delivered set, the current shard
    map and reshard generation, and how the replay itself went (``result``
    is ``absent`` / ``ok`` / ``corrupt``; ``frames_dropped`` counts frames
    rejected by CRC/framing — a torn tail is ONE dropped frame and a
    healthy journal)."""

    result: str = 'absent'
    generation: int = 0
    members: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    delivered: FrozenSet[Tuple[int, int, int]] = frozenset()
    shard_map: Dict[str, Tuple[int, ...]] = field(default_factory=dict)
    resharded: int = 0
    frames_dropped: int = 0
    records: int = 0

    def apply(self, record: Dict[str, Any]) -> None:
        """Fold one journal record (replay side of the two-sided record-kind
        registry — every arm here names a TOPOLOGY_RECORD_KINDS member)."""
        kind = record.get('kind')
        delivered = set(self.delivered)
        if kind == 'epoch':
            self.generation = int(record.get('generation', self.generation))
        elif kind == 'join':
            host = str(record.get('host'))
            self.members[host] = {
                'process_index': record.get('process_index'),
                'process_count': record.get('process_count'),
                'expiry': float(record.get('expiry', 0.0)),
                'alive': True,
            }
        elif kind == 'leave':
            host = str(record.get('host'))
            if host in self.members:
                self.members[host]['alive'] = False
        elif kind == 'lease':
            host = str(record.get('host'))
            if host in self.members:
                self.members[host]['expiry'] = float(
                    record.get('expiry', 0.0))
        elif kind == 'progress':
            delivered.add((int(record.get('epoch', 0)),
                           int(record.get('index', -1)),
                           int(record.get('drop', 0))))
            self.delivered = frozenset(delivered)
        elif kind == 'reshard':
            self.resharded += 1
            self.generation = int(record.get('generation', self.generation))
            assignments = record.get('assignments') or {}
            self.shard_map = {
                str(host): tuple(int(i) for i in indices)
                for host, indices in assignments.items()}
        self.records += 1

    def stale_leases(self, now: float) -> List[str]:
        """Hosts still marked alive whose lease expired before ``now`` —
        presumed dead; their undelivered shard is re-dealable."""
        return sorted(host for host, info in self.members.items()
                      if info.get('alive') and float(
                          info.get('expiry', 0.0)) < now)

    def as_dict(self) -> Dict[str, Any]:
        """JSON-ready summary for diagnostics / the doctor report."""
        return {'result': self.result, 'generation': self.generation,
                'members': {host: dict(info)
                            for host, info in sorted(self.members.items())},
                'delivered': len(self.delivered),
                'resharded': self.resharded,
                'frames_dropped': self.frames_dropped,
                'records': self.records}


def read_frames(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """Decode journal frames until the first bad one (short header, short
    payload, CRC mismatch, non-JSON) — a torn tail from a crashed append
    truncates the replay, never corrupts it. Returns (records,
    dropped_count); dropped is 1 when a trailing frame was rejected."""
    records: List[Dict[str, Any]] = []
    dropped = 0
    with open(path, 'rb') as stream:
        while True:
            header = stream.read(_FRAME_HEADER.size)
            if not header:
                break
            if len(header) < _FRAME_HEADER.size:
                dropped += 1
                break
            length, crc = _FRAME_HEADER.unpack(header)
            payload = stream.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                dropped += 1
                break
            try:
                record = json.loads(payload.decode('utf-8'))
            except (UnicodeDecodeError, json.JSONDecodeError):
                dropped += 1
                break
            records.append(record)
    return records, dropped


def replay_topology_journal(path: str) -> TopologyReplay:
    """Replay a membership journal into a :class:`TopologyReplay`.
    ``result`` is ``absent`` (no journal — a fresh pod), ``ok`` (every
    frame decoded) or ``corrupt`` (replay stopped at a bad frame; the
    prefix before it still replayed — degraded loudly, never silently)."""
    replay = TopologyReplay()
    if not os.path.exists(path):
        return replay
    records, dropped = read_frames(path)
    replay.frames_dropped = dropped
    for record in records:
        replay.apply(record)
    replay.result = 'corrupt' if dropped else 'ok'
    return replay


# --------------------------------------------------------------- journal


class MembershipJournal:
    """Durable multi-writer membership journal (module doc): the token
    ledger's frame/flush/replay discipline with compact-at-open instead of
    in-place rotation. All topology record kinds are journaled through the
    typed ``note_*`` wrappers below so the writer-side kind literals live
    in exactly one module, audited against TOPOLOGY_RECORD_KINDS."""

    def __init__(self, path: str, rotate_bytes: int = DEFAULT_ROTATE_BYTES,
                 clock: Callable[[], float] = time.time) -> None:
        self.path = path
        self.rotate_bytes = rotate_bytes
        self._clock = clock
        self._file: Optional[Any] = None
        self._appended = 0
        self.last_replay: Optional[TopologyReplay] = None

    def open(self) -> TopologyReplay:
        """Replay the journal (tolerating a torn tail), compact it into one
        snapshot record when it outgrew ``rotate_bytes``, then open for
        appending. Returns the replay so the caller can seed its shard map
        and surface ``frames_dropped`` loudly."""
        replay = replay_topology_journal(self.path)
        self.last_replay = replay
        if (os.path.exists(self.path)
                and os.path.getsize(self.path) >= self.rotate_bytes):
            self._compact(replay)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._file = open(self.path, 'ab')
        self.append_record('epoch', generation=replay.generation)
        return replay

    def append_record(self, kind: str, **fields: Any) -> None:
        """Append one framed record and flush — each append is durable on
        its own, so a crash between appends loses at most the torn tail
        the replay already tolerates. IO errors are logged, not raised: a
        full shared disk degrades membership, it must not kill the read."""
        if self._file is None:
            return
        record = dict(fields, kind=kind)
        payload = json.dumps(record, sort_keys=True).encode('utf-8')
        frame = _FRAME_HEADER.pack(len(payload),
                                   zlib.crc32(payload)) + payload
        try:
            self._file.write(frame)
            self._file.flush()
            self._appended += 1
        except OSError:
            logger.exception('topology journal append failed (%s); '
                             'membership continues undurably', self.path)

    # Typed writer surface: callers journal through these so topology kind
    # literals never leak into reader.py / chaos.py (the protocol rule
    # audits append_record literals per module).

    def note_join(self, host: str, process_index: int, process_count: int,
                  generation: int, lease_s: float) -> None:
        """Announce ``host`` with its negotiated identity and first lease."""
        self.append_record('join', host=host, process_index=process_index,
                           process_count=process_count,
                           generation=generation,
                           expiry=self._clock() + lease_s)

    def note_leave(self, host: str) -> None:
        """Record a clean departure (reader stop)."""
        self.append_record('leave', host=host)

    def note_lease(self, host: str, lease_s: float) -> None:
        """Renew ``host``'s liveness lease."""
        self.append_record('lease', host=host,
                           expiry=self._clock() + lease_s)

    def note_progress(self, host: str, epoch: int, index: int,
                      drop: int) -> None:
        """Record delivery of one globally-indexed item — the undelivered
        set a reshard re-deals is everything NOT journaled here."""
        self.append_record('progress', host=host, epoch=epoch, index=index,
                           drop=drop)

    def note_reshard(self, generation: int,
                     assignments: Dict[str, Sequence[int]],
                     reason: str) -> None:
        """Record a re-deal of the undelivered remainder over survivors."""
        self.append_record('reshard', generation=generation,
                           assignments={host: list(indices) for host, indices
                                        in sorted(assignments.items())},
                           reason=reason)

    def _compact(self, replay: TopologyReplay) -> None:
        """Collapse the journal into one ``epoch`` snapshot record,
        atomically (tempfile + fsync + ``os.replace``) — only ever called
        from :meth:`open`, the multi-writer synchronization barrier."""
        record = {'kind': 'epoch', 'generation': replay.generation,
                  'compacted': replay.records}
        payload = json.dumps(record, sort_keys=True).encode('utf-8')
        frame = _FRAME_HEADER.pack(len(payload),
                                   zlib.crc32(payload)) + payload
        parent = os.path.dirname(self.path) or '.'
        handle, temp_path = tempfile.mkstemp(dir=parent,
                                             prefix='.topology-compact-')
        try:
            with os.fdopen(handle, 'wb') as stream:
                stream.write(frame)
                stream.flush()
                os.fsync(stream.fileno())
            os.replace(temp_path, self.path)
        except OSError:
            logger.exception('topology journal compaction failed (%s); '
                             'continuing with the uncompacted journal',
                             self.path)
        finally:
            # no-op after a successful os.replace; on ANY failure path
            # (OSError or not) the orphaned temp file is removed
            try:
                os.unlink(temp_path)
            except OSError:
                pass

    def state(self) -> Dict[str, Any]:
        """Diagnostics block (ledger-state idiom): armed flag, path, append
        count, plus the last replay's result/drops when one ran."""
        block: Dict[str, Any] = {'armed': self._file is not None,
                                 'path': self.path,
                                 'appended': self._appended}
        if self.last_replay is not None:
            block['last_replay'] = self.last_replay.result
            block['frames_dropped'] = self.last_replay.frames_dropped
            block['records_replayed'] = self.last_replay.records
            block['generation'] = self.last_replay.generation
        return block

    def close(self) -> None:
        """Flush and close with NO terminal record — a clean stop and a
        crash replay identically (the ledger's crash-equivalence rule)."""
        if self._file is None:
            return
        try:
            self._file.flush()
            self._file.close()
        except OSError:
            logger.exception('topology journal close failed (%s)', self.path)
        self._file = None


# --------------------------------------------------------------- reshard


def undelivered_items(num_rowgroups: int, epoch: int,
                      delivered: FrozenSet[Tuple[int, int, int]],
                      drop_partitions: int = 1) -> List[Tuple[int, int]]:
    """The re-dealable remainder of ``epoch``: every (global_index, drop)
    item NOT journaled as progress, in ventilation order (ascending global
    index, then drop) — the order the reshard contract preserves."""
    remainder = []
    for index in range(num_rowgroups):
        for drop in range(drop_partitions):
            if (epoch, index, drop) not in delivered:
                remainder.append((index, drop))
    return remainder


def reshard_assignments(undelivered: Sequence[Tuple[int, int]],
                        survivors: Sequence[str]
                        ) -> Dict[str, Tuple[int, ...]]:
    """Round-robin the undelivered remainder over ``survivors`` in
    enumeration order — deterministic given the same remainder and roster,
    so every survivor computes the identical deal from its own replay.
    Returns global rowgroup indices per host (deduplicated, ordered)."""
    if not survivors:
        raise ValueError('cannot reshard over an empty survivor set')
    dealt: Dict[str, List[int]] = {host: [] for host in survivors}
    for position, (index, _drop) in enumerate(undelivered):
        host = survivors[position % len(survivors)]
        if index not in dealt[host]:
            dealt[host].append(index)
    return {host: tuple(indices) for host, indices in dealt.items()}


# ----------------------------------------------------------- composition


def compose_global_digest(manifest_paths: Sequence[str]) -> Dict[str, Any]:
    """Fold per-host lineage manifests into ONE topology-invariant global
    digest: collect every delivered item row from each manifest's newest
    segment, require a shared dataset token, sort the union canonically by
    item identity, and fold from the genesis digest — the same chain rule
    ``lineage verify`` applies to a single host. Identical for any host
    count and across a mid-epoch reshard, because item identities are
    global (epoch, fragment, rowgroup, row range, drop) and each is
    delivered exactly once per epoch. Duplicate identities (a rowgroup
    delivered twice — a broken reshard) are counted, never masked."""
    from petastorm_tpu_torch.telemetry.lineage import (fold_digest, genesis_digest,
                                                 load_manifest,
                                                 manifest_items)
    dataset_token: Optional[str] = None
    items: List[Tuple[List[Any], int]] = []
    for path in manifest_paths:
        segments = load_manifest(path)
        if not segments:
            raise ValueError('lineage manifest {!r} has no segments'
                             .format(path))
        segment = segments[-1]
        token = segment['header'].get('dataset_token')
        if dataset_token is None:
            dataset_token = token
        elif token != dataset_token:
            raise ValueError(
                'manifest {!r} belongs to dataset token {!r}, expected '
                '{!r} — digests of different datasets do not compose'
                .format(path, token, dataset_token))
        for item in manifest_items(segment):
            identity = [item[0], item[1], item[2], item[3], item[4]]
            items.append((identity, int(item[5])))
    if dataset_token is None:
        raise ValueError('no manifests to compose')
    keys = [json.dumps(identity, sort_keys=True)
            for identity, _rows in items]
    duplicates = sorted(key for key in set(keys) if keys.count(key) > 1)
    order = sorted(range(len(items)), key=lambda i: keys[i])
    digest = genesis_digest(dataset_token)
    total_rows = 0
    for position in order:
        identity, rows = items[position]
        digest = fold_digest(digest, identity, rows)
        total_rows += rows
    return {'digest': digest, 'items': len(items), 'rows': total_rows,
            'duplicates': duplicates, 'hosts': len(manifest_paths),
            'dataset_token': dataset_token}


# ------------------------------------------------- cross-topology restore


def merge_topology_states(states: Sequence[Dict[str, Any]],
                          new_count: int) -> List[Dict[str, Any]]:
    """Re-deal a full pod's saved reader states onto a DIFFERENT host
    count (save on 4 hosts, resume on 2): map every host's consumed
    (piece, drop) pairs to global rowgroup indices through its saved
    assignment, then cut generation-0 deals for ``new_count`` hosts and
    project the global consumed set back into each new host's local piece
    space. The merged states carry a ``topology`` block naming the new
    deal; feed each to ``make_reader(topology=policy_from_state(state),
    resume_state=state)``. Refuses mid-batch cursors and mismatched
    epochs — only a batch-aligned, pod-consistent save resumes exactly."""
    if new_count < 1:
        raise ValueError('new_count must be >= 1, got {!r}'
                         .format(new_count))
    if not states:
        raise ValueError('no states to merge')
    epochs: List[int] = []
    global_rowgroups: Optional[int] = None
    consumed_global: Dict[int, set] = {}
    for state in states:
        topo = state.get('topology')
        if not topo:
            raise ValueError(
                'state_dict was not saved by a topology-armed reader — '
                'cross-topology restore requires the negotiated path '
                '(make_reader(topology=...))')
        if state.get('row_cursor') is not None:
            raise ValueError(
                'cannot merge a mid-batch state (row_cursor is set); '
                'save on a batch boundary')
        epochs.append(int(state.get('epochs_consumed', 0)))
        rowgroups = int(topo['global_rowgroups'])
        if global_rowgroups is None:
            global_rowgroups = rowgroups
        elif rowgroups != global_rowgroups:
            raise ValueError(
                'states disagree on the global rowgroup count: {} vs {}'
                .format(global_rowgroups, rowgroups))
        assignment = [int(i) for i in topo['assignment']]
        for epoch_key, pairs in (state.get('consumed_by_epoch')
                                 or {}).items():
            bucket = consumed_global.setdefault(int(epoch_key), set())
            for piece, drop in pairs:
                bucket.add((assignment[int(piece)], int(drop)))
    if len(set(epochs)) > 1:
        raise ValueError(
            'states disagree on epochs_consumed ({}) — save the whole pod '
            'at one barrier before restoring across topologies'
            .format(sorted(set(epochs))))
    assert global_rowgroups is not None
    merged: List[Dict[str, Any]] = []
    for new_index in range(new_count):
        assignment = deal_assignment(new_index, new_count, global_rowgroups)
        reverse = {global_index: piece
                   for piece, global_index in enumerate(assignment)}
        consumed_local = {
            str(epoch): sorted(
                [reverse[index], drop]
                for index, drop in pairs if index in reverse)
            for epoch, pairs in sorted(consumed_global.items())}
        merged.append({
            'version': states[0].get('version'),
            'items_per_epoch': len(assignment),
            'epochs_consumed': epochs[0],
            'consumed_by_epoch': {epoch: pairs for epoch, pairs
                                  in consumed_local.items() if pairs},
            'row_cursor': None,
            'topology': {'process_index': new_index,
                         'process_count': new_count,
                         'generation': 0,
                         'assignment': list(assignment),
                         'global_rowgroups': global_rowgroups},
        })
    return merged


def policy_from_state(state: Dict[str, Any],
                      journal_path: Optional[str] = None) -> TopologyPolicy:
    """The :class:`TopologyPolicy` that resumes one merged state on its
    new host: pinned identity + explicit assignment, so the resumed reader
    shards exactly as the merge dealt regardless of the live environment."""
    topo = state.get('topology')
    if not topo:
        raise ValueError('state has no topology block — it was not saved '
                         'by a topology-armed reader')
    return TopologyPolicy(journal_path=journal_path,
                          process_index=int(topo['process_index']),
                          process_count=int(topo['process_count']),
                          assignment=tuple(int(i)
                                           for i in topo['assignment']),
                          generation=int(topo.get('generation', 0)))


# ------------------------------------------------------------- per-host


class HostTopology:
    """One reader's live view of the negotiated topology: identity, shard
    assignment, journal membership and progress. Constructed by ``Reader``
    when ``topology=`` is armed; ``clock`` is injectable so lease tests
    never sleep."""

    def __init__(self, policy: TopologyPolicy, journal_path: str,
                 num_rowgroups: int, registry: Optional[Any] = None,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.policy = policy
        self.num_rowgroups = num_rowgroups
        self._registry = registry
        self._clock = clock or time.time
        self.process_index, self.process_count = resolve_process_identity(
            policy.process_index, policy.process_count)
        self.host_id = policy.host_id or 'host-{}'.format(self.process_index)
        self.generation = policy.generation
        self.journal = MembershipJournal(journal_path, clock=self._clock)
        replay = self.journal.open()
        self.frames_dropped = replay.frames_dropped
        if self.frames_dropped:
            logger.warning(
                'topology journal %s dropped %d frame(s) on replay — a '
                'past append was torn or a byte flipped; membership '
                'resumed from the intact prefix', journal_path,
                self.frames_dropped)
            self._inc('topology_frames_dropped', self.frames_dropped)
        if policy.assignment is not None:
            self.assignment: Tuple[int, ...] = policy.assignment
        else:
            self.assignment = deal_assignment(
                self.process_index, self.process_count, num_rowgroups)
        self.journal.note_join(self.host_id, self.process_index,
                               self.process_count, self.generation,
                               policy.lease_s)
        self._lease_renewed_at = self._clock()
        if self.generation > 0:
            self._inc('host_reshard')
            self._trace_instant('host_reshard')

    def _inc(self, name: str, n: int = 1) -> None:
        if self._registry is not None:
            self._registry.inc(name, n)

    @staticmethod
    def _trace_instant(name: str) -> None:
        from petastorm_tpu_torch.telemetry.tracing import trace_instant
        trace_instant(name)

    def note_progress(self, epoch: int, piece: int, drop: int) -> None:
        """Journal delivery of local piece ``piece`` as its GLOBAL rowgroup
        index (the identity a reshard subtracts), renewing the membership
        lease when half the window has elapsed."""
        if piece < 0 or piece >= len(self.assignment):
            return
        self.journal.note_progress(self.host_id, epoch,
                                   self.assignment[piece], drop)
        now = self._clock()
        if (now - self._lease_renewed_at
                >= self.policy.lease_s * _LEASE_RENEW_FRACTION):
            self.journal.note_lease(self.host_id, self.policy.lease_s)
            self._lease_renewed_at = now

    def header(self) -> Dict[str, Any]:
        """The lineage-manifest topology header: the negotiated identity
        and shard map that ``lineage diff`` attributes divergences to.
        Deliberately minimal and deterministic — an undisturbed survivor's
        header must byte-match its same-seed baseline."""
        return {'process_count': self.process_count,
                'process_index': self.process_index,
                'generation': self.generation,
                'shard_map': list(self.assignment)}

    def state_block(self) -> Dict[str, Any]:
        """The ``state_dict()['topology']`` block cross-topology restore
        merges on: identity + explicit global assignment."""
        return {'process_index': self.process_index,
                'process_count': self.process_count,
                'generation': self.generation,
                'assignment': list(self.assignment),
                'global_rowgroups': self.num_rowgroups}

    def report(self) -> Dict[str, Any]:
        """Diagnostics block: identity, assignment size, journal state and
        any stale leases visible at report time."""
        block = {'host_id': self.host_id,
                 'process_index': self.process_index,
                 'process_count': self.process_count,
                 'generation': self.generation,
                 'assignment': list(self.assignment),
                 'journal': self.journal.state()}
        replay = self.journal.last_replay
        if replay is not None:
            block['stale_leases'] = replay.stale_leases(self._clock())
        return block

    def close(self) -> None:
        """Journal a clean leave and close (idempotent)."""
        if self.journal is not None and self.journal._file is not None:
            self.journal.note_leave(self.host_id)
            self.journal.close()

    def abandon(self) -> None:
        """Close the journal WITHOUT a leave record — the crash simulation
        hook. To every later replay this host simply stops journaling, which
        is exactly what a SIGKILL'd or partitioned host looks like; survivors
        must detect it by lease expiry, not by a polite goodbye."""
        if self.journal is not None and self.journal._file is not None:
            self.journal.close()
