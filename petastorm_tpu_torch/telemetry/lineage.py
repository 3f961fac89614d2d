"""Sample-lineage audit plane: provable determinism, batch provenance, and
first-divergence diagnosis. A copy of ``petastorm_tpu.telemetry.lineage``:
the same identities, digests and manifest format, so either package
verifies and diffs the other's manifests, those recorded under a negotiated
topology (:mod:`~petastorm_tpu_torch.parallel.topology`) included: ``lineage
diff`` attributes a changed shard map or reshard generation to ``topology``.

The pipeline PROMISES "same seed + any topology => same sample order"; this
module is the instrument that proves it and pinpoints where two runs diverge
("Optimizing High-Throughput Distributed Data Pipelines for Reproducible
Deep Learning at Scale", PAPERS.md). Three cooperating pieces:

- :class:`LineageRecorder` — rides every reader
  (``make_reader(lineage=...)``): a **chained order digest** (blake2b folded
  over each delivered item's ``(epoch, fragment, rowgroup, row_range,
  drop_partition, rows_delivered)`` identity, folded in VENTILATION order so
  the digest is identical on every pool/transport and invariant under worker
  respawns and redeliveries — attempts are deliberately NOT part of the
  identity); optional **sampled content fingerprints** (CRC-32 over column
  buffers, every Nth piece, off by default) catching silent data corruption
  the order digest cannot; and a bounded, rotating **batch-manifest JSONL**
  (training step -> ordered item identities + running digest) written
  through the existing :class:`~petastorm_tpu_torch.telemetry.export.JsonlEventLogger`
  machinery. Digest state checkpoints with the reader (``state_dict``), so a
  save/resume run folds to the same digest as an uninterrupted one.

- a **dry replay verifier** — ``petastorm-tpu-torch-throughput lineage verify`` —
  re-derives the expected item stream purely from (seed, shard config,
  schedule plan, quarantine ledger) recorded in the manifest header, without
  reading any data, and compares it against the recorded stream: the
  ventilator's seeded shuffle, the cost-aware scheduler's interleave and the
  split plan are all replayed as pure functions.

- a **differ** — ``lineage diff <a> <b>`` — pinpoints the first divergent
  step between two recorded runs and attributes it to the responsible
  subsystem (seed change, schedule-plan delta such as a cost-ledger
  reordering the interleave or a split-plan change, quarantine skip, shard
  config, or content corruption), with a distinct exit code per attribution
  so scripts can branch on the diagnosis.

Divergence observed LIVE (an item delivered that was never expected, a
duplicate delivery, a resume whose stream no longer matches its checkpoint)
increments the ``lineage_divergence`` counter, emits a matching trace
instant, and surfaces in ``Reader.diagnostics['lineage']`` / the ``/metrics``
gauges / the doctor report.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass
from typing import (Any, Callable, Deque, Dict, Iterator, List, Mapping,
                    Optional, Sequence, Tuple)

import numpy as np

from petastorm_tpu_torch.telemetry.export import (JsonlEventLogger,
                                            env_rotation_settings)
from petastorm_tpu_torch.telemetry.registry import MetricsRegistry
from petastorm_tpu_torch.telemetry.tracing import trace_instant

logger = logging.getLogger(__name__)

#: manifest format version (bumped on incompatible record-schema changes)
MANIFEST_VERSION = 1

#: default manifest basename in the dataset's local state home
#: (``petastorm_tpu_torch.dataset_state.sidecar_path``)
MANIFEST_BASENAME = '_petastorm_tpu_lineage_{token}.jsonl'

#: chained-digest width (blake2b digest_size)
DIGEST_BYTES = 16

#: manifest JSONL event names (one header per reader run, then manifest
#: records carrying the folded item stream)
HEADER_EVENT = 'lineage_header'
MANIFEST_EVENT = 'lineage_manifest'

#: CLI exit codes — distinct per diagnosis so scripts can branch on them
EXIT_OK = 0
EXIT_DIVERGED = 1
EXIT_ERROR = 2
EXIT_SEED = 3
EXIT_SHARD_CONFIG = 4
EXIT_SCHEDULE_PLAN = 5
EXIT_QUARANTINE = 6
EXIT_CONTENT = 7
EXIT_TOPOLOGY = 8

#: ``lineage diff`` attribution -> exit code (the JAX package's)
ATTRIBUTION_EXIT_CODES: Dict[str, int] = {
    'identical': EXIT_OK,
    'seed': EXIT_SEED,
    'shard_config': EXIT_SHARD_CONFIG,
    'schedule_plan': EXIT_SCHEDULE_PLAN,
    'quarantine': EXIT_QUARANTINE,
    'content': EXIT_CONTENT,
    'topology': EXIT_TOPOLOGY,
    'unknown': EXIT_DIVERGED,
}


# --------------------------------------------------------------- identities

def canonical_identity(epoch: int, fragment_path: str, row_group_id: Any,
                       row_range: Optional[Sequence[int]],
                       drop: int) -> List[Any]:
    """The JSON-stable identity of one delivered work item. Deliberately
    attempt-free: a respawned worker's redelivery of the same item folds to
    the same bytes. ``row_range`` is the cost-aware scheduler's sub-range
    coordinate (None for whole-rowgroup items)."""
    if row_group_id is None:
        rowgroup: Any = None
    else:
        try:
            rowgroup = int(row_group_id)  # numpy ints are not JSON-safe
        except (TypeError, ValueError):
            rowgroup = str(row_group_id)
    return [int(epoch), str(fragment_path), rowgroup,
            [int(row_range[0]), int(row_range[1])]
            if row_range is not None else None,
            int(drop)]


def genesis_digest(dataset_token: str) -> bytes:
    """The chain's starting value: derived from the dataset token so digests
    of different (dataset, read-config) identities can never collide at
    item 0."""
    return hashlib.blake2b(dataset_token.encode('utf-8'),
                           digest_size=DIGEST_BYTES).digest()


def fold_digest(prev: bytes, identity: Sequence[Any], rows: int) -> bytes:
    """One chain step: ``H_{i+1} = blake2b(H_i || canonical_json(identity,
    rows))``. The chain value is itself the resumable digest state — a
    checkpointed reader continues folding from the saved bytes."""
    payload = json.dumps([list(identity), int(rows)], sort_keys=True,
                         separators=(',', ':')).encode('utf-8')
    return hashlib.blake2b(prev + payload,
                           digest_size=DIGEST_BYTES).digest()


def default_manifest_path(dataset_url_or_path: str, dataset_token: str,
                          cache_location: Optional[str] = None
                          ) -> Optional[str]:
    """Where the manifest sidecar lives by default: the dataset's local
    state home (shared derivation with the cost ledger —
    :func:`petastorm_tpu_torch.dataset_state.sidecar_path`); None for remote
    stores with no cache (pass an explicit
    ``LineagePolicy(manifest_path=...)``)."""
    from petastorm_tpu_torch.dataset_state import sidecar_path
    return sidecar_path(dataset_url_or_path,
                        MANIFEST_BASENAME.format(token=dataset_token),
                        cache_location)


# ------------------------------------------------------------- fingerprints

def _crc_cell(crc: int, value: Any) -> int:
    """Fold one decoded cell into a CRC-32: raw buffer bytes (plus dtype and
    shape) for array-likes, a stable text repr for object cells."""
    arr = np.asarray(value)
    if arr.dtype == object:
        # object cells (Decimal, str rows off the object path): the repr is
        # process-stable where the object's buffer address is not
        return zlib.crc32(repr(value).encode('utf-8', 'backslashreplace'),
                          crc)
    crc = zlib.crc32('{}|{}'.format(arr.dtype.str, arr.shape).encode(), crc)
    return zlib.crc32(np.ascontiguousarray(arr).tobytes(), crc)


def content_fingerprint(columns: Mapping[str, Any]) -> Dict[str, Any]:
    """CRC-32 content fingerprint of one delivered batch's column buffers:
    ``{'crc32': combined, 'fields': {name: crc}}``. Computed where the batch
    is PRODUCED (the worker — in-process, spawned, or service-fleet) and
    shipped on the batch's ``lineage`` sidecar, so a bit flipped anywhere
    between decode and the training loop shows up as a cross-run fingerprint
    mismatch the order digest alone cannot see. Sampled (every Nth piece,
    ``LineagePolicy.fingerprint_every``) because hashing every buffer of
    every batch is measurable work."""
    fields: Dict[str, int] = {}
    for name in sorted(columns):
        column = columns[name]
        crc = 0
        if isinstance(column, np.ndarray) and column.dtype != object:
            crc = _crc_cell(crc, column)
        else:
            for value in column:
                crc = _crc_cell(crc, value)
        fields[name] = crc & 0xFFFFFFFF
    combined = zlib.crc32(
        json.dumps(fields, sort_keys=True).encode('utf-8')) & 0xFFFFFFFF
    return {'crc32': combined, 'fields': fields}


# ------------------------------------------------------------------- policy

@dataclass(frozen=True)
class LineagePolicy:
    """Frozen lineage-audit policy (``make_reader(lineage=...)``).

    ``manifest_path`` overrides where the batch-manifest JSONL is written
    (default: the dataset's local state home); ``manifest=False`` keeps the
    in-memory digest without writing any file. ``fingerprint_every`` samples
    worker-side content CRCs every Nth piece (0 = off, the default — order
    integrity is free, content hashing is not). ``manifest_every`` batches
    folded items per manifest record. ``max_bytes`` / ``max_rotations``
    bound the manifest on disk (``max_rotations=None`` defers to
    ``PETASTORM_TPU_TELEMETRY_JSONL_ROTATIONS``, default 1)."""

    manifest_path: Optional[str] = None
    manifest: bool = True
    fingerprint_every: int = 0
    manifest_every: int = 32
    max_bytes: Optional[int] = 8 << 20
    max_rotations: Optional[int] = None

    def __post_init__(self) -> None:
        if self.fingerprint_every < 0:
            raise ValueError('fingerprint_every must be >= 0, got {!r}'
                             .format(self.fingerprint_every))
        if self.manifest_every < 1:
            raise ValueError('manifest_every must be >= 1, got {!r}'
                             .format(self.manifest_every))


def resolve_lineage_policy(value: Any) -> Optional[LineagePolicy]:
    """Normalize the ``make_reader(lineage=...)`` knob: ``None``/``False``
    -> no recorder (the byte-identical default path), ``True`` -> the
    default :class:`LineagePolicy`, a path string -> default policy writing
    its manifest there, a policy instance -> itself."""
    if value is None or value is False:
        return None
    if value is True:
        return LineagePolicy()
    if isinstance(value, LineagePolicy):
        return value
    if isinstance(value, str):
        return LineagePolicy(manifest_path=value)
    raise TypeError('lineage must be None/False, True, a manifest path, or '
                    'a LineagePolicy; got {!r}'.format(value))


def build_manifest_logger(policy: LineagePolicy, dataset_url_or_path: str,
                          dataset_token: str,
                          cache_location: Optional[str] = None
                          ) -> Tuple[Optional[JsonlEventLogger],
                                     Optional[str]]:
    """The recorder's manifest logger + resolved path for one reader:
    ``(None, None)`` when the policy disables the manifest or no local
    state home exists (the digest still runs in memory)."""
    if not policy.manifest:
        return None, None
    path = policy.manifest_path or default_manifest_path(
        dataset_url_or_path, dataset_token, cache_location)
    if path is None:
        return None, None
    env_bytes, env_rotations = env_rotation_settings()
    rotations = (policy.max_rotations if policy.max_rotations is not None
                 else env_rotations)
    max_bytes = policy.max_bytes if policy.max_bytes is not None \
        else env_bytes
    return JsonlEventLogger(path, interval_s=0.0, max_bytes=max_bytes,
                            max_rotations=rotations), path


# ----------------------------------------------------------------- recorder

class _Entry(object):
    """One expected work item: ventilation-ordered, folded once delivered."""

    __slots__ = ('key', 'identity', 'rows', 'delivered', 'fingerprint',
                 'quarantined')

    def __init__(self, key: Tuple[int, int, int], identity: List[Any],
                 rows: Optional[int] = None, delivered: bool = False,
                 fingerprint: Optional[Mapping[str, Any]] = None,
                 quarantined: bool = False) -> None:
        self.key = key
        self.identity = identity
        self.rows = rows
        self.delivered = delivered
        self.fingerprint = fingerprint
        self.quarantined = quarantined


class LineageRecorder(object):
    """One reader's lineage state (module docstring).

    Thread model: :meth:`expect` runs on the ventilator thread (strictly in
    ventilation order — that ordering IS the digest's fold order),
    :meth:`deliver` on the consuming thread(s), :meth:`report` /
    :meth:`order_digest` from anywhere; one internal lock guards the small
    mutable surface. Manifest JSONL writes happen OUTSIDE the lock (slow
    disks must not stall delivery accounting).

    Deliveries arrive in completion order — a thread pool's second worker
    can finish piece 7 before piece 3 — so delivered items wait in a reorder
    buffer and fold strictly in expected (ventilation) order; the buffer is
    bounded by the ventilator's in-flight window by construction."""

    def __init__(self, dataset_token: str, policy: LineagePolicy,
                 jsonl: Optional[JsonlEventLogger] = None,
                 manifest_path: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None,
                 clock: Optional[Callable[[], float]] = None,
                 resume_state: Optional[Mapping[str, Any]] = None) -> None:
        self.dataset_token = dataset_token
        self.policy = policy
        self.manifest_path = manifest_path
        self._jsonl = jsonl
        self._registry = registry
        self._clock: Callable[[], float] = clock or time.monotonic
        self._lock = threading.Lock()
        self._digest = genesis_digest(dataset_token)
        self._folded = 0
        self._entries: Deque[_Entry] = deque()
        self._by_key: Dict[Tuple[int, int, int], _Entry] = {}
        #: restored-but-undelivered checkpoint entries awaiting their
        #: re-ventilation (matched head-of-line in :meth:`expect`)
        self._restore_entries: List[_Entry] = []
        self._restore_cursor = 0
        self._unflushed: List[List[Any]] = []
        self._unflushed_first_seq = 0
        self._unflushed_prev_digest = self._digest
        self._step = 0
        self._rows_folded = 0
        self._divergence = 0
        self._last_divergence: Optional[Dict[str, Any]] = None
        self._closed = False
        if resume_state is not None:
            self._restore(resume_state)
            self._unflushed_first_seq = self._folded
            self._unflushed_prev_digest = self._digest

    # ------------------------------------------------------------- restore

    def _restore(self, state: Mapping[str, Any]) -> None:
        if int(state.get('version', -1)) != 1:
            raise ValueError('unrecognized lineage resume state {!r}'
                             .format(state))
        self._digest = bytes.fromhex(str(state['digest']))
        self._folded = int(state['folded'])
        self._rows_folded = int(state.get('rows_folded', 0))
        for row in state.get('pending') or []:
            key_list, identity, rows, delivered, quarantined = row
            entry = _Entry(
                (int(key_list[0]), int(key_list[1]), int(key_list[2])),
                _normalize_identity(identity),
                int(rows) if rows is not None else None,
                bool(delivered), None, bool(quarantined))
            self._entries.append(entry)
            self._by_key[entry.key] = entry
            if not entry.delivered:
                self._restore_entries.append(entry)

    # ------------------------------------------------------------ pipeline

    def expect(self, epoch: int, piece: int, drop: int, fragment_path: str,
               row_group_id: Any,
               row_range: Optional[Sequence[int]] = None) -> None:
        """Record one ventilated work item (called in ventilation order —
        the fold order of the chain)."""
        key = (int(epoch), int(piece), int(drop))
        identity = canonical_identity(epoch, fragment_path, row_group_id,
                                      row_range, drop)
        divergence: Optional[Tuple[str, str]] = None
        with self._lock:
            if self._restore_cursor < len(self._restore_entries):
                entry = self._restore_entries[self._restore_cursor]
                self._restore_cursor += 1
                if entry.key == key and entry.identity == identity:
                    return
                # the resumed construction no longer produces the stream the
                # checkpoint came from — flag it, then trust the live run
                divergence = ('resume_mismatch',
                              'expected {} at resume, ventilator produced {}'
                              .format(entry.identity, identity))
                del self._by_key[entry.key]
                entry.key = key
                entry.identity = identity
                self._by_key[key] = entry
            elif key in self._by_key:
                divergence = ('duplicate_expect',
                              'item {} ventilated twice'.format(key))
            else:
                entry = _Entry(key, identity)
                self._entries.append(entry)
                self._by_key[key] = entry
        if divergence is not None:
            self._note_divergence(*divergence)

    def deliver(self, item_id: Sequence[int], rows: int,
                fingerprint: Optional[Mapping[str, Any]] = None,
                quarantined: bool = False) -> None:
        """Record one delivered batch (exactly once per work item on every
        pool — duplicates and unknowns are divergence). Folds the contiguous
        delivered prefix into the chain."""
        key = (int(item_id[0]), int(item_id[1]), int(item_id[2]))
        divergence: Optional[Tuple[str, str]] = None
        flush: Optional[Dict[str, Any]] = None
        with self._lock:
            entry = self._by_key.get(key)
            if entry is None:
                divergence = ('unexpected_delivery',
                              'item {} delivered but never ventilated'
                              .format(key))
            elif entry.delivered:
                divergence = ('duplicate_delivery',
                              'item {} delivered twice'.format(key))
            else:
                entry.delivered = True
                entry.rows = int(rows)
                entry.fingerprint = dict(fingerprint) if fingerprint else None
                entry.quarantined = bool(quarantined)
                flush = self._fold_ready_locked()
        if divergence is not None:
            self._note_divergence(*divergence)
        if flush is not None:
            self._emit_manifest(flush)

    def _fold_ready_locked(self) -> Optional[Dict[str, Any]]:
        """Fold every head-of-line delivered entry; returns a manifest
        payload to emit (outside the lock) once ``manifest_every`` items
        accumulated."""
        folded_any = False
        while self._entries and self._entries[0].delivered:
            entry = self._entries.popleft()
            del self._by_key[entry.key]
            rows = int(entry.rows or 0)
            self._digest = fold_digest(self._digest, entry.identity, rows)
            self._folded += 1
            self._rows_folded += rows
            folded_any = True
            row = list(entry.identity) + [
                rows,
                int(entry.fingerprint['crc32'])
                if entry.fingerprint else None,
                1 if entry.quarantined else 0]
            self._unflushed.append(row)
        if folded_any and len(self._unflushed) >= self.policy.manifest_every:
            return self._take_manifest_locked()
        return None

    def _take_manifest_locked(self) -> Optional[Dict[str, Any]]:
        if not self._unflushed:
            return None
        payload = {'version': MANIFEST_VERSION,
                   'step': self._step,
                   'first_seq': self._unflushed_first_seq,
                   'prev_digest': self._unflushed_prev_digest.hex(),
                   'digest': self._digest.hex(),
                   'items': self._unflushed}
        self._unflushed = []
        self._unflushed_first_seq = self._folded
        self._unflushed_prev_digest = self._digest
        return payload

    def _emit_manifest(self, payload: Dict[str, Any]) -> None:
        if self._jsonl is not None:
            self._jsonl.emit({}, event=MANIFEST_EVENT, **payload)

    def _note_divergence(self, reason: str, detail: str) -> None:
        with self._lock:
            self._divergence += 1
            self._last_divergence = {'reason': reason, 'detail': detail,
                                     'at_mono': self._clock()}
        if self._registry is not None:
            self._registry.inc('lineage_divergence')
        trace_instant('lineage_divergence',
                      args={'reason': reason, 'detail': detail})
        logger.warning('lineage divergence (%s): %s', reason, detail)

    # ------------------------------------------------------------ surfaces

    def write_header(self, config: Mapping[str, Any]) -> None:
        """Emit the run's reproduction header (seed, shard config, schedule
        plan, quarantine ledger, item list) — everything ``lineage verify``
        replays the expected stream from."""
        if self._jsonl is None:
            return
        record = dict(config)
        record.setdefault('version', MANIFEST_VERSION)
        record.setdefault('dataset_token', self.dataset_token)
        record.setdefault('genesis', genesis_digest(self.dataset_token).hex())
        self._jsonl.emit({}, event=HEADER_EVENT, **record)

    def stamp_step(self, step: int) -> None:
        """Stamp the consuming loop's training-step counter
        (:class:`~petastorm_tpu_torch.parallel.loader.TorchDataLoader` calls this
        once per yielded batch) — manifest records carry the latest stamp,
        tying item provenance to training steps."""
        with self._lock:
            self._step = int(step)

    def order_digest(self) -> str:
        """Hex digest of the chain over every folded item so far: the
        provable order identity. Two runs with the same seed, shard config
        and schedule plan fold to the same value on every pool/transport."""
        with self._lock:
            return self._digest.hex()

    @property
    def divergence_count(self) -> int:
        """Total live-divergence events observed."""
        with self._lock:
            return self._divergence

    def state_dict(self) -> Dict[str, Any]:
        """Resumable digest state: the chain value, fold count, and the
        pending (expected-but-unfolded) suffix with delivery flags — a
        resumed reader seeded with this continues folding to the exact
        digest of an uninterrupted run. Checkpoint with
        ``Reader.state_dict()`` (which embeds this under ``'lineage'``)."""
        with self._lock:
            pending = [[list(e.key), list(e.identity),
                        e.rows if e.delivered else None,
                        bool(e.delivered), bool(e.quarantined)]
                       for e in self._entries]
            return {'version': 1,
                    'digest': self._digest.hex(),
                    'folded': self._folded,
                    'rows_folded': self._rows_folded,
                    'pending': pending}

    def report(self) -> Dict[str, Any]:
        """JSON-safe lineage view for ``Reader.diagnostics['lineage']``."""
        with self._lock:
            pending = len(self._entries)
            return {'enabled': True,
                    'order_digest': self._digest.hex(),
                    'items_folded': self._folded,
                    'rows_folded': self._rows_folded,
                    'pending_items': pending,
                    'divergence': self._divergence,
                    'last_divergence': dict(self._last_divergence)
                    if self._last_divergence else None,
                    'fingerprint_every': self.policy.fingerprint_every,
                    'manifest_path': self.manifest_path,
                    'step': self._step}

    def close(self) -> None:
        """Flush the remaining folded items as a final manifest record
        (idempotent — ``Reader.stop`` may run more than once)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            payload = self._take_manifest_locked()
        if payload is not None:
            payload['final'] = True
            self._emit_manifest(payload)


def _normalize_identity(identity: Sequence[Any]) -> List[Any]:
    """JSON-roundtrip an identity so in-memory and deserialized forms
    compare equal (tuples -> lists, numpy ints -> ints)."""
    return json.loads(json.dumps(list(identity)))


# ------------------------------------------------------------ manifest I/O

def _manifest_chain(path: str) -> List[str]:
    """The manifest file chain oldest-first: ``path.N ... path.1, path``."""
    generations: List[Tuple[int, str]] = []
    directory = os.path.dirname(path) or '.'
    base = os.path.basename(path)
    try:
        names = os.listdir(directory)
    except OSError:
        names = []
    for name in names:
        if name.startswith(base + '.'):
            suffix = name[len(base) + 1:]
            if suffix.isdigit():
                generations.append((int(suffix),
                                    os.path.join(directory, name)))
    chain = [p for _n, p in sorted(generations, reverse=True)]
    if os.path.exists(path):
        chain.append(path)
    return chain


def load_manifest(path: str) -> List[Dict[str, Any]]:
    """Parse a manifest (rotated generations included, oldest first) into
    run *segments*: ``[{'header': ..., 'records': [...]}]`` — one segment
    per recorded reader run (each run writes its own header). Records keep
    their file order, which is fold order."""
    segments: List[Dict[str, Any]] = []
    for file_path in _manifest_chain(path):
        with open(file_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    record = json.loads(line)
                except ValueError:
                    continue  # torn tail line of a rotated file
                event = record.get('event')
                if event == HEADER_EVENT:
                    segments.append({'header': record, 'records': []})
                elif event == MANIFEST_EVENT:
                    if not segments:
                        # rotation dropped the header generation: keep the
                        # records under a headerless segment so chain
                        # verification still runs
                        segments.append({'header': None, 'records': []})
                    segments[-1]['records'].append(record)
    if not segments:
        raise ValueError('{} holds no lineage records'.format(path))
    return segments


def manifest_items(segment: Mapping[str, Any]) -> List[List[Any]]:
    """The segment's folded item rows, concatenated in fold order. Row
    layout: ``[epoch, fragment, rowgroup, row_range, drop, rows, crc, q]``."""
    items: List[List[Any]] = []
    for record in segment['records']:
        items.extend(record.get('items') or [])
    return items


# ------------------------------------------------------------- dry replay

def replay_expected_stream(header: Mapping[str, Any]) -> Iterator[List[Any]]:
    """Re-derive the expected item-identity stream purely from a recorded
    header — no data read, no reader built: the ventilator's seeded shuffle,
    the cost-aware interleave (replayed through the scheduler's own
    ``_interleave_order`` so the two can never drift), resume skip sets and
    epoch tagging are all modeled as pure functions. Yields canonical
    identities in fold order, indefinitely for ``num_epochs=None`` readers
    (callers zip against the recorded stream)."""
    items = [list(item) for item in header.get('items') or []]
    if not items:
        return
    seed = header.get('seed')
    shuffle = bool(header.get('shuffle_row_groups', True))
    num_epochs = header.get('num_epochs')
    pre_shuffles = int(header.get('pre_shuffles', 0))
    skip_by_iteration = {
        int(k): {(int(i[0]), int(i[1])) for i in v}
        for k, v in (header.get('skip_by_iteration') or {}).items()}
    schedule = header.get('schedule') or None
    order_fn: Optional[Callable[[List[List[Any]]], List[List[Any]]]] = None
    if schedule and not schedule.get('cold_start') \
            and schedule.get('interleave'):
        from petastorm_tpu_torch.schedule.cost_schedule import _interleave_order
        costs = {int(k): float(v)
                 for k, v in (schedule.get('piece_costs') or {}).items()}
        heavy_skew = float(schedule['heavy_skew'])
        prestage = bool(schedule['prestage'])

        def order_fn(ordered: List[List[Any]]) -> List[List[Any]]:
            entries = [(item, costs.get(int(item[0]), 1.0))
                       for item in ordered]
            if len(entries) < 2:
                return ordered
            return _interleave_order(entries, heavy_skew, prestage)

    rng = np.random.RandomState(seed)
    current = list(items)

    def reorder() -> None:
        nonlocal current
        # same RNG consumption as ConcurrentVentilator._reorder: one
        # shuffle per reorder point, interleave applied on top
        rng.shuffle(current)
        if order_fn is not None:
            current = order_fn(current)

    if shuffle:
        for _ in range(pre_shuffles):
            reorder()
    passes = 0
    while num_epochs is None or passes < int(num_epochs) - pre_shuffles:
        if shuffle:
            reorder()
        epoch = pre_shuffles + passes
        skip = skip_by_iteration.get(passes, set())
        for item in current:
            piece, fragment, row_group, row_range, drop = item
            if (int(piece), int(drop)) in skip:
                continue
            yield canonical_identity(epoch, fragment, row_group, row_range,
                                     drop)
        passes += 1


def _shard_config(header: Mapping[str, Any]) -> Dict[str, Any]:
    return {'cur_shard': header.get('cur_shard'),
            'shard_count': header.get('shard_count'),
            'shard_seed': header.get('shard_seed'),
            'drop_partitions': header.get('drop_partitions', 1)}


def _topology_of(header: Mapping[str, Any]) -> Any:
    """JSON-normalized negotiated-topology block (process count / index /
    shard map / reshard generation — parallel/topology.py); absent for a
    static-shard recording, so static-vs-static runs never attribute here."""
    topology = header.get('topology')
    if topology is None:
        return None
    return json.loads(json.dumps(topology, sort_keys=True))


def verify_manifest(manifest_path: str,
                    dataset_url: Optional[str] = None) -> Dict[str, Any]:
    """The dry replay verifier: prove a recorded run's order digest from
    first principles, reading zero data.

    Three checks over the manifest's LAST run segment: (1) the recorded
    digest chain recomputes exactly from the recorded identities (a torn
    manifest or recorder bug cannot hide); (2) the recorded identity stream
    equals the replay of (seed, shard config, schedule plan, quarantine
    ledger) from the header; (3) when ``dataset_url`` is given, the
    header's sharded rowgroup map still matches the store's footer metadata
    (fragment paths, rowgroup ids, row counts — metadata only). Returns a
    JSON-safe result with ``exit_code`` (0 ok / 1 diverged / 2 error)."""
    segments = load_manifest(manifest_path)
    segment = segments[-1]
    header = segment['header']
    if header is None:
        return {'ok': False, 'reason': 'no_header',
                'detail': 'manifest holds records but no header (rotated '
                          'away?) — cannot replay without the run config',
                'exit_code': EXIT_ERROR}
    if header.get('resumed'):
        return {'ok': False, 'reason': 'resumed_run',
                'detail': 'this segment was recorded by a resumed reader; '
                          'replay verification needs a fresh-run manifest '
                          '(digest continuity is checkpoint-verified '
                          'instead)', 'exit_code': EXIT_ERROR}
    records = segment['records']
    items = manifest_items(segment)
    checked = 0
    # (1) chain integrity
    if records and int(records[0]['first_seq']) == 0 \
            and records[0]['prev_digest'] != header.get('genesis'):
        return {'ok': False, 'reason': 'chain_mismatch', 'divergent_step': 0,
                'detail': 'first record does not chain from the genesis '
                          'digest', 'exit_code': EXIT_DIVERGED}
    prev_hex: Optional[str] = None
    for record in records:
        digest = bytes.fromhex(str(record['prev_digest']))
        if prev_hex is not None and record['prev_digest'] != prev_hex:
            return {'ok': False, 'reason': 'chain_gap',
                    'divergent_step': int(record['first_seq']),
                    'detail': 'record at seq {} does not chain from the '
                              'previous record (rotation gap or tamper)'
                              .format(record['first_seq']),
                    'exit_code': EXIT_DIVERGED}
        for row in record.get('items') or []:
            digest = fold_digest(digest, row[:5], int(row[5]))
            checked += 1
        if digest.hex() != record['digest']:
            return {'ok': False, 'reason': 'chain_mismatch',
                    'divergent_step': int(record['first_seq']),
                    'detail': 'recomputed digest {} != recorded {} for the '
                              'record starting at seq {}'.format(
                                  digest.hex(), record['digest'],
                                  record['first_seq']),
                    'exit_code': EXIT_DIVERGED}
        prev_hex = str(record['digest'])
    # (2) replay the expected stream
    if header.get('shuffle_row_groups', True) and header.get('seed') is None:
        # RandomState(None) draws fresh OS entropy: the recorded order was
        # real but is not RE-DERIVABLE — an unverifiable recording, not a
        # divergence (record with an explicit seed to get replay coverage)
        return {'ok': False, 'reason': 'seedless_shuffle',
                'detail': 'this run shuffled rowgroups with seed=None — the '
                          'order cannot be replayed; record with an explicit '
                          'seed (the digest chain itself checked out)',
                'exit_code': EXIT_ERROR}
    first_seq = int(records[0]['first_seq']) if records else 0
    expected = replay_expected_stream(header)
    for _ in range(first_seq):  # rotation-truncated prefix: advance silently
        next(expected, None)
    for offset, row in enumerate(items):
        derived = next(expected, None)
        if derived is None:
            return {'ok': False, 'reason': 'order_divergence',
                    'divergent_step': first_seq + offset,
                    'detail': 'recorded stream is longer than the replay '
                              '(item {})'.format(row[:5]),
                    'exit_code': EXIT_DIVERGED}
        if _normalize_identity(row[:5]) != derived:
            return {'ok': False, 'reason': 'order_divergence',
                    'divergent_step': first_seq + offset,
                    'detail': 'recorded item {} but the replay derives {}'
                              .format(row[:5], derived),
                    'exit_code': EXIT_DIVERGED}
    # (3) dataset metadata cross-check (zero data read)
    if dataset_url and header.get('shard_rowgroups'):
        mismatch = _check_dataset_rowgroups(dataset_url, header)
        if mismatch is not None:
            return {'ok': False, 'reason': 'dataset_mismatch',
                    'divergent_step': None, 'detail': mismatch,
                    'exit_code': EXIT_DIVERGED}
    final = records[-1]['digest'] if records else header.get('genesis')
    return {'ok': True, 'reason': 'verified',
            'items_checked': checked, 'order_digest': final,
            'detail': 'digest chain + replayed order match over {} item(s)'
                      .format(checked),
            'exit_code': EXIT_OK}


def _check_dataset_rowgroups(dataset_url: str,
                             header: Mapping[str, Any]) -> Optional[str]:
    """Re-enumerate the store's rowgroups (footer metadata only) under the
    header's shard config and compare with the recorded map; returns a
    mismatch description or None."""
    from petastorm_tpu_torch.etl import dataset_metadata
    from petastorm_tpu_torch.fs_utils import normalize_dataset_url_or_urls
    from petastorm_tpu_torch.reader import Reader
    shard = _shard_config(header)
    handle = dataset_metadata.open_dataset(
        normalize_dataset_url_or_urls(dataset_url))
    row_groups = dataset_metadata.load_row_groups(handle)
    sharded = Reader._partition_row_groups(row_groups, shard['cur_shard'],
                                           shard['shard_count'], shard['shard_seed'])
    live = [[rg.fragment_path, rg.row_group_id, rg.row_group_num_rows]
            for rg in sharded]
    recorded = [list(row) for row in header['shard_rowgroups']]
    if _normalize_identity(live) != _normalize_identity(recorded):
        return ('the store\'s sharded rowgroup enumeration no longer '
                'matches the recording ({} vs {} rowgroup(s)) — dataset '
                'contents or shard config changed'
                .format(len(live), len(recorded)))
    return None


# ------------------------------------------------------------------- differ

def _schedule_plan_of(header: Mapping[str, Any]) -> Any:
    schedule = header.get('schedule')
    if not schedule:
        return None
    return json.loads(json.dumps(schedule, sort_keys=True))


def diff_manifests(path_a: str, path_b: str) -> Dict[str, Any]:
    """First-divergence diagnosis between two recorded runs: walks both
    streams to the first step whose identity (or rows / content
    fingerprint / quarantine flag) differs and attributes the divergence to
    the responsible subsystem by comparing the run headers — ``seed``,
    ``shard_config``, ``schedule_plan`` (a cost-ledger delta reordering the
    interleave, a split-plan change), ``topology`` (a negotiated shard map
    / reshard generation changed — parallel/topology.py), ``quarantine``,
    or ``content`` (identical stream, different bytes). ``exit_code`` is
    distinct per attribution (:data:`ATTRIBUTION_EXIT_CODES`)."""
    seg_a = load_manifest(path_a)[-1]
    seg_b = load_manifest(path_b)[-1]
    header_a = seg_a['header'] or {}
    header_b = seg_b['header'] or {}
    items_a = manifest_items(seg_a)
    items_b = manifest_items(seg_b)

    causes: List[str] = []
    if header_a.get('seed') != header_b.get('seed'):
        causes.append('seed')
    if _shard_config(header_a) != _shard_config(header_b):
        causes.append('shard_config')
    if _topology_of(header_a) != _topology_of(header_b):
        causes.append('topology')
    if _schedule_plan_of(header_a) != _schedule_plan_of(header_b):
        causes.append('schedule_plan')
    if sorted(header_a.get('quarantined_fragments') or []) != \
            sorted(header_b.get('quarantined_fragments') or []):
        causes.append('quarantine')

    divergent_step: Optional[int] = None
    kind = None
    detail = ''
    for step, (row_a, row_b) in enumerate(zip(items_a, items_b)):
        if _normalize_identity(row_a[:5]) != _normalize_identity(row_b[:5]):
            divergent_step, kind = step, 'identity'
            detail = '{} vs {}'.format(row_a[:5], row_b[:5])
            break
        if int(row_a[5]) != int(row_b[5]):
            divergent_step, kind = step, 'rows'
            detail = 'item {} delivered {} vs {} rows'.format(
                row_a[:5], row_a[5], row_b[5])
            break
        if bool(row_a[7]) != bool(row_b[7]):
            divergent_step, kind = step, 'quarantine'
            detail = 'item {} quarantined in one run only'.format(row_a[:5])
            break
        if row_a[6] is not None and row_b[6] is not None \
                and int(row_a[6]) != int(row_b[6]):
            divergent_step, kind = step, 'content'
            detail = ('item {} content fingerprint {:#010x} vs {:#010x} — '
                      'same order, different bytes'.format(
                          row_a[:5], int(row_a[6]), int(row_b[6])))
            break
    if divergent_step is None and len(items_a) != len(items_b):
        divergent_step = min(len(items_a), len(items_b))
        kind = 'length'
        detail = '{} vs {} recorded item(s)'.format(len(items_a),
                                                    len(items_b))

    if divergent_step is None and not causes:
        return {'identical': True, 'attribution': 'identical',
                'first_divergent_step': None,
                'detail': 'streams identical over {} item(s)'
                          .format(len(items_a)),
                'exit_code': EXIT_OK}

    if kind == 'content':
        attribution = 'content'
    elif kind in ('quarantine', 'rows') and 'quarantine' in causes:
        attribution = 'quarantine'
    elif kind == 'quarantine':
        attribution = 'quarantine'
    elif causes:
        attribution = causes[0]
    elif kind == 'rows':
        attribution = 'content'
    else:
        attribution = 'unknown'
    return {'identical': False,
            'attribution': attribution,
            'header_deltas': causes,
            'first_divergent_step': divergent_step,
            'divergence_kind': kind,
            'detail': detail or ('headers differ ({}) but the recorded '
                                 'streams never reached the reordered '
                                 'region'.format(causes)),
            'exit_code': ATTRIBUTION_EXIT_CODES.get(attribution,
                                                    EXIT_DIVERGED)}


# ---------------------------------------------------------------------- CLI

def _record_run(dataset_url: str, manifest: Optional[str], workers: int,
                seed: Optional[int], epochs: int, fingerprint_every: int,
                cost_schedule: bool) -> Dict[str, Any]:
    """One lineage-armed epoch (the ``lineage record`` engine): returns the
    digest + manifest path."""
    from petastorm_tpu_torch.reader import make_reader
    policy = LineagePolicy(manifest_path=manifest,
                           fingerprint_every=fingerprint_every)
    with make_reader(dataset_url, workers_count=workers, seed=seed,
                     num_epochs=epochs,
                     cost_schedule=True if cost_schedule else None,
                     lineage=policy) as reader:
        rows = 0
        for batch in reader.iter_columnar(include_empty=True):
            rows += batch.num_rows
        report = reader.diagnostics['lineage']
    return {'order_digest': report['order_digest'],
            'items': report['items_folded'], 'rows': rows,
            'divergence': report['divergence'],
            'manifest': report['manifest_path']}


def _find_default_manifest(dataset_url: str) -> Optional[str]:
    """The single lineage manifest in a local dataset's state home, or None
    when absent/ambiguous (the caller then requires ``--manifest``)."""
    from petastorm_tpu_torch.dataset_state import local_state_home
    home = local_state_home(dataset_url)
    if home is None or not os.path.isdir(home):
        return None
    prefix, suffix = MANIFEST_BASENAME.split('{token}')
    found = [os.path.join(home, name) for name in sorted(os.listdir(home))
             if name.startswith(prefix) and name.endswith(suffix)]
    return found[0] if len(found) == 1 else None


def main(argv: Optional[List[str]] = None) -> int:
    """``petastorm-tpu-torch-throughput lineage`` entry: ``record`` a lineage-armed
    epoch, ``verify`` a recorded manifest by dry replay, or ``diff`` two
    recorded runs to the first divergent step (module docstring; exit codes
    in :data:`ATTRIBUTION_EXIT_CODES`)."""
    import argparse
    parser = argparse.ArgumentParser(
        description='Sample-lineage audit: record, verify and diff '
                    'deterministic sample streams')
    sub = parser.add_subparsers(dest='command', required=True)
    p_record = sub.add_parser('record', help='run one lineage-armed epoch '
                                            'and write its manifest')
    p_record.add_argument('dataset_url')
    p_record.add_argument('--manifest', default=None)
    p_record.add_argument('--workers', type=int, default=2)
    p_record.add_argument('--seed', type=int, default=None)
    p_record.add_argument('--epochs', type=int, default=1)
    p_record.add_argument('--fingerprint-every', type=int, default=0)
    p_record.add_argument('--cost-schedule', action='store_true')
    p_verify = sub.add_parser('verify', help='dry-replay a recorded '
                                             'manifest — zero data read')
    p_verify.add_argument('dataset_url')
    p_verify.add_argument('--manifest', default=None)
    p_verify.add_argument('--no-dataset', action='store_true',
                          help='skip the store metadata cross-check')
    p_verify.add_argument('--json', action='store_true')
    p_diff = sub.add_parser('diff', help='first-divergence diagnosis '
                                         'between two recorded manifests')
    p_diff.add_argument('manifest_a')
    p_diff.add_argument('manifest_b')
    p_diff.add_argument('--json', action='store_true')
    args = parser.parse_args(argv)

    if args.command == 'record':
        result = _record_run(args.dataset_url, args.manifest, args.workers,
                             args.seed, args.epochs, args.fingerprint_every,
                             args.cost_schedule)
        print(json.dumps(result))
        return EXIT_OK if not result['divergence'] else EXIT_DIVERGED
    if args.command == 'verify':
        manifest = args.manifest or _find_default_manifest(args.dataset_url)
        if manifest is None:
            parser.error('no manifest found next to {} — pass --manifest'
                         .format(args.dataset_url))
        try:
            result = verify_manifest(
                manifest,
                dataset_url=None if args.no_dataset else args.dataset_url)
        except (OSError, ValueError) as exc:
            print('lineage verify: {}'.format(exc))
            return EXIT_ERROR
        if args.json:
            print(json.dumps(result))
        else:
            print('lineage verify: {} — {}'.format(
                'OK' if result['ok'] else
                'DIVERGED ({})'.format(result['reason']), result['detail']))
        return int(result['exit_code'])
    # diff
    try:
        result = diff_manifests(args.manifest_a, args.manifest_b)
    except (OSError, ValueError) as exc:
        print('lineage diff: {}'.format(exc))
        return EXIT_ERROR
    if args.json:
        print(json.dumps(result))
    elif result['identical']:
        print('lineage diff: identical — {}'.format(result['detail']))
    else:
        print('lineage diff: first divergence at step {} — attributed to '
              '{} ({})'.format(result['first_divergent_step'],
                               result['attribution'], result['detail']))
    return int(result['exit_code'])


if __name__ == '__main__':
    import sys
    sys.exit(main())
