"""Durable token ledger for the service dispatcher. A copy of
``petastorm_tpu.service.ledger``: the journal's frames and records are the
JAX package's byte for byte, so either package replays the other's journal.

The :class:`~petastorm_tpu_torch.service.dispatcher.FairShareScheduler`
journals every token lifecycle edge — issued / delivered / retired / failed /
quarantined, plus client registrations, setup-blob digests and reshard
decisions — to an append-only sidecar of CRC-framed JSON records. A
restarted dispatcher replays the journal before it serves a single frame:
the replay restores token-counter monotonicity (a straggler ``w_result``
for a pre-crash token can never collide with a fresh one), the
delivered-token set (dispatcher-side duplicate suppression survives the
restart — the client-side dedup is no longer the only line) and the
per-client cursors the ledger-epoch handshake reports back to re-adopting
clients.

Frame format (one per record)::

    >II header: payload length, CRC32(payload)
    payload:    UTF-8 JSON object with a 'kind' field

Append-only with atomic rotation: once the journal passes ``rotate_bytes``
the writer compacts its live state into ONE snapshot-carrying ``epoch``
record in a temp file and ``os.replace``s it over the journal. A torn tail
or a flipped byte fails its frame's CRC; replay stops at the first bad frame
(everything after an unreadable frame is untrusted), counts it in
``frames_dropped`` and reports ``result='corrupt'`` — the dispatcher degrades
LOUDLY to replay-from-clients (an error log and the ledger-replay breaker),
never to a wrong order.

Durability is process-crash-level by design: frames are flushed to the OS
on every append (they survive any SIGKILL of the dispatcher process) but
not fsync'd — host power loss may cost tail frames, which replay treats
exactly like a torn tail.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import tempfile
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

#: journal basename inside a fleet cache dir / dataset local state home
#: (``dataset_state.local_state_home`` — the underscore prefix keeps it out
#: of Parquet directory listings, like every other sidecar)
LEDGER_BASENAME = '_petastorm_tpu_dispatcher_ledger.bin'

#: every record kind the journal may carry — the two-sided contract between
#: the scheduler's journal hooks and :func:`replay_journal`; pipecheck's
#: protocol rule validates both sides against this tuple (a typo'd kind
#: fails tier-1 instead of silently never replaying)
LEDGER_RECORD_KINDS = ('epoch', 'client', 'setup', 'issued', 'delivered',
                       'retired', 'failed', 'quarantined', 'reshard')

#: frame header: payload length + CRC32(payload)
_FRAME_HEADER = struct.Struct('>II')

#: journal size that triggers a compacting rotation
DEFAULT_ROTATE_BYTES = 4 << 20


def default_ledger_path(state_home: str) -> str:
    """The journal path inside a fleet cache dir or dataset state home."""
    return os.path.join(state_home, LEDGER_BASENAME)


def dataset_ledger_path(dataset_url_or_path: str,
                        cache_location: Optional[str] = None) -> Optional[str]:
    """The journal path for a dataset's local state home
    (``dataset_state.sidecar_path`` — the same placement the cost ledger and
    lineage manifest use); None when the dataset has no local home."""
    from petastorm_tpu_torch.dataset_state import sidecar_path
    return sidecar_path(dataset_url_or_path, LEDGER_BASENAME, cache_location)


class LedgerReplay(object):
    """What one journal replay recovered (plus how trustworthy it is).

    ``result`` is ``'absent'`` (no journal — first start), ``'ok'`` (every
    frame verified) or ``'corrupt'`` (replay stopped at a bad frame;
    ``frames_dropped`` counts it and the caller must degrade loudly).
    ``'discarded'`` means the caller skipped replay on purpose (open
    ledger-replay breaker)."""

    __slots__ = ('result', 'epoch', 'next_token', 'delivered', 'served',
                 'clients', 'setups', 'frames_dropped', 'records',
                 'resharded')

    def __init__(self) -> None:
        self.result = 'absent'
        self.epoch = 0
        self.next_token = 0
        #: tokens whose result already went out to a client pre-crash —
        #: the dispatcher-side dedup set the restart must not forget
        self.delivered: set = set()
        #: per-client delivered-item cursors, keyed by client name
        self.served: Dict[str, int] = {}
        #: client name -> {host, window} as last hello'd
        self.clients: Dict[str, Dict[str, Any]] = {}
        #: setup id (hex str) -> blob digest — enough to verify a re-opened
        #: setup matches what the fleet was serving pre-crash
        self.setups: Dict[str, str] = {}
        self.frames_dropped = 0
        self.records = 0
        self.resharded = 0

    def apply(self, record: Dict[str, Any]) -> None:
        """Fold one verified record into the recovered state."""
        kind = record.get('kind')
        if kind == 'epoch':
            self.epoch = int(record.get('epoch', self.epoch))
            if 'next_token' in record:
                # a rotation snapshot is authoritative at its position
                self.next_token = int(record['next_token'])
                self.delivered = set(record.get('delivered') or ())
                self.served = dict(record.get('served') or {})
                self.clients = dict(record.get('clients') or {})
                self.setups = dict(record.get('setups') or {})
                self.resharded = int(record.get('resharded') or 0)
        elif kind == 'issued':
            token = int(record['token'])
            self.next_token = max(self.next_token, token + 1)
        elif kind == 'delivered':
            self.delivered.add(int(record['token']))
        elif kind == 'retired':
            client = record.get('client')
            if client is not None:
                self.served[client] = self.served.get(client, 0) + 1
            self.delivered.discard(int(record['token']))
        elif kind == 'failed' or kind == 'quarantined':
            self.delivered.discard(int(record['token']))
        elif kind == 'client':
            self.clients[str(record.get('name'))] = {
                'host': record.get('host'), 'window': record.get('window')}
        elif kind == 'setup':
            self.setups[str(record.get('setup'))] = str(record.get('digest'))
        elif kind == 'reshard':
            self.resharded += 1

    def as_dict(self) -> Dict[str, Any]:
        """JSON-safe summary for ``state()['ledger']`` and doctor."""
        return {'result': self.result, 'epoch': self.epoch,
                'next_token': self.next_token,
                'delivered': len(self.delivered),
                'clients': len(self.clients), 'setups': len(self.setups),
                'frames_dropped': self.frames_dropped,
                'records': self.records, 'resharded': self.resharded}


def read_frames(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """Every CRC-verified record in journal order, plus the dropped-frame
    count. Stops at the FIRST bad frame (short header, short payload, CRC
    mismatch, non-JSON payload): framing after an unreadable frame cannot be
    trusted, so the suffix is abandoned — counted, never guessed at."""
    records: List[Dict[str, Any]] = []
    dropped = 0
    with open(path, 'rb') as f:
        while True:
            header = f.read(_FRAME_HEADER.size)
            if not header:
                break
            if len(header) < _FRAME_HEADER.size:
                dropped += 1
                break
            length, crc = _FRAME_HEADER.unpack(header)
            payload = f.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                dropped += 1
                break
            try:
                record = json.loads(payload.decode('utf-8'))
            except (UnicodeDecodeError, ValueError):
                dropped += 1
                break
            if isinstance(record, dict):
                records.append(record)
    return records, dropped


def replay_journal(path: str) -> LedgerReplay:
    """Recover a :class:`LedgerReplay` from the journal at ``path``
    (``result='absent'`` when there is none)."""
    replay = LedgerReplay()
    if not os.path.exists(path):
        return replay
    try:
        records, dropped = read_frames(path)
    except OSError as exc:
        logger.error('ledger: journal %s is unreadable (%s); degrading to '
                     'replay-from-clients', path, exc)
        replay.result = 'corrupt'
        replay.frames_dropped = 1
        return replay
    for record in records:
        replay.apply(record)
    replay.records = len(records)
    replay.frames_dropped = dropped
    replay.result = 'corrupt' if dropped else 'ok'
    return replay


class TokenLedger(object):
    """Append-only CRC-framed journal writer with atomic compaction.

    The writer mirrors just enough live state (token counter, delivered
    set, per-client cursors, setup digests) to emit a self-contained
    snapshot record at rotation — so the journal's size is bounded by the
    LIVE state, not by epoch length. All appends are serialized by an
    internal lock (the scheduler journals from the pump thread, but the
    guarantee should not depend on that)."""

    def __init__(self, path: str,
                 rotate_bytes: int = DEFAULT_ROTATE_BYTES) -> None:
        self.path = path
        self.rotate_bytes = rotate_bytes
        self._lock = threading.Lock()
        self._file: Any = None
        self._epoch = 0
        self._next_token = 0
        self._delivered: set = set()
        self._served: Dict[str, int] = {}
        self._clients: Dict[str, Dict[str, Any]] = {}
        self._setups: Dict[str, str] = {}
        self._resharded = 0
        self._appended = 0
        self._replay: Optional[LedgerReplay] = None

    # ------------------------------------------------------------ lifecycle

    def open(self, discard: bool = False) -> LedgerReplay:
        """Replay the existing journal (unless ``discard``), bump the ledger
        epoch, and start appending. Returns the replay — the caller feeds it
        to ``FairShareScheduler.adopt_replay``. ``discard=True`` (open
        ledger-replay breaker: the journal corrupted the last replays too)
        truncates the journal and starts fresh — the degrade-to-
        replay-from-clients path, loud by construction."""
        with self._lock:
            if discard:
                replay = LedgerReplay()
                replay.result = 'discarded'
                try:
                    os.unlink(self.path)
                except OSError:
                    pass
            else:
                replay = replay_journal(self.path)
            self._replay = replay
            self._epoch = replay.epoch + 1
            self._next_token = replay.next_token
            self._delivered = set(replay.delivered)
            self._served = dict(replay.served)
            self._clients = dict(replay.clients)
            self._setups = dict(replay.setups)
            self._resharded = replay.resharded
            parent = os.path.dirname(self.path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._file = open(self.path, 'ab')
        self.append_record('epoch', epoch=self._epoch)
        return replay

    def close(self) -> None:
        """Flush and release the journal handle (no terminal record — a
        clean stop and a crash replay identically, which is the point)."""
        with self._lock:
            if self._file is not None:
                try:
                    self._file.flush()
                finally:
                    self._file.close()
                    self._file = None

    # -------------------------------------------------------------- appends

    def append_record(self, kind: str, **fields: Any) -> None:
        """Append one CRC-framed record and mirror it into the live state
        the next rotation snapshot will carry. Journal write failures are
        logged, not raised — durability is an upgrade, never a new way to
        take the data plane down."""
        record = dict(fields, kind=kind)
        payload = json.dumps(record, sort_keys=True).encode('utf-8')
        frame = _FRAME_HEADER.pack(len(payload), zlib.crc32(payload)) + payload
        with self._lock:
            if self._file is None:
                return
            self._mirror(kind, record)
            try:
                self._file.write(frame)
                self._file.flush()
                self._appended += 1
                if self._file.tell() >= self.rotate_bytes:
                    self._rotate()
            except OSError:
                logger.exception('ledger: append to %s failed; the journal '
                                 'is degraded until the next rotation',
                                 self.path)

    def _mirror(self, kind: str, record: Dict[str, Any]) -> None:
        # called under _lock
        if kind == 'issued':
            self._next_token = max(self._next_token,
                                   int(record['token']) + 1)
        elif kind == 'delivered':
            self._delivered.add(int(record['token']))
        elif kind == 'retired':
            client = record.get('client')
            if client is not None:
                self._served[client] = self._served.get(client, 0) + 1
            self._delivered.discard(int(record['token']))
        elif kind == 'failed' or kind == 'quarantined':
            self._delivered.discard(int(record['token']))
        elif kind == 'client':
            self._clients[str(record.get('name'))] = {
                'host': record.get('host'), 'window': record.get('window')}
        elif kind == 'setup':
            self._setups[str(record.get('setup'))] = str(record.get('digest'))
        elif kind == 'reshard':
            self._resharded += 1

    def _rotate(self) -> None:
        """Compact the journal to ONE snapshot-carrying epoch record,
        published atomically (temp file + ``os.replace``). Called under
        ``_lock``."""
        snapshot = {'kind': 'epoch', 'epoch': self._epoch,
                    'next_token': self._next_token,
                    'delivered': sorted(self._delivered),
                    'served': self._served, 'clients': self._clients,
                    'setups': self._setups, 'resharded': self._resharded}
        payload = json.dumps(snapshot, sort_keys=True).encode('utf-8')
        frame = _FRAME_HEADER.pack(len(payload),
                                   zlib.crc32(payload)) + payload
        parent = os.path.dirname(self.path) or '.'
        fd, tmp_path = tempfile.mkstemp(dir=parent,
                                        prefix='.ledger-rotate-')
        try:
            with os.fdopen(fd, 'wb') as tmp:
                tmp.write(frame)
                tmp.flush()
                os.fsync(tmp.fileno())
            self._file.close()
            os.replace(tmp_path, self.path)
            self._file = open(self.path, 'ab')
        except OSError:
            logger.exception('ledger: rotation of %s failed; journal keeps '
                             'growing until the next attempt', self.path)
            if self._file is None or self._file.closed:
                self._file = open(self.path, 'ab')
        finally:
            # no-op after a successful os.replace; on ANY failure path
            # (OSError or not) the orphaned temp file is removed
            try:
                os.unlink(tmp_path)
            except OSError:
                pass

    # ------------------------------------------------------------- snapshot

    @property
    def epoch(self) -> int:
        """The CURRENT ledger epoch (bumped on every ``open``) — what the
        ledger-epoch handshake reports to clients."""
        return self._epoch

    def state(self) -> Dict[str, Any]:
        """JSON-safe journal status for ``state()['ledger']`` / doctor."""
        with self._lock:
            out: Dict[str, Any] = {
                'armed': self._file is not None, 'path': self.path,
                'epoch': self._epoch, 'appended': self._appended,
                'delivered': len(self._delivered),
            }
            if self._replay is not None:
                out['last_replay'] = self._replay.result
                out['frames_dropped'] = self._replay.frames_dropped
                out['records_replayed'] = self._replay.records
            return out
