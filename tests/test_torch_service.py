"""The port's input service (``petastorm_tpu_torch.service``) held against the
JAX package's ``petastorm_tpu.service``.

- The scheduler: the port's and the JAX ``FairShareScheduler`` get the same
  injected clock and the same operations (the JAX test class's 12 cases and
  the reshard, replay-adoption, retune and journal cases); every returned
  value, every assignment and the final ``state()`` must be equal (exact).
- ``choose_service_knob`` on the same snapshots, the wire's bytes
  (``to_bytes`` of every descriptor, ``encode_cost``, ``parse_service_url``)
  and the ledger's journal, written by either package and replayed by the
  other (a torn or flipped frame counted the same): exact.
- End to end against localhost fleets (dispatcher thread on an ephemeral
  port, spawned decode workers): ``make_reader(service_url=)`` rows equal the
  port's thread reader's and the JAX reader's as multisets by ``idx``; the
  device decode tail over the service equals the thread reader's batches
  (K1's plain version on the CPU); two concurrent readers, the shared cache,
  a worker killed mid-item, quarantine parity under ``on_error='skip'``,
  ``busy`` backpressure, a poison item, a rejoin, a dispatcher crash with the
  ledger armed, cost hints reaching the DRR, an unreachable URL and the
  ``reader_pool`` exclusion; and the ``serve`` CLI (the doctor's blocks are
  in ``tests/test_torch_doctor.py``).

The module imports no JAX at its top: the fleet's workers import it to load
the toy workers below, and stay light (the JAX halves import inside tests).
"""

import glob
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pyarrow as pa
import pytest

from petastorm_tpu_torch import TorchDataLoader, make_reader
from petastorm_tpu_torch.codecs import (CompressedNdarrayCodec, DctImageCodec, NdarrayCodec,
                                        ScalarCodec)
from petastorm_tpu_torch.errors import TransientIOError
from petastorm_tpu_torch.etl.dataset_metadata import write_rows
from petastorm_tpu_torch.resilience import RetryPolicy
from petastorm_tpu_torch.service import ServiceFleet, ServicePool, fetch_service_state
from petastorm_tpu_torch.unischema import Unischema, UnischemaField
from petastorm_tpu_torch.workers.worker_base import WorkerBase

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST_RETRIES = RetryPolicy(max_attempts=3, backoff_base_s=0.01, max_backoff_s=0.05)
NUM_ROWS = 200
ROWS_PER_FILE = 25  # -> 8 part files / 8 rowgroup work items per epoch
RESPONSE_TIMEOUT_ENV = 'PETASTORM_TPU_SERVICE_RESPONSE_TIMEOUT_S'

ProbeSchema = Unischema('ServiceProbe', [
    UnischemaField('idx', np.int64, (), ScalarCodec(pa.int64()), False),
    UnischemaField('vec', np.float32, (16,), NdarrayCodec(), False),
])
ImageSchema = Unischema('ServiceImages', [
    UnischemaField('idx', np.int64, (), ScalarCodec(pa.int64()), False),
    UnischemaField('image', np.uint8, (16, 16, 3), DctImageCodec(), False),
    UnischemaField('embedding', np.float32, (32,), CompressedNdarrayCodec(stored=True), False),
])


def _part_files(root):
    files = sorted(glob.glob(os.path.join(str(root), '**', '*.parquet'), recursive=True))
    assert files, 'no part files under {}'.format(root)
    return files


def _rows(reader):
    """``{idx: vec bytes}`` of an epoch, each idx once."""
    out = {}
    for row in reader:
        assert int(row.idx) not in out
        out[int(row.idx)] = np.asarray(row.vec).tobytes()
    return out


@pytest.fixture(scope='module')
def service_store(tmp_path_factory):
    root = tmp_path_factory.mktemp('service') / 'store'
    url = 'file://' + str(root)
    write_rows(url, ProbeSchema, [{'idx': i, 'vec': np.full(16, i, np.float32)}
                                  for i in range(NUM_ROWS)],
               rows_per_file=ROWS_PER_FILE, rowgroup_size_mb=1)
    return {'url': url, 'root': root}


@pytest.fixture(scope='module')
def image_store(tmp_path_factory):
    root = tmp_path_factory.mktemp('service_images') / 'store'
    url = 'file://' + str(root)
    rng = np.random.RandomState(3)
    write_rows(url, ImageSchema,
               [{'idx': i, 'image': rng.randint(0, 255, (16, 16, 3), dtype=np.uint8),
                 'embedding': rng.randn(32).astype(np.float32)} for i in range(48)],
               rows_per_file=12)
    return url


@pytest.fixture(scope='module')
def fleet(tmp_path_factory):
    """One shared two-worker fleet with a shared cache dir, reused by every
    test that neither kills workers nor crashes the dispatcher."""
    cache_dir = str(tmp_path_factory.mktemp('service_cache'))
    with ServiceFleet(workers=2, cache_dir=cache_dir, stale_timeout_s=10.0) as running:
        yield running


# ---------------------------------------------------------------------------
# FairShareScheduler parity (injectable clock, no sockets)
# ---------------------------------------------------------------------------

def _plain(value):
    """A comparable form of a scheduler argument or return value."""
    if type(value).__name__ == 'Assignment':
        return tuple(getattr(value, name) for name in type(value).__slots__)
    if type(value).__name__ == 'WorkerDescriptor':
        return value.to_bytes()
    if type(value).__name__ == 'LedgerReplay':
        return value.as_dict()
    if isinstance(value, (list, tuple)):
        return [_plain(item) for item in value]
    return value


class _Recorder(object):
    """One package's scheduler behind a recording proxy: every call's name,
    arguments and (plain) result are appended to ``trace``."""

    def __init__(self, package, **kwargs):
        import importlib
        self.dispatcher = importlib.import_module(package + '.service.dispatcher')
        self.wire = importlib.import_module(package + '.service.wire')
        self.ledger = importlib.import_module(package + '.service.ledger')
        self.now = [0.0]
        self.sched = self.dispatcher.FairShareScheduler(clock=lambda: self.now[0], **kwargs)
        self.trace = []

    def __getattr__(self, name):
        fn = getattr(self.sched, name)

        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.trace.append((name, _plain(args), _plain(kwargs), _plain(out)))
            return out
        return call

    def register(self, key=b'w0', worker_id=0, host='h', shm_results=False):
        self.add_worker(key, self.wire.WorkerDescriptor(worker_id=worker_id, pid=1, host=host,
                                                        shm_results=shm_results))
        self.worker_ready(key)


def case_drr_alternates_between_skewed_clients(r):
    r.add_client(b'A', 'a', 'h')
    r.add_client(b'B', 'b', 'h')
    for i in range(40):
        assert r.submit(b'A', b'%d' % i, b's', b'blob') is not None
    for i in range(10):
        assert r.submit(b'B', b'%d' % i, b's', b'blob') is not None
    r.add_setup(b'A', b's', b'setup')
    r.register()
    served = []
    for _ in range(20):
        assignment = r.next_assignment()
        owner, _ = r.result_route(assignment.token)
        served.append(owner)
        r.retire(assignment.token, assignment.attempt)
        r.worker_ready(b'w0')
    assert all(served[i] != served[i + 1] for i in range(19)), served


def case_drr_single_client_gets_full_fleet(r):
    r.add_client(b'A', 'a', 'h')
    tokens = [r.submit(b'A', b'%d' % i, b's', b'b') for i in range(3)]
    r.register()
    assert r.next_assignment().token == tokens[0]


def case_admission_window_rejects_beyond_bound(r):
    r.add_client(b'A', 'a', 'h')
    for i in range(3):
        r.submit(b'A', b'%d' % i, b's', b'b')
    assert r.sched.busy_rejections == 1


def case_window_frees_on_retire_not_on_assignment(r):
    r.add_client(b'A', 'a', 'h')
    token = r.submit(b'A', b'0', b's', b'b')
    r.register()
    assignment = r.next_assignment()
    assert r.submit(b'A', b'1', b's', b'b') is None
    r.result_route(token)
    r.retire(token, assignment.attempt)
    assert r.submit(b'A', b'1', b's', b'b') is not None


def case_stale_worker_requeue_and_stale_ack_protocol(r):
    r.add_client(b'A', 'a', 'h')
    r.submit(b'A', b'0', b's', b'b')
    r.register(b'w0', 0)
    first = r.next_assignment()
    r.heartbeat(0, 1)
    r.now[0] = 3.0
    r.stale_workers()
    r.now[0] = 9.0
    assert r.stale_workers() == [b'w0']
    r.remove_worker(b'w0')
    r.register(b'w1', 1)
    second = r.next_assignment()
    assert second.token == first.token and second.attempt == 1
    r.retire(second.token, 0)
    r.state()
    r.retire(second.token, 1)


def case_attempt_budget_exhaustion_fails_item_loudly(r):
    r.add_client(b'A', 'a', 'h')
    r.submit(b'A', b'7', b's', b'b')
    for generation in range(3):
        key = b'w%d' % generation
        r.register(key, generation)
        if r.next_assignment() is None:
            break
        if r.remove_worker(key):
            break
    assert r.sched.items_failed == 1


def case_shm_fail_pins_item_to_wire_and_respects_budget(r):
    r.add_client(b'A', 'a', 'samehost')
    r.submit(b'A', b'0', b's', b'b')
    r.register(b'w0', 0, host='samehost', shm_results=True)
    colocated = []
    for _ in range(3):
        assignment = r.next_assignment()
        colocated.append(assignment.colocated)
        r.result_route(assignment.token)
        failed = r.requeue_token(assignment.token)
        r.worker_ready(b'w0')
    assert colocated == [True, False, False] and failed is not None


def case_missing_setup_burns_budget_instead_of_spinning(r):
    r.add_client(b'A', 'a', 'h')
    r.submit(b'A', b'0', b'unknown-setup', b'b')
    r.register()
    failed = None
    for _ in range(4):
        assignment = r.next_assignment()
        if assignment is None:
            break
        failed = r.forget_setups(b'w0', assignment.token)
        r.worker_ready(b'w0')
        if failed is not None:
            break
    assert failed is not None


def case_idle_client_ttl_collection(r):
    r.add_client(b'A', 'a', 'h')
    r.add_setup(b'A', b's', b'blob')
    r.now[0] = 50.0
    r.expired_clients()
    r.now[0] = 151.0
    assert r.expired_clients() == [b'A']
    r.remove_client(b'A')
    r.has_client(b'A')
    r.submit(b'A', b'0', b's', b'b')


def case_item_deadline_reaps_heartbeating_worker(r):
    r.add_client(b'A', 'a', 'h')
    r.submit(b'A', b'0', b's', b'b')
    r.register()
    r.next_assignment()
    for tick in range(1, 5):
        r.now[0] = float(tick)
        r.heartbeat(0, tick)
    r.stale_workers()
    r.now[0] = 6.5
    r.heartbeat(0, 99)
    assert r.stale_workers() == [b'w0']


def case_duplicate_result_dropped_after_requeue_race(r):
    r.add_client(b'A', 'a', 'h')
    r.submit(b'A', b'0', b's', b'b')
    r.register(b'w0', 0)
    assignment = r.next_assignment()
    r.result_route(assignment.token)
    r.remove_worker(b'w0')
    r.register(b'w1', 1)
    redelivery = r.next_assignment()
    assert r.result_route(redelivery.token) is None


def case_setup_blob_ships_once_per_worker(r):
    r.add_client(b'A', 'a', 'h')
    r.add_setup(b'A', b's', b'SETUPBLOB')
    r.submit(b'A', b'0', b's', b'b')
    r.submit(b'A', b'1', b's', b'b')
    r.register()
    first = r.next_assignment()
    r.retire(first.token, first.attempt)
    r.worker_ready(b'w0')
    assert first.setup_blob == b'SETUPBLOB' and r.next_assignment().setup_blob is None


def case_cost_hints_heavy_routing_and_reshard(r):
    """Measured costs: the DRR charges them, heavy items go least-loaded, and
    a worker join re-deals the undelivered queue round-robin."""
    r.add_client(b'A', 'a', 'h')
    r.add_client(b'B', 'b', 'h')
    for i in range(6):
        r.submit(b'A', b'%d' % i, b's', b'b', cost=[0.1, 9.0, 2.5, 1.0, 0.5, 3.0][i])
        r.submit(b'B', b'%d' % i, b's', b'b')
    for worker_id in range(3):
        r.register(b'w%d' % worker_id, worker_id)
    r.reshard('worker-join')
    for _ in range(8):
        assignment = r.next_assignment()
        if assignment is None:
            for worker_id in range(3):
                r.worker_ready(b'w%d' % worker_id)
            continue
        r.result_route(assignment.token)
        r.retire(assignment.token, assignment.attempt)
    r.remove_worker(b'w2')
    r.reshard('worker-leave')
    r.autotune_snapshot()


def case_adopt_replay_and_retunes(r):
    """A replayed ledger: the token space moves to the epoch's base, a
    replayed delivered token's straggler result is dropped; then the
    admission and client-window retunes."""
    replay = r.ledger.LedgerReplay()
    replay.result, replay.next_token, replay.delivered = 'ok', 17, {3, 5}
    replay.resharded = 2
    r.adopt_replay(replay, 2)
    r.add_client(b'A', 'a', 'h', 4)
    r.add_client(b'B', 'b', 'h')
    r.submit(b'A', b'0', b's', b'b')
    r.result_route(5)
    r.set_admission_window(2)
    r.client_window(b'A')
    r.set_admission_window(32)
    r.set_client_windows(100)
    r.effective_client_window()
    r.autotune_snapshot()
    assert r.sched.replay_info['next_token'] == 17


SCHEDULER_CASES = [
    (case_drr_alternates_between_skewed_clients, {'admission_window': 64}),
    (case_drr_single_client_gets_full_fleet, {}),
    (case_admission_window_rejects_beyond_bound, {'admission_window': 2}),
    (case_window_frees_on_retire_not_on_assignment, {'admission_window': 1}),
    (case_stale_worker_requeue_and_stale_ack_protocol, {'stale_timeout_s': 5.0}),
    (case_attempt_budget_exhaustion_fails_item_loudly, {'max_item_attempts': 2}),
    (case_shm_fail_pins_item_to_wire_and_respects_budget, {'max_item_attempts': 3}),
    (case_missing_setup_burns_budget_instead_of_spinning, {'max_item_attempts': 2}),
    (case_idle_client_ttl_collection, {'client_ttl_s': 100.0}),
    (case_item_deadline_reaps_heartbeating_worker,
     {'stale_timeout_s': 1000.0, 'item_deadline_s': 5.0}),
    (case_duplicate_result_dropped_after_requeue_race, {}),
    (case_setup_blob_ships_once_per_worker, {}),
    (case_cost_hints_heavy_routing_and_reshard, {'admission_window': 64, 'quantum': 0.5}),
    (case_adopt_replay_and_retunes, {}),
]


@pytest.mark.parametrize('case,kwargs', SCHEDULER_CASES,
                         ids=[case.__name__[5:] for case, _ in SCHEDULER_CASES])
def test_scheduler_equals_jax(case, kwargs, tmp_path):
    """The same operations on both schedulers, each with a journal armed:
    equal returns, assignments and state, and byte-equal journals."""
    traces, journals = [], []
    for package in ('petastorm_tpu', 'petastorm_tpu_torch'):
        recorder = _Recorder(package, **kwargs)
        path = str(tmp_path / package / 'ledger.bin')
        journal = recorder.ledger.TokenLedger(path)
        journal.open()
        recorder.sched.journal = journal
        case(recorder)
        recorder.state()
        journal.close()
        traces.append(recorder.trace)
        with open(path, 'rb') as f:
            journals.append(f.read())
    assert traces[0] == traces[1]
    assert journals[0] == journals[1] and len(journals[0]) > 20


def test_choose_service_knob_equals_jax():
    from petastorm_tpu.autotune.knobs import build_service_knobs as jax_knobs
    from petastorm_tpu.service.dispatcher import FairShareScheduler as JaxScheduler
    from petastorm_tpu.service.dispatcher import choose_service_knob as jax_choose
    from petastorm_tpu_torch.autotune.knobs import build_service_knobs
    from petastorm_tpu_torch.service.dispatcher import FairShareScheduler, choose_service_knob
    port_knobs = build_service_knobs(FairShareScheduler(admission_window=16))
    jax_built = jax_knobs(JaxScheduler(admission_window=16))
    assert [(k.knob_id, k.minimum, k.maximum, k.step, k.cost) for k in port_knobs] == \
        [(k.knob_id, k.minimum, k.maximum, k.step, k.cost) for k in jax_built]
    prev = {'counters': {'service_busy': 0}}
    snapshots = [
        {'counters': {'service_busy': 3}, 'gauges': {
            'service_queue_depth': 1.0, 'service_workers': 2.0,
            'service_admission_window': 16.0, 'service_client_window': 8.0}},
        {'counters': {'service_busy': 3}, 'gauges': {
            'service_queue_depth': 1.0, 'service_workers': 2.0,
            'service_admission_window': 16.0, 'service_client_window': 16.0}},
        {'counters': {'service_busy': 0}, 'gauges': {
            'service_queue_depth': 50.0, 'service_workers': 2.0}},
        {'counters': {'service_busy': 0}, 'gauges': {'service_queue_depth': 3.0}},
        {}]
    choices = []
    for cur in snapshots:
        for eligible in (port_knobs, port_knobs[:1], port_knobs[1:], []):
            ids = [k.knob_id for k in eligible]
            jax_eligible = [k for k in jax_built if k.knob_id in ids]
            choice = choose_service_knob(prev, cur, 0.0, eligible)
            assert choice == jax_choose(prev, cur, 0.0, jax_eligible)
            choices.append(choice)
    assert {'service_client_window', 'service_admission_window', None} <= set(choices)


# ---------------------------------------------------------------------------
# wire bytes
# ---------------------------------------------------------------------------

def test_wire_bytes_equal_jax():
    from petastorm_tpu.service import wire as jax_wire
    from petastorm_tpu_torch.service import wire
    assert (wire.MIN_COST_HINT, wire.MAX_COST_HINT, wire.WORKER_PORT_OFFSET) == \
        (jax_wire.MIN_COST_HINT, jax_wire.MAX_COST_HINT, jax_wire.WORKER_PORT_OFFSET)
    for cls, args in (('WorkerDescriptor', (3, 42, 'box', 2, 0.25, True)),
                      ('WorkerDescriptor', (0, 1, 'h')),
                      ('ShmResultDescriptor', ('ptt-svc-x', [3, 0, 17], 12345)),
                      ('ShmResultDescriptor', ('n', [], None)),
                      ('WorkerMetricsUpdate', (1, 9, {'counters': {'a': 1}})),
                      ('WorkerMetricsUpdate', (1, 9, {})),
                      ('WorkerIncidentUpdate', (2, 4, {'kind': 'hang', 'size': 3}))):
        port = getattr(wire, cls)(*args)
        jax = getattr(jax_wire, cls)(*args)
        assert port.to_bytes() == jax.to_bytes(), cls
        back = getattr(wire, cls).from_bytes(jax.to_bytes())
        assert back.to_bytes() == jax.to_bytes()
        assert getattr(jax_wire, cls).from_bytes(port.to_bytes()).to_bytes() == port.to_bytes()
    assert wire.ShmResultDescriptor('n', [3, 0, 17], 1).total_bytes == 20
    for cost in (0.0, 0.25, 1.0, 1.0 / 3.0, 4.0, 123.456789):
        assert wire.encode_cost(cost) == jax_wire.encode_cost(cost)
    for blob in (b'1.5', b'0', b'-2', b'nan', b'x', b'', b'inf', b'0.000001'):
        assert wire.decode_cost(blob) == jax_wire.decode_cost(blob) or \
            (np.isnan(wire.decode_cost(blob)) and np.isnan(jax_wire.decode_cost(blob)))
    for url in ('tcp://10.0.0.2:8780', 'petastorm-service://fleet:9', 'tcp://h:100',
                'tcp://[::1]:5'):
        assert wire.parse_service_url(url) == jax_wire.parse_service_url(url)
        assert wire.client_endpoint(url) == jax_wire.client_endpoint(url)
        assert wire.worker_endpoint(url) == jax_wire.worker_endpoint(url)
    for bad in ('http://h:1', 'tcp://h', 'tcp://:5', 'tcp://h:x'):
        with pytest.raises(ValueError):
            wire.parse_service_url(bad)
        with pytest.raises(ValueError):
            jax_wire.parse_service_url(bad)
    assert wire.host_token() == jax_wire.host_token()


# ---------------------------------------------------------------------------
# the ledger's journal
# ---------------------------------------------------------------------------

def _write_journal(ledger_module, path, rotate_bytes=None):
    kwargs = {} if rotate_bytes is None else {'rotate_bytes': rotate_bytes}
    ledger = ledger_module.TokenLedger(path, **kwargs)
    ledger.open()
    for token in range(60):
        ledger.append_record('issued', token=token, client='a', cost=1.0)
        ledger.append_record('delivered', token=token)
        if token % 3:
            ledger.append_record('retired', token=token, client='a')
    ledger.append_record('client', name='a', host='h', window=8)
    ledger.append_record('setup', setup='s0', digest='d0', client='a')
    ledger.append_record('failed', token=3)
    ledger.append_record('quarantined', token=6)
    ledger.append_record('reshard', reason='worker-join', workers=2, undelivered=4,
                         resharded=1)
    ledger.close()
    ledger = ledger_module.TokenLedger(path, **kwargs)   # a second life: epoch 2
    ledger.open()
    ledger.append_record('issued', token=(2 << 40))
    state = ledger.state()
    ledger.close()
    return state


@pytest.mark.parametrize('rotate_bytes', [None, 2048])
def test_ledger_journals_replay_across_packages(tmp_path, rotate_bytes):
    from petastorm_tpu.service import ledger as jax_ledger
    from petastorm_tpu_torch.service import ledger
    port_path, jax_path = str(tmp_path / 'port.bin'), str(tmp_path / 'jax.bin')
    port_state = _write_journal(ledger, port_path, rotate_bytes)
    jax_state = _write_journal(jax_ledger, jax_path, rotate_bytes)
    with open(port_path, 'rb') as f, open(jax_path, 'rb') as g:
        assert f.read() == g.read()
    assert {k: v for k, v in port_state.items() if k != 'path'} == \
        {k: v for k, v in jax_state.items() if k != 'path'}
    want = jax_ledger.replay_journal(jax_path)
    assert want.result == 'ok' and want.epoch == 2 and want.next_token == (2 << 40) + 1
    for replay in (ledger.replay_journal(jax_path), ledger.replay_journal(port_path)):
        assert replay.as_dict() == want.as_dict()
        assert (replay.delivered, replay.served, replay.clients, replay.setups) == \
            (want.delivered, want.served, want.clients, want.setups)
    assert jax_ledger.replay_journal(port_path).as_dict() == want.as_dict()
    assert ledger.read_frames(jax_path) == jax_ledger.read_frames(port_path)
    # a flipped byte in the last frame, and a torn tail: counted the same
    size = os.path.getsize(port_path)
    with open(port_path, 'r+b') as f:
        f.seek(size - 3)
        byte = f.read(1)
        f.seek(size - 3)
        f.write(bytes([byte[0] ^ 0xFF]))
    with open(jax_path, 'r+b') as f:
        f.truncate(size - 3)
    for path in (port_path, jax_path):
        got, want = ledger.replay_journal(path), jax_ledger.replay_journal(path)
        assert got.as_dict() == want.as_dict()
        assert got.result == 'corrupt' and got.frames_dropped == 1
        assert ledger.read_frames(path) == jax_ledger.read_frames(path)
    assert ledger.replay_journal(str(tmp_path / 'absent')).result == 'absent'
    assert ledger.LEDGER_BASENAME == jax_ledger.LEDGER_BASENAME
    assert ledger.LEDGER_RECORD_KINDS == jax_ledger.LEDGER_RECORD_KINDS


def test_dataset_ledger_path_equals_jax(service_store, tmp_path):
    from petastorm_tpu.service import ledger as jax_ledger
    from petastorm_tpu_torch.service import ledger
    for cache_location in (None, str(tmp_path)):
        assert ledger.dataset_ledger_path(service_store['url'], cache_location) == \
            jax_ledger.dataset_ledger_path(service_store['url'], cache_location)


# ---------------------------------------------------------------------------
# end to end against localhost fleets
# ---------------------------------------------------------------------------

def test_service_reader_rows_equal_thread_and_jax_readers(service_store, fleet):
    """The same read through the fleet, the port's thread pool and the JAX
    reader: equal rows by idx; the dispatcher's state rides diagnostics."""
    from petastorm_tpu import make_reader as jax_make_reader
    with jax_make_reader(service_store['url'], seed=7, num_epochs=1) as reader:
        jax_rows = _rows(reader)
    with make_reader(service_store['url'], seed=7, num_epochs=1, workers_count=2) as reader:
        thread_rows = _rows(reader)
    with make_reader(service_store['url'], service_url=fleet.service_url, seed=7,
                     num_epochs=1) as reader:
        service_rows = _rows(reader)
        diag = reader.diagnostics
    assert service_rows == thread_rows == jax_rows
    assert sorted(service_rows) == list(range(NUM_ROWS))
    assert diag['rowgroups_quarantined'] == 0
    service = diag['service']
    assert service['reachable'] is True and service['state'] == 'serving'
    assert len(service['workers']) == 2 and service['ledger'] == {'armed': False}
    assert {'queue_depth', 'busy_rejections', 'items_requeued', 'results_dropped'} <= \
        set(service)
    # co-located fleet: the whole epoch rode one-shot segments, none failed
    assert diag['service_shm_batches'] == NUM_ROWS // ROWS_PER_FILE
    assert diag['wire_batches'] == 0 and diag['service_resubmitted'] == 0


def test_device_decode_over_the_service_equals_thread_batches(image_store, tmp_path):
    """device_decode_fields over a one-worker fleet (so results arrive in
    ventilation order) into a CPU TorchDataLoader: the thread reader's
    batches, bit for bit (the raw columns reach the decode tail alike)."""
    import torch

    def batches(**kwargs):
        with make_reader(image_store, shuffle_row_groups=False, num_epochs=1,
                         device_decode_fields=['image', 'embedding'], **kwargs) as reader:
            loader = TorchDataLoader(reader, batch_size=8, device='cpu')
            out = [{name: value.clone() for name, value in batch.items()}
                   for batch in loader]
            return out, loader.stats.as_dict()

    with ServiceFleet(workers=1, cache_dir=str(tmp_path / 'cache')) as running:
        service, service_stats = batches(service_url=running.service_url)
    thread, thread_stats = batches(workers_count=1)
    assert len(service) == len(thread) == 6
    assert service_stats['device_stored_batches'] == thread_stats['device_stored_batches'] == 6
    for got, want in zip(service, thread):
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name].dtype == want[name].dtype, name
            assert torch.equal(got[name], want[name]), name


def test_two_concurrent_readers_and_the_shared_cache(service_store, fleet):
    """Two readers at once on one fleet each get every row once; a third,
    later client is served from the fleet's shared cache."""
    results, errors = {}, []

    def consume(name):
        try:
            with make_reader(service_store['url'], service_url=fleet.service_url,
                             num_epochs=1) as reader:
                results[name] = sorted(_rows(reader))
        except Exception as exc:  # noqa: BLE001 - surfaced via the errors list
            errors.append((name, exc))

    threads = [threading.Thread(target=consume, args=(name,)) for name in 'ab']
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=120)
    assert not errors, errors
    assert results['a'] == results['b'] == list(range(NUM_ROWS))
    with make_reader(service_store['url'], service_url=fleet.service_url,
                     num_epochs=1) as reader:
        assert sorted(_rows(reader)) == list(range(NUM_ROWS))
        diag = reader.diagnostics
    assert diag['cache_hits'] == NUM_ROWS // ROWS_PER_FILE and diag['cache_misses'] == 0


@pytest.mark.faultinject
def test_worker_sigkill_mid_item_loses_zero_rows(service_store, tmp_path):
    from petastorm_tpu_torch.test_util.fault_injection import (FaultRule, FaultSchedule,
                                                         fault_injecting_filesystem)
    target = os.path.basename(_part_files(service_store['root'])[3])
    sched = FaultSchedule(tmp_path / 'faults', [FaultRule(target, kind='kill', times=1)])
    with ServiceFleet(workers=2, stale_timeout_s=3.0) as running:
        with make_reader(service_store['url'], service_url=running.service_url,
                         num_epochs=1, shuffle_row_groups=False,
                         filesystem=fault_injecting_filesystem(sched)) as reader:
            ids = sorted(_rows(reader))
            diag = reader.diagnostics
    assert ids == list(range(NUM_ROWS))
    assert diag['rowgroups_quarantined'] == 0
    assert diag['service']['workers_departed'] >= 1
    assert diag['service']['items_requeued'] >= 1
    assert sched.trigger_count(0) >= 1


@pytest.mark.faultinject
def test_quarantine_parity_with_the_thread_pool_and_jax(service_store, tmp_path):
    """on_error='skip' over the service quarantines what the port's thread
    pool and the JAX reader quarantine (cache-less fleet: a warm cache would
    serve the poisoned rowgroup without touching the faulty filesystem)."""
    from petastorm_tpu import make_reader as jax_make_reader
    from petastorm_tpu.resilience import RetryPolicy as JaxRetryPolicy
    from petastorm_tpu_torch.test_util.fault_injection import (FaultRule, FaultSchedule,
                                                         fault_injecting_filesystem)
    target = os.path.basename(_part_files(service_store['root'])[2])

    def read_with_faults(factory, state_dir, retries, **kwargs):
        sched = FaultSchedule(state_dir, [FaultRule(target)])  # always fails
        with factory(service_store['url'], num_epochs=1,
                     filesystem=fault_injecting_filesystem(sched), on_error='skip',
                     retry_policy=retries, shuffle_row_groups=False, **kwargs) as reader:
            return sorted(_rows(reader)), reader.diagnostics

    with ServiceFleet(workers=2) as running:
        service_ids, service_diag = read_with_faults(
            make_reader, tmp_path / 'service', FAST_RETRIES, service_url=running.service_url)
    thread_ids, thread_diag = read_with_faults(make_reader, tmp_path / 'thread',
                                               FAST_RETRIES, workers_count=2)
    jax_ids, jax_diag = read_with_faults(
        jax_make_reader, tmp_path / 'jax',
        JaxRetryPolicy(max_attempts=3, backoff_base_s=0.01, max_backoff_s=0.05),
        workers_count=2)
    assert service_ids == thread_ids == jax_ids
    assert len(service_ids) == NUM_ROWS - ROWS_PER_FILE
    entries = [diag['quarantine'] for diag in (service_diag, thread_diag, jax_diag)]
    assert all(len(entry) == 1 for entry in entries)
    for (entry,) in entries:
        assert target in entry['fragment_path'] and entry['reason'] == 'error'
        assert entry['error_type'] == entries[2][0]['error_type']
        assert entry['attempts'] == entries[2][0]['attempts']


class EchoWorker(WorkerBase):
    """Service-shippable toy worker: publishes its input doubled."""

    def process(self, **kwargs):
        """Publish ``{'value': kwargs['value'] * 2}``."""
        self.publish_func({'value': kwargs['value'] * 2})


def test_admission_busy_backpressure():
    """A client pushing past the dispatcher's admission window gets explicit
    BUSY rejections, backs off, and still completes every item."""
    with ServiceFleet(workers=1, admission_window=2, shm_results=False) as running:
        pool = ServicePool(running.service_url, window=8)
        try:
            pool._window = 8  # out-submit the dispatcher's clamped window
            pool.start(EchoWorker, None, ventilator=None)
            for i in range(8):
                pool.ventilate(value=i)
            values = sorted(pool.get_results(timeout=60)['value'] for _ in range(8))
            assert values == [2 * i for i in range(8)]
            assert pool.diagnostics['busy_rejections'] >= 1
            assert running.state()['busy_rejections'] >= 1
        finally:
            pool.stop()
            pool.join()


class PoisonOnLoad(object):
    """Pickles fine client-side, explodes inside the worker's load."""

    def __reduce__(self):
        """Reconstruct via :func:`_explode` (which raises)."""
        return (_explode, ())


def _explode():
    """Deserialization bomb for :class:`PoisonOnLoad`."""
    raise RuntimeError('poison kwargs blob')


def test_poison_item_fails_loudly_and_a_rejoin_completes():
    """A work item that cannot even load on the worker errors back to its
    owner as one failed item and the worker lives; then a dispatcher that
    forgot its clients (as after a restart) answers ``rejoin`` and a new
    client's read completes."""
    with ServiceFleet(workers=1, shm_results=False) as running:
        pool = ServicePool(running.service_url)
        try:
            pool.start(EchoWorker, None, ventilator=None)
            pool.ventilate(value=PoisonOnLoad())
            with pytest.raises(RuntimeError, match='poison kwargs blob'):
                pool.get_results(timeout=60)
        finally:
            pool.join()
        assert running.processes[0].poll() is None
        assert len(running.state()['workers']) == 1
        pool = ServicePool(running.service_url)
        try:
            pool.start(EchoWorker, None, ventilator=None)
            pool.ventilate(value=1)
            assert pool.get_results(timeout=60)['value'] == 2
            scheduler = running.dispatcher.scheduler
            for key in list(scheduler._clients):
                scheduler.remove_client(key)
            pool.ventilate(value=21)
            assert pool.get_results(timeout=60)['value'] == 42
            assert pool.diagnostics['rejoins'] >= 1
        finally:
            pool.stop()
            pool.join()


@pytest.mark.faultinject
def test_dispatcher_crash_with_the_ledger_is_rows_exact(service_store, tmp_path,
                                                         monkeypatch):
    """The dispatcher crashes a third into the epoch and a new incarnation
    replays the ledger: the epoch completes with every row exactly once, the
    workers re-adopt it, and its state reports the replay."""
    monkeypatch.setenv(RESPONSE_TIMEOUT_ENV, '1.0')
    with ServiceFleet(workers=2, ledger=str(tmp_path / 'ledger.bin')) as running:
        rows = []
        with make_reader(service_store['url'], service_url=running.service_url,
                         num_epochs=1, seed=5) as reader:
            for row in reader:
                rows.append(int(row.idx))
                if len(rows) == NUM_ROWS // 3:
                    running.crash_dispatcher()
            diag = reader.diagnostics
        ledger = running.state()['ledger']
        # an idle worker re-announces itself within five idle polls and the
        # new incarnation answers w_rejoin: the fleet heals without respawns
        deadline = time.monotonic() + 20
        while len(running.state()['workers']) < 2 and time.monotonic() < deadline:
            time.sleep(0.1)
        workers = running.state()['workers']
        pids = [process.pid for process in running.processes]
    assert sorted(rows) == list(range(NUM_ROWS))
    assert ledger['armed'] and ledger['epoch'] == 2 and ledger['last_replay'] == 'ok'
    assert ledger['records_replayed'] > 0 and ledger['frames_dropped'] == 0
    assert diag['ledger_rearms'] + diag['rejoins'] >= 1
    assert sorted(worker['pid'] for worker in workers) == sorted(pids)


def test_cost_hints_reach_the_dispatcher(service_store, fleet, tmp_path):
    """A cost-scheduled service read ships each item's hint with its submit:
    the cost the workers retired grows by the hints' sum, not the count."""
    from petastorm_tpu_torch.telemetry.cost_model import CostLedger
    from petastorm_tpu_torch.etl.dataset_metadata import load_row_groups, open_dataset
    with make_reader(service_store['url'], reader_pool_type='dummy') as reader:
        token = reader.dataset_token
    row_groups = load_row_groups(open_dataset(service_store['url']))
    ledger = CostLedger(token)
    for index, rg in enumerate(row_groups):
        entry = ledger._entry('{}#{}'.format(rg.fragment_path, rg.row_group_id))
        seconds = 0.03 if index == 1 else 0.01
        entry['stages']['decode'] = {'count': 1, 'sum_s': seconds, 'max_s': seconds}
    path = ledger.save(str(tmp_path / 'costs.json'))

    def served():
        return sum(w['cost_served'] for w in fleet.state()['workers'])

    before = served()
    with make_reader(service_store['url'], service_url=fleet.service_url, num_epochs=1,
                     cost_schedule=path) as reader:
        hints = [reader._cost_scheduler.cost_hint_for(item)
                 for item in reader._ventilator._items_to_ventilate]
        assert sorted(_rows(reader)) == list(range(NUM_ROWS))
    assert len(hints) == NUM_ROWS // ROWS_PER_FILE and max(hints) > 1.5
    assert served() - before == pytest.approx(sum(hints), abs=1e-2)


def test_unreachable_url_and_the_reader_pool_exclusion(service_store):
    from petastorm_tpu_torch.workers.dummy_pool import DummyPool
    with pytest.raises(TransientIOError):
        ServicePool('tcp://127.0.0.1:1', connect_timeout_s=0.5)
    with pytest.raises(TransientIOError):
        fetch_service_state('tcp://127.0.0.1:1', timeout_s=0.5)
    with pytest.raises(ValueError, match='mutually exclusive'):
        make_reader(service_store['url'], service_url='tcp://127.0.0.1:1',
                    reader_pool=DummyPool())
    with pytest.raises(TransientIOError):
        make_reader(service_store['url'], service_url='tcp://127.0.0.1:1')


def test_pool_shape_arguments_warn_and_lambdas_are_named(service_store, fleet, monkeypatch):
    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.predicates import in_lambda
    with pytest.warns(UserWarning, match=r"ignoring pool-shape arguments \['workers_count'"):
        with make_batch_reader(service_store['url'], service_url=fleet.service_url,
                               workers_count=3, num_epochs=1) as reader:
            assert sum(batch.idx.shape[0] for batch in reader) == NUM_ROWS
    monkeypatch.setitem(sys.modules, 'dill', None)
    with pytest.raises(TypeError, match='the predicate.*lambda.*pickle'):
        make_reader(service_store['url'], service_url=fleet.service_url,
                    predicate=in_lambda(['idx'], lambda i: i % 2 == 0))


def test_serve_cli_runs_a_fleet_until_interrupted():
    """``petastorm-tpu-torch-throughput serve --port 0``: prints the URL of a
    fleet on an ephemeral port pair, answers state requests, stops on SIGINT."""
    env = dict(os.environ, PYTHONPATH=REPO)
    process = subprocess.Popen(
        [sys.executable, '-m', 'petastorm_tpu_torch.benchmark.cli', 'serve', '--port', '0',
         '--workers', '1', '--state-interval', '0'],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        line = process.stdout.readline()
        assert 'input service running at tcp://127.0.0.1:' in line, line
        url = line.split(' running at ')[1].split()[0]
        state = fetch_service_state(url, timeout_s=5.0)
        assert state['state'] == 'serving' and len(state['workers']) == 1
        from petastorm_tpu_torch.tools import doctor
        report = doctor.check_service(url)
        assert report['status'] == 'ok' and report['workers'] == 1
        assert doctor.check_ledger(report) == {'status': 'unarmed'}
    finally:
        process.send_signal(signal.SIGINT)
        assert process.wait(timeout=30) == 0
        process.stdout.close()


def test_fleet_scrape_and_autotune_equal_jax_rendering(service_store, tmp_path):
    """``metrics_port=0`` serves the fleet's ``/metrics``: the dispatcher's
    per-client and per-worker gauges and the workers' heartbeat snapshots,
    rendered as the JAX exporter renders the same state and snapshots; the
    armed service autotuner reports through ``state()``."""
    import urllib.request
    from petastorm_tpu.telemetry import export as jax_export
    from petastorm_tpu.telemetry.http_exporter import service_state_text as jax_state_text
    from petastorm_tpu_torch.autotune import AutotunePolicy
    from petastorm_tpu_torch.telemetry import export
    from petastorm_tpu_torch.telemetry.http_exporter import service_state_text
    policy = AutotunePolicy(window_s=0.05, warmup_windows=1, hold_windows=1)
    with ServiceFleet(workers=1, metrics_port=0, autotune=policy) as running:
        with make_reader(service_store['url'], service_url=running.service_url,
                         num_epochs=1) as reader:
            assert sorted(_rows(reader)) == list(range(NUM_ROWS))
            dispatcher = running.dispatcher
            deadline = time.monotonic() + 20
            # a worker ships its cumulative snapshot every 4th heartbeat (2 s)
            while (not dispatcher.worker_metrics_snapshots().get('0', {}).get('histograms')
                   and time.monotonic() < deadline):
                time.sleep(0.1)
            state = dispatcher.scheduler.state()
            snapshots = dispatcher.worker_metrics_snapshots()
            with urllib.request.urlopen(dispatcher.metrics_url + '/metrics', timeout=10) as r:
                text = r.read().decode('utf-8')
            with urllib.request.urlopen(dispatcher.metrics_url + '/healthz', timeout=10) as r:
                health = json.loads(r.read().decode('utf-8'))
        report = running.state()['autotune']
    assert service_state_text(state) == jax_state_text(state)
    assert 'petastorm_tpu_service_client_in_flight{client="' in text
    assert 'petastorm_tpu_service_worker_assigned{worker="0"}' in text
    assert list(snapshots) == ['0'] and snapshots['0']['histograms']
    assert export.to_prometheus_text_labeled(snapshots, 'worker', 'petastorm_tpu_worker') == \
        jax_export.to_prometheus_text_labeled(snapshots, 'worker', prefix='petastorm_tpu_worker')
    assert 'petastorm_tpu_worker_' in text and 'worker="0"' in text
    assert health['status'] == 'ok' and health['workers'] == 1
    assert report['controller'] == 'service' and report['windows'] >= 1
    assert set(report['knobs']) == {'service_admission_window', 'service_client_window'}
