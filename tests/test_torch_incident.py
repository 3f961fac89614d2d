"""The port's incident plane (``petastorm_tpu_torch.telemetry.incident``)
against the JAX package's: policy resolution, the bundle layout, the token
bucket of each trigger kind, retention, ``bundle_reference``/``adopt``,
``analyze_bundle`` ranking bundles the JAX recorder wrote as the JAX analyzer
does, the reader's, loader's and fleet's triggers, and (on one fleet armed
with incidents and history, shared by the fleet tests below) the workers'
``w_incident`` frames adopted by the dispatcher, the dispatcher's run record
and the lineage digest through the service."""

import json
import os
import time

import numpy as np
import pytest

import petastorm_tpu.telemetry.incident as jax_incident
import petastorm_tpu_torch.telemetry.incident as port_incident
import petastorm_tpu_torch.test_util.fault_injection as port_fi
from petastorm_tpu_torch import TorchDataLoader, make_reader
from petastorm_tpu_torch.resilience import default_board
from petastorm_tpu_torch.telemetry.incident import (EXIT_CODES, IncidentPolicy,
                                                    IncidentRecorder, scan_bundles)

ROWS = 48


class FakeClock(object):
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _recorder(module, home, **policy_kwargs):
    policy = module.IncidentPolicy(home=str(home), **policy_kwargs)
    clock = FakeClock()
    return module.IncidentRecorder(policy.home, policy, clock=clock), clock


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    """48 rows ``id``/``vec`` in 4 files, written by the JAX package."""
    from petastorm_tpu.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu.etl.dataset_metadata import write_rows
    from petastorm_tpu.unischema import Unischema, UnischemaField
    schema = Unischema('IncidentProbe', [
        UnischemaField('id', np.int64, (), ScalarCodec(), False),
        UnischemaField('vec', np.float32, (8,), NdarrayCodec(), False)])
    url = 'file://' + str(tmp_path_factory.mktemp('incident') / 'store')
    write_rows(url, schema, [{'id': i, 'vec': np.full(8, i, np.float32)}
                             for i in range(ROWS)], n_files=4)
    return url


def _copy_store(store, dest):
    import shutil
    shutil.copytree(store[len('file://'):], str(dest))
    return 'file://' + str(dest)


# -------------------------------------------------------------------- units

@pytest.mark.parametrize('value', [None, False, True])
def test_policy_resolution_matches_jax(value):
    port = port_incident.resolve_incident_policy(value)
    jax = jax_incident.resolve_incident_policy(value)
    assert (port is None) == (jax is None)
    if port is not None:
        assert (port.max_bundles, port.bucket_capacity, port.refill_interval_s,
                tuple(port.triggers)) == (jax.max_bundles, jax.bucket_capacity,
                                          jax.refill_interval_s, tuple(jax.triggers))
    assert port_incident.TRIGGER_KINDS == jax_incident.TRIGGER_KINDS
    assert port_incident.EXIT_CODES == jax_incident.EXIT_CODES
    with pytest.raises(ValueError):
        IncidentPolicy(triggers=('no_such_kind',))


def test_bundle_layout_matches_jax(tmp_path):
    layouts = []
    for module in (port_incident, jax_incident):
        recorder, _ = _recorder(module, tmp_path / module.__name__)
        recorder.add_source('metrics', lambda: {'counters': {'rows': 7}})
        path = recorder.trigger('quarantine', ctx=(0, 3, 1),
                                args={'reason': 'error', 'error_type': 'ValueError'})
        with open(os.path.join(path, 'manifest.json')) as f:
            manifest = json.load(f)
        layouts.append((os.path.basename(path), sorted(os.listdir(path)), sorted(manifest),
                        manifest['kind'], manifest['cause'], manifest['ctx']))
    assert layouts[0] == layouts[1]
    assert layouts[0][0] == 'incident-00000-quarantine' and layouts[0][4] == 'corruption'


def test_rate_limit_each_kind_its_own_bucket(tmp_path):
    recorder, clock = _recorder(port_incident, tmp_path, bucket_capacity=1,
                                refill_interval_s=60.0)
    assert recorder.trigger('slo_breach') is not None
    assert recorder.trigger('slo_breach') is None
    assert recorder.trigger('breaker_open') is not None
    clock.now += 59.0
    assert recorder.trigger('slo_breach') is None
    clock.now += 1.0
    assert recorder.trigger('slo_breach') is not None
    report = recorder.report()
    assert (report['captured'], report['rate_limited'], report['retained']) == (3, 2, 3)


def test_retention_keeps_the_newest(tmp_path):
    recorder, clock = _recorder(port_incident, tmp_path, max_bundles=2, refill_interval_s=1.0)
    paths = []
    for _ in range(4):
        clock.now += 1.0
        paths.append(recorder.trigger('slo_breach'))
    assert [entry['path'] for entry in scan_bundles(recorder.home)] == paths[:1:-1]
    assert not os.path.isdir(paths[0]) and not os.path.isdir(paths[1])
    # a restarted owner numbers past the retained bundles
    reborn = IncidentRecorder(recorder.home, recorder.policy, clock=FakeClock())
    assert os.path.basename(reborn.trigger('slo_breach')) == 'incident-00004-slo_breach'


def test_reference_adopted_across_packages(tmp_path):
    """A bundle the JAX recorder captured ships as a reference; the port's
    recorder adopts it into its home, and both analyzers agree on it."""
    shipper, _ = _recorder(jax_incident, tmp_path / 'worker')
    path = shipper.trigger('breaker_open', args={'breaker': 'store'})
    reference = jax_incident.bundle_reference(path, ship_bytes_cap=1 << 20)
    assert reference == port_incident.bundle_reference(path, ship_bytes_cap=1 << 20)
    adopter, _ = _recorder(port_incident, tmp_path / 'dispatcher')
    adopted = adopter.adopt(reference)
    assert adopted is not None and adopter.captured == 1
    assert port_incident.analyze_bundle(adopted)['top_cause'] == 'storage-path'
    assert 'inline' not in port_incident.bundle_reference(path, ship_bytes_cap=1)


@pytest.mark.parametrize('kind, ctx', [
    ('breaker_open', None), ('watchdog_reap', (0, 2, 1)), ('shm_crc_drop', None),
    ('slo_breach', (2, 7, 1)), ('lineage_divergence', (0, 1, 0)), ('service_poison_item', None),
    ('quarantine', (0, 3, 2)),
])
def test_analyze_bundle_ranks_a_jax_bundle_as_jax(tmp_path, kind, ctx, capsys):
    recorder, _ = _recorder(jax_incident, tmp_path)
    path = recorder.trigger(kind, ctx=ctx, args={'reason': 'error',
                                                  'error_type': 'TransientIOError'})
    port = port_incident.analyze_bundle(path)
    jax = jax_incident.analyze_bundle(path)
    assert port == jax
    assert port_incident.main([path]) == jax_incident.main([path]) == \
        EXIT_CODES[port['top_cause']]
    capsys.readouterr()


def test_autopsy_bad_bundle(tmp_path, capsys):
    assert port_incident.main([str(tmp_path / 'nope')]) == port_incident.EXIT_BAD_BUNDLE
    capsys.readouterr()


def test_worker_incident_update_roundtrip_between_packages():
    from petastorm_tpu.service.wire import WorkerIncidentUpdate as JaxUpdate
    from petastorm_tpu_torch.service.wire import WorkerIncidentUpdate
    reference = {'bundle': '/x/incident-00000-slo_breach', 'kind': 'slo_breach',
                 'cause': 'scheduling-skew', 'ctx': [1, 2, 3], 'size_bytes': 5,
                 'inline': {'manifest.json': '{}'}}
    update = WorkerIncidentUpdate(worker_id=4, seq=9, reference=reference)
    assert update.to_bytes() == JaxUpdate(worker_id=4, seq=9, reference=reference).to_bytes()
    assert JaxUpdate.from_bytes(update.to_bytes()).reference == reference


def test_dispatcher_adopts_guards_and_correlates(tmp_path, monkeypatch):
    from petastorm_tpu_torch.service.dispatcher import Dispatcher
    from petastorm_tpu_torch.service.wire import WorkerDescriptor
    monkeypatch.setenv('PETASTORM_TPU_INCIDENT_HOME', str(tmp_path / 'dispatcher'))
    shipper, _ = _recorder(port_incident, tmp_path / 'worker')
    ref = port_incident.bundle_reference(shipper.trigger('watchdog_reap'),
                                         ship_bytes_cap=1 << 20)
    dispatcher = Dispatcher(incidents=True)
    try:
        dispatcher.record_worker_incident(3, 1, ref)   # unknown worker: dropped
        assert dispatcher.incidents_state()['fleet'] == []
        for token, worker_id in ((b'w3', 3), (b'w4', 4)):
            dispatcher.scheduler.add_worker(
                token, WorkerDescriptor(worker_id=worker_id, pid=worker_id, host='h'))
        dispatcher.record_worker_incident(3, 1, ref)
        dispatcher.record_worker_incident(3, 1, ref)   # stale seq: dropped
        dispatcher.record_worker_incident(4, 1, ref)
        state = dispatcher.incidents_state()
        (entry,) = state['fleet']
        assert entry['cause'] == 'hang' and entry['count'] == 2
        assert sorted(entry['workers']) == [3, 4] and state['captured'] == 2
        assert dispatcher.state()['incidents']['captured'] == 2
    finally:
        dispatcher.stop()


# ------------------------------------------------------------------- reader

def test_reader_captures_one_bundle_for_one_corrupt_file(tmp_path, store):
    url = _copy_store(store, tmp_path / 'store')
    fs = port_fi.fault_injecting_filesystem(port_fi.FaultSchedule(
        str(tmp_path / 'faults'), [port_fi.FaultRule('part_00002', kind='corrupt', times=1)]))
    home = str(tmp_path / 'incidents')
    with make_reader(url, reader_pool_type='thread', workers_count=2, on_error='skip',
                     filesystem=fs, incidents=IncidentPolicy(home=home)) as reader:
        rows = sum(batch.num_rows for batch in reader.iter_columnar())
        # a second edge of the same kind inside the bucket is rate-limited
        reader._incidents.trigger('quarantine', args={'reason': 'error'})
        report = reader.incident_report()
        assert reader.diagnostics['incidents']['captured'] == 1
    assert rows == ROWS - 12
    assert report['captured'] == 1 and report['rate_limited'] == 1
    (entry,) = scan_bundles(home)
    assert entry['kind'] == 'quarantine'
    for source in ('metrics.json', 'breakers.json', 'quarantine.json', 'config.json'):
        assert os.path.exists(os.path.join(entry['path'], source))
    code = port_incident.main([entry['path']])
    assert code == EXIT_CODES[port_incident.analyze_bundle(entry['path'])['top_cause']]


def test_reader_breaker_edge_is_one_storage_path_bundle(tmp_path, store):
    home = str(tmp_path / 'incidents')
    with make_reader(store, reader_pool_type='dummy',
                     incidents=IncidentPolicy(home=home)) as reader:
        breaker = default_board().breaker('probe_store_port', failure_threshold=1)
        breaker.record_failure()
        breaker.reset()
        breaker.record_failure()   # the second edge: rate-limited
        report = reader.incident_report()
        for _ in reader.iter_columnar():
            pass
    assert report['captured'] == 1 and report['rate_limited'] >= 1
    (entry,) = scan_bundles(home)
    assert entry['kind'] == 'breaker_open'
    assert port_incident.main([entry['path']]) == EXIT_CODES['storage-path']


def test_loader_reuses_the_readers_recorder_or_owns_one(tmp_path, store):
    home = str(tmp_path / 'incidents')
    with make_reader(store, reader_pool_type='dummy',
                     incidents=IncidentPolicy(home=home)) as reader:
        loader = TorchDataLoader(reader, batch_size=8, device='cpu', incidents=True)
        assert loader._incidents is reader._incidents and not loader._owns_incidents
        loader._on_slo_breach({'efficiency': 0.1, 'target_efficiency': 0.9})
        assert sum(1 for _ in loader) == ROWS // 8
    assert [e['kind'] for e in scan_bundles(home)] == ['slo_breach']
    with make_reader(store, reader_pool_type='dummy') as reader:
        loader = TorchDataLoader(reader, batch_size=8, device='cpu',
                                 incidents=IncidentPolicy(home=str(tmp_path / 'own')))
        assert loader._owns_incidents and loader.incident_report()['captured'] == 0
        loader.stop()


# ------------------------------------------------------------------- fleet

@pytest.fixture(scope='module')
def armed_fleet(tmp_path_factory):
    """One fleet of two workers with incidents and history armed, shared by
    the fleet tests of this module."""
    from petastorm_tpu_torch.service import ServiceFleet
    root = tmp_path_factory.mktemp('armed_fleet')
    previous = os.environ.get('PETASTORM_TPU_INCIDENT_HOME')
    os.environ['PETASTORM_TPU_INCIDENT_HOME'] = str(root / 'incidents')
    fleet = ServiceFleet(workers=2, heartbeat_interval_s=0.2, incidents=True,
                         history=str(root / 'service_history.bin'))
    try:
        fleet.start()
        yield fleet
    finally:
        fleet.stop()
        if previous is None:
            os.environ.pop('PETASTORM_TPU_INCIDENT_HOME', None)
        else:
            os.environ['PETASTORM_TPU_INCIDENT_HOME'] = previous


def test_fleet_workers_ship_incidents_the_dispatcher_adopts(tmp_path, store, armed_fleet):
    url = _copy_store(store, tmp_path / 'store')
    fs = port_fi.fault_injecting_filesystem(port_fi.FaultSchedule(
        str(tmp_path / 'faults'), [port_fi.FaultRule('part_00001', kind='corrupt', times=1)]))
    with make_reader(url, service_url=armed_fleet.service_url, on_error='skip',
                     filesystem=fs) as reader:
        rows = sum(batch.num_rows for batch in reader.iter_columnar())
    assert rows == ROWS - 12
    deadline = time.monotonic() + 20
    state = {}
    while time.monotonic() < deadline:
        state = armed_fleet.dispatcher.incidents_state()
        if state.get('captured', 0) >= 1:
            break
        time.sleep(0.1)
    (entry,) = state['fleet']
    assert 'quarantine' in entry['kinds'] and len(entry['workers']) == 1
    adopted = [b for b in scan_bundles(state['home']) if b['kind'] == 'quarantine']
    assert adopted and port_incident.analyze_bundle(adopted[0]['path'])['trigger'] == \
        'quarantine'


def test_fleet_lineage_digest_equals_the_thread_readers(store, armed_fleet):
    digests = []
    for kwargs in ({'service_url': armed_fleet.service_url},
                   {'reader_pool_type': 'thread', 'workers_count': 2}):
        with make_reader(store, seed=4, shuffle_rows=True, lineage=True, **kwargs) as reader:
            for _ in reader.iter_columnar(include_empty=True):
                pass
            digests.append(reader.order_digest())
    assert digests[0] == digests[1] and len(digests[0]) == 32


def test_dispatcher_run_record_and_sentinel(armed_fleet):
    from petastorm_tpu_torch.telemetry.history import load_records
    state = armed_fleet.dispatcher.state()
    assert 'sentinel' in state and state['history']['path'] == armed_fleet.history_path
    record = armed_fleet.dispatcher.build_history_record()
    assert record['owner'] == 'dispatcher' and record['dataset_token'] == 'service'
    armed_fleet.dispatcher._write_history_record()
    records, dropped = load_records(armed_fleet.history_path)
    assert dropped == 0 and [r['owner'] for r in records] == ['dispatcher']
