"""The port's doctor (``petastorm_tpu_torch.tools.doctor``) held against the
JAX package's: on the CPU the store round trip is ok and the install healthy,
every block the port has carries the JAX block's keys (the backend's, plus
the device name), ``backend`` reports no CUDA device, ``--json`` prints one
line, a backend probe that hangs is reported as a timeout, and the input
service's ``service`` and ``ledger`` blocks read an unconfigured, a live and
an unreachable service as the JAX doctor does."""

import json
import time

import pytest

from petastorm_tpu.tools import doctor as jax_doctor
from petastorm_tpu_torch.tools import doctor

#: the JAX round trip's blocks that collect_report lifts to the top level
LIFTED = ('telemetry', 'trace', 'resilience', 'autotune', 'slo', 'lineage', 'history')
#: the JAX doctor's blocks whose planes the port lacks
NOT_PORTED = ('topology', 'pipecheck')


@pytest.fixture(scope='module')
def jax_roundtrip():
    from petastorm_tpu.telemetry.analyze import attribute_bottleneck
    roundtrip = jax_doctor.check_store_roundtrip()
    blocks = {name: roundtrip.pop(name) for name in LIFTED}
    blocks['telemetry'] = {'snapshot': blocks['telemetry'],
                           'bottleneck': attribute_bottleneck(blocks['telemetry'])}
    blocks['store_roundtrip'] = roundtrip
    return blocks


def test_json_report_healthy_with_the_jax_blocks(capsys, jax_roundtrip):
    assert doctor.main(['--json', '--no-link']) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    report = json.loads(lines[0])
    assert report['healthy'] is True
    assert report['store_roundtrip']['status'] == 'ok'
    assert report['store_roundtrip']['rows'] == 200
    backend = report['backend']
    assert backend['status'] == 'down' and backend['devices'] == 0
    assert backend['platform'] is None and 'CUDA' in backend['detail']
    assert 'link' not in report
    for name in ('store_roundtrip', 'trace', 'resilience', 'autotune', 'slo', 'telemetry',
                 'lineage', 'history'):
        assert set(report[name]) == set(jax_roundtrip[name]), name
    assert report['lineage']['enabled'] and report['lineage']['divergence'] == 0
    assert report['history']['status'] == 'ok' and report['history']['records'] == 1
    assert set(report['storage']) == set(jax_doctor.check_storage())
    assert report['storage']['status'] == 'ok'
    assert report['storage']['footer_cache_hits'] > 0
    assert set(report['incidents']) == set(jax_doctor.check_incidents())
    assert set(report['telemetry']['bottleneck']) == \
        set(jax_roundtrip['telemetry']['bottleneck'])
    assert report['autotune']['enabled'] and 'efficiency' in report['slo']
    assert report['trace']['events'] > 0
    assert not set(report) & set(NOT_PORTED)
    assert report['service'] == jax_doctor.check_service() == {'status': 'unconfigured'}
    assert report['ledger'] == jax_doctor.check_ledger(report['service']) == {'status': 'unarmed'}
    versions = report['versions']
    assert set(versions) == {'python', 'numpy', 'pyarrow', 'torch', 'cuda',
                             'petastorm_tpu_torch'}
    assert versions['torch'] and versions['cuda'] is None
    doctor._print_human(report)
    human = capsys.readouterr().out
    assert 'store roundtrip: OK' in human and 'verdict: healthy' in human
    assert 'backend: DOWN' in human


def test_backend_keys_cover_the_jax_probe(monkeypatch):
    monkeypatch.setattr(jax_doctor, 'PROBE_CODE', "print('banner')\nprint('cpu 1')\n")
    jax_up = jax_doctor.check_backend(timeout_s=30)
    assert jax_up['status'] == 'up'
    monkeypatch.setattr(doctor, 'PROBE_CODE',
                        "print('banner')\nprint('cuda 1 NVIDIA H100 80GB HBM3')\n")
    up = doctor.check_backend(timeout_s=30)
    assert up == {'status': 'up', 'platform': 'cuda', 'devices': 1,
                  'device_name': 'NVIDIA H100 80GB HBM3'}
    assert set(jax_up) <= set(up)
    monkeypatch.setattr(doctor, 'PROBE_CODE', "print('garbage')\n")
    assert doctor.check_backend(timeout_s=30)['status'] == 'down'


def test_backend_probe_timeout_is_reported_not_hung(monkeypatch):
    monkeypatch.setattr(doctor, 'PROBE_CODE', 'import time\ntime.sleep(60)\n')
    start = time.monotonic()
    result = doctor.check_backend(timeout_s=1)
    assert time.monotonic() - start < 30
    assert result['status'] == 'timeout' and result['devices'] == 0
    assert '1s' in result['detail']


def test_link_probe_child_parses_and_fails_soft(monkeypatch):
    monkeypatch.setattr(doctor, 'LINK_PROBE_CODE',
                        "print('LINKPROBE_JSON ' + '{{\"dispatch_rtt_ms\": 0.02, "
                        "\"row\": {row_bytes}, \"batch\": {batch}}}')\n")
    assert doctor.check_link(timeout_s=30) == {'dispatch_rtt_ms': 0.02, 'row': 1024,
                                               'batch': 1024}
    monkeypatch.setattr(doctor, 'LINK_PROBE_CODE', "raise SystemExit('no card')\n")
    failed = doctor.check_link(timeout_s=30)
    assert failed['status'] == 'fail' and 'no card' in failed['detail']


def test_service_and_ledger_blocks_of_a_live_fleet_and_an_unreachable_one(
        tmp_path, capsys, monkeypatch):
    """The doctor's service and ledger blocks against the JAX doctor's: a live
    fleet (named by ``--service-url`` or ``PETASTORM_TPU_SERVICE_URL``), an
    unreachable URL (a WARNING) and a ledger-armed dispatcher; the
    unconfigured case is in the first test."""
    from petastorm_tpu_torch.service import ServiceFleet
    with ServiceFleet(workers=1) as fleet:
        live = doctor.check_service(fleet.service_url)
        assert live['status'] == 'ok' and live['workers'] == 1
        assert set(live) == set(jax_doctor.check_service(fleet.service_url))
        monkeypatch.setenv('PETASTORM_TPU_SERVICE_URL', fleet.service_url)
        assert doctor.check_service()['workers'] == 1
    monkeypatch.delenv('PETASTORM_TPU_SERVICE_URL')
    asked = {}
    monkeypatch.setattr(doctor, 'collect_report',
                        lambda **kwargs: asked.update(kwargs) or {'healthy': True})
    assert doctor.main(['--json', '--no-link', '--service-url', 'tcp://h:9']) == 0
    assert asked['service_url'] == 'tcp://h:9'
    capsys.readouterr()
    down = doctor.check_service('tcp://127.0.0.1:1', timeout_s=0.5)
    assert down['status'] == 'unreachable' and set(down) == set(
        jax_doctor.check_service('tcp://127.0.0.1:1', timeout_s=0.5))
    doctor._print_human({'versions': {k: None for k in (
        'petastorm_tpu_torch', 'python', 'torch', 'cuda', 'pyarrow', 'numpy')},
        'backend': {'status': 'down'}, 'store_roundtrip': {'status': 'ok', 'rows': 1,
                                                           'rows_per_sec': 1},
        'service': down, 'ledger': {'status': 'unarmed'}, 'healthy': True})
    assert 'UNREACHABLE' in capsys.readouterr().out
    with ServiceFleet(workers=0, ledger=str(tmp_path / 'ledger.bin')) as armed:
        service = doctor.check_service(armed.service_url)
        ledger = doctor.check_ledger(service)
    assert ledger == jax_doctor.check_ledger(service)
    assert ledger['status'] == 'ok' and ledger['epoch'] == 1
    assert ledger['last_replay'] == 'absent' and ledger['frames_dropped'] == 0
