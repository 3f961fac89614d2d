"""The port's telemetry core against the JAX package's, on the same inputs:
power-of-two buckets, registry snapshots and their merge, the stage
recorder's sidecar, the Prometheus exposition (byte for byte), the JSONL log
read back through ``load_snapshot``, bottleneck attribution, the efficiency
SLO's breach edges, and the global switch. Times are never compared: every
input is a scripted value."""

import json
import os

import numpy as np
import pytest

from petastorm_tpu.telemetry import analyze as jax_analyze
from petastorm_tpu.telemetry import export as jax_export
from petastorm_tpu.telemetry import registry as jax_registry
from petastorm_tpu.telemetry import slo as jax_slo
from petastorm_tpu.telemetry import spans as jax_spans
from petastorm_tpu_torch.telemetry import analyze, export, registry, slo, spans

SEED = 13


def _observations(seed=SEED, n=400):
    """Seeded latencies spanning sub-microsecond to minutes, bucket edges and
    negatives included."""
    rng = np.random.RandomState(seed)
    values = list(10.0 ** rng.uniform(-8, 2.5, size=n))
    values += [0.0, -1.0, 1e-6, 2e-6, 4e-6, 2e-6 + 1e-12, 3600.0 * 24]
    return [float(v) for v in values]


def _fill(registry_module, values, stages=('decode', 'h2d', 'cache_miss')):
    reg = registry_module.MetricsRegistry()
    for i, value in enumerate(values):
        reg.observe(stages[i % len(stages)], value)
    reg.observe('wire_bytes_copied', 4096 * (len(values) % 7 + 1),
                unit=registry_module.BYTES_UNIT)
    reg.inc('breaker_open', 3)
    reg.inc('watchdog_reap')
    reg.gauge('slo_target_efficiency').set(0.9)
    return reg


def test_catalog_names_are_the_jax_packages():
    assert spans.STAGES == jax_spans.STAGES
    assert spans.ENVELOPE_STAGES == jax_spans.ENVELOPE_STAGES
    assert spans.COUNTERS == jax_spans.COUNTERS
    assert spans.SIZE_HISTOGRAMS == jax_spans.SIZE_HISTOGRAMS
    assert spans.TRACE_INSTANTS == jax_spans.TRACE_INSTANTS
    assert spans.GAUGES == jax_spans.GAUGES


@pytest.mark.parametrize('unit', [registry.SECONDS_UNIT, registry.BYTES_UNIT, 0.25])
def test_bucket_index_matches_jax(unit):
    scale = 1.0 if unit == registry.SECONDS_UNIT else 1e7
    for value in _observations():
        value *= scale
        assert (registry.bucket_index(value, unit)
                == jax_registry.bucket_index(value, unit)), value
        for num_buckets in (4, 32):
            assert (registry.bucket_index(value, unit, num_buckets)
                    == jax_registry.bucket_index(value, unit, num_buckets))
    for index in range(33):
        assert (registry.bucket_upper_bound(index, unit)
                == jax_registry.bucket_upper_bound(index, unit))


def test_snapshot_and_merge_match_jax():
    values = _observations()
    port, jax = _fill(registry, values), _fill(jax_registry, values)
    assert port.snapshot() == jax.snapshot()
    other = _observations(seed=SEED + 1, n=50)
    merged = registry.merge_snapshots(port.snapshot(), None,
                                      _fill(registry, other).snapshot())
    jax_merged = jax_registry.merge_snapshots(jax.snapshot(), None,
                                              _fill(jax_registry, other).snapshot())
    assert merged == jax_merged
    # additive: the merged counts are the sums
    assert merged['histograms']['decode']['count'] == (
        port.snapshot()['histograms']['decode']['count']
        + _fill(registry, other).snapshot()['histograms']['decode']['count'])
    assert merged['counters']['breaker_open'] == 6


def test_stage_recorder_sidecar_matches_jax_and_merges():
    values = _observations(n=60)
    port, jax = spans.StageRecorder(), jax_spans.StageRecorder()
    for i, value in enumerate(values):
        stage = ('rowgroup_read', 'decode', 'serialize')[i % 3]
        port.record(stage, abs(value))
        jax.record(stage, abs(value))
    sidecar, jax_sidecar = port.drain(), jax.drain()
    assert sidecar == jax_sidecar
    assert port.drain() is None
    # the sidecar survives the JSON ride of the serializer's metadata
    sidecar = json.loads(json.dumps(sidecar))
    reg, jax_reg = registry.MetricsRegistry(), jax_registry.MetricsRegistry()
    reg.merge_stage_times(sidecar)
    jax_reg.merge_stage_times(sidecar)
    assert reg.snapshot() == jax_reg.snapshot()
    assert reg.snapshot()['histograms']['decode']['count'] == len(values[1::3])


def test_prometheus_text_is_byte_for_byte_the_jax_packages():
    reg = _fill(registry, _observations())
    reg.observe('odd.stage-name 1', 0.5)   # sanitized, with a raw_name label
    reg.inc('9lives')
    snapshot = reg.snapshot()
    text = export.to_prometheus_text(snapshot)
    assert text == jax_export.to_prometheus_text(snapshot)
    assert 'raw_name="odd.stage-name 1"' in text
    for line in text.splitlines():
        if not line.startswith('#'):
            assert export.METRIC_NAME_RE.match(line.split('{')[0].split(' ')[0]), line


def test_jsonl_log_round_trips_through_both_load_snapshots(tmp_path):
    path = str(tmp_path / 'events.jsonl')
    logger = export.JsonlEventLogger(path, interval_s=3600.0, max_bytes=4000,
                                     max_rotations=2)
    first = _fill(registry, _observations(n=30)).snapshot()
    last = _fill(registry, _observations(n=90)).snapshot()
    assert logger.maybe_emit(first)
    assert not logger.due() and not logger.maybe_emit(first)   # inside the interval
    for _ in range(3):
        assert logger.emit(first, event='loader_interval')
    assert logger.emit(last)
    # the size cap rotated the older lines into .1 / .2 generations
    assert os.path.exists(path + '.1')
    assert os.path.getsize(path) <= 4000 or len(open(path).readlines()) == 1
    assert export.load_snapshot(path) == jax_export.load_snapshot(path) == last
    record = json.loads(open(path).read().splitlines()[-1])
    assert {'ts', 'ts_unix', 'ts_mono', 'event', 'pid', 'telemetry'} <= set(record)
    bare = tmp_path / 'snap.json'
    bare.write_text(json.dumps({'telemetry': {'snapshot': first}}))
    assert export.load_snapshot(str(bare)) == jax_export.load_snapshot(str(bare)) == first
    empty = tmp_path / 'empty.json'
    empty.write_text('')
    with pytest.raises(ValueError):
        export.load_snapshot(str(empty))


def test_logger_from_env_reads_the_jax_packages_variables(tmp_path, monkeypatch):
    monkeypatch.delenv('PETASTORM_TPU_TELEMETRY_JSONL', raising=False)
    assert export.logger_from_env() is None
    monkeypatch.setenv('PETASTORM_TPU_TELEMETRY_JSONL', str(tmp_path / 'x.jsonl'))
    monkeypatch.setenv('PETASTORM_TPU_TELEMETRY_JSONL_MAX_BYTES', '1234')
    monkeypatch.setenv('PETASTORM_TPU_TELEMETRY_JSONL_ROTATIONS', '3')
    assert export.env_rotation_settings() == jax_export.env_rotation_settings() == (1234, 3)
    assert export.logger_from_env().path == str(tmp_path / 'x.jsonl')


def _without_port_differences(report):
    """The attribution report minus its defined difference: the port's
    ``detail`` texts name its own objects."""
    return {k: v for k, v in report.items() if k != 'detail'}


@pytest.mark.parametrize('case', ['pipeline', 'empty', 'service_pressure', 'bytes_only'])
def test_attribute_bottleneck_matches_jax(case):
    if case == 'pipeline':
        snapshot = _fill(registry, _observations()).snapshot()
    elif case == 'empty':
        snapshot = {}
    elif case == 'service_pressure':
        snapshot = {'histograms': {'pool_wait': {'unit': 1e-6, 'count': 3, 'sum': 2.0}},
                    'counters': {'service_busy': 4}, 'gauges': {'service_queue_depth': 2.0}}
    else:
        snapshot = {'histograms': {'wire_bytes_copied': {'unit': 1.0, 'count': 3,
                                                         'sum': 9e6}}}
    for top_n in (1, 5):
        report = analyze.attribute_bottleneck(snapshot, top_n=top_n)
        jax_report = jax_analyze.attribute_bottleneck(snapshot, top_n=top_n)
        assert _without_port_differences(report) == _without_port_differences(jax_report)
        assert report['what_if'] == [] and report['detail']
        assert analyze.format_report(report).splitlines()[0] == \
            jax_analyze.format_report(jax_report).splitlines()[0]


def test_analyze_cli_prints_the_report(tmp_path, capsys):
    snapshot = _fill(registry, _observations()).snapshot()
    path = tmp_path / 'snap.json'
    path.write_text(json.dumps(snapshot))
    assert analyze.main([str(path), '--json', '--top', '3']) == 0
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(analyze.attribute_bottleneck(snapshot, top_n=3)))
    assert analyze.main([str(path)]) == 0
    assert 'bottleneck: ' in capsys.readouterr().out


def _wait_snapshot(shuffle_wait_s, d2d_wait_s=0.0, pool_wait_s=0.0):
    hist = {}
    for stage, seconds in (('shuffle_wait', shuffle_wait_s), ('d2d_wait', d2d_wait_s),
                           ('pool_wait', pool_wait_s), ('h2d', 0.125)):
        if seconds:
            hist[stage] = {'unit': 1e-6, 'count': 4, 'sum': seconds, 'max': seconds,
                           'buckets': {'10': 4}}
    return {'histograms': hist, 'counters': {}, 'gauges': {}}


#: (elapsed_s, shuffle_wait_s, d2d_wait_s, pool_wait_s, rows): a warm-up
#: window, a healthy one, a breach, a deeper breach (no new edge), recovery,
#: and a second breach (a second edge)
_SCRIPT = [(0.5, 0.4, 0.0, 0.0, 10), (2.0, 0.05, 0.0, 0.3, 100), (4.0, 0.9, 0.2, 0.0, 150),
           (6.0, 2.5, 0.3, 0.0, 160), (20.0, 1.0, 0.1, 0.0, 2000),
           (30.0, 6.0, 0.5, 0.0, 2100)]


@pytest.mark.parametrize('target', [0.9, 0.5])
def test_slo_tracker_gives_the_jax_packages_breach_edges(target):
    tracker = slo.SloTracker(slo.resolve_slo_policy(target))
    jax_tracker = jax_slo.SloTracker(jax_slo.resolve_slo_policy(target))
    reg, jax_reg = registry.MetricsRegistry(), jax_registry.MetricsRegistry()
    edges = []
    for elapsed, shuffle_wait, d2d_wait, pool_wait, rows in _SCRIPT:
        snapshot = _wait_snapshot(shuffle_wait, d2d_wait, pool_wait)
        report = tracker.evaluate(snapshot, elapsed, rows=rows, registry=reg)
        jax_report = jax_tracker.evaluate(snapshot, elapsed, rows=rows, registry=jax_reg)
        assert report == jax_report
        edges.append(report['breaches'])
    assert reg.snapshot() == jax_reg.snapshot()
    assert tracker.history() == jax_tracker.history()
    if target == 0.9:
        assert edges == [0, 0, 1, 1, 1, 2]
        assert reg.snapshot()['counters']['slo_breach'] == 2
    assert slo.efficiency_from_snapshot(_wait_snapshot(1.0), 4.0, rows=30) == \
        jax_slo.efficiency_from_snapshot(_wait_snapshot(1.0), 4.0, rows=30)
    with pytest.raises(ValueError):
        slo.resolve_slo_policy(1.5)
    with pytest.raises(ValueError):
        slo.resolve_slo_policy('high')


def test_disabled_telemetry_leaves_the_registry_empty():
    assert registry.telemetry_enabled()
    # what an earlier test in this process recorded on this thread (the
    # storage engine's spans, used without a reader) is not this test's
    spans.drain_stage_times()
    registry.set_telemetry_enabled(False)
    try:
        reg = registry.MetricsRegistry()
        reg.observe('decode', 0.5)
        reg.inc('breaker_open')
        with spans.stage_span('decode'):
            pass
        spans.record_stage('rowgroup_read', 0.25)
        reg.merge_stage_times({'decode': {'unit': 1e-6, 'count': 1, 'sum': 1.0}})
        assert reg.snapshot() == {'histograms': {}, 'counters': {}, 'gauges': {}}
        assert spans.drain_stage_times() is None
        # the switch is the port's own: the JAX package's stays on
        assert jax_registry.telemetry_enabled()
    finally:
        registry.set_telemetry_enabled(True)
    with spans.stage_span('decode'):
        pass
    drained = spans.drain_stage_times()
    assert drained['decode']['count'] == 1
