"""The port's run history and regression sentinel
(``petastorm_tpu_torch.telemetry.history``/``sentinel``) against the JAX
package's: the port reads a store the JAX ``RunHistorian`` wrote (and the
JAX package reads the port's), ``compare`` gives the JAX verdict and exit
code on the same records, a torn tail counts in ``history_frames_dropped``,
the sentinel rings once on a synthetic step drop and never on a stationary
series (synthetic time, as the JAX tests drive it), and the reader, loader,
dispatcher and autotuner wiring."""

import json
import os
import random

import numpy as np
import pytest

import petastorm_tpu.telemetry.history as jax_history
import petastorm_tpu.telemetry.sentinel as jax_sentinel
import petastorm_tpu_torch.telemetry.history as port_history
import petastorm_tpu_torch.telemetry.sentinel as port_sentinel
from petastorm_tpu_torch import TorchDataLoader, make_reader
from petastorm_tpu_torch.telemetry.history import (COMPARE_EXIT_CODES, RunHistorian,
                                                   load_records)
from petastorm_tpu_torch.telemetry.registry import SECONDS_UNIT, MetricsRegistry

ROWS = 40


def _record(module=port_history, rate=100.0, token='tok', platform='test-plat',
            shares=None, knobs=None, fingerprints=None, stamp=1000.0):
    snapshot = {'histograms': {stage: {'unit': SECONDS_UNIT, 'count': 1, 'sum': share * 10.0,
                                       'max': 1.0, 'mean': 1.0, 'buckets': {}}
                               for stage, share in (shares or {}).items()}}
    return module.build_run_record(
        'reader', token, elapsed_s=10.0, rows=int(rate * 10), snapshot=snapshot,
        slo_report={'efficiency': 0.9, 'wait_seconds': 1.0, 'primary_wait_stage': 'pool_wait'},
        fingerprints=fingerprints or {'config': 'abc'}, knobs=knobs or {'decode_threads': 4.0},
        platform=platform, recorded_unix_s=stamp)


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    from petastorm_tpu.codecs import ScalarCodec
    from petastorm_tpu.etl.dataset_metadata import write_rows
    from petastorm_tpu.unischema import Unischema, UnischemaField
    schema = Unischema('HistoryProbe', [UnischemaField('id', np.int64, (), ScalarCodec(),
                                                       False)])
    url = 'file://' + str(tmp_path_factory.mktemp('history') / 'store')
    write_rows(url, schema, [{'id': i} for i in range(ROWS)], n_files=4)
    return url


# ------------------------------------------------------------------- store

@pytest.mark.parametrize('writer, reader', [(jax_history, port_history),
                                            (port_history, jax_history)])
def test_a_store_written_by_one_package_reads_in_the_other(tmp_path, writer, reader):
    path = str(tmp_path / 'hist.bin')
    historian = writer.RunHistorian(path)
    for i in range(3):
        assert historian.append(_record(writer, rate=100.0 + i, stamp=float(i)))
    records, dropped = reader.load_records(path)
    assert dropped == 0 and [r['recorded_unix_s'] for r in records] == [0.0, 1.0, 2.0]
    assert records == writer.load_records(path)[0]
    assert port_history.HISTORY_BASENAME == jax_history.HISTORY_BASENAME


def test_records_are_built_alike():
    kwargs = dict(rate=50.0, shares={'decode': 0.3, 'cache_miss': 0.9}, knobs={'x': 2.0})
    assert _record(port_history, **kwargs) == _record(jax_history, **kwargs)
    assert port_history.fingerprint({'b': 1, 'a': [2]}) == \
        jax_history.fingerprint({'a': [2], 'b': 1})


def test_torn_tail_counted_and_healed(tmp_path):
    path = str(tmp_path / 'hist.bin')
    registry = MetricsRegistry()
    historian = RunHistorian(path, registry=registry)
    for i in range(3):
        historian.append(_record(stamp=float(i)))
    with open(path, 'ab') as f:
        f.write(b'\x00\x00\x01\x00GARB')
    assert port_history.load_records(path)[1] == 1 == jax_history.load_records(path)[1]
    assert len(historian.records()) == 3
    assert registry.snapshot()['counters'].get('history_frames_dropped') == 1
    assert historian.state()['frames_dropped'] == 1
    historian.append(_record(stamp=9.0))
    records, dropped = load_records(path)
    assert dropped == 0 and [r['recorded_unix_s'] for r in records] == [0.0, 1.0, 2.0, 9.0]


# ----------------------------------------------------------------- compare

def _scenario(module, name):
    records = [_record(module, rate=100.0 + (i % 3), stamp=float(i),
                       shares={'decode': 0.2}) for i in range(6)]
    candidate = {
        'within': lambda: _record(module, rate=101.0, stamp=99.0),
        'regressed': lambda: _record(module, rate=50.0, stamp=99.0, shares={'decode': 0.5},
                                     knobs={'decode_threads': 2.0},
                                     fingerprints={'config': 'xyz'}),
        'improved': lambda: _record(module, rate=200.0, stamp=99.0),
        'thin': lambda: _record(module, stamp=99.0),
    }[name]()
    if name == 'thin':
        records = records[:1]
    return records, candidate


@pytest.mark.parametrize('name, verdict', [('within', 'within-noise'),
                                           ('regressed', 'regressed'),
                                           ('improved', 'improved'),
                                           ('thin', 'insufficient-history')])
def test_compare_gives_the_jax_verdict(name, verdict):
    port = port_history.compare_against_history(*_scenario(port_history, name))
    jax = jax_history.compare_against_history(*_scenario(jax_history, name))
    assert port == jax and port['verdict'] == verdict
    assert port['exit_code'] == COMPARE_EXIT_CODES[verdict]
    assert COMPARE_EXIT_CODES == jax_history.COMPARE_EXIT_CODES


@pytest.mark.parametrize('candidate_rate', [101.0, 50.0, 200.0])
def test_history_cli_matches_jax(tmp_path, capsys, candidate_rate):
    path = str(tmp_path / 'hist.bin')
    historian = jax_history.RunHistorian(path)
    for i in range(6):
        historian.append(_record(jax_history, rate=100.0 + (i % 3), stamp=float(i)))
    historian.append(_record(jax_history, rate=candidate_rate, stamp=99.0))
    assert port_history.main(['list', path]) == 0
    assert '7 record(s)' in capsys.readouterr().out
    assert port_history.main(['show', path, '--index', '0']) == 0
    assert json.loads(capsys.readouterr().out)['recorded_unix_s'] == 0.0
    port = port_history.main(['compare', path, '--json'])
    port_report = json.loads(capsys.readouterr().out)
    jax = jax_history.main(['compare', path, '--json'])
    assert port == jax and port_report == json.loads(capsys.readouterr().out)
    from petastorm_tpu_torch.benchmark.cli import main as cli_main
    assert cli_main(['history', 'compare', path]) == port
    assert port_history.main(['list', str(tmp_path / 'none.bin')]) == \
        port_history.EXIT_BAD_STORE
    capsys.readouterr()


# ----------------------------------------------------------------- sentinel

def _alarms(module, series):
    sentinel = module.RegressionSentinel(module.SentinelPolicy(min_window_s=1.0),
                                         owner='reader')
    alarms = []
    sentinel._on_alarm = alarms.append
    rows = 0
    for window, rate in enumerate(series):
        rows += rate
        sentinel.observe_sample(float(window + 1), int(rows))
    return alarms, sentinel


def test_sentinel_rings_once_on_a_step_drop():
    series = [1000] * 30 + [400] * 30
    port, sentinel = _alarms(port_sentinel, series)
    jax, _ = _alarms(jax_sentinel, series)
    assert len(port) == len(jax) == 1 and sentinel.alarms == 1
    assert port[0]['series'] == 'rate'
    assert port[0]['pre_rate_rows_per_sec'] > port[0]['post_rate_rows_per_sec']
    assert {k: v for k, v in port[0].items() if 'unix' not in k} == \
        {k: v for k, v in jax[0].items() if 'unix' not in k}


def test_sentinel_never_rings_on_a_stationary_series():
    rng = random.Random(1234)
    series = [rng.uniform(900, 1100) for _ in range(1000)]
    port, sentinel = _alarms(port_sentinel, series)
    assert port == [] and sentinel.alarms == 0
    assert _alarms(jax_sentinel, series)[0] == []


def test_sentinel_files_one_perf_regression_bundle(tmp_path):
    from petastorm_tpu_torch.telemetry.incident import (IncidentPolicy, IncidentRecorder,
                                                        analyze_bundle, scan_bundles)
    home = str(tmp_path / 'incidents')
    incidents = IncidentRecorder(home, IncidentPolicy(home=home))
    registry = MetricsRegistry()
    sentinel = port_sentinel.RegressionSentinel(port_sentinel.SentinelPolicy(min_window_s=1.0),
                                                owner='reader', registry=registry,
                                                incidents=incidents, dataset_token='tok')
    rows = 0
    for window, rate in enumerate([1000] * 30 + [300] * 30):
        rows += rate
        sentinel.observe_sample(float(window + 1), rows)
    (entry,) = scan_bundles(home)
    assert entry['kind'] == 'perf_regression'
    assert analyze_bundle(entry['path'])['trigger'] == 'perf_regression'
    assert registry.snapshot()['counters']['perf_regression'] == 1
    assert port_sentinel.resolve_sentinel_policy(True) is not None
    assert port_sentinel.resolve_sentinel_policy(False) is None


# ------------------------------------------------------------------ wiring

def _drain(reader):
    return sum(batch.num_rows for batch in reader.iter_columnar())


def test_reader_appends_comparable_records(tmp_path, store):
    path = str(tmp_path / 'hist.bin')
    tokens = []
    for _ in range(2):
        with make_reader(store, workers_count=1, history=path) as reader:
            assert reader._sentinel is not None
            assert _drain(reader) == ROWS
            diag = reader.diagnostics
            assert diag['history']['path'] == path and diag['sentinel']['owner'] == 'reader'
            tokens.append(reader.dataset_token)
        reader.stop()   # idempotent: still one record a run
    records, dropped = load_records(path)
    assert dropped == 0 and [r['owner'] for r in records] == ['reader', 'reader']
    assert records[0]['dataset_token'] == tokens[0]
    assert records[0]['fingerprints']['config'] == records[1]['fingerprints']['config']
    assert 'decode_threads' in records[0]['knobs'] and records[0]['rows'] == ROWS
    assert jax_history.compare_against_history(records, records[-1])['verdict'] == \
        port_history.compare_against_history(records, records[-1])['verdict']
    with make_reader(store, workers_count=1) as reader:
        assert reader.history_report() is None and _drain(reader) == ROWS


def test_default_store_beside_the_dataset_matches_jax(store):
    assert port_history.default_history_path(store) == jax_history.default_history_path(store)


def test_loader_and_reader_both_record(tmp_path, store):
    path = str(tmp_path / 'hist.bin')
    reader = make_reader(store, workers_count=1, history=path)
    loader = TorchDataLoader(reader, batch_size=8, device='cpu', history=True)
    with loader:
        assert sum(1 for _ in loader) == ROWS // 8
    records, _ = load_records(path)
    assert sorted(r['owner'] for r in records) == ['loader', 'reader']
    assert 'loader' in next(r for r in records if r['owner'] == 'loader')['fingerprints']
    with make_reader(store, workers_count=1) as reader:
        with pytest.warns(UserWarning, match='no store path'):
            loader = TorchDataLoader(reader, batch_size=8, device='cpu', history=True)
        assert loader._history is None and loader._sentinel is not None


def test_autotune_warm_start_seeds_from_the_last_good_record(tmp_path, store):
    from petastorm_tpu_torch.autotune import AutotunePolicy
    path = str(tmp_path / 'hist.bin')
    with make_reader(store, workers_count=1, history=path) as reader:
        _drain(reader)
    records, _ = load_records(path)
    forged = dict(records[-1], knobs=dict(records[-1]['knobs'], ventilator_max_in_flight=5.0))
    RunHistorian(path).append(forged)
    policy = AutotunePolicy(warm_start=True, warmup_windows=1000)
    with make_reader(store, workers_count=1, history=path, autotune=policy) as reader:
        seeded = [d for d in reader.autotune_report()['decisions']
                  if d['action'] == 'warm_start']
        assert any(d['knob'] == 'ventilator_max_in_flight' and d['to'] == 5.0 for d in seeded)
        _drain(reader)
    with make_reader(store, workers_count=1, history=str(tmp_path / 'empty.bin'),
                     autotune=policy) as reader:
        assert not [d for d in reader.autotune_report()['decisions']
                    if d['action'] == 'warm_start']
        _drain(reader)


def test_dispatcher_history_forms(tmp_path):
    from petastorm_tpu_torch.service.dispatcher import Dispatcher
    from petastorm_tpu_torch.service.fleet import ServiceFleet
    dispatcher = Dispatcher(history=True)
    assert dispatcher._history is None and dispatcher._sentinel is not None
    assert dispatcher.history_report() is None
    fleet = ServiceFleet(workers=0, cache_dir=str(tmp_path), history=True)
    assert fleet.history_path == str(tmp_path / port_history.HISTORY_BASENAME)
    assert fleet.dispatcher._history is not None
    assert os.path.basename(fleet.history_path) == jax_history.HISTORY_BASENAME
