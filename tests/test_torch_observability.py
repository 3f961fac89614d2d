"""The port's observability surface on live pipelines: the process pool's
cross-process sidecar merge (stage counts and trace events equal to the JAX
process pool's, flow arrows in ``dump_trace``, and a respawned worker's fresh
recorder merging additively), the scrape endpoint of ``metrics_port=0`` over
localhost, the loader's ``torch.profiler`` ranges, and the efficiency
reports. Process pools are spawned in two tests only; times are never
compared."""

import glob
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import petastorm_tpu as jax_pkg
from petastorm_tpu.telemetry import tracing as jax_tracing
from petastorm_tpu_torch import make_reader
from petastorm_tpu_torch.parallel.loader import TorchDataLoader
from petastorm_tpu_torch.telemetry import spans, tracing
from petastorm_tpu_torch.telemetry.analyze import attribute_bottleneck
from petastorm_tpu_torch.telemetry.slo import SloPolicy

ROWS = 64
FILES = 8


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    """64 rows in 8 files of one rowgroup: ``id`` and a float32 (8,) ``vec``."""
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('Observed', [
        UnischemaField('id', np.int64, (), ScalarCodec(), False),
        UnischemaField('vec', np.float32, (8,), NdarrayCodec(), False)])
    rng = np.random.RandomState(7)
    url = 'file://' + str(tmp_path_factory.mktemp('observe') / 'store')
    write_rows(url, schema, [{'id': i, 'vec': rng.randn(8).astype(np.float32)}
                             for i in range(ROWS)], n_files=FILES, rowgroup_size_mb=1)
    return url


@pytest.fixture
def armed():
    for module in (tracing, jax_tracing):
        module.reset_tracing()
        module.set_trace_enabled(True)
    try:
        yield
    finally:
        for module in (tracing, jax_tracing):
            module.set_trace_enabled(False)
            module.reset_tracing()
        spans.drain_stage_times()


def _counts(snapshot):
    return {name: hist['count'] for name, hist in snapshot['histograms'].items()}


def _events(snapshot):
    return sorted({(e['name'], tuple(e['ctx']) if e['ctx'] else None)
                   for e in snapshot['events']})


def test_process_pool_sidecars_match_the_jax_process_pool(store, armed):
    """One worker each, so both pools publish in the same order: the merged
    snapshots have the same stages and counts, the traces the same events,
    and the port's Chrome trace joins worker and consumer tracks by flow
    arrows."""
    kwargs = dict(reader_pool_type='process', workers_count=1, seed=4, shuffle_rows=True,
                  num_epochs=1, trace=True)
    with jax_pkg.make_reader(store, **kwargs) as reader:
        jax_rows = [int(row.id) for row in reader]
        jax_snapshot = reader.telemetry_snapshot()
        jax_trace = jax_tracing.trace_snapshot()
    with make_reader(store, **kwargs) as reader:
        rows = [int(row.id) for row in reader]
        snapshot = reader.telemetry_snapshot()
        trace = tracing.trace_snapshot()
        chrome = reader.dump_trace()
        diag = reader.diagnostics
    assert rows == jax_rows and sorted(rows) == list(range(ROWS))
    assert diag['shm_batches'] == FILES
    assert _counts(snapshot) == _counts(jax_snapshot)
    for stage in ('rowgroup_read', 'decode', 'shuffle', 'shm_map', 'shm_release',
                  'pool_wait', 'wire_bytes_copied'):
        assert snapshot['histograms'][stage]['count'] == FILES, stage
    # serialize rides the NEXT batch's sidecar: the last one stays behind
    assert snapshot['histograms']['serialize']['count'] == FILES - 1
    assert _events(trace) == _events(jax_trace)
    worker_pids = {e['pid'] for e in trace['events']} - {trace['pid']}
    assert len(worker_pids) == 1
    flows = [e for e in chrome['traceEvents'] if e['ph'] in ('s', 'f')]
    assert len(flows) == 2 * FILES
    assert {e['pid'] for e in flows if e['ph'] == 's'} == worker_pids
    assert attribute_bottleneck(snapshot)['top_stage'] is not None


def test_a_respawned_workers_recorder_merges_additively(store, tmp_path):
    from petastorm_tpu.test_util.fault_injection import (FaultRule, FaultSchedule,
                                                         fault_injecting_filesystem)
    target = os.path.basename(sorted(glob.glob(
        os.path.join(store[len('file://'):], '**', '*.parquet'), recursive=True))[3])
    schedule = FaultSchedule(str(tmp_path / 'faults'), [FaultRule(target, kind='kill',
                                                                  times=1)])
    with make_reader(store, reader_pool_type='process', workers_count=2,
                     shuffle_row_groups=False,
                     filesystem=fault_injecting_filesystem(schedule)) as reader:
        ids = sorted(int(row.id) for row in reader)
        snapshot = reader.telemetry_snapshot()
        diag = reader.diagnostics
    assert ids == list(range(ROWS))
    assert diag['workers_respawned'] == 1
    hists = snapshot['histograms']
    # every delivered batch carried its worker's spans; the killed worker's
    # unpublished item is the only loss, and its redo is read again
    assert hists['rowgroup_read']['count'] >= FILES - 1
    assert hists['decode']['count'] >= FILES - 1
    assert hists['shm_map']['count'] + diag['shm_fallback_batches'] == FILES
    # one fs_open a worker, the replacement's too (the killed worker's is
    # lost with it when it dies on its first item)
    assert 2 <= hists['fs_open']['count'] <= 3
    assert sum(hists['decode']['buckets'].values()) == hists['decode']['count']


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as response:
        return response.status, response.headers.get('Content-Type'), response.read()


def _parse_prometheus(text):
    """``{series: value}`` of a Prometheus text exposition; raises on a line
    that is neither a comment nor ``name{labels} value``."""
    series = {}
    for line in text.splitlines():
        if not line or line.startswith('#'):
            continue
        name, value = line.rsplit(' ', 1)
        series[name] = float(value)
    return series


def test_the_scrape_endpoint_serves_the_reader_and_the_loader(store):
    with make_reader(store, reader_pool_type='thread', workers_count=2, num_epochs=1,
                     metrics_port=0, slo_policy=0.5) as reader:
        loader = TorchDataLoader(reader, batch_size=16, device='cpu', metrics_port=0,
                                 slo_policy=SloPolicy(target_efficiency=0.8,
                                                      min_elapsed_s=0.0))
        assert loader.metrics_url != reader.metrics_url
        assert reader.metrics_url.startswith('http://127.0.0.1:')
        rows = 0
        for batch in loader:
            rows += len(batch['id'])
            status, content_type, body = _get(reader.metrics_url + '/metrics')
            assert status == 200 and content_type.startswith('text/plain; version=0.0.4')
        status, _, body = _get(loader.metrics_url + '/metrics')
        series = _parse_prometheus(body.decode('utf-8'))
        assert series['petastorm_tpu_h2d_count'] == 4
        assert series['petastorm_tpu_shuffle_wait_count'] == 4
        assert series['petastorm_tpu_slo_target_efficiency'] == 0.8
        reader_series = _parse_prometheus(_get(reader.metrics_url + '/metrics')[2]
                                          .decode('utf-8'))
        assert reader_series['petastorm_tpu_decode_count'] == FILES
        assert reader_series['petastorm_tpu_slo_target_efficiency'] == 0.5
        health = json.loads(_get(reader.metrics_url + '/healthz')[2])
        assert health == {'status': 'ok', 'rows_consumed': ROWS, 'stopped': False,
                          'rowgroups_quarantined': 0}
        assert json.loads(_get(loader.metrics_url + '/healthz')[2])['batches'] == 4
        variables = json.loads(_get(loader.metrics_url + '/vars')[2])
        assert variables['snapshot']['histograms']['collate']['count'] == FILES
        with pytest.raises(urllib.error.HTTPError):
            _get(reader.metrics_url + '/nothing')
        report = loader.efficiency_report()
        assert report['rows'] == rows == ROWS and report['primary_wait_stage'] == 'shuffle_wait'
        assert 0.0 <= report['efficiency'] <= 1.0
        reader_report = reader.efficiency_report()
        assert reader_report['rows'] == ROWS and reader_report['target_efficiency'] == 0.5
        urls = reader.metrics_url, loader.metrics_url
        loader.stop()
        loader.join()
    for url in urls:
        with pytest.raises(urllib.error.URLError):
            _get(url + '/healthz')


def test_the_loaders_stages_are_profiler_ranges(store):
    """The loader's ``record_function`` ranges show in a torch profiler trace,
    one per batch, as the JAX loader's annotations show in a device trace."""
    from torch.profiler import ProfilerActivity, profile
    with make_reader(store, reader_pool_type='dummy', num_epochs=1) as reader:
        loader = TorchDataLoader(reader, batch_size=8, device='cpu')
        # the producer thread's ranges need profile_all_threads
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        with profile(activities=[ProfilerActivity.CPU], experimental_config=config) as prof:
            batches = sum(1 for _ in loader)
    counts = {event.key: event.count for event in prof.key_averages()}
    assert batches == ROWS // 8
    assert counts['petastorm_tpu_torch.loader.h2d'] == batches
    # one wait a batch plus the wait that met the end of the stream
    assert counts['petastorm_tpu_torch.loader.wait_input'] == batches + 1
    assert loader.telemetry.snapshot()['histograms']['h2d']['count'] == batches


def test_diagnostics_carry_the_telemetry_blocks(store):
    with make_reader(store, reader_pool_type='dummy', num_epochs=1) as reader:
        assert reader.autotune_report() == {'enabled': False}
        assert reader.metrics_url is None
        ids = [int(row.id) for row in reader]
        diag = reader.diagnostics
        assert reader.dump_trace()['traceEvents'] == []   # tracing was never armed
    assert sorted(ids) == list(range(ROWS))
    assert 'autotune' not in diag and 'trace' not in diag
    assert diag['telemetry']['histograms']['decode']['count'] == FILES
    assert diag['telemetry']['gauges']['slo_target_efficiency'] == 0.9
    assert diag['slo']['rows'] == ROWS
    json.dumps(diag['telemetry'])
