"""The port's stage spans on the profiler's clock and its own loader stages:
while ``torch.profiler`` records, the reader workers' and the loader's
scoped spans are ``record_function`` ranges on the threads that ran them;
with the profiler off none opens. ``PORT_STAGES`` (``deliver`` and the three
spans on the card's clock) sits beside the JAX package's catalog, pipecheck
accepts it, time-share attribution leaves the card's clock out, and with
telemetry off none of them is recorded. :class:`DeviceSpans` resolves its
entries in order without a synchronize (CUDA events faked here; the card's
case is ``portbench/tests/test_portbench_program_spans.py``)."""

import collections

import numpy as np
import pytest
import torch

from petastorm_tpu.telemetry import spans as jax_spans
from petastorm_tpu_torch import make_reader
from petastorm_tpu_torch.analysis import run_pipecheck
from petastorm_tpu_torch.parallel.loader import DeviceSpans, TorchDataLoader
from petastorm_tpu_torch.telemetry import MetricsRegistry, registry, spans
from petastorm_tpu_torch.telemetry.analyze import attribute_bottleneck

ROWS = 64
FILES = 4
BATCH = 8


@pytest.fixture(scope='module')
def store(tmp_path_factory):
    """64 rows in 4 files of one rowgroup: ``id`` and a float32 (8,) ``vec``."""
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    schema = Unischema('Ranged', [
        UnischemaField('id', np.int64, (), ScalarCodec(), False),
        UnischemaField('vec', np.float32, (8,), NdarrayCodec(), False)])
    rng = np.random.RandomState(11)
    url = 'file://' + str(tmp_path_factory.mktemp('ranges') / 'store')
    write_rows(url, schema, [{'id': i, 'vec': rng.randn(8).astype(np.float32)}
                             for i in range(ROWS)], n_files=FILES, rowgroup_size_mb=1)
    return url


def _read_through_loader(store):
    with make_reader(store, reader_pool_type='thread', workers_count=2,
                     num_epochs=1) as reader:
        loader = TorchDataLoader(reader, batch_size=BATCH, device='cpu')
        batches = sum(1 for _ in loader)
    return loader, batches


def test_stage_spans_are_ranges_on_the_threads_that_ran_them(store):
    from torch.profiler import ProfilerActivity, profile
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=config) as prof:
        _, batches = _read_through_loader(store)
    threads = collections.defaultdict(set)
    counts = collections.Counter()
    for event in prof.events():
        if event.name.startswith(spans.RANGE_PREFIX):
            threads[event.name].add(event.thread)
            counts[event.name] += 1
    assert batches == ROWS // BATCH
    name = {stage: spans.RANGE_PREFIX + stage for stage in (
        'reader.rowgroup_read', 'reader.decode', 'loader.collate', 'loader.h2d',
        'loader.deliver', 'loader.wait_input')}
    assert counts[name['loader.deliver']] == batches
    assert counts[name['loader.wait_input']] == batches + 1
    assert counts[name['loader.h2d']] == batches
    assert counts[name['reader.rowgroup_read']] >= FILES
    assert counts[name['reader.decode']] == FILES
    assert counts[name['loader.collate']] == FILES
    # the training thread waits and delivers; the producer collates; the
    # reader's worker threads read and decode
    training = threads[name['loader.deliver']]
    assert len(training) == 1 and threads[name['loader.wait_input']] == training
    producer = threads[name['loader.collate']]
    assert len(producer) == 1 and not producer & training
    workers = threads[name['reader.rowgroup_read']] | threads[name['reader.decode']]
    assert workers and not workers & (training | producer)


def test_no_range_opens_with_the_profiler_off(store, monkeypatch):
    opened = []
    enter = torch.autograd.profiler.record_function.__enter__

    def counting_enter(self):
        opened.append(self.name)
        return enter(self)

    monkeypatch.setattr(torch.autograd.profiler.record_function, '__enter__', counting_enter)
    loader, batches = _read_through_loader(store)
    assert batches == ROWS // BATCH and opened == []
    # the same ranges do open while the profiler records
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _read_through_loader(store)
    assert spans.RANGE_PREFIX + 'loader.deliver' in opened
    # the spans still land in the histograms
    histograms = loader.telemetry_snapshot()['histograms']
    assert histograms['deliver']['count'] == batches
    assert histograms['decode']['count'] == FILES


def test_port_stages_sit_beside_the_jax_packages_catalog():
    assert not set(spans.PORT_STAGES) & set(jax_spans.STAGES)
    assert spans.DEVICE_CLOCK_STAGES < set(spans.PORT_STAGES)
    assert 'deliver' not in spans.DEVICE_CLOCK_STAGES


def test_pipecheck_accepts_port_stages_and_holds_their_call_form(tmp_path):
    assert run_pipecheck(paths=['petastorm_tpu_torch']).findings == []
    (tmp_path / 'use.py').write_text(
        'def use(registry, loader):\n'
        '    registry.observe("deliver", 1.0)\n'
        '    loader.observe_traced("h2d_on_device", 1.0)\n'
        '    registry.observe("h2d", 1.0)\n'
        '    registry.observe("delivr", 1.0)\n')
    report = run_pipecheck(paths=[str(tmp_path)], rules=['telemetry-names'])
    assert [(f.line, f.message.split(' is ')[0]) for f in report.findings] == [
        (5, "telemetry name 'delivr'")]


def test_attribution_leaves_the_cards_clock_out():
    reg = MetricsRegistry()
    reg.observe('decode', 0.2)
    reg.observe('deliver', 0.01)
    for stage in spans.DEVICE_CLOCK_STAGES:
        reg.observe(stage, 5.0)
    report = attribute_bottleneck(reg.snapshot())
    assert report['top_stage'] == 'decode'
    assert {row['stage'] for row in report['ranked']} == {'decode', 'deliver'}
    assert report['total_stage_seconds'] == pytest.approx(0.21)


def test_no_port_stage_is_recorded_with_telemetry_off(store):
    registry.set_telemetry_enabled(False)
    try:
        loader, batches = _read_through_loader(store)
    finally:
        registry.set_telemetry_enabled(True)
    assert batches == ROWS // BATCH
    histograms = loader.telemetry.snapshot().get('histograms', {})
    assert not set(histograms) & set(spans.PORT_STAGES)


class _Event(object):
    """A CUDA event's ``query``/``elapsed_time`` at a fixed time (ms)."""

    def __init__(self, ms, done=True):
        self.ms, self.done = ms, done

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_device_spans_resolve_in_order_without_waiting():
    reg = MetricsRegistry()
    device_spans = DeviceSpans(reg)
    first = [('h2d_on_device', _Event(0.0), _Event(1.5)),
             ('input_stall_on_device', _Event(2.0), _Event(2.25))]
    # the second entry's copy still runs, though its last event is done
    running = _Event(4.0, done=False)
    second = [('h2d_on_device', _Event(3.0), running),
              ('input_stall_on_device', _Event(5.0), _Event(9.0))]
    # a wait that never waited: the loader's last event came first
    third = [('h2d_on_device', _Event(6.0), _Event(8.0)),
             ('input_stall_on_device', _Event(8.5), _Event(8.0))]
    for entry in (first, second, third):
        device_spans.add(entry)
    device_spans.resolve()
    histograms = reg.snapshot()['histograms']
    # the second entry and the third behind it wait
    assert histograms['h2d_on_device']['count'] == 1
    assert histograms['h2d_on_device']['sum'] == pytest.approx(1.5e-3)
    assert histograms['input_stall_on_device']['sum'] == pytest.approx(0.25e-3)
    running.done = True
    device_spans.resolve()
    histograms = reg.snapshot()['histograms']
    assert histograms['h2d_on_device']['count'] == 3
    assert histograms['h2d_on_device']['sum'] == pytest.approx(4.5e-3)
    assert histograms['input_stall_on_device']['sum'] == pytest.approx(4.25e-3)
