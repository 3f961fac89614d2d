"""The readers of the loader's own spans on hand-built records, and, on the
card, the spans themselves: a tiny image store through the loader with a
device transform records ``h2d_on_device``, ``decode_tail_on_device``,
``input_stall_on_device`` and ``deliver`` once a batch, each resolved
without a synchronize of the loader's (the last at the stream's end); with
telemetry off it records none and makes no timing event. Run the card's cases there with
``python -m pytest portbench/tests -m cuda``."""

import collections

import pytest
import torch

from portbench import harness, traffic
from portbench.tests import tiny

SEED = 2 ** 31 + 303
PORT_SPANS = ('deliver', 'h2d_on_device', 'decode_tail_on_device', 'input_stall_on_device')


def _record(loader_spans, steps=50, seconds=10.0):
    return {'window': {'steps': steps, 'seconds': seconds},
            'spans': {'loader': loader_spans, 'reader': {}},
            'stats': {'batches': steps + 3, 'rows': 0, 'wait_time_s': 0.0,
                      'total_time_s': 1.0}}


def _read(name, record):
    return harness.read_metric(tiny.REPO, name, record)


def test_the_readers_divide_by_their_own_count():
    # 4 of the window's 53 batches were still pending: each reader divides
    # by the span's own count
    record = _record({'h2d_on_device': {'sum': 0.006, 'count': 4},
                      'decode_tail_on_device': {'sum': 0.01, 'count': 5},
                      'input_stall_on_device': {'sum': 0.02, 'count': 40},
                      'deliver': {'sum': 0.0003, 'count': 50},
                      'h2d': {'sum': 0.5, 'count': 53}})
    assert _read('h2d_on_device_ms_per_batch.image', record) == pytest.approx(1.5)
    assert _read('decode_tail_on_device_ms_per_batch.image', record) == pytest.approx(2.0)
    assert _read('deliver_ms_per_batch.image', record) == pytest.approx(0.006)
    # 0.5 ms a batch over a mean step of 200 ms
    for cell in ('image', 'lm'):
        assert _read('input_stall_on_device_share.' + cell, record) == pytest.approx(0.25)


@pytest.mark.parametrize('record', [
    {'window': {'steps': 50, 'seconds': 10.0}},                      # a --trace 0 run
    _record({'h2d': {'sum': 0.5, 'count': 53}}),                     # a program without them
    _record({stage: {'sum': 0.0, 'count': 0} for stage in PORT_SPANS}),  # none in the window
], ids=['untraced', 'absent', 'empty'])
def test_the_readers_find_nothing_where_the_span_is_absent(record):
    for name in ('h2d_on_device_ms_per_batch.image', 'decode_tail_on_device_ms_per_batch.image',
                 'input_stall_on_device_share.image', 'input_stall_on_device_share.lm',
                 'deliver_ms_per_batch.image'):
        assert _read(name, record) is None, name


def test_the_stall_share_needs_a_window_with_steps():
    record = _record({'input_stall_on_device': {'sum': 0.02, 'count': 40}}, steps=0)
    assert _read('input_stall_on_device_share.image', record) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: the spans on the card\'s clock are CUDA events')


def _image_loader(tmp_path):
    """The tiny image cell's store, read once, through the loader with the
    cell's device transform."""
    from petastorm_tpu_torch import DeviceTransform, TorchDataLoader, make_reader
    cell = tiny.image_cell()
    workload = cell.workload
    data = traffic.make(workload['data'], SEED, str(tmp_path), workload['name'])
    read, load = workload['read'], workload['load']
    reader = make_reader(data.url, reader_pool_type=read['pool'], workers_count=read['workers'],
                         num_epochs=1, device_decode_fields=read['device_decode_fields'])
    mean, std = load['normalize']
    transform = DeviceTransform(crop=(load['crop'], load['crop']),
                                random_flip=load['random_flip'], normalize=(mean, std),
                                normalize_dtype=load['normalize_dtype'], seed=SEED)
    return TorchDataLoader(reader, batch_size=load['batch_size'], device='cuda',
                           device_transforms={'image': transform})


def _observed(loader):
    """Every value the loader's registry observes, by stage."""
    values = collections.defaultdict(list)
    observe = loader.telemetry.observe

    def recording(name, value, *args, **kwargs):
        values[name].append(value)
        return observe(name, value, *args, **kwargs)

    loader.telemetry.observe = recording
    return values


@pytest.mark.cuda
def test_the_loader_times_each_batch_on_the_cards_clock(card, tmp_path):
    loader = _image_loader(tmp_path)
    values = _observed(loader)
    batches = 0
    with loader:
        for batch in loader:
            batch['image'].float().sum().item()   # the step's read of the batch
            torch.cuda.synchronize()
            batches += 1
    # the end of the stream is a delivery: after the synchronize it
    # resolved every entry
    histograms = loader.telemetry.snapshot()['histograms']
    assert batches > 0
    for stage in PORT_SPANS:
        assert histograms[stage]['count'] == batches == len(values[stage]), stage
        # a stall is 0 where the batch was ready before the training stream
        # reached its wait, as it is here after each synchronize
        least = min(values[stage])
        assert least >= 0.0 if stage == 'input_stall_on_device' else least > 0.0, (
            stage, values[stage])
    assert histograms['h2d']['count'] == batches


@pytest.mark.cuda
def test_telemetry_off_records_no_span_and_no_timing_event(card, tmp_path, monkeypatch):
    from petastorm_tpu_torch.parallel import loader as loader_module
    from petastorm_tpu_torch.telemetry import registry
    made = []
    timing_event = loader_module._timing_event

    def counting():
        made.append(1)
        return timing_event()

    monkeypatch.setattr(loader_module, '_timing_event', counting)
    registry.set_telemetry_enabled(False)
    try:
        loader = _image_loader(tmp_path)
        with loader:
            batches = sum(1 for _ in loader)
    finally:
        registry.set_telemetry_enabled(True)
    assert batches > 0 and made == []
    assert not set(loader.telemetry.snapshot().get('histograms', {})) & set(PORT_SPANS)

