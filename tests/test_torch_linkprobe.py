"""The port's link probe (``petastorm_tpu_torch.benchmark.linkprobe``) held
against the JAX package's: the bandwidth fit and the streaming ceiling equal
the JAX functions exactly on the same numbers, the probe's fields on the CPU
are finite and positive, and the default device is the card: without one it
raises instead of measuring the CPU."""

import json

import numpy as np
import pytest

from petastorm_tpu.benchmark import linkprobe as jax_linkprobe
from petastorm_tpu_torch.benchmark import linkprobe
from petastorm_tpu_torch.benchmark.linkprobe import (_fit_bandwidth, probe_link,
                                                     streaming_ceiling_rows_per_sec)

FIELDS = ('dispatch_rtt_ms', 'h2d_mbytes_per_sec', 'd2h_mbytes_per_sec',
          'h2d_per_transfer_overhead_ms', 'd2h_per_transfer_overhead_ms')


def test_probe_link_fields_and_sanity_on_the_cpu():
    link = probe_link(sizes_mb=(0.25, 1), dispatch_iters=5, transfer_iters=3, device='cpu')
    jax_link = jax_linkprobe.probe_link(sizes_mb=(0.25, 1), dispatch_iters=5,
                                        transfer_iters=3)
    assert set(link) == set(jax_link)
    for key in FIELDS:
        assert np.isfinite(link[key]) and link[key] >= 0, (key, link[key])
    assert link['h2d_mbytes_per_sec'] > 0 and link['d2h_mbytes_per_sec'] > 0
    assert link['platform'] == 'cpu' and link['probe_sizes_mb'] == [0.25, 1]


@pytest.mark.parametrize('sizes,times', [
    ([1 << 20, 4 << 20, 16 << 20], [0.004 + s / 100e6 for s in (1 << 20, 4 << 20, 16 << 20)]),
    ([1 << 20], [0.01]),
    ([1 << 20, 2 << 20], [0.01, 0.005]),
    ([1 << 20, 2 << 20, 8 << 20], [0.002, 0.0031, 0.0093]),
    ([3 << 20, 5 << 20], [0.001, 0.001]),
])
def test_fit_bandwidth_equals_jax(sizes, times):
    got = _fit_bandwidth(sizes, times)
    assert got == jax_linkprobe._fit_bandwidth(sizes, times)
    assert got[0] > 0 and got[1] >= 0


def test_fit_bandwidth_recovers_slope_and_overhead():
    sizes = [1 << 20, 4 << 20, 16 << 20]
    got_bw, got_t0 = _fit_bandwidth(sizes, [0.004 + s / 100e6 for s in sizes])
    assert abs(got_bw - 100e6) / 100e6 < 1e-6 and abs(got_t0 - 0.004) < 1e-9


@pytest.mark.parametrize('row_bytes,batch_size', [(1024, 2048), (51400832 // 128, 128),
                                                  (784, 1)])
def test_streaming_ceiling_equals_jax(row_bytes, batch_size):
    for link in ({'dispatch_rtt_ms': 10.0, 'h2d_per_transfer_overhead_ms': 5.0,
                  'h2d_mbytes_per_sec': 8.0},
                 {'dispatch_rtt_ms': 0.021, 'h2d_per_transfer_overhead_ms': 0.0,
                  'h2d_mbytes_per_sec': 12345.67}):
        got = streaming_ceiling_rows_per_sec(link, row_bytes, batch_size)
        assert got == jax_linkprobe.streaming_ceiling_rows_per_sec(link, row_bytes,
                                                                   batch_size)
    link = {'dispatch_rtt_ms': 10.0, 'h2d_per_transfer_overhead_ms': 5.0,
            'h2d_mbytes_per_sec': 8.0}
    faster = dict(link, h2d_mbytes_per_sec=80.0)
    assert (streaming_ceiling_rows_per_sec(faster, row_bytes, batch_size)
            > streaming_ceiling_rows_per_sec(link, row_bytes, batch_size))


def test_default_device_is_the_card_and_refuses_the_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='cuda'):
        probe_link(sizes_mb=(0.25,), dispatch_iters=1, transfer_iters=1)
    with pytest.raises(RuntimeError, match='cuda'):
        probe_link(device='cuda:0')
    with pytest.raises(ValueError, match='cuda or cpu'):
        probe_link(device='meta')


def test_main_prints_one_json_line(capsys):
    assert linkprobe.main(['--device', 'cpu']) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    doc = json.loads(lines[0])
    assert doc['platform'] == 'cpu' and doc['metric'] == 'link_probe'
