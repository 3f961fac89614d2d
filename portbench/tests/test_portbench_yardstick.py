"""The frozen arithmetic of the yardstick against hand counts."""

import numpy as np
import pytest
import torch

from portbench import bounds, flops, records
from portbench.harness import quantile
from portbench.tasks.causal_lm import attending_pairs as device_pairs


def test_resnet50_forward_flops_is_the_published_count():
    # He et al. and the common count: 4.09 G multiply-adds at 224 x 224,
    # convolutions and the head
    count = flops.resnet_forward_flops([3, 4, 6, 3], 64, 1000, 224)
    assert count == pytest.approx(8.18e9, rel=0.01)


def test_resnet_flops_hand_count_of_one_block():
    # stem 7x7x3x64 over 4x4 (8 / 2), pool to 2x2, one bottleneck of 64
    # filters projected to 256, head 256 x 10
    stem = 2 * 49 * 3 * 64 * 16
    block = 2 * (64 * 64 * 4 + 9 * 64 * 64 * 4 + 64 * 256 * 4 + 64 * 256 * 4)
    assert flops.resnet_forward_flops([1], 64, 10, 8) == stem + block + 2 * 256 * 10


def test_lm_flops_hand_count():
    # 10 real tokens, 30 pairs, E 4, 2 layers, V 5: dense 24 * 16 * 2 + 2 * 4 * 5
    # per token, 4 * 4 * 2 per pair, times 3
    assert flops.lm_train_flops(10, 30, 4, 2, 5) == 3 * (10 * (768 + 40) + 30 * 32)


def test_attending_pairs_within_documents():
    segments = np.array([[1, 1, 1, 2, 2, 0], [1, 1, 1, 1, 1, 1]])
    assert bounds.attending_pairs(segments) == (6 + 3) + 21
    assert int(device_pairs(torch.from_numpy(segments))) == 30


def test_stored_copy_bytes_of_the_main_batch():
    # 128 float32 (2048,) payloads in one stored block each: read, write and
    # the 128 x 3 int32 table, as chip_smoke.py's k1_bound_ms counts them
    assert bounds.stored_copy_bytes(128, 8192, 128) == 2_098_688


def test_flash_bounds_hand_count():
    # one row, one head of 64, two documents of 2 and 1 tokens: 4 pairs
    segments = np.array([[1, 1, 2, 0]])
    got = bounds.flash_bounds_s(segments, 1, 64, 2, bounds.DEFAULT_CARD)
    peak = bounds.PEAKS[bounds.DEFAULT_CARD]
    matrix, rows, seg = 4 * 64 * 2, 4 * 4, 16
    assert got['fwd'] == pytest.approx(max(2 * 2 * 64 * 4 / peak['bf16_flops'],
                                           (4 * matrix + rows + seg) / peak['hbm_bytes_per_s']))
    assert got['dkv'] == pytest.approx((6 * matrix + 2 * rows + seg) / peak['hbm_bytes_per_s'])


def test_quantile_interpolates_between_order_statistics():
    values = list(range(1, 21))
    assert quantile(values, 0.95) == pytest.approx(19.05)
    assert quantile([3.0], 0.95) == 3.0


def test_flash_roofline_scales_the_bound_by_the_launches_counted():
    fact = {'segments': np.ones((1, 128), dtype=np.int32), 'heads': 2, 'head_dim': 64,
            'layers': 2, 'elem_bytes': 2}
    bound = bounds.flash_bounds_s(fact['segments'], 2, 64, 2, bounds.DEFAULT_CARD)
    ops = {'flash_fwd_kernel<64>': [2, 2 * bound['fwd']],
           'flash_bwd_dq_kernel<64>': [1, bound['dq']],
           'flash_bwd_dkv_kernel<64>': [2, 4 * bound['dkv']]}
    record = {'trace': {'ops': ops}, 'facts': [fact], 'card': bounds.DEFAULT_CARD}
    share = (2 * bound['fwd'] + bound['dq'] + 2 * bound['dkv']) / (
        2 * bound['fwd'] + bound['dq'] + 4 * bound['dkv'])
    assert records.flash_roofline(record) == pytest.approx(100 * share)


def test_readers_find_nothing_without_a_trace():
    record = {'window': {'seconds': 2.0, 'totals': {'flops': 989e12}},
              'card': bounds.DEFAULT_CARD, 'trace': None}
    assert records.device_idle_share(record) is None
    assert records.stored_copy_roofline(record) is None
    assert records.input_wait_share(record) is None
    assert records.model_flops_share(record) == pytest.approx(50.0)
