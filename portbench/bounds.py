"""The table of peaks and the least time a kernel's work can take on the card.

Copies of ``chip_smoke.py``'s ``k1_bound_ms``, ``attending_pairs`` and
``flash_bounds``, frozen here so that the yardstick does not move with the
program. A bound is the larger of the operations at the peak rate and the
bytes (each input read once, each output written once) at the memory rate.
"""

import numpy as np

#: NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAKS = {
    'NVIDIA H100 80GB HBM3': {'bf16_flops': 989e12, 'hbm_bytes_per_s': 3.35e12},
}
DEFAULT_CARD = 'NVIDIA H100 80GB HBM3'

#: matrix products a flash kernel does per attending (query, key) pair
FLASH_PRODUCTS = {'fwd': 2, 'dq': 3, 'dkv': 4}


def peaks(card):
    """The peaks of ``card`` (the H100 SXM's for a name not in the table)."""
    return PEAKS.get(card, PEAKS[DEFAULT_CARD])


def stored_copy_bytes(rows, row_bytes, blocks):
    """Bytes K1 must move for a batch of ``rows`` stored-deflate frames of
    ``row_bytes`` payload each in ``blocks`` stored blocks: the payload read
    once, its ``(m, 3)`` int32 copy table read once, the output written
    once."""
    return 2 * rows * row_bytes + blocks * 3 * 4


def stored_copy_bound_s(moved_bytes, card):
    return moved_bytes / peaks(card)['hbm_bytes_per_s']


def attending_pairs(segments, causal=True):
    """(query, key) pairs that attend in ``[B, T]`` segment ids (0: padding),
    summed over the batch, for one head: within each segment, causal."""
    total = 0
    for row in np.asarray(segments):
        _, counts = np.unique(row[row > 0], return_counts=True)
        counts = counts.astype(np.int64)
        total += int((counts * (counts + 1) // 2).sum() if causal else (counts ** 2).sum())
    return total


def flash_bounds_s(segments, heads, head_dim, elem_bytes, card, causal=True):
    """``{kernel: seconds}`` for K2 (``fwd``), K3 (``dq``) and K4 (``dkv``)
    on one ``[B, T]`` batch of segments with ``heads`` heads of
    ``head_dim``."""
    segments = np.asarray(segments)
    b, t = segments.shape
    bh = b * heads
    pairs = attending_pairs(segments, causal) * heads
    matrix = bh * t * head_dim * elem_bytes
    rows = bh * t * 4
    seg_bytes = segments.size * 4
    moved = {'fwd': 4 * matrix + rows + seg_bytes,
             'dq': 5 * matrix + 2 * rows + seg_bytes,
             'dkv': 6 * matrix + 2 * rows + seg_bytes}
    peak = peaks(card)
    return {name: max(products * 2 * head_dim * pairs / peak['bf16_flops'],
                      moved[name] / peak['hbm_bytes_per_s'])
            for name, products in FLASH_PRODUCTS.items()}
