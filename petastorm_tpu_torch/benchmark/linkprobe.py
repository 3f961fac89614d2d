"""Host<->device link characterization: the port of
``petastorm_tpu.benchmark.linkprobe``.

A streaming loader pays, for every batch, one host->device transfer and one
dispatch round trip, so its ceiling on a given link is

    streaming_ceiling_rows_per_sec ~= batch / (rtt_s + overhead_s + batch_bytes / h2d_bytes_per_sec)

This module measures the three link primitives on one device: the dispatch
round trip of a tiny add, host->device bandwidth and device->host bandwidth.
Bandwidth is a least-squares line over several transfer sizes,
``t(bytes) = t0 + bytes / bandwidth``: the slope isolates the bandwidth from
the per-transfer overhead ``t0`` (reported as the intercept).

The device is ``cuda`` unless the caller passes ``device='cpu'``; a CUDA
request without a card raises, it never measures the CPU instead. On the card
every timing ends in ``torch.cuda.synchronize()`` (the JAX package gates on a
value readback); on the CPU it ends in a value readback. H2D copies a
pageable numpy array (``torch.from_numpy(...).to(device, copy=True)``), as
``jax.device_put`` does; D2H times ``.cpu().numpy()`` of distinct resident
tensors. The fields are the JAX package's, with ``platform`` ``'cuda'`` or
``'cpu'``.

Run: ``python -m petastorm_tpu_torch.benchmark.linkprobe`` prints one JSON line.
"""
from __future__ import annotations

import json
import time

import numpy as np

__all__ = ['probe_link', 'streaming_ceiling_rows_per_sec']


def _median_time(fn, iters):
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _fit_bandwidth(sizes_bytes, times_s):
    """Least-squares ``t = t0 + bytes/bw`` -> (bytes_per_sec, t0_s).

    With one size the whole time is the bandwidth's (t0 reported as 0); a
    slope at or below 0 (transfers too small to resolve it) gives the largest
    size over the shortest time and t0 0."""
    if len(sizes_bytes) < 2:
        return sizes_bytes[0] / times_s[0], 0.0
    slope, intercept = np.polyfit(np.asarray(sizes_bytes, dtype=np.float64),
                                  np.asarray(times_s, dtype=np.float64), 1)
    if slope <= 0:
        return max(sizes_bytes) / min(times_s), 0.0
    return 1.0 / slope, max(float(intercept), 0.0)


def probe_link(sizes_mb=(1, 4, 16), dispatch_iters=30, transfer_iters=5, device=None):
    """Measure the dispatch round trip and H2D/D2H bandwidth on ``device``
    (``cuda`` when None).

    Returns ``platform``, ``dispatch_rtt_ms``, ``h2d_mbytes_per_sec``,
    ``h2d_per_transfer_overhead_ms``, ``d2h_mbytes_per_sec``,
    ``d2h_per_transfer_overhead_ms`` and ``probe_sizes_mb``."""
    import torch

    from petastorm_tpu_torch.parallel.loader import resolve_device
    device = resolve_device(device)

    if device.type == 'cuda':
        def gate(x):
            torch.cuda.synchronize(device)
    else:
        def gate(x):
            x.reshape(-1)[0].item()

    def bump(x):
        return x + 1

    # warm: the add's first launch and the allocator at the probe's shape
    seed = torch.zeros((8, 128), dtype=torch.float32, device=device)
    gate(bump(seed))

    rtt_s = _median_time(lambda: gate(bump(seed)), dispatch_iters)

    h2d_sizes, h2d_times = [], []
    d2h_sizes, d2h_times = [], []
    for size_mb in sizes_mb:
        n_bytes = int(size_mb * (1 << 20))
        host = np.random.RandomState(7).randint(0, 255, size=(n_bytes,), dtype=np.uint8)

        def h2d():
            # copy=True: on the CPU too the bytes move into a new buffer
            gate(torch.from_numpy(host).to(device, copy=True))

        h2d_sizes.append(n_bytes)
        h2d_times.append(_median_time(h2d, transfer_iters))

        # one distinct resident tensor a timed readback (`bump` makes each a
        # buffer of its own)
        residents = []
        for _ in range(transfer_iters):
            r = bump(torch.from_numpy(host).to(device))
            gate(r)
            residents.append(r)
        d2h_times_i = []
        for r in residents:
            t0 = time.perf_counter()
            r.cpu().numpy()
            d2h_times_i.append(time.perf_counter() - t0)
        del residents
        d2h_sizes.append(n_bytes)
        d2h_times.append(float(np.median(d2h_times_i)))

    h2d_bw, h2d_t0 = _fit_bandwidth(h2d_sizes, h2d_times)
    d2h_bw, d2h_t0 = _fit_bandwidth(d2h_sizes, d2h_times)
    return {
        'platform': device.type,
        'dispatch_rtt_ms': round(rtt_s * 1e3, 3),
        'h2d_mbytes_per_sec': round(h2d_bw / (1 << 20), 2),
        'h2d_per_transfer_overhead_ms': round(h2d_t0 * 1e3, 3),
        'd2h_mbytes_per_sec': round(d2h_bw / (1 << 20), 2),
        'd2h_per_transfer_overhead_ms': round(d2h_t0 * 1e3, 3),
        'probe_sizes_mb': list(sizes_mb),
    }


def streaming_ceiling_rows_per_sec(link, row_bytes, batch_size):
    """Upper bound for a per-batch streaming loader on the measured link: each
    batch pays one H2D transfer of ``batch_size * row_bytes`` (plus the fitted
    per-transfer overhead) and one dispatch round trip."""
    batch_bytes = row_bytes * batch_size
    per_batch_s = (link['dispatch_rtt_ms'] / 1e3
                   + link['h2d_per_transfer_overhead_ms'] / 1e3
                   + batch_bytes / (link['h2d_mbytes_per_sec'] * (1 << 20)))
    return batch_size / per_batch_s


def main(argv=None):
    """CLI: print one JSON line of link measurements (``--device cpu`` for the
    CPU; the card by default)."""
    import argparse
    parser = argparse.ArgumentParser(description='host<->device link probe')
    parser.add_argument('--device', default=None,
                        help='cuda (default) or cpu')
    args = parser.parse_args(argv)
    print(json.dumps(dict(probe_link(device=args.device), metric='link_probe', value=0.0,
                          unit='link', vs_baseline=0.0)))
    return 0


if __name__ == '__main__':
    import sys
    sys.exit(main())
