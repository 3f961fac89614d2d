"""Host time of the decode tail's planning of a stored-deflate batch (the
work K1's batches cost the loader's producer thread), on the host's clock.

Run from the root of a checkout, on any machine (no card needed)::

    python -m petastorm_tpu_torch.benchmark.stored_plan [--batch 128] [--length 2048]

It prints one JSON object: the batch, the frame and table sizes, and the
median milliseconds of ``DeviceDecodeStage._plan_stored`` over ``--runs``
plans of ``--batch`` level-0 containers of a float32 ``(length,)`` field."""

import argparse
import json
import statistics
import time

import numpy as np

from petastorm_tpu_torch.codecs import CompressedNdarrayCodec, _npz_raw_member
from petastorm_tpu_torch.decode_engine import RAW_ENC_DEFLATE
from petastorm_tpu_torch.parallel.device_stage import DeviceDecodeStage
from petastorm_tpu_torch.unischema import UnischemaField


def stored_frames(length, batch, seed, values=None):
    """``batch`` level-0 containers of a float32 ``(length,)`` field, as the
    reader ships them: the raw-deflate member of each. ``values(i)`` gives
    row ``i``'s array; by default it is drawn from ``seed``."""
    codec = CompressedNdarrayCodec(stored=True)
    field = UnischemaField('embedding', np.float32, (length,), codec)
    rng = np.random.RandomState(seed)
    return [np.frombuffer(_npz_raw_member(codec.encode(field, values(i) if values else
                                                       rng.randn(length).astype(np.float32)))[1],
                          dtype=np.uint8) for i in range(batch)]


def plan_ms(frames, runs=20):
    """``(plan, milliseconds)``: the decode tail's plan of the batch (None
    when it sends the batch to host inflate) and the median host time of
    ``runs`` plans."""
    enc = np.full(len(frames), RAW_ENC_DEFLATE, dtype=np.uint8)
    plan = DeviceDecodeStage._plan_stored(frames, enc)
    times = []
    for _ in range(runs):
        start = time.perf_counter()
        DeviceDecodeStage._plan_stored(frames, enc)
        times.append(time.perf_counter() - start)
    return plan, statistics.median(times) * 1e3


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--batch', type=int, default=128)
    parser.add_argument('--length', type=int, default=2048)
    parser.add_argument('--runs', type=int, default=200)
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args()
    frames = stored_frames(args.length, args.batch, args.seed)
    plan, ms = plan_ms(frames, args.runs)
    print(json.dumps({'batch': args.batch, 'length': args.length, 'runs': args.runs,
                      'frame_bytes': int(frames[0].size),
                      'table_rows': None if plan is None else int(plan[1].shape[0]),
                      'plan_ms': ms}))


if __name__ == '__main__':
    main()
