#!/usr/bin/env python3
"""Chip smoke of petastorm_tpu_torch on one NVIDIA card (Hopper, sm_90a).

Builds the port's CUDA kernels from ``petastorm_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version on the card, then drives the main
path once at full width: an ImageNet-shaped store (256x256x3 DCT images,
int64 labels, a float32 (2048,) embedding in level-0 deflate containers) ->
``make_reader(device_decode_fields=...)`` on a thread pool ->
``TorchDataLoader`` with on-card stored inflate, DCT decode, random crop,
flip and normalize -> ResNet-50 (bfloat16, random weights from ``--seed``)
for one epoch of SGD steps. It checks shapes, dtypes, the embedding byte for
byte, the decoded images against the host decode, a finite loss, and that the
stored-inflate kernel launched on every batch of the main-path run.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Any failed phase exits non-zero. Output, in order: one line per phase, a
``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints them,
and last ``{"ok": true, "device": {...}}``. The full record is also written to
``chip_smoke_out/chip_smoke.json`` (``--out`` moves it).
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import pyarrow as pa
import pyarrow.fs as pafs
import torch
import torch.nn.functional as F

from petastorm_tpu_torch import DeviceTransform, TorchDataLoader, cuda_build, make_reader
from petastorm_tpu_torch.codecs import (CompressedNdarrayCodec, DctImageCodec, ScalarCodec,
                                        _npz_raw_member)
from petastorm_tpu_torch.etl.dataset_metadata import materialize_dataset, write_table_files
from petastorm_tpu_torch.models.resnet import ResNet50
from petastorm_tpu_torch.ops import raw_decode
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

#: H100 SXM device-memory rate (NVIDIA data sheet), the bound of byte-bound kernels
HBM_BYTES_PER_S = 3.35e12
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
EMBED_LEN = 2048


def check(condition, message):
    if not condition:
        raise RuntimeError('check failed: ' + message)


def log(message):
    print(message, flush=True)


def card_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], check=True, capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    check(bool(out), 'nvidia-smi printed no card')
    return out[0].strip()


def cuda_ms(fn, reps=30, warmup=5):
    """Median milliseconds of ``fn`` on the card, each run bracketed by CUDA
    events after ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------------------ the data

def synthetic_photo(rng, hw):
    """Photograph-like content: upsampled coarse noise plus mild texture."""
    coarse = rng.randint(0, 255, (hw // 16, hw // 16, 3)).astype(np.float32)
    img = np.kron(coarse, np.ones((16, 16, 1), dtype=np.float32))
    texture = rng.randn(hw, hw, 3).astype(np.float32) * 4.0
    return np.clip(img + texture, 0, 255).astype(np.uint8)


def embedding_of(idx, seed):
    return np.random.RandomState(seed * 1000003 + idx).randn(EMBED_LEN).astype(np.float32)


def label_of(idx, seed):
    return int(np.random.RandomState(seed * 7919 + idx).randint(1000))


def imagenet_schema(hw):
    return Unischema('ImagenetSmoke', [
        UnischemaField('idx', np.int64, (), ScalarCodec(), False),
        UnischemaField('label', np.int64, (), ScalarCodec(), False),
        UnischemaField('image', np.uint8, (hw, hw, 3), DctImageCodec(quality=90), False),
        UnischemaField('embedding', np.float32, (EMBED_LEN,),
                       CompressedNdarrayCodec(stored=True), False),
    ])


def write_imagenet_store(url, path, rows, unique_images, hw, seed):
    """ImageNet-shaped store in 4 zstd files of 16 MB rowgroups. Row ``i``
    carries photo ``i % unique_images`` (each encoded once) and its own
    embedding and label. Returns the encoded image blobs."""
    schema = imagenet_schema(hw)
    rng = np.random.RandomState(seed)
    image_field = schema.fields['image']
    embed_field = schema.fields['embedding']
    blobs = [image_field.codec.encode(image_field, synthetic_photo(rng, hw))
             for _ in range(unique_images)]
    table = pa.table({
        'idx': pa.array(np.arange(rows, dtype=np.int64)),
        'label': pa.array([label_of(i, seed) for i in range(rows)], type=pa.int64()),
        'image': pa.array([blobs[i % unique_images] for i in range(rows)], type=pa.binary()),
        'embedding': pa.array([embed_field.codec.encode(embed_field, embedding_of(i, seed))
                               for i in range(rows)], type=pa.binary()),
    }, schema=schema.as_arrow_schema())
    with materialize_dataset(url, schema):
        os.makedirs(path, exist_ok=True)
        write_table_files(pafs.LocalFileSystem(), path, table.schema, table.to_batches(),
                          rowgroup_size_mb=16, rows_per_file=-(-rows // 4),
                          compression='zstd')
    return blobs


# ---------------------------------------------------------------- the phases

def stored_batch(frames):
    """(source on the card, host segment table, inflated length) of a batch:
    ``stored_inflate`` checks the host table and uploads it itself."""
    segs, lengths = raw_decode.plan_stored_batch(frames)
    src = np.concatenate([np.frombuffer(bytes(f), dtype=np.uint8) for f in frames])
    return torch.from_numpy(src).to('cuda'), segs, sum(lengths)


def phase_k1(batch, seed):
    """K1 against its plain version, bit for bit: an edge-case batch (a
    70000-byte frame spanning several stored blocks, 0- and 1-byte frames) and
    a batch of the main path's shape (``batch`` level-0 containers of a float32
    (2048,) embedding), then timings at the main path's shape. ``ms`` times the
    wrapper as the main path calls it: the host check of the table, its upload
    and the launch."""
    codec = CompressedNdarrayCodec(stored=True)
    field = UnischemaField('embedding', np.float32, (EMBED_LEN,), codec)
    main_frames = [bytes(_npz_raw_member(codec.encode(field, embedding_of(i, seed)))[1])
                   for i in range(batch)]
    rng = np.random.RandomState(seed)
    edge_frames = list(main_frames[:3])
    for size in (70000, 0, 1, 1024):
        comp = zlib.compressobj(0, zlib.DEFLATED, -15)
        edge_frames.append(comp.compress(rng.randint(0, 256, size, dtype=np.uint8)
                                         .tobytes()) + comp.flush())
    result = {}
    for name, frames in (('edge', edge_frames), ('main', main_frames)):
        src, segs, out_len = stored_batch(frames)
        got = raw_decode.stored_inflate(src, segs, out_len)
        want = raw_decode.stored_inflate_plain(src, segs, out_len)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max()) if out_len else 0
        check(got.shape == want.shape and err == 0 and torch.equal(got, want),
              'K1 differs from its plain version on the {} batch'.format(name))
        result[name] = {'frames': len(frames), 'src_bytes': int(src.numel()),
                        'segments': int(segs.shape[0]), 'out_bytes': out_len,
                        'max_abs_err': err}
    src, segs, out_len = stored_batch(main_frames)
    moved = src.numel() + segs.nbytes + out_len
    result['main'].update(
        ms=cuda_ms(lambda: raw_decode.stored_inflate(src, segs, out_len)),
        plain_ms=cuda_ms(lambda: raw_decode.stored_inflate_plain(src, segs, out_len)),
        bound_ms=moved / HBM_BYTES_PER_S * 1e3, bound_by='bytes', bytes_moved=int(moved))
    return result


def phase_main_path(url, args):
    """One epoch of the main path; returns its measurements and the (idx,
    embedding) pairs it delivered."""
    torch.manual_seed(args.seed)
    model = ResNet50(num_classes=1000).train()
    optimizer = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    crop = args.crop
    # one step on random data first, so the epoch's step times exclude
    # cuDNN's first-call setup
    warm = torch.randn(args.batch, crop, crop, 3, device='cuda').to(torch.bfloat16)
    check({p.device.type for p in model.parameters()} == {'cuda'},
          'ResNet50 did not build its parameters on the card')
    F.cross_entropy(model(warm), torch.zeros(args.batch, dtype=torch.int64,
                                              device='cuda')).backward()
    optimizer.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    transform = DeviceTransform(crop=(crop, crop), random_flip=True,
                                normalize=(IMAGENET_MEAN, IMAGENET_STD),
                                normalize_dtype='bfloat16', seed=args.seed)
    delivered = []
    losses = []
    step_s = []
    torch.cuda.reset_peak_memory_stats()
    raw_decode.stored_inflate.launches = 0
    with make_reader(url, reader_pool_type='thread', workers_count=args.workers,
                     seed=args.seed, device_decode_fields=['image', 'embedding']) as reader:
        loader = TorchDataLoader(reader, batch_size=args.batch,
                                 device_transforms={'image': transform})
        start = time.perf_counter()
        for batch in loader:
            step_start = time.perf_counter()
            check(tuple(batch['image'].shape) == (args.batch, crop, crop, 3)
                  and batch['image'].dtype == torch.bfloat16
                  and batch['image'].device.type == 'cuda', 'image batch shape/dtype')
            check(tuple(batch['embedding'].shape) == (args.batch, EMBED_LEN)
                  and batch['embedding'].dtype == torch.float32, 'embedding shape/dtype')
            check(batch['label'].dtype == torch.int64 and batch['idx'].dtype == torch.int64,
                  'label/idx dtype')
            delivered.append((batch['idx'].clone(), batch['label'].clone(),
                              batch['embedding'].clone()))
            loss = F.cross_entropy(model(batch['image']), batch['label'])
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - step_start)
        wall_s = time.perf_counter() - start
        launches = raw_decode.stored_inflate.launches
        stats = loader.stats.as_dict()
    steps = len(losses)
    losses = [float(x) for x in losses]
    check(steps >= args.min_steps, 'only {} steps ran'.format(steps))
    check(all(np.isfinite(losses)), 'non-finite loss {}'.format(losses))
    check(launches == steps == stats['device_stored_batches'],
          'K1 launched {} times over {} batches ({} stored batches): not on every batch'
          .format(launches, steps, stats['device_stored_batches']))
    return {'steps': steps, 'rows': stats['rows'], 'wall_s': wall_s,
            'rows_per_s': stats['rows'] / wall_s,
            'input_stall_fraction': stats['input_stall_fraction'],
            'step_ms_median': statistics.median(step_s) * 1e3,
            'step_ms': [s * 1e3 for s in step_s],
            'peak_memory_bytes': torch.cuda.max_memory_allocated(),
            'losses': losses, 'k1_launches': launches}, delivered


def check_delivered(delivered, seed):
    seen = set()
    for idx, label, embedding in delivered:
        idx = idx.cpu().numpy()
        label = label.cpu().numpy()
        embedding = embedding.cpu().numpy()
        for row, i in enumerate(idx):
            check(embedding[row].tobytes() == embedding_of(int(i), seed).tobytes(),
                  'embedding of row {} differs from its host decode'.format(i))
            check(int(label[row]) == label_of(int(i), seed), 'label of row {}'.format(i))
            seen.add(int(i))
    return len(seen)


def phase_image_check(url, blobs, args):
    """Transform-free pass over two batches: the on-card DCT decode within +-1
    of the host decode (``dct_decode_image``) of the same stored blobs."""
    field = imagenet_schema(args.image).fields['image']
    worst = 0
    checked = 0
    with make_reader(url, reader_pool_type='dummy', shuffle_row_groups=False,
                     schema_fields=['idx', 'image'], device_decode_fields=['image']) as reader:
        loader = TorchDataLoader(reader, batch_size=args.batch)
        for batch, _ in zip(loader, range(2)):
            images = batch['image'].cpu().numpy()
            check(images.dtype == np.uint8 and images.shape[1:] == (args.image,) * 2 + (3,),
                  'decoded image shape/dtype')
            for row, i in enumerate(batch['idx'].cpu().numpy()):
                host = field.codec.decode(field, blobs[int(i) % len(blobs)])
                worst = max(worst, int(np.abs(images[row].astype(int) - host.astype(int)).max()))
                checked += 1
    check(checked == 2 * args.batch and worst <= 1,
          'on-card DCT decode off by {} from the host decode'.format(worst))
    return {'images_checked': checked, 'max_abs_err': worst}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--rows', type=int, default=1024)
    parser.add_argument('--batch', type=int, default=128)
    parser.add_argument('--min-steps', type=int, default=8)
    parser.add_argument('--unique-images', type=int, default=256)
    parser.add_argument('--image', type=int, default=256)
    parser.add_argument('--crop', type=int, default=224)
    parser.add_argument('--workers', type=int, default=4)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--out', default=os.path.join('chip_smoke_out', 'chip_smoke.json'))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this script needs a '
              'CUDA card', file=sys.stderr)
        return 2
    card = card_line()
    device_name = torch.cuda.get_device_name(0)
    log('phase 1 card: {} | torch {} cuda {}'.format(card, torch.__version__,
                                                     torch.version.cuda))
    record = {'card': card, 'device': device_name}

    start = time.perf_counter()
    for name in cuda_build.KERNELS:
        cuda_build.load(name)
    record['build_s'] = time.perf_counter() - start
    log('phase 2 build: {} in {:.3f} s'.format(', '.join(cuda_build.KERNELS),
                                               record['build_s']))

    k1 = phase_k1(args.batch, args.seed)
    record['k1'] = k1
    log('phase 3 K1 stored_copy bit-exact: edge {} | main-shape kernel_ms={:.5f} '
        'plain_ms={:.5f} bound_ms={:.5f} launches_per_step=1 [{}]'.format(
            k1['edge'], k1['main']['ms'], k1['main']['plain_ms'], k1['main']['bound_ms'],
            card))

    tmp = tempfile.mkdtemp(prefix='petastorm_tpu_torch_smoke_')
    try:
        path = os.path.join(tmp, 'imagenet')
        url = 'file://' + path
        start = time.perf_counter()
        blobs = write_imagenet_store(url, path, args.rows, args.unique_images,
                                     args.image, args.seed)
        record['store_write_s'] = time.perf_counter() - start
        main_path, delivered = phase_main_path(url, args)
        main_path['distinct_rows'] = check_delivered(delivered, args.seed)
        check(main_path['distinct_rows'] == main_path['rows'], 'rows repeated or lost')
        record['main_path'] = main_path
        log('phase 4 main path: {} steps of ResNet-50 at batch {}: rows/s={:.2f} '
            'input_stall_fraction={:.4f} step_ms(median)={:.2f} peak_memory={:.3f} GiB '
            'loss {:.4f}->{:.4f}, K1 launches {} on {} batches, store written in {:.1f} s '
            '[{}]'.format(main_path['steps'], args.batch, main_path['rows_per_s'],
                          main_path['input_stall_fraction'], main_path['step_ms_median'],
                          main_path['peak_memory_bytes'] / 2 ** 30, main_path['losses'][0],
                          main_path['losses'][-1], main_path['k1_launches'],
                          main_path['steps'], record['store_write_s'], card))
        record['image_check'] = phase_image_check(url, blobs, args)
        log('phase 5 images: {}'.format(record['image_check']))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = {'kernels': [{
        'name': 'stored_copy', 'route': 'cuda',
        'source': 'petastorm_tpu_torch/csrc/stored_copy.cu',
        'replaces': 'petastorm_tpu/ops/raw_decode.py:165',
        'launches': record['main_path']['k1_launches'],
        'max_abs_err': max(k1['edge']['max_abs_err'], k1['main']['max_abs_err']),
        'ms': k1['main']['ms'], 'plain_ms': k1['main']['plain_ms'],
        'bound_ms': k1['main']['bound_ms'], 'bound_by': 'bytes',
        # no single PyTorch call gathers bytes by a (src, dst, len) segment table
        'library_ms': None}]}
    record.update(kernels)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(record, f, indent=1)
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': device_name,
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
