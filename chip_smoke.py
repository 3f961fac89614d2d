#!/usr/bin/env python3
"""Chip smoke of petastorm_tpu_torch on one NVIDIA card (Hopper, sm_90a).

Builds the port's CUDA kernels from ``petastorm_tpu_torch/csrc`` (one nvcc per
source), holds each kernel against its plain PyTorch
version on the card, then drives the port's two paths at full width:

- the ImageNet device-decode path: an ImageNet-shaped store (256x256x3 DCT
  images, int64 labels, a float32 (2048,) embedding in level-0 deflate
  containers) -> ``make_reader(device_decode_fields=...)`` on a thread pool ->
  ``TorchDataLoader`` with on-card stored inflate (K1), DCT decode, random
  crop, flip and normalize -> ResNet-50 (bfloat16, random weights from
  ``--seed``) for one epoch of SGD steps;
- the long-context LM path: a store of 64 rows of 8192 int32 tokens ->
  ``make_reader`` -> ``TorchDataLoader(batch_size=2)`` -> ``TransformerLM``
  (embed 512, 4 heads, 4 layers, bfloat16) with the flash-attention kernels
  (K2 forward, K3 dQ and K4 dK/dV, on the bf16 tensor cores), Adam, one
  warm-up and 8 timed steps; the same path through
  ``TorchDataLoader.scan_stream``, each chunk of 8 Adam steps one CUDA graph
  replay (phase 7b); then its packed variant: ragged documents packed into
  8192-token bins, the segmented kernels and the packed loss, 4 steps;
- ``bench.py``'s headline MNIST configuration: a store of 50,000 rows (a
  (28, 28) uint8 image and int64 labels) -> ``make_reader`` (4 threads) ->
  ``InMemTorchLoader(batch_size=2048)`` -> ``MnistCNN`` (bfloat16) with
  SGD through ``scan_epochs``, one CUDA graph replay an epoch, the epoch's
  permutation from J4 (phase 9); then the same store and model through
  ``TorchDataLoader.scan_stream`` in chunks of 8 batches (phase 10);
- resumable packed-LM training from plain Parquet (phase 11): a native
  Parquet store (``doc_id`` int64, ``tokens`` ``list<int32>``, 16 rowgroups
  of ragged documents that first-fit packs into exactly two full 8192-token
  bins) -> ``make_torch_loader`` (``make_batch_reader`` with
  ``make_packing_transform``, batch 2, so every step is one work item) -> the
  phase 7-8 LM with the segmented kernels, Adam: 16 steps uninterrupted, then
  from the same weights 8 steps, ``TrainingCheckpointer.save`` with the
  loader, everything dropped, a new model and optimizer restored and a new
  loader built with ``resume_state=``, and the last 8 steps. These runs read
  with one worker thread, so the batch order repeats: the resumed
  batches must equal the uninterrupted run's last 8 bit for bit with none
  after them, the losses must agree within ``RESUME_LOSS_RTOL``, and K2-K4
  must each launch layers x steps times in each half with no dense fallback.
  Then the same 8 + 8 steps with two worker threads, whose items arrive in
  the order they finish: the documents trained on before the save and after
  the resume must be the epoch's, each once;
- the reader's row-space features (phase 12): a store of 16 streams of 32
  frames of 1024 tokens (one rowgroup a stream, 4 files, a rowgroup index on
  ``stream_id``) -> ``make_reader`` with an ``NGram`` of 8 frames
  (``timestamp_overlap=False``) and a rowgroup selector of the 8 even streams
  -> ``TorchDataLoader(batch_size=2)`` -> phase 7's LM on the windows
  reshaped to [2, 8192], 1 + 8 Adam steps, then the rest of the epoch; every
  selected window must arrive once, as 8 consecutive frames of one selected
  stream with its frames' tokens (12a); then phase 9's store through
  ``make_reader(predicate=in_pseudorandom_split([0.8, 0.2], 0, 'idx'),
  cache_type='local-disk')`` -> ``TorchDataLoader`` -> ``MnistCNN``'s eager
  step: with ``num_epochs=2`` each epoch must read exactly the split's
  ``idx`` set with one cache hit or miss a rowgroup; then two passes of a
  ``num_epochs=1`` loader over a new cache must each deliver that set, the
  first with a miss and the second with a hit for every rowgroup (12b);
- the process pool (phase 13): phase 5's store and model read by a process
  pool of 4 spawned workers with the shared-memory ring required (13a: K1 on
  every batch, every row once with its label and embedding bytes, every
  result through the ring with no fallback, CRC failure or stale drop, the
  ring's segment gone after ``join()``, no worker holding a CUDA context);
  phase 10's MNIST stream on a process pool of 4 (13b: each epoch's ``idx``
  once, and the first chunk, read by one process worker, against the eager
  twin); then one epoch of it with a worker SIGKILLed once the first chunk's
  rows were read (13c: every ``idx`` once, one respawn, the segment gone).
  It prints ``/dev/shm``'s size and ``os.cpu_count()``;
- expert-routed MoE training, ``bench.py``'s ``moe`` section (phase 14): a
  store of 32 rows of 2048 int32 tokens -> ``make_reader`` (2 threads) ->
  ``InMemTorchLoader(batch_size=4, shuffle=True, seed=4)`` ->
  ``MoETransformerLM`` (embed 512, 4 heads, 2 layers, 8 experts in every
  layer, top-1 Switch routing at capacity factor 1.25, bfloat16, weights from
  ``--seed``) with dense causal attention, Adam, one warm-up and 8 timed
  steps and a profiled one; switch_routing on the card and on the CPU must
  agree bit for bit on the first batch's router probabilities, and the first
  layer's MoE output in float32 must match a per-token loop reference (14a);
  the same model, weights and batches with the causal flash kernels, whose
  attention is held against dense attention layer by layer and whose first
  batch must be within 1e-3 of 14a's loss with under 1% of tokens rerouted
  (14b); then a one-rank NCCL process group: ``sharded_moe_ffn`` against the
  MoE layer's local path, and ``ring_attention_sharded`` (causal and
  segmented) at [2, 8192, 4, 128] against the flash kernels (14c). One card
  runs one rank, so no exchange happens: the ring's rotation and merge and
  the expert all-to-all across ranks are held by the CPU tests;
- data- and pipeline-parallel training (phase 15) on a one-rank NCCL group
  (``initialize_distributed`` on a file store of its own, destroyed after
  the phase): phase 7's token store -> ``make_reader`` sharded by the mesh's
  'data' coordinate -> ``TorchDataLoader(batch_size=4, mesh=('stage',
  'data') of 1 x 1, partition_spec=('data',))``, whose fields must be
  DTensors on cuda -> an embedding, ``make_pipeline`` with one stage of the
  4 flash Blocks and 2 microbatches (K2-K4 at phase 7's [8, 8192, 128]), the
  head and ``next_token_loss``, Adam, 1 + 8 steps; the first batch within
  ``PIPE_LOSS_RTOL``/``PIPE_GRAD_NORM_RTOL`` of the unpipelined
  ``TransformerLM`` with the same weights, and a profiled step running K2-K4
  8 times each (15a); phase 9's store -> ``InMemTorchLoader(mesh=('data',))
  .scan_epochs``, the shard-local shuffle (J9) at one shard, 3 epochs of one
  graph replay each, every epoch's rows distinct, the first epoch against an
  eager twin (15b); phase 10's stream through ``scan_stream`` over the mesh,
  bit-equal to the mesh-less loader's batches (15c). The stage shift to
  itself is skipped at one stage; the P2P schedule across stages is held by
  the CPU tests;
- the reference petastorm's user surface (phase 16): phase 7's 64 token rows
  as a ``pyarrow.Table`` -> ``make_converter`` -> ``make_torch_loader``
  (one worker, rowgroups in order) -> phase 7's LM for 1 + 8 Adam steps,
  every batch the table's rows in order, K2-K4 layers x steps each, a second
  conversion a cache hit and ``delete()`` removing the store (16a); phase
  9's 50,000 MNIST rows as a table (``image`` a ``list<uint8>`` of 784)
  through ``make_torch_dataloader`` (``BatchedDataLoader``), phase 9's store
  through ``DataLoader(make_reader(...))`` and the converter's store through
  ``InMemBatchedDataLoader(make_batch_reader(...), num_epochs=2)``, all onto
  the card into eager ``MnistCNN`` steps, each epoch's ``idx`` values
  distinct (16b); phase 5's store through
  ``make_batch_reader(device_decode_fields=['image', 'embedding'])`` ->
  phase 5's loader and ResNet-50, K1 on every batch, the first two decoded
  batches bit-equal to ``make_reader``'s, coalesced and field by field, and
  a plain store refused (16c); the example twins' ``main(argv)`` in this
  process: the long-context twin ``--packed`` at phase 8's width (segmented
  K2-K4 through the ring at one rank), the ImageNet twin
  ``--on-chip-decode`` at ResNet-50's width on 256 synthetic 224x224 DCT
  rows, the MNIST twin ``--inmem`` and the converter twin, each ending with
  a finite loss (16d). It prints first whether ``cv2``, ``pandas`` and
  ``dill`` import;
- pipeline telemetry and the autotuner (phase 17): phase 5's store and path
  with ``make_reader(trace=True, metrics_port=0)`` on a process pool of 4
  and a loader with ``metrics_port=0``: the stage counts against the
  batches and rowgroups, a ``/metrics`` and ``/healthz`` scrape during the
  run, the Chrome trace's worker tracks and flow arrows, attribution, K1 8
  launches, and the one pinned copy a batch timed on the card by CUDA events
  around it in the smoke's own upload wrapper (17a); phase 10's stream
  through eager ``MnistCNN`` steps with telemetry off, on and traced, each
  twice in mirrored order after a warm-up epoch, then 2 epochs under
  ``autotune=``: each epoch's ``idx`` once, at least two decisions, knobs
  within bounds, no breaker (17b); phase 7's LM unarmed, then with the
  flight recorder armed (its step within the unarmed pass's range widened
  by 10%), a profiled 2-step window with the loader's ``wait_input`` and
  ``h2d`` ranges beside K2-K4, and ``scan_stream`` passes with telemetry
  armed: none launching outside the graph after the capture, one ``h2d``
  span a chunk (17c).

Each path (and each half of phase 11) runs with the launch counts set to 0
just before it and read just after, and fails unless every kernel of the
path launched on it. The
wrappers count only launches made outside a CUDA graph, so the LM graph
phase (7b) counts its kernels in profiler traces instead: K2-K4 must each
run once a layer and step in every replay. Each graph phase holds
the graph's first epoch or chunk of losses against an eager run of the same
batches from the same weights. K1 is held
bit for bit against its plain version on outputs whose memory held 0xAB
(an edge batch, source offsets 0-15 with gaps between rows, the main path's
batch and a 64 MiB batch of multi-block frames). The flash
kernels are compared with their plain versions in five modes (causal,
non-causal, segmented with padding, segmented with the keys' ids apart from
the queries' as a ring's blocks run them, head_dim 64 with a ragged T) by
``flash_compare`` of ``ops/flash_attention.py``, and the LM path's
first-batch loss and gradient norm with the kernels against the same model
run with plain dense attention. Kernel times are the mean of back-to-back
calls between one pair of CUDA events (``cuda_ms``); K1's own device time
is taken with its launches queued behind a spin of the card, so the host's
issue of each launch stays out of it (``device_ms``).

Run from the repository root with no arguments::

    python3 chip_smoke.py

Any failed phase exits non-zero. Output, in order: one line per phase, a
``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints them,
and last ``{"ok": true, "device": {...}}``. The full record is also written to
``chip_smoke_out/chip_smoke.json`` (``--out`` moves it).
"""

import argparse
import concurrent.futures
import copy
import functools
import importlib
import itertools
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request
import warnings
import zlib

import numpy as np
import pyarrow as pa
import pyarrow.fs as pafs
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from petastorm_tpu_torch import (DeviceTransform, InMemTorchLoader, MnistCNN, NGram,
                                 TorchDataLoader, TrainingCheckpointer, TransformerLM,
                                 cuda_build, make_batch_reader, make_converter,
                                 make_packing_transform, make_reader, make_torch_loader)
from petastorm_tpu_torch.autotune import AutotunePolicy
from petastorm_tpu_torch.benchmark.lm_data import (FRAME_STREAM_INDEX, full_bin_rowgroups,
                                                   ragged_documents, token_rows,
                                                   write_frame_store, write_packed_store,
                                                   write_ragged_store, write_token_store)
from petastorm_tpu_torch.benchmark.mfu import (mfu, moe_transformer_train_flops_per_step,
                                               transformer_train_flops_per_step)
from petastorm_tpu_torch.benchmark.mnist_data import mnist_rows, write_mnist_store
from petastorm_tpu_torch.benchmark.stored_plan import plan_ms, stored_frames
from petastorm_tpu_torch.codecs import CompressedNdarrayCodec, DctImageCodec, ScalarCodec
from petastorm_tpu_torch.etl.dataset_metadata import materialize_dataset, write_table_files
from petastorm_tpu_torch.models.moe import (MoETransformerLM, moe_aux_total, moe_drop_fractions,
                                            switch_routing)
from petastorm_tpu_torch.models.moe import _capacity as moe_capacity
from petastorm_tpu_torch.models.resnet import ResNet50
from petastorm_tpu_torch.models.transformer import next_token_loss
from petastorm_tpu_torch.ops import raw_decode
from petastorm_tpu_torch.ops.image import normalize_image
from petastorm_tpu_torch.ops.index_shuffle import epoch_round_keys, random_index_shuffle
from petastorm_tpu_torch.ops.packing import (pack_sequences, packed_next_token_loss,
                                             segment_causal_attention)
from petastorm_tpu_torch.ops.ring_attention import dense_attention, ring_attention_sharded
from petastorm_tpu_torch.ops.sharded_moe import sharded_moe_ffn
from petastorm_tpu_torch.parallel import loader as loader_module
from petastorm_tpu_torch.parallel.mesh import (PartitionSpec, initialize_distributed,
                                               make_mesh, mesh_shard_info)
from petastorm_tpu_torch.parallel.pipeline import blocks_stage_fn, make_pipeline, microbatch
from petastorm_tpu_torch.predicates import in_pseudorandom_split
from petastorm_tpu_torch.pytorch import DataLoader, InMemBatchedDataLoader
from petastorm_tpu_torch.selectors import SingleIndexSelector
from petastorm_tpu_torch.telemetry import registry as telemetry_registry
from petastorm_tpu_torch.telemetry import tracing as telemetry_tracing
from petastorm_tpu_torch.telemetry.analyze import attribute_bottleneck
from petastorm_tpu_torch.unischema import Unischema, UnischemaField
from petastorm_tpu_torch.workers.process_pool import ProcessPool
from petastorm_tpu_torch.workers.shm_ring import SHM_DIR

# the module, not the function the ops package exports under the same name
flash = importlib.import_module('petastorm_tpu_torch.ops.flash_attention')

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


def cuda_ms(fn, reps=20, runs=3, warmup=3):
    """Milliseconds a call of ``fn`` on the card: ``reps`` back-to-back calls
    between one pair of CUDA events, divided by ``reps``, after ``warmup``
    calls; the median of ``runs`` such runs. A call's host work (the
    wrapper's checks and launch) overlaps the card's work on the calls queued
    before it, so a sub-millisecond kernel is timed without it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
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

#: the large K1 shape: 128 containers of a float32 (131072,) field, 64 MiB
#: inflated (more than the H100's 50 MB L2), each frame several stored blocks
K1_LARGE_LEN = 131072
#: bytes between the rows of the spread-out tables of the offset sweep
K1_GAP = 5


def stored_plan(frames):
    """(source on the card, host table, the table on the card, inflated
    length, host milliseconds of the planning) of a batch as the decode
    tail plans it on the loader's producer thread: the table skips each
    frame's npy header and writes the payloads as a dense matrix. The time
    is the median of 20 plans on the host's clock."""
    planned, plan_time_ms = plan_ms(frames)
    check(planned is not None, 'the decode tail did not plan the batch for K1')
    src, segs, n, row_bytes, _, _ = planned
    return (torch.from_numpy(src).to('cuda'), segs, torch.from_numpy(segs).to('cuda'),
            n * row_bytes, plan_time_ms)


def fill_allocator(nbytes):
    """Leave ``nbytes`` of 0xAB in the caching allocator's free block that
    the next allocation of that size takes; returns its address."""
    filler = torch.full((nbytes,), 0xAB, dtype=torch.uint8, device='cuda')
    address = filler.data_ptr()
    del filler
    return address


def k1_check(name, src, segs, out_len, device_segments=None):
    """K1 (through its wrapper) against its plain version, bit for bit, on an
    output whose memory held 0xAB: gaps must come out 0, not left over. With
    the table on the card the wrapper allocates nothing before the output,
    which must then take the 0xAB block; when the wrapper uploads the table
    itself, the upload may take that block first."""
    address = fill_allocator(out_len)
    got = raw_decode.stored_inflate(src, segs, out_len, device_segments=device_segments)
    want = raw_decode.stored_inflate_plain(src, segs, out_len)
    torch.cuda.synchronize()
    reused = got.data_ptr() == address
    check(reused or device_segments is None,
          'K1 {}: the output did not reuse the 0xAB block'.format(name))
    err = int((got.int() - want.int()).abs().max()) if out_len else 0
    check(got.shape == want.shape and err == 0 and torch.equal(got, want),
          'K1 differs from its plain version on the {} batch'.format(name))
    return {'src_bytes': int(src.numel()), 'segments': int(segs.shape[0]),
            'out_bytes': out_len, 'max_abs_err': err, 'over_0xab': reused}


def spread(segs, offset, gap):
    """The table with its sources moved ``offset`` bytes on and ``gap`` bytes
    left before each row's destination (and after the last)."""
    moved = segs.astype(np.int64)
    moved[:, 0] += offset
    moved[:, 1] += gap * np.arange(1, len(segs) + 1)
    return moved.astype(np.int32)


def device_ms(launch, reps, runs=3):
    """Device milliseconds per call of ``launch``: ``reps`` calls between one
    pair of CUDA events, queued behind a spin of the card
    (``torch.cuda._sleep``) that outlasts the host's issue of all of them,
    so the card runs them back to back with no wait on the host; the median
    of ``runs``. A run whose issue outlasted its spin is dropped and the spin
    doubled."""
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 10 ** 7
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    ms_per_cycle = start.elapsed_time(end) / cycles
    spin_ms = 2.0
    times = []
    for _ in range(runs + 6):
        torch.cuda._sleep(int(spin_ms / ms_per_cycle))
        start.record()
        issue_t = time.perf_counter()
        for _ in range(reps):
            launch()
        issue_ms = (time.perf_counter() - issue_t) * 1e3
        end.record()
        end.synchronize()
        if issue_ms < spin_ms:
            times.append(start.elapsed_time(end) / reps)
            if len(times) == runs:
                return statistics.median(times)
        else:
            spin_ms *= 2
    raise RuntimeError('check failed: the host issued {} launches in {:.3f} ms, longer than '
                       'the {:.3f} ms spin ahead of them'.format(reps, issue_ms, spin_ms / 2))


def k1_kernel_ms(src, segs, device_segments, out_len, reps):
    """Device time of K1 alone (the C entry point, no wrapper), with the
    source and the table resident on the card; checks the last launch's
    output against the wrapper's."""
    kernel = cuda_build.load('stored_copy')
    out = torch.empty(out_len, dtype=torch.uint8, device='cuda')
    stream = torch.cuda.current_stream().cuda_stream
    args = (src.data_ptr(), device_segments.data_ptr(), int(device_segments.shape[0]),
            out.data_ptr(), out_len, stream)

    def launch():
        status = kernel(*args)
        if status:
            raise RuntimeError('stored_copy launch failed: cudaError {}'.format(status))

    ms = device_ms(launch, reps)
    want = raw_decode.stored_inflate(src, segs, out_len, device_segments=device_segments)
    check(torch.equal(out, want), 'K1 timed launches wrote another output')
    return ms


def k1_bound_ms(segs, out_len):
    """The least time of K1's work: the table and the payload bytes its rows
    name, read once (block and npy headers no row covers are never read),
    and every output byte written once."""
    moved = int(segs[:, 2].astype(np.int64).sum()) + segs.nbytes + out_len
    return moved / HBM_BYTES_PER_S * 1e3, moved


def phase_k1(batch, seed):
    """K1 against its plain version, bit for bit, on outputs whose memory held
    0xAB: an edge-case batch (a 70000-byte frame spanning several stored
    blocks, 0- and 1-byte frames) with its table on the card and again
    uploaded by the wrapper, the main path's batch (``batch`` containers of
    a float32 (2048,) embedding) and the large one (``batch`` of a float32
    (131072,) field) with the table on the card as the decode tail has it,
    and the edge batch at source offsets 0-15 with gaps between its rows. Then times: at the
    main shape K1's device time (``kernel_ms``), the wrapper as ``finish``
    calls it (``wrapper_ms``), the plain version, and one strided ``copy_``
    that computes the same output for this one-block-per-frame layout
    (``library_ms``); at the large shape K1's device time and a
    device-to-device ``copy_`` of the output's byte count; at both, the
    host time of the decode tail's planning of the batch."""
    main_frames = stored_frames(EMBED_LEN, batch, seed, lambda i: embedding_of(i, seed))
    rng = np.random.RandomState(seed)
    edge_frames = list(main_frames[:3])
    for size in (70000, 0, 1, 1024):
        comp = zlib.compressobj(0, zlib.DEFLATED, -15)
        edge_frames.append(np.frombuffer(comp.compress(rng.randint(
            0, 256, size, dtype=np.uint8).tobytes()) + comp.flush(), dtype=np.uint8))
    result = {}
    edge_segs, edge_lengths = raw_decode.plan_stored_batch(edge_frames)
    edge_src = np.concatenate(edge_frames)
    edge_src = torch.from_numpy(edge_src).to('cuda')
    result['edge'] = k1_check('edge', edge_src, edge_segs, sum(edge_lengths),
                              torch.from_numpy(edge_segs).to('cuda'))
    result['edge_host_table'] = k1_check('edge, table uploaded by the wrapper', edge_src,
                                         edge_segs, sum(edge_lengths))
    sweep = []
    for offset in range(16):
        src = torch.cat([torch.full((offset,), 0xAB, dtype=torch.uint8, device='cuda'),
                         edge_src])
        segs = spread(edge_segs, offset, K1_GAP)
        out_len = sum(edge_lengths) + K1_GAP * (len(segs) + 1)
        sweep.append(k1_check('offset {}'.format(offset), src, segs, out_len,
                              torch.from_numpy(segs).to('cuda')))
    result['offset_sweep'] = {'offsets': 16, 'gap': K1_GAP,
                              'max_abs_err': max(case['max_abs_err'] for case in sweep)}

    src, segs, dev_segs, out_len, plan_ms = stored_plan(main_frames)
    result['main'] = k1_check('main', src, segs, out_len, dev_segs)
    result['main']['host_plan_ms'] = plan_ms
    # the strided copy of one call: frame i's payload starts at i * frame_len
    # + the first row's source offset (its one block header and npy header)
    frame_len = main_frames[0].size
    check(all(f.size == frame_len for f in main_frames) and len(segs) == batch,
          'the main batch is not one stored block per frame')
    row_bytes = out_len // batch
    strided = src.as_strided((batch, row_bytes), (frame_len, 1), int(segs[0, 0]))
    library_out = torch.empty(batch, row_bytes, dtype=torch.uint8, device='cuda')
    library_out.copy_(strided)
    check(torch.equal(library_out.view(-1), raw_decode.stored_inflate_plain(src, segs, out_len)),
          'the strided copy differs from the plain version')
    bound_ms, moved = k1_bound_ms(segs, out_len)
    result['main'].update(
        kernel_ms=k1_kernel_ms(src, segs, dev_segs, out_len, reps=100),
        wrapper_ms=cuda_ms(lambda: raw_decode.stored_inflate(src, segs, out_len,
                                                             device_segments=dev_segs)),
        plain_ms=cuda_ms(lambda: raw_decode.stored_inflate_plain(src, segs, out_len)),
        library_ms=cuda_ms(lambda: library_out.copy_(strided)),
        bound_ms=bound_ms, bound_by='bytes', bytes_moved=moved)
    del library_out, strided

    src, segs, dev_segs, out_len, plan_ms = stored_plan(
        stored_frames(K1_LARGE_LEN, batch, seed + 1))
    result['large'] = k1_check('large', src, segs, out_len, dev_segs)
    result['large']['host_plan_ms'] = plan_ms
    bound_ms, moved = k1_bound_ms(segs, out_len)
    copy_out = torch.empty(out_len, dtype=torch.uint8, device='cuda')
    result['large'].update(
        kernel_ms=k1_kernel_ms(src, segs, dev_segs, out_len, reps=20),
        memcpy_ms=cuda_ms(lambda: copy_out.copy_(src[:out_len])),
        bound_ms=bound_ms, bound_by='bytes', bytes_moved=moved)
    result['large']['bound_share'] = bound_ms / result['large']['kernel_ms']
    return result


def phase_main_path(url, args, reader_pool=None, inspect=None, factory=make_reader,
                    loader_kwargs=None):
    """One epoch of the main path; returns its measurements and the (idx,
    label, embedding) it delivered. The reader (``factory``: ``make_reader``,
    or ``make_batch_reader`` for phase 16c) runs on a thread pool of
    ``args.workers``, or on ``reader_pool``; the loader gets
    ``loader_kwargs`` too; ``inspect(reader, loader)`` runs once the first
    batch arrived. ``first_batch_s`` is the time from the reader's
    construction (a process pool's spawn included) to the first batch."""
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
    reset_counts()
    open_start = time.perf_counter()
    first_batch_s = None
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')   # make_batch_reader on a Unischema store
        reader = factory(url, reader_pool_type='thread', workers_count=args.workers,
                         reader_pool=reader_pool, seed=args.seed,
                         device_decode_fields=['image', 'embedding'])
    with reader:
        loader = TorchDataLoader(reader, batch_size=args.batch,
                                 device_transforms={'image': transform},
                                 **(loader_kwargs or {}))
        start = time.perf_counter()
        for batch in loader:
            step_start = time.perf_counter()
            if first_batch_s is None:
                first_batch_s = step_start - open_start
                if inspect is not None:
                    inspect(reader, loader)
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
        counts = read_counts()
        stats = loader.stats.as_dict()
        diagnostics = reader.diagnostics
        items_per_epoch = reader.items_per_epoch
    launches = counts['stored_copy']
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
            'losses': losses, 'k1_launches': launches, 'counts': counts,
            'first_batch_s': first_batch_s, 'items_per_epoch': items_per_epoch,
            'diagnostics': diagnostics}, delivered


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


# ------------------------------------------------------- flash attention kernels

#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet), the bound of the
#: compute-bound flash kernels
PEAK_BF16_FLOPS = 989e12
#: matrix products each flash kernel does per attending (q, k) pair
FLASH_PRODUCTS = {'fwd': 2, 'dq': 3, 'dkv': 4}
LM = dict(vocab=256, embed=512, heads=4, layers=4, max_len=8192)
LM_ROWS = 64
LM_BATCH = 2
LM_STEPS = 8
PACKED_STEPS = 4
#: the LM path's first-batch loss and gradient norm, kernels against plain
#: dense attention: relative tolerances, four or more times the largest
#: errors measured on an H100 (loss 1.1e-5; gradient norm 5.7e-5, twice the
#: 2.8e-5 measured before the bf16 kernels rounded P and dS to bf16 before
#: their second product). Dense attention computes in fp32 from the same bf16
#: model; the
#: two also differ by summation order, and where that rounds an attention
#: output or gradient to the neighbouring bf16 value.
LM_LOSS_RTOL = 5e-5
LM_GRAD_NORM_RTOL = 2.5e-4


def attending_pairs(bh, t, causal, segments, heads):
    """(q, k) pairs that attend, summed over the B * H rows: the work the
    kernels' data needs."""
    if segments is None:
        return bh * (t * (t + 1) // 2 if causal else t * t)
    total = 0
    for row in segments.cpu().numpy():
        _, counts = np.unique(row[row > 0], return_counts=True)
        total += int((counts * (counts + 1) // 2).sum()) if causal else int((counts ** 2).sum())
    return total * heads


def flash_bounds(bh, t, d, causal, segments, heads, elem):
    """{kernel: (bound_ms, bound_by)} at this shape: the larger of the FLOPs of
    the attending pairs at the bf16 peak and the bytes (each input read once,
    each output written once) at the memory rate."""
    pairs = attending_pairs(bh, t, causal, segments, heads)
    matrix = bh * t * d * elem
    rows = bh * t * 4
    seg_bytes = 0 if segments is None else segments.numel() * 4
    moved = {'fwd': 4 * matrix + rows + seg_bytes,
             'dq': 5 * matrix + 2 * rows + seg_bytes,
             'dkv': 6 * matrix + 2 * rows + seg_bytes}
    out = {}
    for name, products in FLASH_PRODUCTS.items():
        flop_ms = products * 2 * d * pairs / PEAK_BF16_FLOPS * 1e3
        byte_ms = moved[name] / HBM_BYTES_PER_S * 1e3
        out[name] = ((flop_ms, 'operations') if flop_ms >= byte_ms else (byte_ms, 'bytes'))
    return out


def short_segments(b, t, seed):
    """[B, T] int32 segments of many short documents (1-40 tokens) with
    padding runs inside and at the end of each row."""
    rng = np.random.RandomState(seed)
    seg = np.zeros((b, t), dtype=np.int32)
    for row in range(b):
        pos, ident = 0, 1
        while pos < t - 16:
            n = int(rng.randint(1, 41))
            if rng.rand() < 0.15:
                pos += n           # a padding run
                continue
            seg[row, pos:pos + n] = ident
            ident += 1
            pos += n
    return torch.from_numpy(seg).to('cuda')


def packed_segments(b, t, seed):
    """[B, T] int32 segments of the packed path: documents of 256-4096 tokens
    packed into T-token bins."""
    docs = ragged_documents(48, 256, 4096, 256, seed)
    return torch.from_numpy(pack_sequences(docs, t)['segments'][:b]).to('cuda')


def flash_outputs(b, t, h, d, causal, dtype, segments, seed, key_segments=None):
    """K2, K3 and K4 and what they are held against on the same inputs
    (``flash_reference``): a list of (kernel, output, got, want, bound)."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(b * h, t, d, generator=gen).to('cuda', dtype)
                   for _ in range(4))
    mode = (causal, segments, h, key_segments)
    want, bound, lse_ref, delta = flash.flash_reference(q, k, v, do, *mode)
    o, lse = flash.flash_forward(q, k, v, *mode)
    dq = flash.flash_bwd_dq(q, k, v, do, lse_ref, delta, *mode)
    dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse_ref, delta, *mode)
    torch.cuda.synchronize()
    return [(kernel, label, got, want[label], bound.get(label))
            for kernel, label, got in (('fwd', 'o', o), ('fwd', 'lse', lse), ('dq', 'dq', dq),
                                       ('dkv', 'dk', dk), ('dkv', 'dv', dv))]


def flash_cases(seed):
    """name -> (B, T, H, D, causal, dtype, segments[, key segments]): five
    modes at a small shape (the fifth, the keys' segment ids apart from the
    queries', is what a ring's off-diagonal blocks run); causal,
    segmented-causal and key segments also at the LM path's shape, which is
    phase 14c's ring shape."""
    heads = LM['heads']
    d = LM['embed'] // heads
    t_main = LM['max_len']
    bf16 = torch.bfloat16
    return {
        'causal': (2, 320, 2, 128, True, bf16, None),
        'causal_f32': (2, 320, 2, 128, True, torch.float32, None),
        'noncausal': (2, 320, 2, 128, False, bf16, None),
        'segmented_causal': (2, 320, 2, 128, True, bf16, short_segments(2, 320, seed)),
        'key_segments': (2, 320, 2, 128, False, bf16, short_segments(2, 320, seed + 1),
                         short_segments(2, 320, seed + 2)),
        'key_segments_f32': (2, 320, 2, 64, False, torch.float32,
                             short_segments(2, 320, seed + 3), short_segments(2, 320, seed + 4)),
        'd64_ragged_t': (2, 200, 4, 64, True, bf16, None),
        'd64_ragged_t_noncausal': (1, 77, 2, 64, False, bf16, None),
        'causal_main': (LM_BATCH, t_main, heads, d, True, bf16, None),
        'segmented_causal_main': (LM_BATCH, t_main, heads, d, True, bf16,
                                  packed_segments(LM_BATCH, t_main, seed)),
        'key_segments_main': (LM_BATCH, t_main, heads, d, False, bf16,
                              packed_segments(LM_BATCH, t_main, seed + 5),
                              packed_segments(LM_BATCH, t_main, seed + 6)),
    }


def flash_case(name, b, t, h, d, causal, dtype, segments, key_segments=None, seed=0):
    """Each of K2, K3 and K4 against its plain version on the same inputs,
    element by element and in norm (``flash.flash_compare``, with the
    allowance for the bf16 kernels' rounding of P and dS); returns the case's
    errors."""
    result = {'shape': [b * h, t, d], 'causal': causal, 'dtype': str(dtype),
              'segmented': segments is not None, 'key_segments': key_segments is not None}
    for kernel, label, got, want, bound in flash_outputs(b, t, h, d, causal, dtype, segments,
                                                         seed, key_segments):
        check(bool(torch.isfinite(got.float()).all()),
              'flash {} {}: non-finite {}'.format(name, kernel, label))
        result[label] = flash.flash_compare(got, want, bound)
        check(result[label]['ok'], 'flash {} {}: {} differs from the plain version: {}'.format(
            name, kernel, label, result[label]))
    return result


def phase_flash(seed):
    """K2-K4 against their plain versions in five modes at a small shape and
    three (causal, segmented-causal, key segments) at the LM path's shape;
    then times at the LM path's shape."""
    result = {'cases': {}}
    for index, (name, args) in enumerate(flash_cases(seed).items()):
        result['cases'][name] = flash_case(name, *args, seed=seed + index)
    # times at the LM path's shape, causal, bf16
    heads = LM['heads']
    d = LM['embed'] // heads
    t_main = LM['max_len']
    bh = LM_BATCH * heads
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(bh, t_main, d, generator=gen).to('cuda', torch.bfloat16)
                   for _ in range(4))
    o, lse = flash.flash_forward_plain(q, k, v, True)
    delta = (do.float() * o.float()).sum(dim=-1)
    timing = {
        'fwd': (lambda: flash.flash_forward(q, k, v, True),
                lambda: flash.flash_forward_plain(q, k, v, True)),
        'dq': (lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta, True),
               lambda: flash.flash_bwd_dq_plain(q, k, v, do, lse, delta, True)),
        'dkv': (lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta, True),
                lambda: flash.flash_bwd_dkv_plain(q, k, v, do, lse, delta, True)),
    }
    bounds = flash_bounds(bh, t_main, d, True, None, heads, 2)
    # the yardstick: one PyTorch call computing the same function,
    # scaled_dot_product_attention in [B, H, T, D]; never called by the port
    qs, ks, vs = (x.view(LM_BATCH, heads, t_main, d).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    grad = do.view(LM_BATCH, heads, t_main, d)
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), grad, retain_graph=True))
    library = {'fwd': sdpa_fwd, 'dq': sdpa_bwd, 'dkv': sdpa_bwd}
    result['timing'] = {}
    for name, (kernel_fn, plain_fn) in timing.items():
        result['timing'][name] = {
            'ms': cuda_ms(kernel_fn),
            'plain_ms': cuda_ms(plain_fn, reps=5),
            'bound_ms': bounds[name][0], 'bound_by': bounds[name][1],
            'library_ms': library[name]}
    result['timing_shape'] = [bh, t_main, d]
    return result


def flash_errors(flash_result, labels):
    return max(case[label]['max_abs_err'] for case in flash_result['cases'].values()
               for label in labels)


# ------------------------------------------------------------- the LM path

def reset_counts():
    """Set every kernel's launch count, and the dense-fallback count, to 0."""
    raw_decode.stored_inflate.launches = 0
    for name in flash.flash_attention.launches:
        flash.flash_attention.launches[name] = 0
    flash.dense_fallbacks = 0


def read_counts():
    """Every kernel's launch count and the dense-fallback count."""
    return {'stored_copy': raw_decode.stored_inflate.launches,
            **flash.flash_attention.launches, 'dense_fallbacks': flash.dense_fallbacks}


def causal_flash(q, k, v):
    return flash.flash_attention(q, k, v, causal=True)


def causal_dense(q, k, v):
    return dense_attention(q, k, v, causal=True)


def loss_and_grad_norm(model, loss_fn):
    model.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    norm = torch.sqrt(sum((p.grad.float() ** 2).sum() for p in model.parameters()))
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), float(norm)


def first_batch_parity(model, loss_with):
    """The first batch's loss and gradient norm with the kernels and with
    plain dense attention, outside any counted run."""
    kernel_loss, kernel_norm = loss_and_grad_norm(model, lambda: loss_with(True))
    plain_loss, plain_norm = loss_and_grad_norm(model, lambda: loss_with(False))
    torch.cuda.synchronize()
    result = {'loss': kernel_loss, 'plain_loss': plain_loss, 'grad_norm': kernel_norm,
              'plain_grad_norm': plain_norm,
              'loss_rel_err': abs(kernel_loss - plain_loss) / abs(plain_loss),
              'grad_norm_rel_err': abs(kernel_norm - plain_norm) / abs(plain_norm),
              'loss_rtol': LM_LOSS_RTOL, 'grad_norm_rtol': LM_GRAD_NORM_RTOL}
    check(np.isfinite([kernel_loss, plain_loss, kernel_norm, plain_norm]).all(),
          'non-finite first-batch loss or gradient norm {}'.format(result))
    check(result['loss_rel_err'] <= LM_LOSS_RTOL
          and result['grad_norm_rel_err'] <= LM_GRAD_NORM_RTOL,
          'first-batch loss/gradient norm with the kernels differ from dense '
          'attention: {}'.format(result))
    return result


def train_lm(batches, optimizer, steps, step_loss):
    """``steps`` Adam steps on ``batches`` with ``step_loss(batch)``, the first
    a warm-up; returns per-step losses and times (a step's time starts after
    its batch arrived), and the wall time of the steps after the warm-up,
    their batch fetches included."""
    losses, step_s = [], []
    batches = iter(batches)
    window_start = None
    for index in range(steps):
        if index == 1:
            window_start = time.perf_counter()
        batch = next(batches)
        start = time.perf_counter()
        losses.append(adam_step(optimizer, step_loss, batch))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - start)
    return [float(x) for x in losses], step_s, time.perf_counter() - window_start


def adam_step(optimizer, step_loss, batch):
    optimizer.zero_grad(set_to_none=True)
    loss = step_loss(batch)
    loss.backward()
    optimizer.step()
    return loss.detach()


#: the tensor-core flash kernels the build must report, one per head_dim
BF16_FLASH_KERNELS = ['sm90::{}<{}>'.format(kernel, d)
                      for kernel in ('flash_fwd_kernel', 'flash_bwd_dq_kernel',
                                     'flash_bwd_dkv_kernel') for d in (64, 128)]
#: kernel-name fragments of the flash kernels in a profiler trace
FLASH_KERNEL_NAMES = {'fwd': 'flash_fwd_kernel', 'dq': 'flash_bwd_dq_kernel',
                      'dkv': 'flash_bwd_dkv_kernel'}


def device_breakdown(step):
    """One more step under ``torch.profiler``, outside the counted run: its
    wall time, the card's device time summed over its kernels, split into
    each flash kernel and everything else, the number of times each flash
    kernel ran on the card (``calls``: the trace's own events, so a CUDA
    graph replay's kernels count too), and the idle share (1 - device time /
    wall time; the profiler's own cost makes it an upper bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    device_ms = dict.fromkeys(list(FLASH_KERNEL_NAMES) + ['other'], 0.0)
    calls = dict.fromkeys(FLASH_KERNEL_NAMES, 0)
    by_kernel = {}
    for event in prof.key_averages():
        if event.device_type != DeviceType.CUDA:
            continue
        group = next((name for name, key in FLASH_KERNEL_NAMES.items() if key in event.key),
                     'other')
        device_ms[group] += event.self_device_time_total / 1e3
        if group in calls:
            calls[group] += event.count
        by_kernel[event.key[:80]] = by_kernel.get(event.key[:80], 0.0) + (
            event.self_device_time_total / 1e3)
    busy_ms = sum(device_ms.values())
    top = sorted(by_kernel.items(), key=lambda item: -item[1])[:6]
    return {'wall_ms': wall_ms, 'device_ms': device_ms, 'device_busy_ms': busy_ms,
            'idle_share': 1 - busy_ms / wall_ms, 'top_kernels_ms': dict(top),
            'calls': calls}


def lm_metrics(losses, step_s, window_s, stats, tokens_per_step, flops_per_step):
    """tokens/s over the timed window (input included); step median, model
    TFLOP/s and MFU from the steps' own times."""
    timed = step_s[1:]
    tflops, util = mfu(flops_per_step, statistics.median(timed))
    return {'steps_run': len(losses), 'timed_steps': len(timed), 'losses': losses,
            'step_ms': [x * 1e3 for x in step_s],
            'step_ms_median': statistics.median(timed) * 1e3,
            'window_s': window_s,
            'tokens_per_s': tokens_per_step * len(timed) / window_s,
            'model_tflops_per_s': tflops, 'mfu': util,
            'flops_per_step': flops_per_step,
            'peak_memory_bytes': torch.cuda.max_memory_allocated(),
            'input_stall_fraction': stats['input_stall_fraction']}


def phase_lm(tmp, seed):
    """The long-context LM path: token store -> reader -> loader ->
    TransformerLM with the flash kernels, one warm-up and LM_STEPS timed Adam
    steps."""
    path = os.path.join(tmp, 'tokens')
    write_token_store('file://' + path, LM_ROWS, LM['max_len'], n_files=2)
    torch.manual_seed(seed)
    model = TransformerLM(dtype=torch.bfloat16, attention_fn=causal_flash, **LM)
    optimizer = torch.optim.Adam(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8)
    flops = transformer_train_flops_per_step(LM_BATCH, LM['max_len'], LM['vocab'],
                                             LM['embed'], LM['layers'])
    with make_reader('file://' + path, workers_count=2, seed=seed) as reader:
        loader = TorchDataLoader(reader, batch_size=LM_BATCH, shuffling_queue_capacity=16,
                                 seed=3, drop_last=True)
        batches = iter(loader)
        first = next(batches)
        check(tuple(first['tokens'].shape) == (LM_BATCH, LM['max_len'])
              and first['tokens'].dtype == torch.int32
              and first['tokens'].device.type == 'cuda',
              'token batch shape/dtype/device')
        tokens = first['tokens']
        parity = first_batch_parity(model, lambda kernels: next_token_loss(
            model(tokens, attention_fn=causal_flash if kernels else causal_dense), tokens))
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, step_s, window_s = train_lm(
            itertools.chain([first], batches), optimizer, LM_STEPS + 1,
            lambda batch: next_token_loss(model(batch['tokens']), batch['tokens']))
        counts = read_counts()
        stats = loader.stats.as_dict()
        breakdown = device_breakdown(lambda: adam_step(
            optimizer, lambda batch: next_token_loss(model(batch['tokens']), batch['tokens']),
            first))
    launches = {name: counts[name] for name in FLASH_PRODUCTS}
    fallbacks = counts['dense_fallbacks']
    result = lm_metrics(losses, step_s, window_s, stats, LM_BATCH * LM['max_len'], flops)
    result.update(first_batch=parity, launches=launches, dense_fallbacks=fallbacks,
                  counts=counts, breakdown=breakdown)
    expected = LM['layers'] * result['steps_run']
    check(all(n == expected for n in launches.values()),
          'flash kernels launched {} times, expected {} each (layers x steps)'
          .format(launches, expected))
    check(fallbacks == 0, '{} attention calls took the dense path'.format(fallbacks))
    check(all(np.isfinite(losses)), 'non-finite LM loss {}'.format(losses))
    return result


def phase_packed(tmp, seed):
    """The packed LM path: ragged documents packed into 8192-token bins ->
    reader -> loader -> TransformerLM with the segmented flash kernels,
    positions and the packed loss, PACKED_STEPS Adam steps."""
    path = os.path.join(tmp, 'packed')
    docs = ragged_documents(48, 256, 4096, LM['vocab'], seed)
    packed = write_packed_store('file://' + path, docs, LM['max_len'])
    torch.manual_seed(seed)
    model = TransformerLM(dtype=torch.bfloat16, **LM)
    optimizer = torch.optim.Adam(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8)

    def packed_loss(batch, kernels=True):
        segments = batch['tokens_segments']
        attention = segment_causal_attention(segments, use_flash=kernels)
        logits = model(batch['tokens'], positions=batch['tokens_positions'],
                       attention_fn=attention)
        return packed_next_token_loss(logits, batch['tokens'], segments)

    with make_reader('file://' + path, workers_count=2, seed=seed) as reader:
        loader = TorchDataLoader(reader, batch_size=LM_BATCH, drop_last=True)
        batches = iter(loader)
        first = next(batches)
        check(all(tuple(first[name].shape) == (LM_BATCH, LM['max_len'])
                  for name in ('tokens', 'tokens_segments', 'tokens_positions')),
              'packed batch shapes')
        parity = first_batch_parity(model, lambda kernels: packed_loss(first, kernels))
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, step_s, window_s = train_lm(itertools.chain([first], batches), optimizer,
                                            PACKED_STEPS, packed_loss)
        counts = read_counts()
        stats = loader.stats.as_dict()
        breakdown = device_breakdown(lambda: adam_step(optimizer, packed_loss, first))
    flops = transformer_train_flops_per_step(LM_BATCH, LM['max_len'], LM['vocab'],
                                             LM['embed'], LM['layers'])
    launches = {name: counts[name] for name in FLASH_PRODUCTS}
    fallbacks = counts['dense_fallbacks']
    result = lm_metrics(losses, step_s, window_s, stats, LM_BATCH * LM['max_len'], flops)
    result.update(first_batch=parity, launches=launches, dense_fallbacks=fallbacks,
                  counts=counts, breakdown=breakdown, bins=int(len(packed['tokens'])),
                  documents=len(docs),
                  fill=float((packed['segments'] > 0).mean()))
    expected = LM['layers'] * PACKED_STEPS
    check(all(n == expected for n in launches.values()),
          'segmented flash kernels launched {} times, expected {} each'
          .format(launches, expected))
    check(fallbacks == 0, '{} packed attention calls took the dense path'.format(fallbacks))
    check(all(np.isfinite(losses)), 'non-finite packed loss {}'.format(losses))
    return result

# ----------------------------------------- resumable packed LM from plain Parquet

#: phase 11: rowgroups of the ragged store, each two full bins (one batch)
RESUME_ROWGROUPS = 16
#: steps of the uninterrupted run (the whole epoch), and where the other stops
RESUME_STEPS = 16
RESUME_SPLIT = 8
#: resumed against uninterrupted losses, relative: one bf16 unit (2^-8). The
#: same kernels run on the same batches from the same weights and optimizer
#: state, so they should agree to the bit; torch's embedding and gather
#: backwards add with atomics on the card, and a different order of those
#: float32 sums can move an Adam update by a rounding and round a bf16
#: activation to its neighbour a step later.
RESUME_LOSS_RTOL = 2 ** -8


def resume_loader(url, seed, workers_count, resume_state=None):
    """Phase 11's read path. The bit-for-bit check reads with one worker
    thread: a pool of two hands its results over in the order they finish,
    so only one worker repeats the batch order from run to run."""
    return make_torch_loader(url, batch_size=LM_BATCH, batched=True,
                             transform_spec=make_packing_transform('tokens', LM['max_len']),
                             seed=seed, shuffle_row_groups=True, num_epochs=1,
                             workers_count=workers_count, resume_state=resume_state,
                             loader_kwargs={'shuffling_queue_capacity': 0})


def resume_model(seed):
    torch.manual_seed(seed)
    model = TransformerLM(dtype=torch.bfloat16, **LM)
    return model, torch.optim.Adam(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8)


def packed_step_loss(model):
    def step_loss(batch):
        segments = batch['tokens_segments']
        logits = model(batch['tokens'], positions=batch['tokens_positions'],
                       attention_fn=segment_causal_attention(segments, use_flash=True))
        return packed_next_token_loss(logits, batch['tokens'], segments)
    return step_loss


def state_digest(model, optimizer):
    """Per-tensor float64 sums of the parameters and Adam moments, on the card."""
    tensors = list(model.parameters()) + [value for state in optimizer.state.values()
                                          for value in state.values()
                                          if torch.is_tensor(value) and value.is_cuda]
    return torch.stack([t.double().sum() for t in tensors]).cpu()


def resume_run(model, optimizer, batches, steps):
    """``steps`` Adam steps counted from 0; per step its loss, its time (from
    the batch's arrival to the synchronize after the update) and a host copy
    of its batch, made after the last step; and the wall time of the steps
    after the first, their fetches included."""
    step_loss = packed_step_loss(model)
    losses, step_s, kept = [], [], []
    window_start = None
    reset_counts()
    for index in range(steps):
        if index == 1:
            window_start = time.perf_counter()
        batch = next(batches)
        start = time.perf_counter()
        losses.append(adam_step(optimizer, step_loss, batch))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - start)
        kept.append(batch)
    window_s = time.perf_counter() - window_start if window_start else None
    host = [{name: value.cpu().numpy() for name, value in batch.items()} for batch in kept]
    del kept
    counts = read_counts()
    launches = {name: counts[name] for name in FLASH_PRODUCTS}
    check(all(n == LM['layers'] * steps for n in launches.values()),
          'segmented flash kernels launched {} times in a run of {} steps, expected {} each'
          .format(launches, steps, LM['layers'] * steps))
    check(counts['dense_fallbacks'] == 0,
          '{} attention calls took the dense path'.format(counts['dense_fallbacks']))
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), 'non-finite loss {}'.format(losses))
    for batch in host:
        check(all(batch[name].shape == (LM_BATCH, LM['max_len'])
                  and batch[name].dtype == np.int32
                  for name in ('tokens', 'tokens_segments', 'tokens_positions'))
              and (batch['tokens_segments'] > 0).all(),
              'a packed batch is not two full int32 bins')
    fill = float(np.mean([(batch['tokens_segments'] > 0).mean() for batch in host]))
    return {'losses': losses, 'step_s': step_s, 'window_s': window_s, 'batches': host,
            'fill': fill, 'launches': launches, 'dense_fallbacks': counts['dense_fallbacks']}


def check_exhausted(batches, what):
    try:
        next(batches)
    except StopIteration:
        return
    raise RuntimeError('check failed: {} gave a batch after the epoch'.format(what))


def same_batches(got, want):
    return len(got) == len(want) and all(
        sorted(g) == sorted(w) and all(np.array_equal(g[name], w[name]) for name in w)
        for g, w in zip(got, want))


def max_rel_err(got, want):
    return max(abs(g - w) / abs(w) for g, w in zip(got, want))


def doc_ids(batches, doc_index):
    """The ``doc_id`` of every document packed into ``batches``, looked up by
    its tokens (each segment of a bin is one whole document)."""
    ids = []
    for batch in batches:
        for tokens, segments in zip(batch['tokens'], batch['tokens_segments']):
            ids.extend(doc_index[tokens[segments == s].tobytes()]
                       for s in np.unique(segments[segments > 0]))
    return ids


def first_docs(batches, doc_index):
    """Each batch's first document: the order the batches came in."""
    return [doc_ids([batch], doc_index)[0] for batch in batches]


def exactly_once_run(url, seed, doc_index, order):
    """Phase 11 with two worker threads, so items reach the loader in the
    order they finish: RESUME_SPLIT steps, the loader's position, a new
    loader resumed from it and the rest of the epoch. The documents trained
    on before the save and after the resume must be the epoch's, each once,
    and the position must name the items delivered before the save."""
    model, optimizer = resume_model(seed)
    loader = resume_loader(url, seed, workers_count=2)
    batches = iter(loader)
    first = resume_run(model, optimizer, batches, RESUME_SPLIT)
    state = loader.state_dict()
    batches.close()
    loader.stop()
    loader.join()
    with resume_loader(url, seed, workers_count=2, resume_state=state) as loader:
        batches = iter(loader)
        rest = resume_run(model, optimizer, batches, RESUME_STEPS - RESUME_SPLIT)
        check_exhausted(batches, 'the two-worker resumed run')
    before = doc_ids(first['batches'], doc_index)
    after = doc_ids(rest['batches'], doc_index)
    check(len(state['consumed_by_epoch'].get(0, [])) == RESUME_SPLIT,
          'the two-worker position names {} delivered items, expected {}'.format(
              state['consumed_by_epoch'], RESUME_SPLIT))
    check(sorted(before + after) == list(range(len(doc_index))),
          'with two workers the documents before the save ({}) and after the resume ({}) '
          'are not the epoch\'s {}, each once'.format(len(before), len(after),
                                                     len(doc_index)))
    return {'docs_before': len(before), 'docs_after': len(after),
            'out_of_order': first_docs(first['batches'] + rest['batches'], doc_index) != order,
            'launches': [first['launches'], rest['launches']]}


def phase_resume(tmp, seed):
    """Phase 11: the packed LM read through ``make_torch_loader`` from a plain
    Parquet store, interrupted after RESUME_SPLIT steps, checkpointed with the
    loader's position, restored into a new model, optimizer and loader, and
    held against the uninterrupted run; then interrupted and resumed with two
    worker threads and held to the epoch's documents, each once."""
    url = 'file://' + os.path.join(tmp, 'ragged')
    phase_start = start = time.perf_counter()
    rowgroups = full_bin_rowgroups(RESUME_ROWGROUPS, LM_BATCH, LM['max_len'], 256, 4096,
                                   LM['vocab'], seed)
    write_ragged_store(url, rowgroups, n_files=2)
    store_write_s = time.perf_counter() - start
    doc_index = {doc.tobytes(): doc_id
                 for doc_id, doc in enumerate(itertools.chain.from_iterable(rowgroups))}
    check(len(doc_index) == sum(map(len, rowgroups)), 'two documents of the store are equal')

    model, optimizer = resume_model(seed)
    with resume_loader(url, seed, workers_count=1) as loader:
        batches = iter(loader)
        whole = resume_run(model, optimizer, batches, RESUME_STEPS)
        check_exhausted(batches, 'the uninterrupted run')
        whole_stats = loader.stats.as_dict()
    del model, optimizer

    model, optimizer = resume_model(seed)
    ckpt_dir = os.path.join(tmp, 'checkpoints')
    ckpt = TrainingCheckpointer(ckpt_dir)
    loader = resume_loader(url, seed, workers_count=1)
    first = resume_run(model, optimizer, iter(loader), RESUME_SPLIT)
    saved_digest = state_digest(model, optimizer)
    torch.cuda.synchronize()
    start = time.perf_counter()
    check(ckpt.save(RESUME_SPLIT, {'model': model.state_dict(),
                                   'optimizer': optimizer.state_dict()}, loader=loader),
          'the checkpointer did not write the step')
    save_ms = (time.perf_counter() - start) * 1e3
    step_dir = os.path.join(ckpt_dir, str(RESUME_SPLIT))
    save_bytes = {name: os.path.getsize(os.path.join(step_dir, name))
                  for name in sorted(os.listdir(step_dir))}
    loader.stop()
    loader.join()
    del model, optimizer, loader
    torch.cuda.empty_cache()

    model, optimizer = resume_model(seed + 1)
    torch.cuda.synchronize()
    start = time.perf_counter()
    state, loader_state = ckpt.restore({'model': model.state_dict(),
                                        'optimizer': optimizer.state_dict()})
    model.load_state_dict(state['model'])
    optimizer.load_state_dict(state['optimizer'])
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - start) * 1e3
    del state
    check(torch.equal(state_digest(model, optimizer), saved_digest),
          'the restored model and optimizer differ from the saved ones')
    delivered = loader_state['reader']['consumed_by_epoch']
    check(len(delivered.get('0', [])) == RESUME_SPLIT,
          'the saved position names {} delivered items, expected {}'.format(
              delivered, RESUME_SPLIT))
    start = time.perf_counter()
    with resume_loader(url, seed, workers_count=1,
                       resume_state=loader_state['reader']) as loader:
        batches = iter(loader)
        head = next(batches)
        first_batch_s = time.perf_counter() - start
        rest = resume_run(model, optimizer, itertools.chain([head], batches),
                          RESUME_STEPS - RESUME_SPLIT)
        check_exhausted(batches, 'the resumed run')

    check(same_batches(first['batches'], whole['batches'][:RESUME_SPLIT]),
          'the interrupted run\'s batches differ from the uninterrupted run\'s first {}'
          .format(RESUME_SPLIT))
    check(same_batches(rest['batches'], whole['batches'][RESUME_SPLIT:]),
          'the resumed batches differ from the uninterrupted run\'s last {}'.format(
              RESUME_STEPS - RESUME_SPLIT))
    first_err = max_rel_err(first['losses'], whole['losses'][:RESUME_SPLIT])
    resumed_err = max_rel_err(rest['losses'], whole['losses'][RESUME_SPLIT:])
    check(first_err <= RESUME_LOSS_RTOL and resumed_err <= RESUME_LOSS_RTOL,
          'losses differ from the uninterrupted run by {:.3e} before and {:.3e} after the '
          'resume (limit {:.1e}): {} + {} vs {}'.format(
              first_err, resumed_err, RESUME_LOSS_RTOL, first['losses'], rest['losses'],
              whole['losses']))

    del model, optimizer
    two_workers = exactly_once_run(url, seed, doc_index,
                                   first_docs(whole['batches'], doc_index))

    timed = whole['step_s'][1:]
    tokens_per_step = LM_BATCH * LM['max_len']
    for run in (whole, first, rest):
        del run['batches']
    return {'rowgroups': RESUME_ROWGROUPS, 'steps': RESUME_STEPS, 'split': RESUME_SPLIT,
            'store_write_s': store_write_s, 'whole': whole, 'first': first, 'resumed': rest,
            'step_ms_median': statistics.median(timed) * 1e3,
            'tokens_per_s': tokens_per_step * len(timed) / whole['window_s'],
            'input_stall_fraction': whole_stats['input_stall_fraction'],
            'fill': whole['fill'], 'save_ms': save_ms, 'save_bytes': save_bytes,
            'restore_ms': restore_ms, 'first_batch_s': first_batch_s,
            'loss_rel_err_first': first_err, 'loss_rel_err_resumed': resumed_err,
            'loss_rtol': RESUME_LOSS_RTOL, 'two_workers': two_workers,
            'phase_s': time.perf_counter() - phase_start}


def resume_line(result, packed, card):
    return ('phase 11 resumable packed LM (make_torch_loader -> make_batch_reader + '
            'make_packing_transform, {} rowgroups of 2 full bins): {} steps of TransformerLM '
            '[{}x{}] bf16, segmented kernels: step_ms(median)={:.2f} tokens/s={:.1f} '
            'input_stall_fraction={:.4f} fill={:.4f}, beside phase 8 (write_packed_store): '
            'step_ms(median)={:.2f} tokens/s={:.1f} fill={:.4f} [{}]; save at step {}: '
            '{:.1f} ms, {} bytes ({}) [{}]; restore {:.1f} ms [{}]; resumed reader\'s first '
            'batch {:.3f} s [{}]; resumed batches equal the uninterrupted run\'s last {} bit '
            'for bit, none after; losses max rel err {:.3e} before / {:.3e} after the resume '
            '(limit {:.1e}); launches {} / {} / {} (uninterrupted / first / resumed half), '
            'dense_fallbacks 0; two workers: {} documents before the save + {} after the '
            'resume = the epoch\'s, each once (batch order {} the one-worker run\'s), '
            'launches {} / {}; the phase took {:.1f} s, its store written in {:.2f} s '
            '[{}]'.format(
                result['rowgroups'], result['steps'], LM_BATCH, LM['max_len'],
                result['step_ms_median'], result['tokens_per_s'],
                result['input_stall_fraction'], result['fill'], packed['step_ms_median'],
                packed['tokens_per_s'], packed['fill'], card, result['split'],
                result['save_ms'], sum(result['save_bytes'].values()), result['save_bytes'],
                card, result['restore_ms'], card, result['first_batch_s'], card,
                result['steps'] - result['split'], result['loss_rel_err_first'],
                result['loss_rel_err_resumed'], result['loss_rtol'],
                result['whole']['launches'], result['first']['launches'],
                result['resumed']['launches'], result['two_workers']['docs_before'],
                result['two_workers']['docs_after'],
                'differs from' if result['two_workers']['out_of_order'] else 'equals',
                *result['two_workers']['launches'], result['phase_s'], result['store_write_s'],
                card))

# ------------------------------------------------- whole programs on CUDA graphs

#: the MNIST in-memory configuration of bench.py (bench.py:782-842)
MNIST_ROWS = 50000
MNIST_BATCH = 2048
MNIST_EPOCHS = 7
MNIST_FLOOR_RUNS = 3
MNIST_CHUNK = 8
#: graph against eager losses of the same batches from the same weights,
#: relative: one bf16 unit (2^-8). The same kernels run on the same inputs,
#: so the two should agree to the bit; a convolution algorithm that cuDNN
#: picks otherwise on the capture stream may round a bf16 activation to its
#: neighbour.
MNIST_LOSS_RTOL = 2 ** -8
LM_GRAPH_CHUNK = 8
#: the device the graph phases' eager references upload to
CARD = 'cuda'


def mnist_step(model, optimizer):
    """bench.py's MNIST train step (bench.py:693-705): normalize to bf16,
    softmax cross-entropy with integer labels, SGD."""
    def step(batch):
        images = normalize_image(batch['image'][..., None], mean=[0.1307], std=[0.3081],
                                 dtype=torch.bfloat16)
        loss = F.cross_entropy(model(images), batch['digit'])
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()
    return step


def mnist_model(seed):
    """(model, SGD, its eager twin from the same weights, the twin's SGD)."""
    torch.manual_seed(seed)
    model = MnistCNN()
    twin = copy.deepcopy(model)
    return (model, torch.optim.SGD(model.parameters(), lr=0.01), twin,
            torch.optim.SGD(twin.parameters(), lr=0.01))


def loss_agreement(graph, eager, rtol):
    """Step-by-step relative error of the graph's losses against the eager
    run's; fails beyond ``rtol``."""
    graph = np.asarray([float(x) for x in graph], dtype=np.float64)
    eager = np.asarray([float(x) for x in eager], dtype=np.float64)
    check(graph.shape == eager.shape and graph.size > 0, 'graph ran {} steps, eager {}'.format(
        graph.size, eager.size))
    check(np.isfinite(graph).all() and np.isfinite(eager).all(), 'non-finite losses')
    err = float(np.max(np.abs(graph - eager) / np.abs(eager)))
    result = {'steps': int(graph.size), 'max_rel_err': err, 'rtol': rtol,
              'graph': graph.tolist(), 'eager': eager.tolist()}
    check(err <= rtol, 'graph losses differ from the eager run of the same batches: {}'
          .format(result))
    return result


def check_permutation(index, n):
    check(index is not None and index.numel() == n and bool(torch.equal(
        torch.sort(index).values, torch.arange(n, device=index.device))),
        'an epoch\'s index vector is not a permutation of [0, {})'.format(n))


def timed(fn):
    """(result, seconds): ``fn()`` on the host clock; ``fn`` ends in a readback."""
    start = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - start


def phase_mnist_inmem(tmp, seed):
    """bench.py's headline on the card: make_reader -> InMemTorchLoader ->
    MnistCNN (bf16) with scan_epochs: a warm-up epoch (fill, upload, capture),
    the sequential floor (median of MNIST_FLOOR_RUNS), then MNIST_EPOCHS
    shuffled epochs, each timed to a host readback of its last loss."""
    url = 'file://' + os.path.join(tmp, 'mnist')
    start = time.perf_counter()
    write_mnist_store(url, MNIST_ROWS, n_files=4, rowgroup_size_mb=8, seed=seed)
    store_write_s = time.perf_counter() - start
    model, optimizer, twin, twin_opt = mnist_model(seed)
    step = mnist_step(model, optimizer)
    state = (model, optimizer)
    torch.cuda.reset_peak_memory_stats()
    fill_start = time.perf_counter()
    reader = make_reader(url, workers_count=4, shuffle_row_groups=True, seed=42, num_epochs=1)
    loader = InMemTorchLoader(reader, batch_size=MNIST_BATCH, num_epochs=None, shuffle=True,
                              seed=7)
    fill_s = time.perf_counter() - fill_start
    batches = len(loader)
    rows = batches * MNIST_BATCH
    (first,) = loader.scan_epochs(step, state=state)
    first = first.tolist()
    fill_epoch_s = time.perf_counter() - fill_start
    check_permutation(loader._index, loader.num_rows)
    (program,) = loader._scan_cache.programs()
    # the eager twin on the same batches (the iterator's epoch 0 is scan's)
    twin_step = mnist_step(twin, twin_opt)
    eager = [twin_step(batch) for batch, _ in zip(loader, range(batches))]
    agreement = loss_agreement(first, eager, MNIST_LOSS_RTOL)

    def epoch(shuffle=None):
        return float(loader.scan_epochs(step, shuffle=shuffle, state=state)[0][-1])

    epoch(shuffle=False)   # the sequential program's capture
    floor = [timed(lambda: epoch(shuffle=False))[1] for _ in range(MNIST_FLOOR_RUNS)]
    floor_s = statistics.median(floor)
    epochs = []
    for _ in range(MNIST_EPOCHS):
        last, elapsed = timed(epoch)
        check_permutation(loader._index, loader.num_rows)
        check(np.isfinite(last), 'non-finite loss {}'.format(last))
        epochs.append({'s': elapsed, 'rows_per_s': rows / elapsed,
                       'input_overhead': max(0.0, 1.0 - floor_s / elapsed), 'last_loss': last})
    eager_rows_per_s = rows / timed(lambda: float(torch.stack(
        [twin_step(batch) for batch, _ in zip(loader, range(batches))])[-1]))[1]
    keys = epoch_round_keys(7, 1000)
    positions = torch.arange(loader.num_rows, device=loader.device)
    j4_ms = cuda_ms(lambda: random_index_shuffle(positions, keys, loader.num_rows), reps=10)
    j4 = device_breakdown(lambda: random_index_shuffle(positions, keys, loader.num_rows))
    graph_epoch = device_breakdown(epoch)
    eager_epoch = device_breakdown(lambda: float(torch.stack(
        [twin_step(batch) for batch, _ in zip(loader, range(batches))])[-1]))
    sequential = loader._scan_cache.programs()[1]
    return {'rows': rows, 'batches_per_epoch': batches, 'store_write_s': store_write_s,
            'fill_s': fill_s, 'fill_epoch_s': fill_epoch_s, 'capture_s': program.capture_s,
            'floor_capture_s': sequential.capture_s,
            'floor_s': floor, 'floor_median_s': floor_s, 'epochs': epochs,
            'rows_per_s': statistics.median(e['rows_per_s'] for e in epochs),
            'input_overhead': statistics.median(e['input_overhead'] for e in epochs),
            'eager_rows_per_s': eager_rows_per_s, 'j4_ms': j4_ms,
            'j4_device_ms': j4['device_busy_ms'], 'graph_epoch': graph_epoch,
            'eager_epoch': eager_epoch, 'first_epoch': agreement,
            'replays': {'shuffled': program.replays, 'sequential': sequential.replays},
            'peak_memory_bytes': torch.cuda.max_memory_allocated()}


def first_chunk_batches(make, batches, batch_size, seed):
    """The first chunk as scan_stream builds it: ``batches`` batches of a
    fresh loader from ``make()`` in stream order, shuffled within the chunk
    by the numpy permutation of ``seed`` (None: not shuffled), on the card."""
    with make() as reader:
        loader = TorchDataLoader(reader, batch_size=batch_size)
        taken = [{name: t.cpu().numpy() for name, t in b.items()}
                 for b, _ in zip(loader, range(batches))]
    columns = {name: np.concatenate([b[name] for b in taken]) for name in taken[0]}
    if seed is not None:
        perm = np.random.RandomState(seed % 2 ** 31).permutation(batches * batch_size)
        columns = {name: col[perm] for name, col in columns.items()}
    return [{name: torch.from_numpy(col[i * batch_size:(i + 1) * batch_size]).to(CARD)
             for name, col in columns.items()} for i in range(batches)]


def phase_mnist_stream(tmp, seed):
    """The same store and model through TorchDataLoader.scan_stream
    (bench.py:1419-1455): chunks of MNIST_CHUNK batches, seed=epoch. First a
    pass in stream order that is deterministic (an in-line reader), whose
    first chunk is held against the eager twin; then epochs 0-7 on a thread
    pool of 4, the first a warm-up."""
    url = 'file://' + os.path.join(tmp, 'mnist')   # phase 9's store
    model, optimizer, twin, twin_opt = mnist_model(seed + 1)
    step = mnist_step(model, optimizer)

    def inline_reader():
        return make_reader(url, reader_pool_type='dummy', shuffle_row_groups=True, seed=42)

    with inline_reader() as reader:
        check_loader = TorchDataLoader(reader, batch_size=MNIST_BATCH)
        chunks = check_loader.scan_stream(step, chunk_batches=MNIST_CHUNK, seed=0,
                                          state=(model, optimizer))
    twin_step = mnist_step(twin, twin_opt)
    eager = [twin_step(batch) for batch in first_chunk_batches(
        inline_reader, MNIST_CHUNK, MNIST_BATCH, 0)]
    agreement = loss_agreement(chunks[0].tolist(), eager, MNIST_LOSS_RTOL)
    epochs = []
    with make_reader(url, workers_count=4, shuffle_row_groups=True, seed=42,
                     num_epochs=1) as reader:
        loader = TorchDataLoader(reader, batch_size=MNIST_BATCH)
        for epoch in range(MNIST_EPOCHS + 1):
            def one_pass():
                aux = loader.scan_stream(step, chunk_batches=MNIST_CHUNK, seed=epoch,
                                         state=(model, optimizer))
                float(aux[-1][-1])
                return sum(int(a.shape[0]) for a in aux) * MNIST_BATCH
            rows, elapsed = timed(one_pass)
            epochs.append({'s': elapsed, 'rows': rows, 'rows_per_s': rows / elapsed})
        programs = [entry[0] for entry in loader._scan_stream_programs.programs()]
    return {'chunk_batches': MNIST_CHUNK, 'epochs': epochs,
            'rows_per_s': statistics.median(e['rows_per_s'] for e in epochs[1:]),
            'capture_s': [p.capture_s for p in programs],
            'replays': [p.replays for p in programs], 'first_chunk': agreement}


def phase_lm_graph(tmp, seed):
    """Phase 7's store, model and Adam (capturable) through
    TorchDataLoader.scan_stream in chunks of LM_GRAPH_CHUNK steps: the first
    chunk of an in-line reader's pass held against the eager twin within
    phase 7's first-batch loss limit, then a pass on a thread pool of 2 for
    the capture and one timed pass, counted: no step may launch a kernel
    outside the graph. The graph's kernels are counted in profiler traces,
    of one replay and of one more whole pass: K2-K4 must each run
    LM['layers'] times a step in every replay."""
    path = 'file://' + os.path.join(tmp, 'tokens')   # phase 7's store
    torch.manual_seed(seed)
    model = TransformerLM(dtype=torch.bfloat16, attention_fn=causal_flash, **LM)
    twin = copy.deepcopy(model)

    def lm_step(model):
        optimizer = torch.optim.Adam(model.parameters(), lr=3e-4, betas=(0.9, 0.999),
                                     eps=1e-8, capturable=True)

        def step(batch):
            return adam_step(optimizer, lambda b: next_token_loss(model(b['tokens']),
                                                                  b['tokens']), batch)
        return step, optimizer

    step, optimizer = lm_step(model)

    def inline_reader():
        return make_reader(path, reader_pool_type='dummy', seed=seed)

    with inline_reader() as reader:
        chunks = TorchDataLoader(reader, batch_size=LM_BATCH).scan_stream(
            step, chunk_batches=LM_GRAPH_CHUNK, state=(model, optimizer))
    twin_step, _ = lm_step(twin)
    eager = [twin_step(batch) for batch in first_chunk_batches(
        inline_reader, LM_GRAPH_CHUNK, LM_BATCH, None)]
    agreement = loss_agreement(chunks[0].tolist(), eager, LM_LOSS_RTOL)
    torch.cuda.reset_peak_memory_stats()
    with make_reader(path, workers_count=2, seed=seed) as reader:
        loader = TorchDataLoader(reader, batch_size=LM_BATCH)
        loader.scan_stream(step, chunk_batches=LM_GRAPH_CHUNK, state=(model, optimizer))
        reset_counts()

        def one_pass():
            aux = loader.scan_stream(step, chunk_batches=LM_GRAPH_CHUNK,
                                     state=(model, optimizer))
            losses = torch.cat(aux).tolist()
            return losses
        losses, wall_s = timed(one_pass)
        counts = read_counts()
        ((program, _, _),) = loader._scan_stream_programs.programs()
        # replays of the last chunk, outside the counted pass: the graph alone
        replay_ms = cuda_ms(program.run, reps=2, runs=3, warmup=1)
        breakdown = device_breakdown(program.run)
        replays_before = program.replays
        traced_pass = device_breakdown(one_pass)
        pass_replays = program.replays - replays_before
    steps = len(losses)
    eager_launches = {name: counts[name] for name in FLASH_PRODUCTS}
    check(all(n == 0 for n in eager_launches.values()),
          'a graph pass launched flash kernels outside the graph: {}'.format(eager_launches))
    check(counts['dense_fallbacks'] == 0, 'attention took the dense path')
    per_replay = LM['layers'] * LM_GRAPH_CHUNK
    check(all(n == per_replay for n in breakdown['calls'].values()),
          'a profiled replay ran the flash kernels {} times, expected {} each (layers x '
          'steps)'.format(breakdown['calls'], per_replay))
    check(pass_replays * LM_GRAPH_CHUNK == steps
          and all(n == per_replay * pass_replays for n in traced_pass['calls'].values()),
          'a profiled pass of {} replays ran the flash kernels {} times, expected {} each'
          .format(pass_replays, traced_pass['calls'], per_replay * pass_replays))
    check(all(np.isfinite(losses)), 'non-finite LM loss {}'.format(losses))
    tflops, util = mfu(transformer_train_flops_per_step(
        LM_BATCH, LM['max_len'], LM['vocab'], LM['embed'], LM['layers']), wall_s / steps)
    return {'chunk_batches': LM_GRAPH_CHUNK, 'steps': steps, 'wall_s': wall_s,
            'tokens_per_s': steps * LM_BATCH * LM['max_len'] / wall_s,
            'step_ms': wall_s / steps * 1e3, 'model_tflops_per_s': tflops, 'mfu': util,
            'replay_ms': replay_ms, 'replay_step_ms': replay_ms / LM_GRAPH_CHUNK,
            'replay_tokens_per_s': LM_GRAPH_CHUNK * LM_BATCH * LM['max_len'] / replay_ms * 1e3,
            'eager_launches': eager_launches, 'traced_calls': traced_pass['calls'],
            'traced_replays': pass_replays, 'traced_calls_per_replay': breakdown['calls'],
            'capture_s': program.capture_s, 'first_chunk': agreement,
            'losses': losses, 'breakdown': breakdown, 'traced_pass': traced_pass,
            'peak_memory_bytes': torch.cuda.max_memory_allocated()}


# ------------------------------------------------- the row-space features (phase 12)

#: phase 12a: the frame store (streams, frames a stream, tokens a frame) and
#: the selected streams; a window of NGRAM_LEN frames is one LM sequence
FRAME_STREAMS = 16
FRAMES_PER_STREAM = 32
FRAME_LEN = 1024
NGRAM_LEN = LM['max_len'] // FRAME_LEN
SELECTED_STREAMS = list(range(0, FRAME_STREAMS, 2))
#: phase 12b: the train split's fractions and the cache's size cap
SPLIT = [0.8, 0.2]
CACHE_LIMIT_BYTES = 1 << 30


def check_windows(frame_ids, tokens, frames):
    """12a's delivery checks: every window (a row of ``frame_ids``) is
    NGRAM_LEN consecutive frame ids of one selected stream starting at a
    multiple of NGRAM_LEN, every such window arrives exactly once, and a
    window's tokens are its frames' tokens in order."""
    streams = frame_ids // FRAMES_PER_STREAM
    check(bool((np.diff(frame_ids, axis=1) == 1).all())
          and bool((streams == streams[:, :1]).all()),
          'a window is not {} consecutive frames of one stream'.format(NGRAM_LEN))
    odd = sorted(set(streams[:, 0].tolist()) - set(SELECTED_STREAMS))
    check(not odd, 'unselected streams {} were delivered'.format(odd))
    want = sorted(s * FRAMES_PER_STREAM + w * NGRAM_LEN for s in SELECTED_STREAMS
                  for w in range(FRAMES_PER_STREAM // NGRAM_LEN))
    check(sorted(frame_ids[:, 0].tolist()) == want,
          'the windows delivered are not each selected window once: {}'.format(
              sorted(frame_ids[:, 0].tolist())))
    check(np.array_equal(tokens, frames.reshape(-1, FRAME_LEN)[frame_ids]),
          'a window\'s tokens differ from its frames\' tokens')
    return {'windows': int(len(frame_ids)), 'streams': sorted(set(streams[:, 0].tolist()))}


def phase_ngram_lm(tmp, seed):
    """Phase 12a: a frame store -> make_reader with an NGram of NGRAM_LEN
    frames (timestamp_overlap=False) and a rowgroup selector of the even
    streams -> TorchDataLoader -> phase 7's LM on the windows reshaped to
    [LM_BATCH, max_len], one warm-up and LM_STEPS timed Adam steps, then the
    rest of the epoch read for the delivery checks."""
    url = 'file://' + os.path.join(tmp, 'frames')
    phase_start = start = time.perf_counter()
    frames = write_frame_store(url, FRAME_STREAMS, FRAMES_PER_STREAM, FRAME_LEN, LM['vocab'],
                               n_files=4, seed=seed)
    store_write_s = time.perf_counter() - start
    torch.manual_seed(seed)
    model = TransformerLM(dtype=torch.bfloat16, attention_fn=causal_flash, **LM)
    optimizer = torch.optim.Adam(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8)
    flops = transformer_train_flops_per_step(LM_BATCH, LM['max_len'], LM['vocab'],
                                             LM['embed'], LM['layers'])

    def step_loss(batch):
        tokens = batch['tokens'].reshape(LM_BATCH, LM['max_len'])
        return next_token_loss(model(tokens), tokens)

    ngram = NGram({i: ['tokens', 'frame_id'] for i in range(NGRAM_LEN)}, delta_threshold=1,
                  timestamp_field='frame_id', timestamp_overlap=False)
    delivered = []

    def recorded(batches):
        for batch in batches:
            delivered.append(batch)
            yield batch

    selector = SingleIndexSelector(FRAME_STREAM_INDEX, SELECTED_STREAMS)
    with make_reader(url, schema_fields=ngram, rowgroup_selector=selector, workers_count=2,
                     shuffle_row_groups=True, seed=7) as reader:
        loader = TorchDataLoader(reader, batch_size=LM_BATCH)
        batches = recorded(iter(loader))
        first = next(batches)
        check(tuple(first['tokens'].shape) == (LM_BATCH, NGRAM_LEN, FRAME_LEN)
              and first['tokens'].dtype == torch.int32
              and first['tokens'].device.type == 'cuda'
              and tuple(first['frame_id'].shape) == (LM_BATCH, NGRAM_LEN),
              'window batch {}'.format({k: (tuple(v.shape), v.dtype, v.device.type)
                                        for k, v in first.items()}))
        flat = first['tokens'].reshape(LM_BATCH, LM['max_len'])
        parity = first_batch_parity(model, lambda kernels: next_token_loss(
            model(flat, attention_fn=causal_flash if kernels else causal_dense), flat))
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, step_s, window_s = train_lm(itertools.chain([first], batches), optimizer,
                                            LM_STEPS + 1, step_loss)
        counts = read_counts()
        stats = loader.stats.as_dict()
        for _ in batches:   # the rest of the epoch, for the delivery checks
            pass
        breakdown = device_breakdown(lambda: adam_step(optimizer, step_loss, first))
    frame_ids = torch.cat([b['frame_id'] for b in delivered]).cpu().numpy()
    tokens = torch.cat([b['tokens'] for b in delivered]).cpu().numpy()
    delivery = check_windows(frame_ids, tokens, frames)
    launches = {name: counts[name] for name in FLASH_PRODUCTS}
    fallbacks = counts['dense_fallbacks']
    result = lm_metrics(losses, step_s, window_s, stats, LM_BATCH * LM['max_len'], flops)
    result.update(first_batch=parity, launches=launches, dense_fallbacks=fallbacks,
                  counts=counts, breakdown=breakdown, delivery=delivery,
                  store_write_s=store_write_s, phase_s=time.perf_counter() - phase_start)
    expected = LM['layers'] * result['steps_run']
    check(all(n == expected for n in launches.values()),
          'flash kernels launched {} times on the NGram path, expected {} each (layers x '
          'steps)'.format(launches, expected))
    check(fallbacks == 0, '{} attention calls took the dense path'.format(fallbacks))
    check(all(np.isfinite(losses)), 'non-finite LM loss {}'.format(losses))
    return result


def observe_items(reader):
    """Record each work item's epoch and ``idx`` values as the loader reads
    them from ``reader`` (the loader's batches do not carry the epoch)."""
    seen = {}
    inner = reader.iter_columnar

    def iter_columnar(*args, **kwargs):
        for batch in inner(*args, **kwargs):
            if batch.num_rows:
                seen.setdefault(batch.item_id[0], []).append(np.array(batch.columns['idx']))
            yield batch
    reader.iter_columnar = iter_columnar
    return seen


def split_pass(reader, loader, step):
    """One pass of ``loader`` through MnistCNN's eager step: the ``idx``
    values it delivered (sorted) and its time, rate, last loss and the
    cache's hits and misses over the pass."""
    before = reader.diagnostics
    start = time.perf_counter()
    idx, losses = [], []
    for batch in loader:
        losses.append(step(batch))
        idx.append(batch['idx'])
    last = float(losses[-1])
    elapsed = time.perf_counter() - start
    after = reader.diagnostics
    got = np.sort(torch.cat(idx).cpu().numpy())
    check(np.isfinite(last), 'non-finite loss {}'.format(last))
    return got, {'s': elapsed, 'rows': int(len(got)), 'rows_per_s': len(got) / elapsed,
                 'last_loss': last,
                 'hits': after['cache_hits'] - before['cache_hits'],
                 'misses': after['cache_misses'] - before['cache_misses']}


def phase_split_cache(tmp, seed):
    """Phase 12b: phase 9's store through make_reader with a pseudorandom
    split predicate and the local-disk cache -> TorchDataLoader -> MnistCNN's
    eager step. First one reader of ``num_epochs=2`` on 4 threads: a
    rowgroup's second-epoch read may start before its first stored the
    entry, so its checks do not depend on timing (each epoch reads exactly
    the split's ``idx`` set, each rowgroup is one hit or miss an epoch, and
    each misses at least once); its hits and misses by epoch are recorded.
    Then two passes of one ``num_epochs=1`` loader over a new cache (the
    reader resets between them): each must deliver the split's set, the
    first with a miss and the second with a hit for every rowgroup."""
    phase_start = time.perf_counter()
    url = 'file://' + os.path.join(tmp, 'mnist')   # phase 9's store
    predicate = in_pseudorandom_split(SPLIT, 0, 'idx')
    want = np.nonzero(predicate.do_include({'idx': np.arange(MNIST_ROWS)}))[0]
    model, optimizer, _, _ = mnist_model(seed + 2)
    step = mnist_step(model, optimizer)
    cache = dict(cache_type='local-disk', cache_size_limit=CACHE_LIMIT_BYTES)

    with make_reader(url, predicate=predicate, num_epochs=2, workers_count=4, seed=42,
                     cache_location=os.path.join(tmp, 'mnist_cache_epochs'),
                     **cache) as reader:
        rowgroups = reader.items_per_epoch
        seen = observe_items(reader)
        got, epochs = split_pass(reader, TorchDataLoader(reader, batch_size=MNIST_BATCH,
                                                         drop_last=False), step)
        by_epoch = reader.diagnostics['cache_by_epoch']
    check(np.array_equal(got, np.repeat(want, 2)),
          'num_epochs=2 delivered {} rows, not the split\'s {} idx values twice each'
          .format(len(got), len(want)))
    check(sorted(seen) == [0, 1] and sorted(by_epoch) == [0, 1],
          'num_epochs=2 read epochs {} and counted {}'.format(sorted(seen), sorted(by_epoch)))
    for epoch, arrays in sorted(seen.items()):
        check(np.array_equal(np.sort(np.concatenate(arrays)), want),
              'epoch {} read not the split\'s idx set each once'.format(epoch))
        counts = by_epoch[epoch]
        check(counts['hits'] + counts['misses'] == rowgroups,
              'epoch {} counted {} hits and {} misses over {} rowgroups'.format(
                  epoch, counts['hits'], counts['misses'], rowgroups))
    check(epochs['misses'] >= rowgroups,
          'only {} misses over {} rowgroups in a new cache'.format(epochs['misses'],
                                                                  rowgroups))
    epochs['by_epoch'] = {str(epoch): counts for epoch, counts in by_epoch.items()}

    cache_dir = os.path.join(tmp, 'mnist_cache')
    passes = []
    with make_reader(url, predicate=predicate, workers_count=4, seed=42,
                     cache_location=cache_dir, **cache) as reader:
        loader = TorchDataLoader(reader, batch_size=MNIST_BATCH, drop_last=False)
        for _ in range(2):
            got, one = split_pass(reader, loader, step)
            passes.append(one)
            check(np.array_equal(got, want),
                  'pass {} delivered {} rows, not the split\'s {} idx values each once'
                  .format(len(passes), len(got), len(want)))
        cache_stats = reader.diagnostics['cache']
    fill, hit = passes
    check(fill['misses'] == rowgroups and fill['hits'] == 0,
          'the filling pass had {} misses and {} hits, expected {} and 0'.format(
              fill['misses'], fill['hits'], rowgroups))
    check(hit['hits'] == rowgroups and hit['misses'] == 0,
          'the hit pass had {} hits and {} misses, expected {} and 0'.format(
              hit['hits'], hit['misses'], rowgroups))
    disk_bytes = sum(os.path.getsize(os.path.join(root, name))
                     for root, _, names in os.walk(cache_dir) for name in names)
    return {'rowgroups': rowgroups, 'split_rows': int(len(want)), 'epochs': epochs,
            'fill': fill, 'hit': hit, 'cache_disk_bytes': disk_bytes,
            'cache_stats': cache_stats, 'phase_s': time.perf_counter() - phase_start}


def ngram_line(result, lm, card):
    return ('phase 12a NGram windows (8 x {} frames, timestamp_overlap=False, streams {} '
            'by rowgroup selector) -> TorchDataLoader -> TransformerLM [{}x{}] bf16: {} steps '
            '(1 warm-up): tokens/s={:.1f} step_ms(median)={:.2f} input_stall_fraction={:.4f} '
            'losses {:.4f}->{:.4f} launches {} dense_fallbacks {}; {} windows each once from '
            'streams {}; first batch {}; one profiled step: {}; beside phase 7: '
            'tokens/s={:.1f} step_ms(median)={:.2f} input_stall_fraction={:.4f}, one '
            'profiled step: {}; the phase took {:.1f} s, its store written in {:.2f} s '
            '[{}]'.format(
                FRAME_LEN, SELECTED_STREAMS, LM_BATCH, LM['max_len'], result['steps_run'],
                result['tokens_per_s'], result['step_ms_median'],
                result['input_stall_fraction'], result['losses'][0], result['losses'][-1],
                result['launches'], result['dense_fallbacks'],
                result['delivery']['windows'], result['delivery']['streams'],
                {key: round(value, 6) for key, value in result['first_batch'].items()},
                breakdown_line(result['breakdown']), lm['tokens_per_s'],
                lm['step_ms_median'], lm['input_stall_fraction'],
                breakdown_line(lm['breakdown']), result['phase_s'], result['store_write_s'],
                card))


def split_cache_line(result, card):
    epochs, fill, hit = result['epochs'], result['fill'], result['hit']
    by_epoch = '; '.join('epoch {}: {} misses, {} hits'.format(
        epoch, counts['misses'], counts['hits'])
        for epoch, counts in sorted(epochs['by_epoch'].items()))
    return ('phase 12b in_pseudorandom_split({}, 0, idx) through the local-disk cache -> '
            'TorchDataLoader -> MnistCNN eager: {} of {} rows an epoch, {} rowgroups; '
            'num_epochs=2 rows/s={:.1f} ({:.3f} s; {}); then two passes: filling pass '
            'rows/s={:.1f} ({:.3f} s, {} misses, {} hits), hit pass rows/s={:.1f} '
            '({:.3f} s, {} hits, {} misses); cache {} bytes on disk; the phase took '
            '{:.1f} s [{}]'.format(
                SPLIT, result['split_rows'], MNIST_ROWS, result['rowgroups'],
                epochs['rows_per_s'], epochs['s'], by_epoch,
                fill['rows_per_s'], fill['s'], fill['misses'], fill['hits'],
                hit['rows_per_s'], hit['s'], hit['hits'], hit['misses'],
                result['cache_disk_bytes'], result['phase_s'], card))


def breakdown_line(breakdown):
    return 'wall {:.2f} ms, device {:.2f} ms ({}), idle share {:.4f}'.format(
        breakdown['wall_ms'], breakdown['device_busy_ms'],
        ', '.join('{} {:.2f}'.format(name, ms) for name, ms in breakdown['device_ms'].items()),
        breakdown['idle_share'])


def lm_line(phase, name, result, card):
    return ('phase {} {} path: {} steps (1 warm-up) of TransformerLM [{}x{}] bf16: '
            'tokens/s={:.1f} step_ms(median)={:.2f} model TFLOP/s={:.3f} MFU={:.5f} '
            'peak_memory={:.3f} GiB input_stall_fraction={:.4f} losses {:.4f}->{:.4f} '
            'launches {} dense_fallbacks {} first batch {}; one profiled step: {} '
            '[{}]'.format(
                phase, name, result['steps_run'], LM_BATCH, LM['max_len'],
                result['tokens_per_s'], result['step_ms_median'],
                result['model_tflops_per_s'], result['mfu'],
                result['peak_memory_bytes'] / 2 ** 30, result['input_stall_fraction'],
                result['losses'][0], result['losses'][-1], result['launches'],
                result['dense_fallbacks'],
                {key: round(value, 6) for key, value in result['first_batch'].items()},
                breakdown_line(result['breakdown']), card))


def lm_graph_line(result, eager, card):
    return ('phase 7b lm path through scan_stream (CUDA graph of {} Adam steps, '
            'capturable): one pass of {} steps: tokens/s={:.1f} step_ms={:.3f} (the '
            'pass\'s wall over its steps, the reader\'s restart included) model '
            'TFLOP/s={:.3f} MFU={:.5f}; a replay alone {:.3f} ms = {:.3f} ms a step, '
            'tokens/s={:.1f}; capture {:.3f} s; beside phase 7 eager: tokens/s={:.1f} '
            'step_ms(median)={:.2f}; launches outside the graph {}; flash kernels in the '
            'traces: {} in one replay, {} in a pass of {} replays; first chunk graph vs '
            'eager max rel err {:.3e} (limit {:.1e}); one profiled replay: {}; one '
            'profiled pass: {}; peak_memory={:.3f} GiB [{}]'.format(
                result['chunk_batches'], result['steps'], result['tokens_per_s'],
                result['step_ms'], result['model_tflops_per_s'], result['mfu'],
                result['replay_ms'], result['replay_step_ms'], result['replay_tokens_per_s'],
                result['capture_s'], eager['tokens_per_s'], eager['step_ms_median'],
                result['eager_launches'], result['traced_calls_per_replay'],
                result['traced_calls'], result['traced_replays'],
                result['first_chunk']['max_rel_err'], result['first_chunk']['rtol'],
                breakdown_line(result['breakdown']), breakdown_line(result['traced_pass']),
                result['peak_memory_bytes'] / 2 ** 30,
                card))


def mnist_inmem_line(result, card):
    return ('phase 9 MNIST in-memory (InMemTorchLoader.scan_epochs, {} rows, batch {}, '
            'MnistCNN bf16, one CUDA graph replay an epoch): rows/s={:.1f} (median of {} '
            'epochs) input_overhead={:.4f} (sequential floor {:.5f} s) fill_epoch_s={:.3f} '
            '(fill {:.3f} s, capture {:.3f} s) J4 at n={}: {:.4f} ms ({:.4f} ms of device '
            'time) eager loop rows/s={:.1f}; graph epoch {}; eager epoch {}; first epoch '
            'graph vs eager max rel err {:.3e} (limit {:.1e}) peak_memory={:.3f} GiB, '
            'store written in {:.1f} s [{}]'.format(
                result['rows'], MNIST_BATCH, result['rows_per_s'], len(result['epochs']),
                result['input_overhead'], result['floor_median_s'], result['fill_epoch_s'],
                result['fill_s'], result['capture_s'], MNIST_ROWS, result['j4_ms'],
                result['j4_device_ms'], result['eager_rows_per_s'],
                breakdown_line(result['graph_epoch']), breakdown_line(result['eager_epoch']),
                result['first_epoch']['max_rel_err'], result['first_epoch']['rtol'],
                result['peak_memory_bytes'] / 2 ** 30, result['store_write_s'], card))


def mnist_stream_line(result, card):
    return ('phase 10 MNIST through TorchDataLoader.scan_stream (chunks of {} batches, '
            'one CUDA graph replay a chunk): rows/s={:.1f} (median of epochs 1-{}), '
            'epoch 0 {:.3f} s with capture {}; first chunk graph vs eager max rel err '
            '{:.3e} (limit {:.1e}) [{}]'.format(
                result['chunk_batches'], result['rows_per_s'], MNIST_EPOCHS,
                result['epochs'][0]['s'], result['capture_s'],
                result['first_chunk']['max_rel_err'], result['first_chunk']['rtol'], card))


# ------------------------------------------------------ the process pool (phase 13)

def shm_segment_gone(pool):
    """True when the pool made a ring and its segment is no longer in /dev/shm."""
    return pool.ring_name is not None and not os.path.exists(
        os.path.join(SHM_DIR, pool.ring_name))


def machine_facts():
    """The size and free bytes of /dev/shm and os.cpu_count()."""
    stat = os.statvfs(SHM_DIR)
    return {'dev_shm_bytes': stat.f_blocks * stat.f_frsize,
            'dev_shm_free_bytes': stat.f_bavail * stat.f_frsize,
            'cpu_count': os.cpu_count()}


def check_no_cuda_in_workers(pool):
    """The pool's live workers hold no CUDA context: nvidia-smi lists one
    compute process (this one; in a container it may show it under another
    pid namespace's number) and none of the workers' pids, and no worker has
    libcuda mapped."""
    pids = [process.pid for process in pool.processes]
    check(all(process.poll() is None for process in pool.processes),
          'a pool worker was not alive at the CUDA check')
    out = subprocess.run(['nvidia-smi', '--query-compute-apps=pid', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, 'nvidia-smi --query-compute-apps failed: {}'.format(out.stderr))
    listed = sorted(int(word) for word in out.stdout.split() if word.strip().isdigit())
    mapped = []
    for pid in pids:
        with open('/proc/{}/maps'.format(pid)) as f:
            if 'libcuda' in f.read():
                mapped.append(pid)
    check(len(listed) == 1 and not set(listed) & set(pids) and not mapped,
          'CUDA contexts: nvidia-smi lists {} (this process is {}, the workers {}); '
          'workers with libcuda mapped: {}'.format(listed, os.getpid(), pids, mapped))
    return {'worker_pids': pids, 'compute_app_pids': listed, 'own_pid': os.getpid()}


def check_transport(diag, items, what):
    """Every result of the run came through the ring, none dropped or redone."""
    check(diag['shm_batches'] == diag['wire_batches'] == items
          and diag['shm_fallback_batches'] == diag['shm_crc_failures']
          == diag['shm_stale_drops'] == 0,
          '{}: {} results, {} of them through the ring (fallbacks {}, CRC failures {}, '
          'stale drops {})'.format(what, diag['wire_batches'], diag['shm_batches'],
                                   diag['shm_fallback_batches'], diag['shm_crc_failures'],
                                   diag['shm_stale_drops']))


def phase_process_imagenet(tmp, args):
    """Phase 13a: phase 5's store and configuration read by a process pool of
    ``args.workers`` spawned workers with the shm ring required (what
    ``make_reader(reader_pool_type='process', workers_count=args.workers,
    shm_transport=True)`` builds): K1 on every batch, every row once with its
    label and embedding bytes, every result through the ring, the segment gone
    after join, and no CUDA context in a worker."""
    phase_start = time.perf_counter()
    url = 'file://' + os.path.join(tmp, 'imagenet')
    pool = ProcessPool(args.workers, shm_transport=True)
    cuda = {}
    result, delivered = phase_main_path(
        url, args, reader_pool=pool,
        inspect=lambda reader, loader: cuda.update(check_no_cuda_in_workers(pool)))
    result['distinct_rows'] = check_delivered(delivered, args.seed)
    check(result['distinct_rows'] == result['rows'] == args.rows,
          '13a: {} distinct rows of {} delivered, {} in the store'.format(
              result['distinct_rows'], result['rows'], args.rows))
    check_transport(result['diagnostics'], result['items_per_epoch'], '13a')
    check(shm_segment_gone(pool), '13a: the ring {} outlived join()'.format(pool.ring_name))
    result['cuda'] = cuda
    result['machine'] = machine_facts()
    result['phase_s'] = time.perf_counter() - phase_start
    return result


def epoch_idx_once(seen, epochs):
    """Each epoch's idx values, seen as the reader delivered them, are
    0..MNIST_ROWS-1 once."""
    check(sorted(seen) == list(range(epochs)), 'epochs seen: {}'.format(sorted(seen)))
    for epoch, parts in seen.items():
        idx = np.sort(np.concatenate(parts))
        check(np.array_equal(idx, np.arange(MNIST_ROWS)),
              'epoch {}: {} idx values, {} distinct, not 0..{} once'.format(
                  epoch, len(idx), len(np.unique(idx)), MNIST_ROWS - 1))


def phase_process_mnist_stream(tmp, seed):
    """Phase 13b: phase 10 on a process pool. First a pass through one
    process worker, whose stream order is the in-line reader's: its first
    chunk held against the eager twin; then epochs 0-7 on a pool of 4
    (the first a warm-up), each epoch's idx once."""
    phase_start = time.perf_counter()
    url = 'file://' + os.path.join(tmp, 'mnist')
    model, optimizer, twin, twin_opt = mnist_model(seed + 1)
    step = mnist_step(model, optimizer)

    def inline_reader():
        return make_reader(url, reader_pool_type='dummy', shuffle_row_groups=True, seed=42)

    with make_reader(url, reader_pool_type='process', workers_count=1, shm_transport=True,
                     shuffle_row_groups=True, seed=42) as reader:
        chunks = TorchDataLoader(reader, batch_size=MNIST_BATCH).scan_stream(
            step, chunk_batches=MNIST_CHUNK, seed=0, state=(model, optimizer))
    twin_step = mnist_step(twin, twin_opt)
    eager = [twin_step(batch) for batch in first_chunk_batches(
        inline_reader, MNIST_CHUNK, MNIST_BATCH, 0)]
    agreement = loss_agreement(chunks[0].tolist(), eager, MNIST_LOSS_RTOL)
    epochs = []
    pool = ProcessPool(4, shm_transport=True)
    open_start = time.perf_counter()
    with make_reader(url, reader_pool=pool, shuffle_row_groups=True, seed=42,
                     num_epochs=1) as reader:
        seen = observe_items(reader)
        loader = TorchDataLoader(reader, batch_size=MNIST_BATCH)
        for epoch in range(MNIST_EPOCHS + 1):
            def one_pass():
                aux = loader.scan_stream(step, chunk_batches=MNIST_CHUNK, seed=epoch,
                                         state=(model, optimizer))
                float(aux[-1][-1])
                return sum(int(a.shape[0]) for a in aux) * MNIST_BATCH
            rows, elapsed = timed(one_pass)
            epochs.append({'s': elapsed, 'rows': rows, 'rows_per_s': rows / elapsed})
        diag = reader.diagnostics
        items = reader.items_per_epoch
    epoch_idx_once(seen, MNIST_EPOCHS + 1)
    check_transport(diag, items * (MNIST_EPOCHS + 1), '13b')
    check(shm_segment_gone(pool), '13b: the ring {} outlived join()'.format(pool.ring_name))
    return {'chunk_batches': MNIST_CHUNK, 'epochs': epochs, 'workers': 4,
            'rows_per_s': statistics.median(e['rows_per_s'] for e in epochs[1:]),
            'first_chunk': agreement, 'items_per_epoch': items,
            'open_to_end_s': time.perf_counter() - open_start,
            'phase_s': time.perf_counter() - phase_start, 'diagnostics': diag}


def phase_process_kill(tmp, seed):
    """Phase 13c: 13b's reader for one epoch of scan_stream, one worker
    SIGKILLed (its pid from the pool's process handles) once the first chunk's
    rows were read: every idx once, one respawn, the segment gone after join."""
    phase_start = time.perf_counter()
    url = 'file://' + os.path.join(tmp, 'mnist')
    model, optimizer, _, _ = mnist_model(seed + 2)
    step = mnist_step(model, optimizer)
    pool = ProcessPool(4, shm_transport=True)
    killed = []
    with make_reader(url, reader_pool=pool, shuffle_row_groups=True, seed=42,
                     num_epochs=1) as reader:
        seen = observe_items(reader)
        observed = reader.iter_columnar

        def iter_columnar(*args, **kwargs):
            rows = 0
            for batch in observed(*args, **kwargs):
                rows += batch.num_rows
                if not killed and rows >= MNIST_CHUNK * MNIST_BATCH:
                    victim = pool.processes[0].pid
                    os.kill(victim, signal.SIGKILL)
                    killed.append(victim)
                yield batch
        reader.iter_columnar = iter_columnar
        loader = TorchDataLoader(reader, batch_size=MNIST_BATCH)

        def one_pass():
            aux = loader.scan_stream(step, chunk_batches=MNIST_CHUNK, seed=0,
                                     state=(model, optimizer))
            last = float(aux[-1][-1])
            check(np.isfinite(last), '13c: non-finite loss {}'.format(last))
            return sum(int(a.shape[0]) for a in aux) * MNIST_BATCH
        rows, elapsed = timed(one_pass)
        diag = reader.diagnostics
    epoch_idx_once(seen, 1)
    check(len(killed) == 1 and diag['workers_respawned'] == 1,
          '13c: killed {}, {} respawns'.format(killed, diag['workers_respawned']))
    check(shm_segment_gone(pool), '13c: the ring {} outlived join()'.format(pool.ring_name))
    return {'killed_pid': killed[0], 'rows': rows, 's': elapsed, 'rows_per_s': rows / elapsed,
            'workers_respawned': diag['workers_respawned'],
            'results_dropped': diag['results_dropped'],
            'shm_stale_drops': diag['shm_stale_drops'],
            'phase_s': time.perf_counter() - phase_start, 'diagnostics': diag}


def process_lines(imagenet, stream, kill, thread_main, thread_stream, card):
    machine = imagenet['machine']
    return [
        'phase 13a ImageNet path on a process pool of {} workers (shm ring): rows/s={:.2f} '
        'step_ms(median)={:.2f} input_stall_fraction={:.4f} spawn-to-first-batch {:.3f} s | '
        'phase 5 threads: rows/s={:.2f} step_ms(median)={:.2f} input_stall_fraction={:.4f} '
        'first batch {:.3f} s | K1 launches {} on {} batches, {} rows each once, {} results '
        'all through the ring, segment gone, worker pids {} hold no CUDA context (nvidia-smi '
        'lists {}) | /dev/shm {} bytes, os.cpu_count() {}; the phase took {:.1f} s '
        '[{}]'.format(
            len(imagenet['cuda']['worker_pids']), imagenet['rows_per_s'],
            imagenet['step_ms_median'], imagenet['input_stall_fraction'],
            imagenet['first_batch_s'], thread_main['rows_per_s'],
            thread_main['step_ms_median'], thread_main['input_stall_fraction'],
            thread_main['first_batch_s'], imagenet['k1_launches'], imagenet['steps'],
            imagenet['distinct_rows'], imagenet['diagnostics']['shm_batches'],
            imagenet['cuda']['worker_pids'], imagenet['cuda']['compute_app_pids'],
            machine['dev_shm_bytes'], machine['cpu_count'], imagenet['phase_s'], card),
        'phase 13b MNIST scan_stream on a process pool of {}: rows/s={:.1f} (median of '
        'epochs 1-{}) | phase 10 threads: rows/s={:.1f}; each epoch\'s idx once; first chunk '
        '(one process worker) vs eager max rel err {:.3e} (limit {:.1e}); the phase took '
        '{:.1f} s [{}]'.format(
            stream['workers'], stream['rows_per_s'], MNIST_EPOCHS, thread_stream['rows_per_s'],
            stream['first_chunk']['max_rel_err'], stream['first_chunk']['rtol'],
            stream['phase_s'], card),
        'phase 13c a worker SIGKILLed after the first chunk: {} rows in {:.3f} s '
        '(rows/s={:.1f}), every idx once, workers_respawned={}, results_dropped={}, '
        'shm_stale_drops={}, segment gone; the phase took {:.1f} s [{}]'.format(
            kill['rows'], kill['s'], kill['rows_per_s'], kill['workers_respawned'],
            kill['results_dropped'], kill['shm_stale_drops'], kill['phase_s'], card)]


# --------------------------------------------- expert-routed MoE training (phase 14)

#: bench.py's moe section (bench.py:91-98, 1171-1242), at its width and depth
MOE = dict(vocab=256, embed=512, heads=4, layers=2, num_experts=8, moe_every=1, max_len=2048)
MOE_ROWS = 32
MOE_BATCH = 4
MOE_STEPS = 8
MOE_AUX_WEIGHT = 0.01
#: 14b's first batch (flash attention) against 14a's (dense attention): the
#: loss's relative difference, and the share of tokens whose top-1 expert
#: differs. Rounding in attention can flip the route of a token whose two
#: largest router logits nearly tie, and a flipped token changes its whole
#: MoE output, so phase 7's 5e-5 does not carry over.
MOE_LOSS_RTOL = 1e-3
MOE_REROUTED_LIMIT = 0.01
#: the first layer's MoE output in float32 on the card against the per-token
#: loop reference on the CPU (float64), over the first batch's first tokens,
#: with capacity_factor = num_experts so that none is dropped; the tolerance of
#: tests/test_moe.py
MOE_CHECK_TOKENS = 1024
MOE_CHECK_TOL = (2e-4, 2e-5)
#: 14c: sharded_moe_ffn against MoEMlp's local path, float32, relative to max|ref|
EXCHANGE_RTOL = 1e-5
#: 14c's ring: [B, T, H, D] of bench.py's flash section at the LM path's batch
RING_SHAPE = (LM_BATCH, LM['max_len'], LM['heads'], LM['embed'] // LM['heads'])


def moe_model(seed, attention_fn=None):
    """The phase's MoETransformerLM, bf16, its weights drawn from ``seed``."""
    return MoETransformerLM(dtype=torch.bfloat16, attention_fn=attention_fn,
                            generator=torch.Generator().manual_seed(seed), **MOE)


def moe_loss(model, tokens, attention_fn=None, drops=None):
    """``next_token_loss + moe_aux_total(weight=0.01)`` as bench.py trains
    it; the largest layer's drop fraction is appended to ``drops``."""
    logits, losses = model(tokens, attention_fn=attention_fn)
    if drops is not None:
        drops.append(torch.stack(moe_drop_fractions(losses)).max().detach())
    return next_token_loss(logits, tokens) + moe_aux_total(losses, MOE_AUX_WEIGHT)


def moe_inputs(model, run):
    """Each MoE layer's input ``[B, T, D]`` while ``run()`` runs."""
    seen = []
    hooks = [block.moe.register_forward_hook(lambda module, args, out: seen.append(
        args[0].detach())) for block in model.blocks if hasattr(block, 'moe')]
    try:
        run()
    finally:
        for hook in hooks:
            hook.remove()
    return seen


def top1_experts(model, inputs):
    """Each MoE layer's top-1 expert of every token of its input."""
    with torch.no_grad():
        return [torch.argmax(block.moe.router(x.reshape(-1, x.shape[-1]).float()), dim=-1)
                for block, x in zip((b for b in model.blocks if hasattr(b, 'moe')), inputs)]


def routing_check(moe, x):
    """switch_routing on the card and on the CPU on the same router
    probabilities (the first layer's, on the first batch): dispatch equal bit
    for bit, combine exactly; its time on the card at this shape."""
    tokens = x.reshape(-1, x.shape[-1])
    with torch.no_grad():
        probs = torch.softmax(moe.router(tokens.float()), dim=-1)
        cap = moe_capacity(tokens.shape[0], MOE['num_experts'], 1, moe.capacity_factor)
        card = switch_routing(probs, cap, 1)
        host = switch_routing(probs.cpu(), cap, 1)
        ms = cuda_ms(lambda: switch_routing(probs, cap, 1), reps=5)
    result = {'shape': [tokens.shape[0], MOE['num_experts'], cap],
              'dispatch_equal': torch.equal(card[0].cpu(), host[0]),
              'combine_equal': torch.equal(card[1].cpu(), host[1]),
              'aux': float(card[2]), 'aux_host': float(host[2]),
              'drop_fraction': float(card[3]), 'drop_fraction_host': float(host[3]), 'ms': ms}
    check(result['dispatch_equal'] and result['combine_equal'],
          'switch_routing on the card differs from the CPU: {}'.format(result))
    return result


def moe_loop_reference(moe, tokens):
    """Per-token top-1 routing the slow, obvious way (no drops), in float64 on
    the CPU, as tests/test_moe.py computes it."""
    router = moe.router.weight.detach().double().cpu().numpy().T
    w1 = moe.w1.detach().double().cpu().numpy()
    w2 = moe.w2.detach().double().cpu().numpy()
    x = tokens.double().cpu().numpy()
    logits = x @ router
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    expert = probs.argmax(axis=1)
    out = np.zeros_like(x)
    for e in range(w1.shape[0]):
        rows = expert == e
        h = x[rows] @ w1[e]
        h = 0.5 * h * (1 + np.tanh(np.sqrt(2 / np.pi) * (h + 0.044715 * h ** 3)))
        out[rows] = (h @ w2[e]) * probs[rows, e][:, None]
    return out


def moe_output_check(moe, x):
    """The MoE layer in float32 on the card, capacity_factor = num_experts,
    against :func:`moe_loop_reference` on MOE_CHECK_TOKENS tokens."""
    layer = copy.deepcopy(moe)
    layer.dtype = torch.float32
    layer.capacity_factor = float(MOE['num_experts'])
    tokens = x.reshape(-1, x.shape[-1])[:MOE_CHECK_TOKENS].float()
    with torch.no_grad():
        got, losses = layer(tokens[None])
    want = moe_loop_reference(layer, tokens)
    got = got[0].double().cpu().numpy()
    err = np.abs(got - want)
    rtol, atol = MOE_CHECK_TOL
    result = {'tokens': MOE_CHECK_TOKENS, 'max_abs_err': float(err.max()),
              'tol_share': float((err / (rtol * np.abs(want) + atol)).max()),
              'drop_fraction': float(losses['moe_drop_fraction'])}
    check(result['drop_fraction'] == 0.0 and result['tol_share'] <= 1,
          'the MoE layer differs from the loop reference: {}'.format(result))
    return result


def einsum_times(moe, x):
    """Device time of the dispatch einsum (bf16) and the combine einsum
    (float32) of one MoE layer at the main path's shape, each forward and
    backward (the dispatch needs no gradient, the combine two), with the
    FLOPs of one of their products."""
    tokens = x.reshape(-1, x.shape[-1]).detach()
    with torch.no_grad():
        probs = torch.softmax(moe.router(tokens.float()), dim=-1)
    cap = moe_capacity(tokens.shape[0], MOE['num_experts'], 1, moe.capacity_factor)
    dispatch, combine = (t.detach() for t in switch_routing(probs, cap, 1)[:2])
    gen = torch.Generator().manual_seed(0)
    expert_out = torch.randn(MOE['num_experts'], cap, MOE['embed'], generator=gen).to(
        tokens.device)
    tokens = tokens.to(torch.bfloat16).requires_grad_()
    dispatch = dispatch.to(torch.bfloat16)
    expert_out.requires_grad_()
    combine.requires_grad_()
    slots = torch.einsum('sd,sxc->xcd', tokens, dispatch)
    mixed = torch.einsum('xcd,sxc->sd', expert_out, combine)
    slot_grad, mix_grad = torch.ones_like(slots), torch.ones_like(mixed)
    return {
        'shape': [tokens.shape[0], MOE['num_experts'], cap, MOE['embed']],
        'flop_per_product': 2 * tokens.shape[0] * MOE['num_experts'] * cap * MOE['embed'],
        'dispatch_fwd_ms': cuda_ms(lambda: torch.einsum('sd,sxc->xcd', tokens, dispatch)),
        'dispatch_bwd_ms': cuda_ms(lambda: torch.autograd.grad(slots, tokens, slot_grad,
                                                               retain_graph=True)),
        'combine_fwd_ms': cuda_ms(lambda: torch.einsum('xcd,sxc->sd', expert_out, combine)),
        'combine_bwd_ms': cuda_ms(lambda: torch.autograd.grad(
            mixed, (expert_out, combine), mix_grad, retain_graph=True))}


def attention_vs_dense(seen):
    """Each layer's attention with K2 against dense attention on the inputs
    it had (``flash_compare``, with the bf16 rounding allowance of
    ``flash_forward_plain`` over |V|)."""
    results = []
    for q, k, v in seen:
        b, _, h, _ = q.shape
        with torch.no_grad():
            got = flash.flash_attention(q, k, v, causal=True)
            want = dense_attention(q, k, v, causal=True)
            qf, kf, vf = (flash._to_bh(x.float()) for x in (q, k, v))
            bound = flash._from_bh(flash.flash_forward_plain(qf, kf, vf.abs(), True)[0], b, h)
        results.append(flash.flash_compare(got, want, bound))
        check(results[-1]['ok'], 'attention with K2 differs from dense attention: {}'.format(
            results[-1]))
    return results


def train_moe(model, batches, drops, attention_fn=None):
    """1 + MOE_STEPS Adam steps (lr 3e-4) on ``batches``, counted: the
    kernels' launches, the step times and the largest drop fraction."""
    optimizer = torch.optim.Adam(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8)

    def step_loss(batch):
        return moe_loss(model, batch['tokens'], attention_fn, drops)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, step_s, window_s = train_lm(batches, optimizer, MOE_STEPS + 1, step_loss)
    counts = read_counts()
    flops = moe_transformer_train_flops_per_step(
        MOE_BATCH, MOE['max_len'], MOE['vocab'], MOE['embed'], MOE['layers'],
        MOE['num_experts'], moe_every=MOE['moe_every'])
    result = lm_metrics(losses, step_s, window_s, {'input_stall_fraction': None},
                        MOE_BATCH * MOE['max_len'], flops)
    result.update(counts=counts, max_drop_fraction=max(float(d) for d in drops))
    check(all(np.isfinite(losses)), 'non-finite MoE loss {}'.format(losses))
    return result, optimizer, step_loss


def phase_moe(tmp, seed):
    """Phase 14a: bench.py's moe section at its width: a token store ->
    make_reader -> InMemTorchLoader -> MoETransformerLM (dense causal
    attention) -> Adam, with the on-card routing and MoE-output checks, the
    einsums' times and a profiled step. Returns the result, the initial
    weights, the batches and the first batch's reference numbers for 14b."""
    path = os.path.join(tmp, 'moe_tokens')
    start = time.perf_counter()
    write_token_store('file://' + path, MOE_ROWS, MOE['max_len'], n_files=2,
                      rowgroup_size_mb=32)
    store_write_s = time.perf_counter() - start
    model = moe_model(seed)
    initial = copy.deepcopy(model.state_dict())
    batches = []

    def recorded(loader):
        for batch in loader:
            batches.append(batch)
            yield batch

    with make_reader('file://' + path, workers_count=2, num_epochs=1,
                     shuffle_row_groups=False) as reader:
        loader = recorded(InMemTorchLoader(reader, batch_size=MOE_BATCH, num_epochs=None,
                                           shuffle=True, seed=4, drop_last=True))
        first = next(loader)['tokens']
        check(tuple(first.shape) == (MOE_BATCH, MOE['max_len'])
              and first.device.type == 'cuda',
              'MoE batch shape/device {} {}'.format(tuple(first.shape), first.device))
        with torch.no_grad():
            inputs = moe_inputs(model, lambda: model(first))
        first_batch = dict(zip(('loss', 'grad_norm'), loss_and_grad_norm(
            model, lambda: moe_loss(model, first))))
        experts = top1_experts(model, inputs)
        moe = model.blocks[0].moe
        routing = routing_check(moe, inputs[0])
        output = moe_output_check(moe, inputs[0])
        einsums = einsum_times(moe, inputs[0])
        drops = []
        # the timed window fetches each batch after the first from the loader
        result, optimizer, step_loss = train_moe(
            model, itertools.chain([batches[0]], loader), drops)
    breakdown = device_breakdown(lambda: adam_step(optimizer, step_loss, batches[0]))
    check(result['counts']['dense_fallbacks'] == 0, 'the MoE path counted a dense fallback')
    result.update(first_batch=first_batch, routing=routing, moe_output=output,
                  einsums=einsums, breakdown=breakdown, store_write_s=store_write_s)
    return result, initial, batches, inputs, experts


def phase_moe_flash(seed, initial, batches, dense_inputs, dense_experts, dense_first):
    """Phase 14b: 14a's model, weights and batches with the causal flash
    kernels as attention_fn: each layer's attention on the first batch against
    dense attention, the first batch's loss against 14a's and the share of
    rerouted tokens, then the same 1 + MOE_STEPS steps, K2-K4 counted."""
    model = moe_model(seed)
    model.load_state_dict(initial)
    first = batches[0]['tokens']
    seen = []

    def recording(q, k, v):
        seen.append((q.detach(), k.detach(), v.detach()))
        return causal_flash(q, k, v)

    with torch.no_grad():
        inputs = moe_inputs(model, lambda: model(first, attention_fn=recording))
    attention = attention_vs_dense(seen)
    experts = top1_experts(model, inputs)
    rerouted = float(sum(int((a != b).sum()) for a, b in zip(experts, dense_experts))
                     / sum(a.numel() for a in experts))
    loss, grad_norm = loss_and_grad_norm(model, lambda: moe_loss(model, first, causal_flash))
    first_batch = {'loss': loss, 'dense_loss': dense_first['loss'], 'grad_norm': grad_norm,
                   'dense_grad_norm': dense_first['grad_norm'],
                   'loss_rel_err': abs(loss - dense_first['loss']) / abs(dense_first['loss']),
                   'grad_norm_rel_err': abs(grad_norm - dense_first['grad_norm'])
                   / abs(dense_first['grad_norm']),
                   'rerouted_share': rerouted, 'loss_rtol': MOE_LOSS_RTOL,
                   'rerouted_limit': MOE_REROUTED_LIMIT}
    check(first_batch['loss_rel_err'] <= MOE_LOSS_RTOL and rerouted < MOE_REROUTED_LIMIT,
          'the first batch with the kernels differs from dense attention: {}'.format(
              first_batch))
    drops = []
    result, _, _ = train_moe(model, iter(batches), drops, causal_flash)
    launches = {name: result['counts'][name] for name in FLASH_PRODUCTS}
    expected = MOE['layers'] * result['steps_run']
    check(all(n == expected for n in launches.values()),
          'flash kernels launched {} times on the MoE path, expected {} each (layers x steps)'
          .format(launches, expected))
    check(result['counts']['dense_fallbacks'] == 0, 'MoE attention took the dense path')
    result.update(first_batch=first_batch, attention=attention, launches=launches)
    return result


def ring_case(mesh, causal, segments, seed):
    """ring_attention_sharded on a one-rank group against the port's flash
    attention on the same global tensors, forward and gradients, with the
    launches of one ring call (forward and backward) counted."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(*RING_SHAPE, generator=gen).to(mesh.device_type, torch.bfloat16)
                   for _ in range(4))
    ring = ring_attention_sharded(mesh, 'seq', causal=causal)
    extra = () if segments is None else (segments,)

    def run(fn):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves, *extra)
        out.backward(do)
        return [out.detach()] + [x.grad for x in leaves]

    def flash_fn(q, k, v, *segments):
        if segments:
            return flash.flash_attention_segmented(q, k, v, segments[0], causal=causal)
        return flash.flash_attention(q, k, v, causal=causal)

    reset_counts()
    got = run(ring)
    torch.cuda.synchronize()
    counts = read_counts()
    want = run(flash_fn)
    result = {'counts': counts, 'ring_ms': cuda_ms(lambda: run(ring), reps=5),
              'flash_ms': cuda_ms(lambda: run(flash_fn), reps=5)}
    for label, g, w in zip(('o', 'dq', 'dk', 'dv'), got, want):
        result[label] = flash.flash_compare(g, w)
        check(result[label]['ok'], 'ring {} differs from flash attention: {}'.format(
            label, result[label]))
    check(all(counts[name] == 1 for name in FLASH_PRODUCTS) and counts['dense_fallbacks'] == 0,
          'a ring call launched {}, expected K2-K4 once each'.format(counts))
    return result


def phase_one_rank(tmp, seed, moe, x):
    """Phase 14c: a one-rank NCCL process group (a file store in the run's
    temporary directory). sharded_moe_ffn against MoEMlp's local path on the
    same weights in float32, then ring_attention_sharded causal and
    segmented-causal at RING_SHAPE against the flash kernels. World size 1
    exchanges nothing: the rotation and the merge are held by the CPU tests."""
    dist.init_process_group('nccl', init_method='file://' + os.path.join(tmp, 'nccl_store'),
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(('seq', 'expert'), (1, 1))
        layer = copy.deepcopy(moe)
        layer.dtype = torch.float32
        tokens = x.reshape(-1, x.shape[-1]).float()
        with torch.no_grad():
            want = layer(tokens[None])[0][0]
            router = layer.router.weight.t()
            got = sharded_moe_ffn(tokens, router, layer.w1, layer.w2, mesh['expert'],
                                  capacity_factor=layer.capacity_factor)[0]
            exchange = {'tokens': tokens.shape[0],
                        'max_abs_err': float((got - want).abs().max()),
                        'max_abs_ref': float(want.abs().max()),
                        'sharded_ms': cuda_ms(lambda: sharded_moe_ffn(
                            tokens, router, layer.w1, layer.w2, mesh['expert'],
                            capacity_factor=layer.capacity_factor), reps=5),
                        'local_ms': cuda_ms(lambda: layer(tokens[None]), reps=5)}
        check(exchange['max_abs_err'] <= EXCHANGE_RTOL * exchange['max_abs_ref'],
              'sharded_moe_ffn differs from the local path: {}'.format(exchange))
        segments = packed_segments(RING_SHAPE[0], RING_SHAPE[1], seed)
        rings = {'causal': ring_case(mesh, True, None, seed),
                 'segmented_causal': ring_case(mesh, True, segments, seed + 1)}
    finally:
        dist.destroy_process_group()
    return {'exchange': exchange, 'rings': rings, 'world_size': 1,
            'ring_launches': {name: sum(r['counts'][name] for r in rings.values())
                              for name in FLASH_PRODUCTS}}


def moe_lines(moe, moe_flash, one_rank, card):
    einsums = moe['einsums']
    fwd_bwd = {name: einsums[name + '_fwd_ms'] + einsums[name + '_bwd_ms']
               for name in ('dispatch', 'combine')}
    return [
        'phase 14a MoE path (bench.py moe: {} steps (1 warm-up) of MoETransformerLM [{}x{}] '
        'embed {} x{} experts, {} layers, bf16, dense attention, InMemTorchLoader): '
        'tokens/s={:.1f} step_ms(median)={:.2f} model TFLOP/s={:.3f} MFU={:.5f} '
        'peak_memory={:.3f} GiB max drop fraction {:.4f} losses {:.4f}->{:.4f}; routing '
        'card vs CPU: dispatch equal {}, combine equal {} ({:.4f} ms on the card); MoE output '
        'vs loop reference max abs err {:.3e} (tol share {:.3f}); a layer\'s dispatch einsum '
        'fwd+bwd {:.3f} ms (bf16), combine einsum fwd+bwd {:.3f} ms (float32), {:.3e} FLOP '
        'a product; one profiled step: {}; top kernels {}; the store written in {:.2f} s '
        '[{}]'.format(
            moe['steps_run'], MOE_BATCH, MOE['max_len'], MOE['embed'], MOE['num_experts'],
            MOE['layers'], moe['tokens_per_s'], moe['step_ms_median'],
            moe['model_tflops_per_s'], moe['mfu'], moe['peak_memory_bytes'] / 2 ** 30,
            moe['max_drop_fraction'], moe['losses'][0], moe['losses'][-1],
            moe['routing']['dispatch_equal'], moe['routing']['combine_equal'],
            moe['routing']['ms'], moe['moe_output']['max_abs_err'],
            moe['moe_output']['tol_share'], fwd_bwd['dispatch'], fwd_bwd['combine'],
            einsums['flop_per_product'], breakdown_line(moe['breakdown']),
            {key: round(value, 3) for key, value in moe['breakdown']['top_kernels_ms'].items()},
            moe['store_write_s'], card),
        'phase 14b MoE path with the flash kernels: tokens/s={:.1f} step_ms(median)={:.2f} '
        'MFU={:.5f} peak_memory={:.3f} GiB launches {} dense_fallbacks {}; attention vs dense '
        'tol share {}; first batch beside 14a {} [{}]'.format(
            moe_flash['tokens_per_s'], moe_flash['step_ms_median'], moe_flash['mfu'],
            moe_flash['peak_memory_bytes'] / 2 ** 30, moe_flash['launches'],
            moe_flash['counts']['dense_fallbacks'],
            [round(a['tol_share'], 4) for a in moe_flash['attention']],
            {key: round(value, 6) for key, value in moe_flash['first_batch'].items()}, card),
        'phase 14c one-rank NCCL group (world size 1: no exchange, so the ring\'s rotation '
        'and merge are held only by the CPU tests): sharded_moe_ffn vs MoEMlp local path max '
        'abs err {:.3e} of max |ref| {:.3e} ({:.3f} ms vs {:.3f} ms, {} tokens float32); '
        'ring_attention_sharded at {} bf16: {}; phase 14 took {:.1f} s [{}]'.format(
            one_rank['exchange']['max_abs_err'], one_rank['exchange']['max_abs_ref'],
            one_rank['exchange']['sharded_ms'], one_rank['exchange']['local_ms'],
            one_rank['exchange']['tokens'], list(RING_SHAPE),
            {name: {'launches': r['counts'], 'ring_ms': round(r['ring_ms'], 4),
                    'flash_ms': round(r['flash_ms'], 4),
                    'tol_share': {label: round(r[label]['tol_share'], 4)
                                  for label in ('o', 'dq', 'dk', 'dv')}}
             for name, r in one_rank['rings'].items()}, moe['phase_s'], card)]


# ------------------------------------- data- and pipeline-parallel training (phase 15)

#: 15a: rows a step (phase 7's LM at twice its batch), microbatches a step
PIPE_BATCH = 4
PIPE_MICRO = 2
#: 15a's first batch through the pipeline against the unpipelined
#: TransformerLM with the same weights and rows, relative: phase 14b's loss
#: limit and phase 7's gradient-norm limit. Only the microbatch split
#: differs: the projections' products run over 2 rows instead of 4 (cuBLAS
#: may pick another kernel, rounding bf16 outputs otherwise) and each block
#: weight's gradient is the float32 sum of two bf16 halves.
PIPE_LOSS_RTOL = 1e-4
PIPE_GRAD_NORM_RTOL = 2.5e-4
#: 15b/15c: MNIST epochs (the first fills, uploads and captures) and timed
#: scan_stream passes after a warm-up pass
MESH_EPOCHS = 3
MESH_STREAM_PASSES = 2


def phase_pipeline_lm(tmp, seed, mesh):
    """15a: phase 7's token store -> make_reader sharded by the mesh's 'data'
    coordinate -> TorchDataLoader(batch_size=PIPE_BATCH, mesh) -> an
    embedding, make_pipeline with one stage holding the 4 flash Blocks
    (PIPE_MICRO microbatches of 2 rows: K2-K4 at phase 7's [8, 8192, 128]),
    the head and next_token_loss; Adam 3e-4, one warm-up and LM_STEPS timed
    steps. The first batch is held against the unpipelined TransformerLM
    with the same weights, and a profiled step must run K2-K4
    layers x microbatches times each."""
    path = 'file://' + os.path.join(tmp, 'tokens')   # phase 7's store
    torch.manual_seed(seed)
    model = TransformerLM(dtype=torch.bfloat16, attention_fn=causal_flash, **LM)
    optimizer = torch.optim.Adam(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8)
    pipe = make_pipeline(blocks_stage_fn(model.blocks, causal_flash), mesh)
    stage_params = dict(model.blocks.named_parameters())

    def pipelined_loss(tokens):
        x = model.embed(tokens)
        ys = pipe(stage_params, microbatch(x, PIPE_MICRO)).reshape(x.shape)
        return next_token_loss(model.head(model.norm(ys)), tokens)

    def step_loss(batch):
        return pipelined_loss(batch['tokens'].to_local())

    def plain_loss(batch):
        tokens = batch['tokens'].to_local()
        return next_token_loss(model(tokens), tokens)

    cur_shard, shard_count = mesh_shard_info(mesh, 'data')
    flops = transformer_train_flops_per_step(PIPE_BATCH, LM['max_len'], LM['vocab'],
                                             LM['embed'], LM['layers'])
    with make_reader(path, workers_count=2, seed=seed, cur_shard=cur_shard,
                     shard_count=shard_count) as reader:
        loader = TorchDataLoader(reader, batch_size=PIPE_BATCH, mesh=mesh,
                                 partition_spec=PartitionSpec('data'))
        batches = iter(loader)
        first = next(batches)
        tokens = first['tokens']
        check(isinstance(tokens, DTensor) and tokens.device.type == 'cuda'
              and tokens.to_local().device.type == 'cuda'
              and tuple(tokens.shape) == (PIPE_BATCH * shard_count, LM['max_len'])
              and tokens.dtype == torch.int32,
              'a 15a batch field is not an int32 DTensor on cuda of the global shape: {} {} {}'
              .format(type(tokens).__name__, tokens.device, tuple(tokens.shape)))
        loss, norm = loss_and_grad_norm(model, lambda: step_loss(first))
        plain, plain_norm = loss_and_grad_norm(model, lambda: plain_loss(first))
        parity = {'loss': loss, 'unpipelined_loss': plain, 'grad_norm': norm,
                  'unpipelined_grad_norm': plain_norm,
                  'loss_rel_err': abs(loss - plain) / abs(plain),
                  'grad_norm_rel_err': abs(norm - plain_norm) / abs(plain_norm),
                  'loss_rtol': PIPE_LOSS_RTOL, 'grad_norm_rtol': PIPE_GRAD_NORM_RTOL}
        check(np.isfinite([loss, plain, norm, plain_norm]).all()
              and parity['loss_rel_err'] <= PIPE_LOSS_RTOL
              and parity['grad_norm_rel_err'] <= PIPE_GRAD_NORM_RTOL,
              'the pipelined first batch differs from the unpipelined model: {}'.format(parity))
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, step_s, window_s = train_lm(itertools.chain([first], batches), optimizer,
                                            LM_STEPS + 1, step_loss)
        counts = read_counts()
        stats = loader.stats.as_dict()
        result = lm_metrics(losses, step_s, window_s, stats, PIPE_BATCH * LM['max_len'], flops)
        breakdown = device_breakdown(lambda: adam_step(optimizer, step_loss, first))
        plain_breakdown = device_breakdown(lambda: adam_step(optimizer, plain_loss, first))
        unpipelined = []
        for _ in range(LM_STEPS + 1):
            start = time.perf_counter()
            adam_step(optimizer, plain_loss, first)
            torch.cuda.synchronize()
            unpipelined.append(time.perf_counter() - start)
    launches = {name: counts[name] for name in FLASH_PRODUCTS}
    per_step = LM['layers'] * PIPE_MICRO
    check(all(n == per_step * result['steps_run'] for n in launches.values())
          and counts['dense_fallbacks'] == 0,
          'flash kernels launched {} times on the pipeline path, expected {} each (layers x '
          'microbatches x steps)'.format(counts, per_step * result['steps_run']))
    check(all(n == per_step for n in breakdown['calls'].values()),
          'a profiled pipeline step ran the flash kernels {} times, expected {} each'
          .format(breakdown['calls'], per_step))
    check(all(np.isfinite(losses)), 'non-finite pipeline loss {}'.format(losses))
    unpipelined_ms = statistics.median(unpipelined[1:]) * 1e3
    result.update(first_batch=parity, launches=launches, counts=counts, breakdown=breakdown,
                  unpipelined_breakdown=plain_breakdown, unpipelined_step_ms=unpipelined_ms,
                  overhead=result['step_ms_median'] / unpipelined_ms,
                  stages=mesh['stage'].size(),
                  stage_shift='skipped (one stage sends nothing to itself)'
                  if mesh['stage'].size() == 1 else 'batch_isend_irecv')
    return result


def mesh_mnist_step(model, optimizer):
    """bench.py's MNIST step on the local rows of a DTensor batch; returns
    the loss and the batch's ``idx`` for the delivery check."""
    train = mnist_step(model, optimizer)

    def step(batch):
        local = {name: value.to_local() for name, value in batch.items()}
        return train(local), local['idx']
    return step


def phase_mnist_mesh(tmp, seed, mesh):
    """15b: phase 9's store -> InMemTorchLoader(batch_size=MNIST_BATCH,
    mesh) -> MnistCNN through scan_epochs over the one-rank mesh: the
    shard-blocked residency and the shard-local shuffle (J9) at one shard,
    MESH_EPOCHS shuffled epochs of one graph replay each. Every epoch must
    deliver distinct rows, batches x batch of them; the first epoch's losses
    are held against an eager twin on the same batches."""
    url = 'file://' + os.path.join(tmp, 'mnist')   # phase 9's store
    model, optimizer, twin, twin_opt = mnist_model(seed + 2)
    step = mesh_mnist_step(model, optimizer)
    state = (model, optimizer)
    reader = make_reader(url, workers_count=4, shuffle_row_groups=True, seed=42, num_epochs=1)
    loader = InMemTorchLoader(reader, batch_size=MNIST_BATCH, num_epochs=None, shuffle=True,
                              seed=7, mesh=mesh)
    batches = loader.num_rows // MNIST_BATCH
    rows = batches * MNIST_BATCH
    def one_epoch():
        (aux,) = loader.scan_epochs(step, state=state)
        float(aux[0][-1])   # the last loss on the host: the replay has run
        return aux

    epochs, delivered = [], []
    for epoch in range(MESH_EPOCHS):
        (losses, idx), elapsed = timed(one_epoch)
        losses = losses.tolist()
        check_permutation(loader._index, loader.num_rows)
        delivered.append(int(torch.unique(idx).numel()))
        check(idx.numel() == rows and delivered[-1] == rows,
              '15b epoch {} delivered {} rows, {} distinct, expected {} once each'.format(
                  epoch, idx.numel(), delivered[-1], rows))
        check(np.isfinite(losses).all(), 'non-finite 15b loss {}'.format(losses))
        if epoch == 0:
            index = loader._index.clone()
            data = loader._data
            twin_step = mnist_step(twin, twin_opt)
            eager = [twin_step({name: col.index_select(
                0, index[i * MNIST_BATCH:(i + 1) * MNIST_BATCH]) for name, col in data.items()})
                for i in range(batches)]
            agreement = loss_agreement(losses, eager, MNIST_LOSS_RTOL)
        epochs.append({'s': elapsed, 'rows_per_s': rows / elapsed, 'last_loss': losses[-1]})
    (program,) = loader._scan_cache.programs()
    check(program.replays == MESH_EPOCHS, '15b ran {} graph replays for {} epochs'.format(
        program.replays, MESH_EPOCHS))
    shuffle_ms = cuda_ms(lambda: loader._epoch_indices(1000), reps=10)
    return {'rows': rows, 'batches_per_epoch': batches, 'epochs': epochs,
            'epoch_ms': statistics.median(e['s'] for e in epochs[1:]) * 1e3,
            'rows_per_s': statistics.median(e['rows_per_s'] for e in epochs[1:]),
            'delivered': delivered, 'first_epoch': agreement, 'replays': program.replays,
            'capture_s': program.capture_s, 'shard_shuffle_ms': shuffle_ms,
            'shard': list(loader._shard)}


def phase_mnist_stream_mesh(tmp, seed, mesh):
    """15c: phase 10's stream (the in-line reader, seed 0) through
    TorchDataLoader.scan_stream over the mesh: every chunk's batches must
    equal the mesh-less loader's bit for bit; then MESH_STREAM_PASSES timed
    training passes on a thread pool of 4 after a warm-up pass."""
    url = 'file://' + os.path.join(tmp, 'mnist')   # phase 9's store

    def inline_reader():
        return make_reader(url, reader_pool_type='dummy', shuffle_row_groups=True, seed=42)

    def record(batch):
        return {name: value.to_local() if isinstance(value, DTensor) else value
                for name, value in batch.items()}

    with inline_reader() as reader:
        got = TorchDataLoader(reader, batch_size=MNIST_BATCH, mesh=mesh,
                              partition_spec=PartitionSpec('data')).scan_stream(
            record, chunk_batches=MNIST_CHUNK, seed=0, state=())
    with inline_reader() as reader:
        want = TorchDataLoader(reader, batch_size=MNIST_BATCH).scan_stream(
            record, chunk_batches=MNIST_CHUNK, seed=0, state=())
    check(len(got) == len(want) > 0
          and all(sorted(g) == sorted(w) and all(torch.equal(g[k], w[k]) for k in w)
                  for g, w in zip(got, want)),
          '15c: scan_stream over the mesh gave other batches than the mesh-less loader')
    model, optimizer, _, _ = mnist_model(seed + 3)
    step = mesh_mnist_step(model, optimizer)
    passes = []
    with make_reader(url, workers_count=4, shuffle_row_groups=True, seed=42,
                     num_epochs=1) as reader:
        loader = TorchDataLoader(reader, batch_size=MNIST_BATCH, mesh=mesh,
                                 partition_spec=PartitionSpec('data'))
        for index in range(MESH_STREAM_PASSES + 1):
            def one_pass():
                aux = loader.scan_stream(step, chunk_batches=MNIST_CHUNK, seed=index,
                                         state=(model, optimizer))
                float(aux[-1][0][-1])
                return sum(int(a[0].shape[0]) for a in aux) * MNIST_BATCH
            rows, elapsed = timed(one_pass)
            passes.append({'s': elapsed, 'rows': rows, 'rows_per_s': rows / elapsed})
    return {'chunks': len(got), 'batches': sum(int(g['idx'].shape[0]) for g in got),
            'passes': passes,
            'rows_per_s': statistics.median(p['rows_per_s'] for p in passes[1:])}


def phase_data_pipeline(tmp, seed):
    """Phase 15 on a one-rank NCCL group (``initialize_distributed`` on a
    file store of its own in the run's temporary directory, destroyed at
    the end): 15a the pipelined flash LM on a ('stage', 'data') mesh of 1 x
    1, 15b J9 and 15c scan_stream on a ('data',) mesh of 1."""
    start = time.perf_counter()
    check(initialize_distributed(init_method='file://' + os.path.join(tmp, 'phase15_store'),
                                 world_size=1, rank=0),
          'a process group was already up before phase 15')
    try:
        result = {'pipeline': phase_pipeline_lm(tmp, seed, make_mesh(('stage', 'data'), (1, 1)))}
        data_mesh = make_mesh(('data',), (1,))
        result['mnist_mesh'] = phase_mnist_mesh(tmp, seed, data_mesh)
        result['stream_mesh'] = phase_mnist_stream_mesh(tmp, seed, data_mesh)
    finally:
        dist.destroy_process_group()
    result['phase_s'] = time.perf_counter() - start
    return result


def data_pipeline_lines(result, lm, mnist_inmem, mnist_stream, card):
    pipe, inmem, stream = result['pipeline'], result['mnist_mesh'], result['stream_mesh']
    return [
        'phase 15a pipelined flash LM (TorchDataLoader(batch_size={}, mesh stage x data = 1 '
        'x 1) -> embed -> make_pipeline, {} stage of {} flash Blocks, {} microbatches -> '
        'head; stage shift {}): {} steps (1 warm-up): tokens/s={:.1f} step_ms(median)={:.2f} '
        'model TFLOP/s={:.3f} MFU={:.5f} peak_memory={:.3f} GiB input_stall_fraction={:.4f} '
        'losses {:.4f}->{:.4f} launches {}; unpipelined TransformerLM on the same rows '
        'step_ms(median)={:.2f} (pipeline / unpipelined {:.4f}), one profiled step: {}; '
        'first batch vs unpipelined {}; one profiled step: {} calls {}; beside phase 7 '
        '(batch {}): tokens/s={:.1f} [{}]'.format(
            PIPE_BATCH, pipe['stages'], LM['layers'], PIPE_MICRO, pipe['stage_shift'],
            pipe['steps_run'], pipe['tokens_per_s'], pipe['step_ms_median'],
            pipe['model_tflops_per_s'], pipe['mfu'], pipe['peak_memory_bytes'] / 2 ** 30,
            pipe['input_stall_fraction'], pipe['losses'][0], pipe['losses'][-1],
            pipe['launches'], pipe['unpipelined_step_ms'], pipe['overhead'],
            breakdown_line(pipe['unpipelined_breakdown']),
            {key: round(value, 7) for key, value in pipe['first_batch'].items()},
            breakdown_line(pipe['breakdown']), pipe['breakdown']['calls'], LM_BATCH,
            lm['tokens_per_s'], card),
        'phase 15b MNIST InMemTorchLoader(mesh data = 1).scan_epochs (shard {} of {}, J9 '
        'per-shard shuffle): epoch_ms(median of epochs 1-{})={:.3f} rows/s={:.1f} beside '
        'phase 9 epoch_ms(median)={:.3f} rows/s={:.1f}; {} replays for {} epochs, '
        'capture {:.3f} s; rows delivered once an epoch {}; first epoch graph vs eager max '
        'rel err {:.3e} (limit {:.1e}); per-shard shuffle {:.4f} ms beside phase 9\'s J4 '
        '{:.4f} ms [{}]'.format(
            inmem['shard'][0], inmem['shard'][1], MESH_EPOCHS - 1, inmem['epoch_ms'],
            inmem['rows_per_s'],
            statistics.median(e['s'] for e in mnist_inmem['epochs']) * 1e3,
            mnist_inmem['rows_per_s'], inmem['replays'], MESH_EPOCHS,
            inmem['capture_s'], inmem['delivered'], inmem['first_epoch']['max_rel_err'],
            inmem['first_epoch']['rtol'], inmem['shard_shuffle_ms'], mnist_inmem['j4_ms'],
            card),
        'phase 15c MNIST TorchDataLoader(mesh data = 1).scan_stream: {} chunks ({} batches) '
        'equal to the mesh-less loader\'s bit for bit; rows/s={:.1f} (median of passes 1-{}) '
        'beside phase 10 rows/s={:.1f}; phase 15 took {:.1f} s [{}]'.format(
            stream['chunks'], stream['batches'], stream['rows_per_s'], MESH_STREAM_PASSES,
            mnist_stream['rows_per_s'], result['phase_s'], card)]


# ----------------------------------------- the reference petastorm's API (phase 16)

#: the example twins driven in-process by phase 16d
TWINS = ('long_context', 'imagenet', 'mnist', 'converter')


def optional_imports():
    """Whether each module that the port imports only where it is needed
    (``cv2``, ``pandas``, ``dill``) imports on this machine."""
    found = {}
    for name in ('cv2', 'pandas', 'dill'):
        try:
            importlib.import_module(name)
            found[name] = True
        except ImportError:
            found[name] = False
    return found


def token_table():
    """Phase 7's 64 rows of int32 (8192,) tokens as a ``pyarrow.Table``:
    ``doc_id`` int64 and ``tokens`` ``list<int32>``."""
    tokens = np.stack(token_rows(LM_ROWS, LM['max_len']))
    offsets = np.arange(0, tokens.size + 1, LM['max_len'], dtype=np.int32)
    return pa.table({'doc_id': pa.array(np.arange(LM_ROWS, dtype=np.int64)),
                     'tokens': pa.ListArray.from_arrays(offsets, tokens.reshape(-1))}), tokens


def recorded(batches, seen):
    """``batches``, each one's ``doc_id`` and ``tokens`` kept in ``seen`` on
    the host (a readback a step, outside the step's own time)."""
    for batch in batches:
        seen.append((batch['doc_id'].cpu().numpy(), batch['tokens'].cpu().numpy()))
        yield batch


def store_files(path):
    """``{file name: mtime_ns}`` of every file in a store directory."""
    return {name: os.stat(os.path.join(path, name)).st_mtime_ns
            for name in sorted(os.listdir(path))}


def phase_converter_lm(tmp, seed):
    """16a: phase 7's tokens as an Arrow table -> make_converter ->
    make_torch_loader (one worker, rowgroups in order) -> phase 7's LM with
    the flash kernels and Adam for 1 + LM_STEPS steps, then the rest of the
    epoch. Every batch must be the table's rows in order; K2-K4 launch layers
    x steps times each; a second make_converter of the table is a cache hit
    that writes nothing, and delete() removes the store."""
    table, tokens = token_table()
    parent = os.path.join(tmp, 'converter_cache')
    start = time.perf_counter()
    converter = make_converter(table, parent_cache_dir_url='file://' + parent)
    convert_s = time.perf_counter() - start
    store = converter.cache_dir_url.replace('file://', '')
    before = store_files(store)
    again = make_converter(table, parent_cache_dir_url='file://' + parent)
    check(again.cache_dir_url == converter.cache_dir_url
          and again.file_urls == converter.file_urls and store_files(store) == before,
          'a second make_converter of the same table was not a cache hit')
    torch.manual_seed(seed)
    model = TransformerLM(dtype=torch.bfloat16, attention_fn=causal_flash, **LM)
    optimizer = torch.optim.Adam(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8)
    flops = transformer_train_flops_per_step(LM_BATCH, LM['max_len'], LM['vocab'],
                                             LM['embed'], LM['layers'])
    seen = []
    with converter.make_torch_loader(
            batch_size=LM_BATCH, shuffle_row_groups=False, workers_count=1,
            loader_kwargs={'pad_ragged': {'tokens': (LM['max_len'],)}}) as loader:
        batches = recorded(iter(loader), seen)
        torch.cuda.reset_peak_memory_stats()
        # what earlier phases left allocated counts in the peak too
        at_reset = torch.cuda.memory_allocated()
        reset_counts()
        losses, step_s, window_s = train_lm(
            batches, optimizer, LM_STEPS + 1,
            lambda batch: next_token_loss(model(batch['tokens']), batch['tokens']))
        counts = read_counts()
        stats = loader.stats.as_dict()
        for _ in batches:   # the rest of the epoch
            pass
    result = lm_metrics(losses, step_s, window_s, stats, LM_BATCH * LM['max_len'], flops)
    launches = {name: counts[name] for name in FLASH_PRODUCTS}
    expected = LM['layers'] * result['steps_run']
    check(all(n == expected for n in launches.values()) and counts['dense_fallbacks'] == 0,
          'converter LM: flash kernels launched {} times ({} dense), expected {} each'
          .format(launches, counts['dense_fallbacks'], expected))
    check(all(np.isfinite(losses)), 'non-finite converter LM loss {}'.format(losses))
    doc_ids = np.concatenate([ids for ids, _ in seen])
    check(doc_ids.tolist() == list(range(LM_ROWS))
          and np.array_equal(np.concatenate([t for _, t in seen]), tokens),
          'the converter loader\'s batches are not the table\'s rows in order')
    converter.delete()
    check(not os.path.exists(store), 'delete() left the converter store behind')
    result.update(convert_s=convert_s, launches=launches, counts=counts,
                  rows_checked=int(doc_ids.size), store_files=len(before),
                  memory_at_reset_bytes=at_reset)
    return result


def mnist_table(seed):
    """Phase 9's 50,000 MNIST rows as a ``pyarrow.Table``: ``idx`` and
    ``digit`` int64, ``image`` ``list<uint8>`` of 784 values."""
    rows = mnist_rows(MNIST_ROWS, seed)
    images = np.stack([row['image'] for row in rows]).reshape(-1)
    offsets = np.arange(0, images.size + 1, 784, dtype=np.int32)
    return pa.table({
        'idx': pa.array(np.array([row['idx'] for row in rows], dtype=np.int64)),
        'digit': pa.array(np.array([row['digit'] for row in rows], dtype=np.int64)),
        'image': pa.ListArray.from_arrays(offsets, images)})


def adapter_epochs(loader, step, epochs, batches_per_epoch=None):
    """Run ``epochs`` epochs of ``loader`` (one pass, or ``batches_per_epoch``
    batches an epoch of one pass) through the eager ``step``; returns each
    epoch's ``idx`` values and wall seconds (to a readback of its last
    loss)."""
    out = []
    batches = iter(loader)
    for _ in range(epochs):
        start = time.perf_counter()
        ids, loss = [], None
        for index, batch in enumerate(batches):
            check(batch['image'].device.type == 'cuda', 'an adapter batch is not on the card')
            ids.append(batch['idx'])
            loss = step({'image': batch['image'].reshape(-1, 28, 28),
                         'digit': batch['digit']})
            if batches_per_epoch is not None and index + 1 == batches_per_epoch:
                break
        check(loss is not None and np.isfinite(float(loss)), 'non-finite MNIST loss')
        out.append((torch.cat(ids).cpu().numpy(), time.perf_counter() - start))
    return out


def phase_adapters(tmp, seed):
    """16b: the reference API's loaders onto the card into eager MnistCNN
    steps: one epoch of the converter's store through
    ``make_torch_dataloader`` (BatchedDataLoader), one of phase 9's store
    through ``DataLoader(make_reader(...))`` (row collate) and two of the
    converter's store through ``InMemBatchedDataLoader(make_batch_reader(...),
    num_epochs=2)``, which serves full batches only. Each epoch's ``idx``
    values must be distinct: all 50,000 rows for the streaming loaders, every
    full batch's worth for the in-memory one."""
    start = time.perf_counter()
    converter = make_converter(mnist_table(seed),
                               parent_cache_dir_url='file://' + os.path.join(tmp, 'mnist_conv'))
    convert_s = time.perf_counter() - start
    model, optimizer, _, _ = mnist_model(seed + 2)
    step = mnist_step(model, optimizer)
    result = {'convert_s': convert_s}
    with converter.make_torch_dataloader(batch_size=MNIST_BATCH) as loader:
        result['batched'] = adapter_epochs(loader, step, 1)
    with DataLoader(make_reader('file://' + os.path.join(tmp, 'mnist'), workers_count=4),
                    batch_size=MNIST_BATCH) as loader:
        result['rows'] = adapter_epochs(loader, step, 1)
    full = MNIST_ROWS // MNIST_BATCH
    loader = InMemBatchedDataLoader(make_batch_reader(converter.file_urls, workers_count=4),
                                    batch_size=MNIST_BATCH, num_epochs=2)
    result['inmem'] = adapter_epochs(loader, step, 2, batches_per_epoch=full)
    converter.delete()
    summary = {'convert_s': convert_s}
    for name, epochs in result.items():
        if name == 'convert_s':
            continue
        want = MNIST_ROWS if name != 'inmem' else full * MNIST_BATCH
        for ids, _ in epochs:
            check(ids.size == want and np.unique(ids).size == want
                  and ids.min() >= 0 and ids.max() < MNIST_ROWS,
                  '{} loader: an epoch held {} idx values ({} distinct), expected {}'
                  .format(name, ids.size, np.unique(ids).size, want))
        summary[name] = {'epochs': len(epochs), 'rows_per_epoch': want,
                         'epoch_s': [s for _, s in epochs],
                         'rows_per_s': [want / s for _, s in epochs]}
    return summary


def first_decoded_batches(url, factory, count, batch_size, **loader_kwargs):
    """The first ``count`` batches of phase 5's store, rowgroups in order on
    one worker, decoded on the card with no augment, copied to the host."""
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')   # make_batch_reader on a Unischema store
        reader = factory(url, workers_count=1, shuffle_row_groups=False,
                         device_decode_fields=['image', 'embedding'])
    with reader:
        loader = TorchDataLoader(reader, batch_size=batch_size, **loader_kwargs)
        out = [{name: t.cpu() for name, t in batch.items()}
               for _, batch in zip(range(count), loader)]
        stats = loader.stats.as_dict()
    return out, stats


def same_batch(a, b):
    return sorted(a) == sorted(b) and all(
        a[name].dtype == b[name].dtype and torch.equal(a[name], b[name]) for name in a)


def phase_batch_decode(tmp, args):
    """16c: phase 5's store through ``make_batch_reader(device_decode_fields=
    ['image', 'embedding'])`` -> phase 5's loader (K1, DCT decode, crop, flip,
    bf16 normalize) -> ResNet-50 for one epoch of SGD steps (phase 5's
    checks: K1 on every batch, every row once with its label and embedding
    bytes); then the first two decoded batches against
    ``make_reader(device_decode_fields=...)``'s, bit for bit, the first
    uploaded field by field against the packed upload, and a plain store,
    which must raise."""
    url = 'file://' + os.path.join(tmp, 'imagenet')
    main_path, delivered = phase_main_path(url, args, factory=make_batch_reader)
    main_path['distinct_rows'] = check_delivered(delivered, args.seed)
    check(main_path['distinct_rows'] == main_path['rows'] == args.rows,
          'make_batch_reader: rows repeated or lost')
    reset_counts()
    ours, stats = first_decoded_batches(url, make_batch_reader, 2, args.batch)
    rows, _ = first_decoded_batches(url, make_reader, 2, args.batch)
    single, single_stats = first_decoded_batches(url, make_batch_reader, 1, args.batch,
                                                 coalesce_fields=False)
    check(len(ours) == len(rows) == 2 and all(same_batch(a, b) for a, b in zip(ours, rows)),
          'make_batch_reader\'s decoded batches differ from make_reader\'s')
    check(same_batch(single[0], ours[0]) and stats['coalesced_uploads'] >= 2
          and single_stats['per_field_uploads'] >= 1 and single_stats['coalesced_uploads'] == 0,
          'the field-by-field upload differs from the packed one ({}, {})'.format(
              stats, single_stats))
    refused = None
    try:
        make_batch_reader('file://' + os.path.join(tmp, 'ragged'),
                          device_decode_fields=['tokens'])
    except ValueError as exc:
        refused = str(exc)
    check(refused is not None and 'requires a Unischema store' in refused,
          'make_batch_reader(device_decode_fields=...) on a plain store did not raise')
    main_path.update(parity_batches=len(ours), parity_k1_launches=read_counts()['stored_copy'],
                     plain_store_refused=refused[:80])
    return main_path


def phase_twins(tmp, seed):
    """16d: each example twin's ``main(argv)`` in this process, at one rank:
    the long-context twin ``--packed`` at phase 8's width (its segmented
    K2-K4 must launch layers x steps times each), the ImageNet twin
    ``--on-chip-decode`` at ResNet-50's width on 256 synthetic 224x224 DCT
    rows, the MNIST twin ``--inmem`` and the converter twin. Each must end
    with a finite loss."""
    from examples.long_context import torch_example as long_context
    twins = {name: importlib.import_module(
        'examples.{0}.torch_{1}example'.format(name, 'converter_' if name == 'converter'
                                                 else '')) for name in TWINS}
    ragged = os.path.join(tmp, 'twin_ragged')
    long_context.build_ragged_dataset(ragged, num_docs=8192, max_len=48, seed=seed)
    steps, layers = 4, LM['layers']
    argv = {
        'long_context': ['--packed', '--dataset-url', ragged, '--seq-len', str(LM['max_len']),
                         '--embed', str(LM['embed']), '--heads', str(LM['heads']),
                         '--layers', str(layers), '--dtype', 'bfloat16', '--batch-size',
                         str(LM_BATCH), '--epochs', '1', '--max-steps', str(steps)],
        'imagenet': ['--on-chip-decode', '--dataset-url',
                     'file://' + os.path.join(tmp, 'twin_imagenet'), '--image-hw', '224',
                     '--stage-sizes', '3', '4', '6', '3', '--num-filters', '64',
                     '--batch-size', '128', '--generate-rows', '256'],
        'mnist': ['--inmem', '--dataset-url', 'file://' + os.path.join(tmp, 'twin_mnist')],
        'converter': ['--cache-dir', os.path.join(tmp, 'twin_converter')],
    }
    result = {}
    for name in TWINS:
        reset_counts()
        start = time.perf_counter()
        loss = twins[name].main(argv[name])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - start
        counts = read_counts()
        check(loss is not None and np.isfinite(loss),
              '{} twin ended with loss {}'.format(name, loss))
        result[name] = {'loss': float(loss), 'wall_s': wall_s, 'counts': counts}
    counts = result['long_context']['counts']
    launches = {name: counts[name] for name in FLASH_PRODUCTS}
    check(all(n == layers * steps for n in launches.values())
          and counts['dense_fallbacks'] == 0,
          'long-context twin: flash kernels launched {}, expected {} each'
          .format(launches, layers * steps))
    result['long_context']['launches'] = launches
    return result


def reference_api_lines(result, record, card):
    lm, loaders, decode, twins = (result[k] for k in ('converter_lm', 'adapters',
                                                       'batch_decode', 'twins'))
    stream = record['mnist_stream']['rows_per_s']
    yield ('phase 16a converter -> make_torch_loader -> TransformerLM [{}x{}] bf16: {} steps '
           '(1 warm-up) tokens/s={:.1f} step_ms(median)={:.2f} input_stall_fraction={:.4f} '
           'peak_memory={:.3f} GiB (allocated at its reset {:.3f} GiB) losses {:.4f}->{:.4f} '
           'launches {} ({} rows in order; '
           'phase 7: tokens/s={:.1f} step_ms(median)={:.2f} input_stall_fraction={:.4f} '
           'peak_memory={:.3f} GiB); cache hit, delete ok, conversion {:.3f} s [{}]'.format(
               LM_BATCH, LM['max_len'], lm['steps_run'], lm['tokens_per_s'],
               lm['step_ms_median'], lm['input_stall_fraction'],
               lm['peak_memory_bytes'] / 2 ** 30, lm['memory_at_reset_bytes'] / 2 ** 30,
               lm['losses'][0], lm['losses'][-1],
               lm['launches'], lm['rows_checked'], record['lm']['tokens_per_s'],
               record['lm']['step_ms_median'], record['lm']['input_stall_fraction'],
               record['lm']['peak_memory_bytes'] / 2 ** 30, lm['convert_s'], card))
    yield ('phase 16b reference loaders into eager MnistCNN steps, rows/s by epoch: '
           'BatchedDataLoader (make_torch_dataloader) {} ({:.3f} of phase 10), DataLoader '
           '(row collate) {} ({:.3f}), InMemBatchedDataLoader {} ({:.3f}); phase 10 '
           'TorchDataLoader.scan_stream {:.1f}; each epoch\'s idx distinct; conversion '
           '{:.3f} s [{}]'.format(
               [round(x, 1) for x in loaders['batched']['rows_per_s']],
               loaders['batched']['rows_per_s'][0] / stream,
               [round(x, 1) for x in loaders['rows']['rows_per_s']],
               loaders['rows']['rows_per_s'][0] / stream,
               [round(x, 1) for x in loaders['inmem']['rows_per_s']],
               statistics.median(loaders['inmem']['rows_per_s']) / stream,
               stream, loaders['convert_s'], card))
    yield ('phase 16c make_batch_reader(device_decode_fields) -> ResNet-50: {} steps '
           'rows/s={:.2f} input_stall_fraction={:.4f} step_ms(median)={:.2f} K1 launches {} '
           '(phase 5: rows/s={:.2f} input_stall_fraction={:.4f}); first {} batches equal '
           'make_reader\'s bit for bit, coalesced and not; a plain store raises [{}]'.format(
               decode['steps'], decode['rows_per_s'], decode['input_stall_fraction'],
               decode['step_ms_median'], decode['k1_launches'],
               record['main_path']['rows_per_s'], record['main_path']['input_stall_fraction'],
               decode['parity_batches'], card))
    yield ('phase 16d example twins, wall s (final loss): {}; long-context launches {} '
           '[{}]'.format({name: '{:.2f} ({:.4f})'.format(twins[name]['wall_s'],
                                                         twins[name]['loss'])
                          for name in TWINS}, twins['long_context']['launches'], card))


def phase_reference_api(tmp, args):
    """Phase 16: the reference petastorm's user surface on the card."""
    start = time.perf_counter()
    result = {'optional_imports': optional_imports()}
    log('phase 16 optional imports: {}'.format(result['optional_imports']))
    result['converter_lm'] = phase_converter_lm(tmp, args.seed)
    result['adapters'] = phase_adapters(tmp, args.seed)
    result['batch_decode'] = phase_batch_decode(tmp, args)
    result['twins'] = phase_twins(tmp, args.seed)
    result['phase_s'] = time.perf_counter() - start
    return result


# ------------------------------------- pipeline telemetry and autotuning (phase 17)

#: the stages phase 17a counts: every batch passes the first four, every
#: rowgroup the next three; d2d_wait once a batch past the decode tail's ring
TELEMETRY_BATCH_STAGES = ('h2d', 'shuffle_wait', 'device_decode')
TELEMETRY_ROWGROUP_STAGES = ('collate', 'rowgroup_read', 'decode')
#: 17b's autotuner: windows short enough for several decisions an epoch
MNIST_AUTOTUNE = AutotunePolicy(window_s=0.25, warmup_windows=1, hold_windows=1,
                                cooldown_windows=2)
#: 2 epochs, not 3, to keep phase 17 near 30 s (the autotuner decides within
#: its first second)
MNIST_AUTOTUNE_EPOCHS = 2
#: 17c's profiled window, in steps
TELEMETRY_PROFILED_STEPS = 2
#: 17c's armed step median may sit this far outside the unarmed pass's range
LM_STEP_RANGE_MARGIN = 0.1


def scrape(url):
    """``(status, body)`` of one GET of the local scrape endpoint."""
    with urllib.request.urlopen(url, timeout=10) as response:
        return response.status, response.read().decode('utf-8')


def prometheus_series(text):
    """``{series: value}`` of a Prometheus text exposition; a line that is
    neither a comment nor ``name{labels} value`` fails the phase."""
    series = {}
    for line in text.splitlines():
        if not line or line.startswith('#'):
            continue
        name, value = line.rsplit(' ', 1)
        check(re.match(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})?$', name) is not None,
              'a malformed exposition line {!r}'.format(line))
        series[name] = float(value)
    return series


def stage_counts(snapshot, stages):
    histograms = snapshot.get('histograms') or {}
    return {stage: (histograms.get(stage) or {}).get('count', 0) for stage in stages}


def wait_split(events, wall_s):
    """Fill against stall from the consumer's ``shuffle_wait`` spans of a
    trace, in order: the first batch's wait (the pipeline's fill), the
    others' sum, median and max (ms), and that sum's share of ``wall_s``."""
    waits = [e['dur_us'] / 1e3 for e in sorted(events, key=lambda e: e['ts_us'])
             if e['name'] == 'shuffle_wait']
    rest = waits[1:] or [0.0]
    return {'fill_ms': waits[0] if waits else 0.0, 'steady_ms': sum(rest),
            'steady_median_ms': statistics.median(rest), 'steady_max_ms': max(rest),
            'steady_share': sum(rest) / 1e3 / wall_s}


def timed_copy_upload(copies):
    """The loader's ``upload_columns`` with a CUDA event pair around the one
    pinned copy alone, on the current stream (the loader's side stream):
    the same packing and staging, then ``(start, end, bytes)`` appended to
    ``copies``."""
    def upload(columns, device, out=None):
        check(out is None, 'the timed upload serves the loader only')
        layout, nbytes = loader_module.packed_layout(columns)
        host = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                           pin_memory=device.type == 'cuda')
        host_np = host.numpy()
        for _, start, col in layout:
            host_np[start:start + col.nbytes] = col.reshape(-1).view(np.uint8)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
        buf = host.to(device, non_blocking=True)
        events[1].record()
        copies.append((events[0], events[1], nbytes))
        return {name: buf[start:start + col.nbytes].view(raw_decode.torch_dtype(col.dtype))
                .view(col.shape) for name, start, col in layout}
    return upload


def phase_telemetry_imagenet(tmp, args):
    """Phase 17a: phase 5's store and path, instrumented: ``make_reader(...,
    trace=True, metrics_port=0)`` on a process pool of ``args.workers`` (the
    one pool whose trace crosses processes, so the worker and consumer tracks
    join by flow arrows), the loader with ``metrics_port=0``, K1 and the
    decode tail, ResNet-50. Checks the stage counts against the batches and
    rowgroups, one ``/metrics`` and ``/healthz`` scrape during the run, the
    Chrome trace, the trace summary's stage names and the attribution; times
    the one pinned copy a batch on the card with CUDA events."""
    phase_start = time.perf_counter()
    url = 'file://' + os.path.join(tmp, 'imagenet')
    copies = []
    live = {}

    def inspect(reader, loader):
        status, text = scrape(loader.metrics_url + '/metrics')
        health, _ = scrape(loader.metrics_url + '/healthz')
        live.update(reader=reader, loader=loader, metrics_status=status,
                    series=prometheus_series(text), healthz_status=health)

    telemetry_tracing.reset_tracing()
    upload = loader_module.upload_columns
    loader_module.upload_columns = timed_copy_upload(copies)
    try:
        result, delivered = phase_main_path(
            url, args, reader_pool=ProcessPool(args.workers, shm_transport=True),
            inspect=inspect, factory=functools.partial(make_reader, trace=True, metrics_port=0),
            loader_kwargs={'metrics_port': 0})
    finally:
        loader_module.upload_columns = upload
    reader, loader = live['reader'], live['loader']
    try:
        snapshot = loader.telemetry_snapshot()
        chrome = json.loads(json.dumps(reader.dump_trace()))
        summary = reader.trace_summary()
        events = telemetry_tracing.trace_snapshot()['events']
        h2d_us = [e['dur_us'] for e in events if e['name'] == 'h2d']
        waits = wait_split(events, result['wall_s'])
    finally:
        loader.stop()
        telemetry_tracing.set_trace_enabled(False)
        telemetry_tracing.reset_tracing()
    torch.cuda.synchronize()
    steps, rowgroups = result['steps'], result['items_per_epoch']
    counts = stage_counts(snapshot, TELEMETRY_BATCH_STAGES + TELEMETRY_ROWGROUP_STAGES
                          + ('d2d_wait',))
    check(result['k1_launches'] == steps, '17a: K1 launched {} times on {} batches'.format(
        result['k1_launches'], steps))
    check(check_delivered(delivered, args.seed) == result['rows'] == args.rows,
          '17a: rows repeated or lost')
    check(all(counts[stage] == steps for stage in TELEMETRY_BATCH_STAGES)
          and all(counts[stage] == rowgroups for stage in TELEMETRY_ROWGROUP_STAGES),
          '17a: stage counts {} against {} batches and {} rowgroups'.format(
              counts, steps, rowgroups))
    ring = loader.device_buffer_depth
    check(counts['d2d_wait'] == max(0, steps - ring),
          '17a: {} d2d_wait spans, expected one a batch past the ring of {}'.format(
              counts['d2d_wait'], ring))
    series = live['series']
    check(live['metrics_status'] == 200 and live['healthz_status'] == 200
          and series.get('petastorm_tpu_h2d_count', 0) >= 1
          and any(name.startswith('petastorm_tpu_h2d_bucket{') for name in series),
          '17a: the scrape during the run: /metrics {}, /healthz {}, h2d series {}'.format(
              live['metrics_status'], live['healthz_status'],
              sorted(name for name in series if '_h2d_' in name)))
    consumer = [e for e in chrome['traceEvents']
                if e['ph'] == 'M' and 'consumer' in e['args']['name']]
    worker_tracks = [e for e in chrome['traceEvents']
                     if e['ph'] == 'M' and 'worker' in e['args']['name']]
    flows = [e for e in chrome['traceEvents'] if e['ph'] in ('s', 'f')]
    check(len(consumer) == 1 and len(worker_tracks) == args.workers
          and len(flows) == 2 * rowgroups,
          '17a: the trace has {} consumer and {} worker tracks and {} flow events for {} '
          'rowgroups'.format(len(consumer), len(worker_tracks), len(flows), rowgroups))
    missing = sorted(set(TELEMETRY_BATCH_STAGES + TELEMETRY_ROWGROUP_STAGES + ('d2d_wait',))
                     - set(summary['by_name']))
    check(not missing and summary['dropped_events'] == 0,
          '17a: the trace summary misses {} (dropped {})'.format(missing,
                                                                 summary['dropped_events']))
    report = attribute_bottleneck(snapshot)
    check(report['top_stage'] is not None and report['recommendation'],
          '17a: attribution named no stage: {}'.format(report))
    copy_ms = [start.elapsed_time(end) for start, end, _ in copies]
    copy_bytes = [nbytes for _, _, nbytes in copies]
    check(len(copies) == steps, '17a: {} timed copies for {} batches'.format(len(copies),
                                                                             steps))
    copy_median = statistics.median(copy_ms)
    bytes_median = statistics.median(copy_bytes)
    return {'steps': steps, 'rowgroups': rowgroups, 'rows': result['rows'],
            'rows_per_s': result['rows_per_s'],
            'input_stall_fraction': result['input_stall_fraction'],
            'step_ms_median': result['step_ms_median'], 'k1_launches': result['k1_launches'],
            'stage_counts': counts,
            'shares': {row['stage']: row['share'] for row in report['ranked']},
            'top_stage': report['top_stage'], 'recommendation': report['recommendation'],
            'h2d_span_ms_median': statistics.median(h2d_us) / 1e3, 'waits': waits,
            'copy_ms': copy_ms, 'copy_ms_median': copy_median, 'copy_bytes': copy_bytes,
            'copy_gb_per_s': bytes_median / (copy_median * 1e6),
            'trace_events': summary['events'], 'flow_events': len(flows),
            'processes': len(summary['processes']),
            'metrics_series': len(series), 'phase_s': time.perf_counter() - phase_start}


def mnist_eager_pass(url, step, epochs=1, **reader_kwargs):
    """``epochs`` epochs of phase 10's stream through the eager MnistCNN step
    (a thread pool of 4, batch MNIST_BATCH): rows/s to a readback of the
    last loss, the ``idx`` values each epoch delivered (each once), the
    loader's snapshot and the reader's autotune report."""
    with make_reader(url, workers_count=4, shuffle_row_groups=True, seed=42,
                     num_epochs=epochs, **reader_kwargs) as reader:
        seen = observe_items(reader)
        loader = TorchDataLoader(reader, batch_size=MNIST_BATCH)
        start = time.perf_counter()
        losses = [step(batch) for batch in loader]
        last = float(losses[-1])
        elapsed = time.perf_counter() - start
        stats = loader.stats.as_dict()
        snapshot = loader.telemetry_snapshot()
        report = reader.autotune_report()
        breakers = reader.diagnostics['breakers']
    epoch_idx_once(seen, epochs)
    check(np.isfinite(last), 'non-finite MNIST loss {}'.format(last))
    return {'s': elapsed, 'rows': stats['rows'], 'rows_per_s': stats['rows'] / elapsed,
            'input_stall_fraction': stats['input_stall_fraction'], 'last_loss': last,
            'stage_counts': stage_counts(snapshot, ('shuffle_wait', 'h2d', 'collate',
                                                    'decode', 'pool_wait')),
            'autotune': report, 'breakers': breakers}


def mnist_mode_pass(url, step, mode):
    """One epoch of :func:`mnist_eager_pass` with telemetry ``'off'``,
    ``'on'`` or ``'traced'`` (the flight recorder armed); the switches are
    restored after it. A traced pass also counts its trace events."""
    if mode == 'off':
        telemetry_registry.set_telemetry_enabled(False)
        try:
            return mnist_eager_pass(url, step)
        finally:
            telemetry_registry.set_telemetry_enabled(True)
    if mode == 'on':
        return mnist_eager_pass(url, step)
    telemetry_tracing.reset_tracing()
    try:
        result = mnist_eager_pass(url, step, trace=True)
        result['trace_events'] = len(telemetry_tracing.trace_snapshot()['events'])
        return result
    finally:
        telemetry_tracing.set_trace_enabled(False)
        telemetry_tracing.reset_tracing()


#: 17b's passes after a warm-up epoch: each mode twice, in mirrored order, so
#: the drift of the run weighs on every mode alike
MNIST_MODE_ORDER = ('off', 'on', 'traced', 'traced', 'on', 'off')


def phase_telemetry_mnist(tmp, seed):
    """Phase 17b: phase 10's MNIST stream (50,000 rows, batch 2048) through
    eager MnistCNN steps: a warm-up epoch, then one epoch each in
    MNIST_MODE_ORDER with telemetry off, on, and on with the flight recorder
    (overhead from each mode's median rows/s); then a reader with
    ``autotune=`` for MNIST_AUTOTUNE_EPOCHS epochs: each epoch's ``idx``
    once, at least two decisions, every knob within its bounds, no
    breaker."""
    phase_start = time.perf_counter()
    url = 'file://' + os.path.join(tmp, 'mnist')   # phase 9's store
    model, optimizer, _, _ = mnist_model(seed + 3)
    step = mnist_step(model, optimizer)
    warm_up = mnist_eager_pass(url, step)
    passes = {mode: [] for mode in MNIST_MODE_ORDER}
    for mode in MNIST_MODE_ORDER:
        passes[mode].append(mnist_mode_pass(url, step, mode))
    batches = MNIST_ROWS // MNIST_BATCH
    for run in passes['off']:
        check(not any(run['stage_counts'].values()),
              '17b: telemetry off still recorded {}'.format(run['stage_counts']))
    for mode in ('on', 'traced'):
        for run in passes[mode]:
            check(run['stage_counts']['shuffle_wait'] == run['stage_counts']['h2d'] == batches,
                  '17b {}: stage counts {} for {} batches'.format(mode, run['stage_counts'],
                                                                   batches))
    check(all(run['trace_events'] > 0 for run in passes['traced']),
          '17b: a traced pass recorded no event')
    rate = {mode: statistics.median(run['rows_per_s'] for run in runs)
            for mode, runs in passes.items()}
    tuned = mnist_eager_pass(url, step, epochs=MNIST_AUTOTUNE_EPOCHS, autotune=MNIST_AUTOTUNE)
    report = tuned['autotune']
    decisions = report['decisions']
    check(report['enabled'] and len(decisions) >= 2,
          '17b: the autotuner made {} decisions in {} windows'.format(len(decisions),
                                                                     report['windows']))
    out_of_bounds = {knob_id: knob for knob_id, knob in report['knobs'].items()
                     if not knob['min'] <= knob['value'] <= knob['max']}
    check(not out_of_bounds, '17b: knobs out of their bounds: {}'.format(out_of_bounds))
    check(not tuned['breakers'] and report['freezes'] == 0,
          '17b: breakers {} tripped, {} freezes'.format(tuned['breakers'], report['freezes']))
    return {'warm_up': warm_up, 'passes': passes, 'rows_per_s': rate,
            'trace_events': passes['traced'][0]['trace_events'],
            'overhead_on': 1 - rate['on'] / rate['off'],
            'overhead_traced': 1 - rate['traced'] / rate['off'],
            'autotune': tuned,
            'decisions': [{key: d[key] for key in ('window', 'action', 'knob', 'from', 'to',
                                                   'rate_rows_per_sec')}
                          for d in decisions],
            'knobs': {knob_id: knob['value'] for knob_id, knob in report['knobs'].items()},
            'phase_s': time.perf_counter() - phase_start}


def profiled_loader_steps(batches, optimizer, step_loss, steps):
    """``steps`` Adam steps on batches from a loader's iterator under
    ``torch.profiler`` (every thread, so the producer's ``h2d`` ranges show):
    ``{range or flash kernel: count}``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    try:
        kwargs = {'experimental_config':
                  torch._C._profiler._ExperimentalConfig(profile_all_threads=True)}
    except TypeError:   # an older torch: the producer's ranges will not show
        kwargs = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **kwargs) as prof:
        for _ in range(steps):
            adam_step(optimizer, step_loss, next(batches))
        torch.cuda.synchronize()
    counts = dict.fromkeys(list(FLASH_KERNEL_NAMES) + ['wait_input', 'h2d'], 0)
    counts['all_threads'] = bool(kwargs)
    for event in prof.key_averages():
        if event.device_type == DeviceType.CUDA:
            for name, key in FLASH_KERNEL_NAMES.items():
                if key in event.key:
                    counts[name] += event.count
        elif event.key.startswith('petastorm_tpu_torch.loader.'):
            name = event.key.rsplit('.', 1)[1]
            counts[name] = counts.get(name, 0) + event.count
    return counts


def phase_telemetry_lm(tmp, seed, lm):
    """Phase 17c: phase 7's store, model and Adam, 1 + LM_STEPS steps first
    with the flight recorder off (phase 7 again at this point of the run),
    then with the reader's recorder armed (K2-K4 layers x steps each; its
    step median within the unarmed pass's range, widened by
    LM_STEP_RANGE_MARGIN, and printed beside phase 7's ``lm``), then a
    profiled window where the loader's ``wait_input`` and ``h2d`` ranges show
    once a batch beside K2-K4; then one ``scan_stream`` pass of
    LM_GRAPH_CHUNK-step graphs (the capture), then a second (replays) with
    telemetry armed: no launch outside the graph in the second, and ``h2d``
    one span a chunk in both."""
    phase_start = time.perf_counter()
    path = 'file://' + os.path.join(tmp, 'tokens')   # phase 7's store
    torch.manual_seed(seed)
    model = TransformerLM(dtype=torch.bfloat16, attention_fn=causal_flash, **LM)
    optimizer = torch.optim.Adam(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8)

    def step_loss(batch):
        return next_token_loss(model(batch['tokens']), batch['tokens'])

    def lm_pass(trace):
        with make_reader(path, workers_count=2, seed=seed, trace=trace) as reader:
            loader = TorchDataLoader(reader, batch_size=LM_BATCH, shuffling_queue_capacity=16,
                                     seed=3, drop_last=True)
            batches = iter(loader)
            reset_counts()
            losses, step_s, _ = train_lm(batches, optimizer, LM_STEPS + 1, step_loss)
            counts = read_counts()
            waits = (wait_split(telemetry_tracing.trace_snapshot()['events'], sum(step_s))
                     if trace else None)
            profiled = (profiled_loader_steps(batches, optimizer, step_loss,
                                              TELEMETRY_PROFILED_STEPS) if trace else None)
            return losses, step_s, counts, profiled, loader.prefetch, waits

    telemetry_tracing.reset_tracing()
    try:
        plain_losses, plain_step_s = lm_pass(trace=False)[:2]
        losses, step_s, counts, profiled, prefetch, waits = lm_pass(trace=True)
        losses += plain_losses
        trace_events = len(telemetry_tracing.trace_snapshot()['events'])
        graph_model = TransformerLM(dtype=torch.bfloat16, attention_fn=causal_flash, **LM)
        graph_optimizer = torch.optim.Adam(graph_model.parameters(), lr=3e-4,
                                           betas=(0.9, 0.999), eps=1e-8, capturable=True)

        def graph_step(batch):
            return adam_step(graph_optimizer, lambda b: next_token_loss(
                graph_model(b['tokens']), b['tokens']), batch)

        with make_reader(path, workers_count=2, seed=seed) as reader:
            loader = TorchDataLoader(reader, batch_size=LM_BATCH)
            # the first pass captures (its warm-up steps launch eagerly, as
            # 7b's); the counted pass replays
            first = loader.scan_stream(graph_step, chunk_batches=LM_GRAPH_CHUNK,
                                       state=(graph_model, graph_optimizer))
            reset_counts()
            aux = loader.scan_stream(graph_step, chunk_batches=LM_GRAPH_CHUNK,
                                     state=(graph_model, graph_optimizer))
            graph_losses = torch.cat(first + aux).tolist()
            graph_counts = read_counts()
            graph_h2d = stage_counts(loader.telemetry.snapshot(), ('h2d',))['h2d']
    finally:
        telemetry_tracing.set_trace_enabled(False)
        telemetry_tracing.reset_tracing()
    steps = len(step_s)
    launches = {name: counts[name] for name in FLASH_PRODUCTS}
    check(all(n == LM['layers'] * steps for n in launches.values()),
          '17c: flash kernels launched {} times, expected {} each'.format(
              launches, LM['layers'] * steps))
    check(all(np.isfinite(losses + graph_losses)), '17c: non-finite loss')
    window = TELEMETRY_PROFILED_STEPS
    check(profiled['wait_input'] == window and 1 <= profiled['h2d'] <= window + prefetch + 1
          and all(profiled[name] == LM['layers'] * window for name in FLASH_KERNEL_NAMES),
          '17c: the profiled window of {} steps shows {}'.format(window, profiled))
    median = statistics.median(step_s[1:]) * 1e3
    plain = [s * 1e3 for s in plain_step_s[1:]]
    low, high = min(plain), max(plain)
    check((1 - LM_STEP_RANGE_MARGIN) * low <= median <= (1 + LM_STEP_RANGE_MARGIN) * high,
          '17c: the armed step median {:.2f} ms outside the unarmed pass\'s {:.2f}-{:.2f} ms'
          .format(median, low, high))
    eager = {name: graph_counts[name] for name in FLASH_PRODUCTS}
    chunks = len(first) + len(aux)
    check(all(n == 0 for n in eager.values()) and graph_counts['dense_fallbacks'] == 0,
          '17c: the replayed pass launched {} outside the graph'.format(eager))
    check(graph_h2d == chunks, '17c: {} h2d spans for {} chunks'.format(graph_h2d, chunks))
    phase7 = lm['step_ms'][1:]
    return {'steps': steps, 'step_ms_median': median,
            'plain_step_ms_median': statistics.median(plain), 'plain_step_ms': [low, high],
            'waits': waits,
            'phase7_step_ms': [min(phase7), max(phase7)],
            'launches': launches, 'profiled': profiled, 'trace_events': trace_events,
            'graph_chunks': chunks, 'graph_h2d_spans': graph_h2d, 'graph_eager_launches': eager,
            'phase_s': time.perf_counter() - phase_start}


def telemetry_imagenet_line(imagenet, main_path, card):
    return ('phase 17a ImageNet instrumented (process pool of {} workers, trace, '
           '/metrics): stage counts {} ({} batches, {} rowgroups); shares {}; top {} -> '
           '{!r}; h2d span median {:.4f} ms (host) against the copy\'s {:.4f} ms on the card '
           'for {} B ({:.2f} GB/s); rows/s {:.2f} stall {:.4f} beside phase 5\'s {:.2f} and '
           '{:.4f}; shuffle_wait: fill {:.2f} ms, then {:.2f} ms in all (median {:.3f}, max {:.3f}'
           ', {:.4f} of the epoch); trace {} events, {} flow events, {} processes; K1 {} '
           'launches; {:.1f} s [{}]'.format(imagenet['processes'] - 1, imagenet['stage_counts'], imagenet['steps'],
                         imagenet['rowgroups'], imagenet['shares'], imagenet['top_stage'],
                         imagenet['recommendation'], imagenet['h2d_span_ms_median'],
                         imagenet['copy_ms_median'], int(statistics.median(
                             imagenet['copy_bytes'])), imagenet['copy_gb_per_s'],
                         imagenet['rows_per_s'], imagenet['input_stall_fraction'],
                         main_path['rows_per_s'], main_path['input_stall_fraction'],
                         *(imagenet['waits'][key] for key in (
                             'fill_ms', 'steady_ms', 'steady_median_ms', 'steady_max_ms',
                             'steady_share')),
                         imagenet['trace_events'], imagenet['flow_events'],
                         imagenet['processes'], imagenet['k1_launches'], imagenet['phase_s'],
                         card))


def telemetry_mnist_line(mnist, card):
    return ('phase 17b MNIST stream, eager steps: rows/s (median of 2 epochs; each epoch in '
           '{} after a {:.1f} warm-up) off {:.1f} ({}), on {:.1f} ({}), traced {:.1f} ({}) '
           '(overhead 1 - on/off {:.4f}, 1 - traced/off {:.4f}; {} trace events); autotune '
           'over {} epochs: {:.1f} rows/s, {} windows, decisions {}, knobs {}; {:.1f} s '
           '[{}]'.format(MNIST_MODE_ORDER, mnist['warm_up']['rows_per_s'],
                         *itertools.chain.from_iterable(
                             (mnist['rows_per_s'][mode],
                              ', '.join('{:.1f}'.format(run['rows_per_s'])
                                        for run in mnist['passes'][mode]))
                             for mode in ('off', 'on', 'traced')),
                         mnist['overhead_on'],
                         mnist['overhead_traced'], mnist['trace_events'],
                         MNIST_AUTOTUNE_EPOCHS, mnist['autotune']['rows_per_s'],
                         mnist['autotune']['autotune']['windows'],
                         [(d['window'], d['action'], d['knob'], d['from'], d['to'])
                          for d in mnist['decisions']], mnist['knobs'], mnist['phase_s'],
                         card))


def telemetry_lm_line(lm, card):
    return ('phase 17c LM with the flight recorder: step median {:.2f} ms armed, {:.2f} ms '
           '(range {:.2f}-{:.2f}) unarmed just before, phase 7\'s {:.2f}-{:.2f}; K2-K4 {}; '
           'shuffle_wait: fill {:.2f} ms, then {:.2f} ms in all (median {:.3f}, max {:.3f}, '
           '{:.4f} of the steps); profiled {} steps: {}; scan_stream {} chunks, {} h2d spans, '
           'launches outside the graph {}; {} trace events; {:.1f} s [{}]'.format(
               lm['step_ms_median'], lm['plain_step_ms_median'], *lm['plain_step_ms'],
               *lm['phase7_step_ms'], lm['launches'],
               *(lm['waits'][key] for key in ('fill_ms', 'steady_ms', 'steady_median_ms',
                                               'steady_max_ms', 'steady_share')),
               TELEMETRY_PROFILED_STEPS, lm['profiled'], lm['graph_chunks'],
               lm['graph_h2d_spans'], lm['graph_eager_launches'], lm['trace_events'],
               lm['phase_s'], card))


def phase_telemetry(tmp, args, record, card):
    """Phase 17: the telemetry plane and the autotuner on the ImageNet (17a),
    MNIST-stream (17b) and LM (17c) paths, each logged as it ends."""
    phase_start = time.perf_counter()
    result = {'imagenet': phase_telemetry_imagenet(tmp, args)}
    log(telemetry_imagenet_line(result['imagenet'], record['main_path'], card))
    result['mnist'] = phase_telemetry_mnist(tmp, args.seed)
    log(telemetry_mnist_line(result['mnist'], card))
    result['lm'] = phase_telemetry_lm(tmp, args.seed, record['lm'])
    log(telemetry_lm_line(result['lm'], card))
    result['phase_s'] = time.perf_counter() - phase_start
    log('phase 17 took {:.1f} s'.format(result['phase_s']))
    return result


def build_kernels():
    """Build and load every entry point of every kernel source, one thread
    and one nvcc call per source, all started together; returns the seconds
    it took. A failed build raises here."""
    def load_all(name, symbols):
        for symbol in symbols:
            cuda_build.load(name, symbol)

    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(cuda_build.KERNELS)) as pool:
        builds = [pool.submit(load_all, name, symbols)
                  for name, (_, symbols) in cuda_build.KERNELS.items()]
        for build in builds:
            build.result()
    return time.perf_counter() - start


def short_kernel_name(mangled):
    """'sm90::flash_fwd_kernel<128>' (bf16), 'flash_fwd_kernel<64>' (float32)
    or 'stored_copy_kernel' from a mangled kernel name."""
    match = re.search(r'\d([a-z][a-z_]*_kernel)(ILi(\d+)E)?', mangled)
    if not match:
        return mangled.strip()
    prefix = 'sm90::' if '4sm90' in mangled else ''
    if not match.group(2):
        return prefix + match.group(1)
    return '{}{}<{}>'.format(prefix, match.group(1), match.group(3))


def ptxas_report(name):
    """{kernel: {'registers': n, 'spill_bytes': stores + loads}} from the
    compiler's report beside the library of kernel source ``name`` (absent
    when the library was built before the report was kept)."""
    path = cuda_build.library_path(name) + '.log'
    if not os.path.exists(path):
        return {}
    report, kernel = {}, None
    with open(path) as f:
        for line in f:
            if 'Function properties for ' in line:
                kernel = short_kernel_name(line.rsplit('Function properties for ', 1)[1])
            elif kernel and 'spill stores' in line:
                numbers = [int(w) for w in line.replace(',', ' ').split() if w.isdigit()]
                report[kernel] = {'spill_bytes': numbers[1] + numbers[2]}
            elif kernel in report and 'Used ' in line and ' registers' in line:
                report[kernel]['registers'] = int(line.split('Used ')[1].split()[0])
                kernel = None
    return report


def phase_imagenet(tmp, args, record, card):
    """Phases 5 and 6: the ImageNet device-decode path and its image check."""
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
    log('phase 5 ImageNet path: {} steps of ResNet-50 at batch {}: rows/s={:.2f} '
        'input_stall_fraction={:.4f} step_ms(median)={:.2f} peak_memory={:.3f} GiB '
        'loss {:.4f}->{:.4f}, K1 launches {} on {} batches, store written in {:.1f} s '
        '[{}]'.format(main_path['steps'], args.batch, main_path['rows_per_s'],
                      main_path['input_stall_fraction'], main_path['step_ms_median'],
                      main_path['peak_memory_bytes'] / 2 ** 30, main_path['losses'][0],
                      main_path['losses'][-1], main_path['k1_launches'],
                      main_path['steps'], record['store_write_s'], card))
    record['image_check'] = phase_image_check(url, blobs, args)
    log('phase 6 images: {}'.format(record['image_check']))


def write_record(record, out):
    if out:
        os.makedirs(os.path.dirname(out) or '.', exist_ok=True)
        with open(out, 'w') as f:
            json.dump(record, f, indent=1)


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
    run_start = time.perf_counter()

    record['build_s'] = build_kernels()
    record['ptxas'] = {name: ptxas_report(name) for name in cuda_build.KERNELS}
    sm90 = {kernel: '{registers} ({spill_bytes})'.format(**info)
            for kernel, info in record['ptxas']['flash_attention'].items() if 'sm90' in kernel}
    check(sorted(sm90) == sorted(BF16_FLASH_KERNELS),
          'the bf16 flash kernels in the ptxas report are {}, expected {}'.format(
              sorted(sm90), sorted(BF16_FLASH_KERNELS)))
    log('phase 2 build: {} in {:.3f} s; registers (spill bytes) of the bf16 flash '
        'kernels: {}'.format(', '.join(cuda_build.KERNELS), record['build_s'], sm90))

    k1 = phase_k1(args.batch, args.seed)
    record['k1'] = k1
    main, large = k1['main'], k1['large']
    log('phase 3 K1 stored_copy bit-exact (edge with the table on the card and uploaded, '
        'offsets 0-15 with gaps, main, large; '
        'outputs over 0xAB): main [{} rows, {} B] kernel_ms={:.5f} wrapper_ms={:.5f} '
        'library_ms={:.5f} plain_ms={:.5f} bound_ms={:.5f} host_plan_ms={:.4f} | large '
        '[{} rows, {} B] kernel_ms={:.5f} memcpy_ms={:.5f} bound_ms={:.5f} ({:.1%} of '
        'bound) host_plan_ms={:.4f} [{}]'.format(
            main['segments'], main['out_bytes'], main['kernel_ms'], main['wrapper_ms'],
            main['library_ms'], main['plain_ms'], main['bound_ms'], main['host_plan_ms'],
            large['segments'], large['out_bytes'], large['kernel_ms'], large['memcpy_ms'],
            large['bound_ms'], large['bound_share'], large['host_plan_ms'], card))

    flash_result = phase_flash(args.seed)
    record['flash'] = flash_result
    log('phase 4 K2-K4 flash vs plain: {} cases within tolerance; at [{}] causal bf16: {} '
        '[{}]'.format(len(flash_result['cases']), flash_result['timing_shape'],
                      {name: {key: round(value, 5) for key, value in row.items()
                              if key.endswith('ms')}
                       for name, row in flash_result['timing'].items()}, card))

    tmp = tempfile.mkdtemp(prefix='petastorm_tpu_torch_smoke_')
    try:
        phase_imagenet(tmp, args, record, card)
        record['lm'] = phase_lm(tmp, args.seed)
        log(lm_line(7, 'lm', record['lm'], card))
        record['lm_graph'] = phase_lm_graph(tmp, args.seed)
        log(lm_graph_line(record['lm_graph'], record['lm'], card))
        record['packed'] = phase_packed(tmp, args.seed)
        log(lm_line(8, 'packed', record['packed'], card))
        record['mnist_inmem'] = phase_mnist_inmem(tmp, args.seed)
        log(mnist_inmem_line(record['mnist_inmem'], card))
        record['mnist_stream'] = phase_mnist_stream(tmp, args.seed)
        log(mnist_stream_line(record['mnist_stream'], card))
        record['resume'] = phase_resume(tmp, args.seed)
        log(resume_line(record['resume'], record['packed'], card))
        record['ngram_lm'] = phase_ngram_lm(tmp, args.seed)
        log(ngram_line(record['ngram_lm'], record['lm'], card))
        record['split_cache'] = phase_split_cache(tmp, args.seed)
        log(split_cache_line(record['split_cache'], card))
        record['process_imagenet'] = phase_process_imagenet(tmp, args)
        record['process_stream'] = phase_process_mnist_stream(tmp, args.seed)
        record['process_kill'] = phase_process_kill(tmp, args.seed)
        for line in process_lines(record['process_imagenet'], record['process_stream'],
                                  record['process_kill'], record['main_path'],
                                  record['mnist_stream'], card):
            log(line)
        phase_start = time.perf_counter()
        record['moe'], initial, batches, inputs, experts = phase_moe(tmp, args.seed)
        record['moe_flash'] = phase_moe_flash(args.seed, initial, batches, inputs, experts,
                                              record['moe']['first_batch'])
        moe = moe_model(args.seed)
        moe.load_state_dict(initial)
        record['one_rank'] = phase_one_rank(tmp, args.seed, moe.blocks[0].moe, inputs[0])
        record['moe']['phase_s'] = time.perf_counter() - phase_start
        for line in moe_lines(record['moe'], record['moe_flash'], record['one_rank'], card):
            log(line)
        record['data_pipeline'] = phase_data_pipeline(tmp, args.seed)
        for line in data_pipeline_lines(record['data_pipeline'], record['lm'],
                                        record['mnist_inmem'], record['mnist_stream'], card):
            log(line)
        record['reference_api'] = phase_reference_api(tmp, args)
        for line in reference_api_lines(record['reference_api'], record, card):
            log(line)
        record['telemetry'] = phase_telemetry(tmp, args, record, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    record['run_s'] = time.perf_counter() - run_start
    kernels = [{
        'name': 'stored_copy', 'route': 'cuda',
        'source': 'petastorm_tpu_torch/csrc/stored_copy.cu',
        'replaces': 'petastorm_tpu/ops/raw_decode.py:165',
        'launches': record['main_path']['k1_launches'],
        'process_pool_launches': record['process_imagenet']['k1_launches'],
        'batch_reader_launches': record['reference_api']['batch_decode']['k1_launches'],
        'telemetry_launches': record['telemetry']['imagenet']['k1_launches'],
        'max_abs_err': max(k1[case]['max_abs_err']
                           for case in ('edge', 'edge_host_table', 'offset_sweep', 'main',
                                        'large')),
        'ms': k1['main']['kernel_ms'], 'wrapper_ms': k1['main']['wrapper_ms'],
        'plain_ms': k1['main']['plain_ms'],
        'bound_ms': k1['main']['bound_ms'], 'bound_by': 'bytes',
        # one strided copy_ computes the main batch's output (one stored block
        # a frame); it gathers no general segment table
        'library_ms': k1['main']['library_ms'],
        'large_kernel_ms': k1['large']['kernel_ms'], 'large_bound_ms': k1['large']['bound_ms'],
        'large_memcpy_ms': k1['large']['memcpy_ms']}]
    for name, counter, replaces, labels in (
            ('flash_fwd', 'fwd', 'petastorm_tpu/ops/flash_attention.py:44', ('o', 'lse')),
            ('flash_bwd_dq', 'dq', 'petastorm_tpu/ops/flash_attention.py:194', ('dq',)),
            ('flash_bwd_dkv', 'dkv', 'petastorm_tpu/ops/flash_attention.py:237',
             ('dk', 'dv'))):
        timing = flash_result['timing'][counter]
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': 'petastorm_tpu_torch/csrc/flash_attention_sm90.cuh', 'replaces': replaces,
            'launches': record['lm']['launches'][counter],
            'ngram_launches': record['ngram_lm']['launches'][counter],
            'moe_launches': record['moe_flash']['launches'][counter],
            'ring_launches': record['one_rank']['ring_launches'][counter],
            'pipeline_launches': record['data_pipeline']['pipeline']['launches'][counter],
            'converter_launches': record['reference_api']['converter_lm']['launches'][counter],
            'twin_launches': record['reference_api']['twins']['long_context']['launches'][
                counter],
            'telemetry_launches': record['telemetry']['lm']['launches'][counter],
            'max_abs_err': flash_errors(flash_result, labels),
            'ms': timing['ms'], 'plain_ms': timing['plain_ms'],
            'bound_ms': timing['bound_ms'], 'bound_by': timing['bound_by'],
            # F.scaled_dot_product_attention: its forward for K2, its backward
            # (dQ, dK and dV together) for K3 and K4
            'library_ms': timing['library_ms']})
    kernels = {'kernels': kernels}
    record.update(kernels)
    write_record(record, args.out)
    log('run: {:.1f} s after the card check'.format(record['run_s']))
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': device_name,
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
