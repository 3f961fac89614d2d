"""Device decode tail: the loader stage that turns raw-shipped codec payloads
into decoded (and optionally augmented) batches on the card.

Counterpart of ``petastorm_tpu.parallel.device_stage`` for
``make_reader(device_decode_fields=...)``: workers pass codec payloads through
undecoded and this stage finishes the job. DCT coefficient blocks run through
:func:`~petastorm_tpu_torch.ops.image_decode.dct_decode_images_torch`, packed
``.npy`` payloads become typed tensors through
:func:`~petastorm_tpu_torch.ops.raw_decode.bitcast_rows`, and stored-block
deflate frames inflate through kernel K1
(:func:`~petastorm_tpu_torch.ops.raw_decode.stored_inflate`), whose segment
table skips each frame's ``.npy`` header and rides in the batch's one upload
as the loader-private ``<field>__segs`` column, as in the JAX stage.
Huffman-coded frames inflate on the loader's producer thread.

The path follows the tensors' device. On the card every step runs as CUDA
work; on the CPU the same steps run the kernels' plain versions, which is how
the CPU tests cover :meth:`DeviceDecodeStage.prepare` and
:meth:`DeviceDecodeStage.finish`. Host mode, where every field decodes through
the codecs' host math before upload, is used only when the caller asks for the
CPU and for host decode.

Differences from the JAX stage, all deliberate:

- No byte cap on the stored-inflate path. The JAX stage sends batches above
  4 MiB (``_STORED_DEVICE_BYTES_MAX``) to host inflate because its Pallas
  kernel stages the whole source and output in VMEM; K1 reads and writes
  device memory directly and needs no staging.
- No power-of-two padding of the source and the segment table. It existed so
  that XLA would not recompile per batch; PyTorch runs eagerly and K1 takes
  any length.
- Randomness: each batch draws from a ``torch.Generator`` seeded from the
  transform's ``seed`` and the batch counter. JAX's
  ``fold_in(PRNGKey(seed), counter)`` stream has no torch twin, so crops and
  flips differ from the JAX package's draw for draw while following the same
  distributions (tests inject the JAX draws through
  :func:`~petastorm_tpu_torch.ops.image.crop_flip`).
- No x32 gate: 8-byte integers stay 64-bit and ``float64`` fields decode on
  the device path like any other (the JAX stage decodes them on the host).
"""

from __future__ import annotations

import collections
import zlib
from dataclasses import dataclass
from io import BytesIO
from typing import Any, Deque, Dict, FrozenSet, List, Mapping, Optional, Tuple

import numpy as np
import torch

from petastorm_tpu_torch.codecs import (CompressedNdarrayCodec, DctImageCodec,
                                        _parse_npy_header)
from petastorm_tpu_torch.decode_engine import (RAW_ENC_DEFLATE, RAW_ENC_NPY,
                                               RAW_ENC_SUFFIX, RAW_HW_SUFFIX,
                                               stack_if_uniform)
from petastorm_tpu_torch.ops import raw_decode
from petastorm_tpu_torch.telemetry.spans import host_span

#: suffix of the loader-private stored-deflate segment-table column
_SEGS_SUFFIX = '__segs'

_TORCH_DTYPES_BY_NAME = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
                         'float16': torch.float16}


@dataclass(frozen=True)
class DeviceTransform:
    """Declarative augment chain for one raw-shipped image field, applied on
    the card right after its decode.

    :param crop: ``(h, w)`` random-crop size; None disables cropping.
    :param random_flip: seeded random horizontal flip (requires ``crop``).
    :param normalize: ``(mean, std)`` per-channel sequences; the output becomes
        ``normalize_dtype``. None keeps uint8.
    :param normalize_dtype: ``'float32'``, ``'bfloat16'`` or ``'float16'``.
    :param seed: base seed; each batch combines it with a running counter, so
        augmentation differs per batch and replays deterministically.
    """

    crop: Optional[Tuple[int, int]] = None
    random_flip: bool = False
    normalize: Optional[Tuple[Tuple[float, ...], Tuple[float, ...]]] = None
    normalize_dtype: str = 'float32'
    seed: int = 0

    def __post_init__(self) -> None:
        if self.random_flip and self.crop is None:
            raise ValueError('DeviceTransform(random_flip=True) requires crop= '
                             '(flip rides the crop)')
        if self.normalize_dtype not in _TORCH_DTYPES_BY_NAME:
            raise ValueError('normalize_dtype must be one of {}'
                             .format(sorted(_TORCH_DTYPES_BY_NAME)))
        if self.crop is not None:
            object.__setattr__(self, 'crop', tuple(self.crop))
        if self.normalize is not None:
            mean, std = self.normalize
            object.__setattr__(self, 'normalize',
                               (tuple(float(m) for m in mean),
                                tuple(float(s) for s in std)))

    @property
    def needs_rng(self) -> bool:
        """True when the chain consumes per-batch randomness."""
        return self.crop is not None

    def generator(self, counter: int, device: torch.device) -> torch.Generator:
        """The batch's generator on ``device``: seeded from ``(seed, counter)``."""
        generator = torch.Generator(device=device)
        generator.manual_seed(((self.seed & 0xFFFFFFFF) << 32) | (counter & 0xFFFFFFFF))
        return generator

    def apply(self, images: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        """Run the chain on a decoded uint8 ``[B, H, W, C]`` (or ``[B, H, W]``) batch."""
        from petastorm_tpu_torch.ops.image import normalize_image, random_crop_flip
        out = images
        if self.crop is not None:
            squeeze = out.dim() == 3
            if squeeze:
                out = out[..., None]
            out = random_crop_flip(out, self.crop, flip=self.random_flip,
                                   generator=generator)
            if squeeze:
                out = out[..., 0]
        if self.normalize is not None:
            mean, std = self.normalize
            out = normalize_image(out, mean, std,
                                  dtype=_TORCH_DTYPES_BY_NAME[self.normalize_dtype])
        return out


@dataclass(frozen=True)
class _FieldPlan:
    """Per-field recipe resolved from the reader's schema at loader
    construction: what raw form arrives and how to finish it."""

    name: str
    kind: str                      # 'dct' | 'npy' | 'deflate'
    shape: Tuple[int, ...]         # decoded per-row shape (may hold None dims)
    quality: int = 75              # dct quantization quality
    transform: Optional[DeviceTransform] = None

    @property
    def aux_names(self) -> Tuple[str, ...]:
        """Auxiliary columns riding alongside this field's raw payload."""
        if self.kind == 'dct':
            return (self.name + RAW_HW_SUFFIX,)
        if self.kind == 'deflate':
            return (self.name + RAW_ENC_SUFFIX,)
        return ()


def _resolve_plans(reader: Any,
                   transforms: Mapping[str, DeviceTransform]) -> Dict[str, _FieldPlan]:
    """Per-field recipes from the reader's ``device_decode_fields``; transforms
    apply to DCT image fields only."""
    plans: Dict[str, _FieldPlan] = {}
    for name in sorted(reader.device_decode_fields):
        field = reader.schema.fields[name]
        if type(field.codec) is DctImageCodec:
            kind = 'dct'
        elif type(field.codec) is CompressedNdarrayCodec:
            kind = 'deflate'
        else:
            kind = 'npy'
        transform = transforms.get(name)
        if transform is not None and kind != 'dct':
            raise ValueError('device_transforms[{!r}]: transforms apply to '
                             'DctImageCodec image fields only (this field '
                             'ships as {})'.format(name, kind))
        plans[name] = _FieldPlan(name=name, kind=kind, shape=tuple(field.shape),
                                 quality=int(getattr(field.codec, 'quality', 75)),
                                 transform=transform)
    unknown = sorted(set(transforms) - set(plans))
    if unknown:
        raise ValueError('device_transforms name fields not in '
                         'device_decode_fields: {}'.format(unknown))
    return plans


def _inflate_frame(frame: Any, enc: int) -> bytes:
    """One raw frame -> its ``.npy`` member bytes: raw-deflate streams
    inflate, stored members pass."""
    if enc == RAW_ENC_DEFLATE:
        return zlib.decompressobj(-15).decompress(memoryview(frame))
    if enc == RAW_ENC_NPY:
        return bytes(memoryview(frame))
    raise ValueError('null cell has no payload (enc={})'.format(enc))


def _npy_meta(first_blob: Any) -> Tuple[int, str, Tuple[int, ...]]:
    """``(header_len, payload dtype string, per-row shape)`` of a packed npy
    column; the ship-raw kernel verified that every row shares row 0's header."""
    parsed = _parse_npy_header(bytes(memoryview(first_blob)))
    if parsed is None:
        raise ValueError('unparseable .npy header in a device-mode batch')
    header_len, shape, fortran, dtype = parsed
    if fortran or dtype.hasobject or dtype.byteorder not in ('=', '|', '<'):
        raise ValueError('npy payload layout is not device-decodable '
                         '(fortran/object/big-endian)')
    return header_len, dtype.str, tuple(int(d) for d in shape)


class DeviceDecodeStage:
    """The loader's decode tail (one per
    :class:`~petastorm_tpu_torch.parallel.loader.TorchDataLoader` whose reader
    ships raw fields). See the module docstring."""

    def __init__(self, reader: Any, transforms: Optional[Mapping[str, DeviceTransform]],
                 depth: int, host_mode: bool) -> None:
        self._plans = _resolve_plans(reader, dict(transforms or {}))
        self._schema_fields = dict(reader.schema.fields)
        self._depth = max(1, int(depth))
        #: every field decodes through the codecs' host math before upload
        self.host_mode = bool(host_mode)
        self._ring: Deque[Any] = collections.deque()
        self._rng_counter = 0
        self._needs_rng = any(p.transform is not None and p.transform.needs_rng
                              for p in self._plans.values())
        #: batches whose stored-deflate fields inflated through K1 (or its
        #: plain version on the CPU)
        self.stored_batches = 0
        if self.host_mode and transforms:
            raise ValueError('device_transforms run on the device decode path; '
                             'construct the loader without host_decode')
        if not self.host_mode:
            bad = sorted(name for name, plan in self._plans.items()
                         if any(d is None for d in plan.shape)
                         or reader.schema.fields[name].nullable)
            if bad:
                raise ValueError(
                    'device_decode_fields {} have wildcard dims or are nullable; '
                    'the device decode tail needs uniform batches — make the field '
                    'shapes concrete/non-nullable or drop the fields from '
                    'device_decode_fields'.format(bad))

    @property
    def passthrough_names(self) -> FrozenSet[str]:
        """Columns the loader's sanitizer passes through untouched: raw payload
        columns pending device decode, plus their auxiliaries."""
        if self.host_mode:
            return frozenset()
        names: List[str] = []
        for plan in self._plans.values():
            names.append(plan.name)
            names.extend(plan.aux_names)
        return frozenset(names)

    @property
    def depth(self) -> int:
        """Current device-buffer ring depth."""
        return self._depth

    def set_depth(self, depth: int) -> int:
        """Runtime-adjust the ring depth; returns the applied value. A shrink
        drains lazily as the ring is throttled."""
        self._depth = max(1, int(depth))
        return self._depth

    # ------------------------------------------------------------ host mode

    def sanitize_decode(self, columns: Dict[str, Any]) -> Tuple[Dict[str, Any], bool]:
        """Host mode: decode every raw-shipped field through the codecs' host
        math and drop the auxiliary columns. Returns ``(columns, decoded_any)``."""
        if not self.host_mode:
            return columns, False
        decoded_any = False
        for plan in self._plans.values():
            if plan.name in columns:
                columns = self._host_decode_field(columns, plan)
                decoded_any = True
        return columns, decoded_any

    def _host_decode_field(self, columns: Dict[str, Any],
                           plan: _FieldPlan) -> Dict[str, Any]:
        out = dict(columns)
        col = out.pop(plan.name)
        if plan.kind == 'dct':
            from petastorm_tpu_torch.ops.image_decode import dct_decode_image
            hw = np.asarray(out.pop(plan.name + RAW_HW_SUFFIX))
            values = [None if coeffs is None else dct_decode_image(
                np.asarray(coeffs), quality=plan.quality,
                orig_hw=(int(hw[i, 0]), int(hw[i, 1])))
                for i, coeffs in enumerate(col)]
        elif plan.kind == 'npy':
            values = [None if blob is None else np.ascontiguousarray(
                np.load(BytesIO(bytes(memoryview(blob))), allow_pickle=False))
                for blob in col]
        else:
            enc = np.asarray(out.pop(plan.name + RAW_ENC_SUFFIX))
            values = [None if frame is None else np.ascontiguousarray(
                np.load(BytesIO(_inflate_frame(frame, int(enc[i]))), allow_pickle=False))
                for i, frame in enumerate(col)]
        out[plan.name] = stack_if_uniform(values, self._schema_fields.get(plan.name))
        return out

    # ---------------------------------------------------------- device path

    def prepare(self, columns: Dict[str, Any]) -> Tuple[Dict[str, Any], Tuple[Any, ...]]:
        """Producer-thread host half: turn raw payloads into upload-ready numeric
        arrays and build the recipe :meth:`finish` runs. Returns
        ``(upload_columns, recipe)``."""
        upload = dict(columns)
        recipe: List[Tuple[Any, ...]] = []
        for plan in self._plans.values():
            if plan.name not in upload:
                continue
            if plan.kind == 'dct':
                hw = np.asarray(upload.pop(plan.name + RAW_HW_SUFFIX))
                h = int(hw[0, 0]) if len(hw) else 0
                w = int(hw[0, 1]) if len(hw) else 0
                upload[plan.name] = np.ascontiguousarray(upload[plan.name])
                recipe.append(('dct', plan.name, plan.quality, (h, w),
                               len(plan.shape) == 2, plan.transform))
            elif plan.kind == 'npy':
                header_len, dtype_str, row_shape = _npy_meta(upload[plan.name][0])
                recipe.append(('npy', plan.name, header_len, dtype_str, row_shape))
            else:
                frames = upload[plan.name]
                enc = np.asarray(upload.pop(plan.name + RAW_ENC_SUFFIX))
                stored = self._plan_stored(frames, enc)
                if stored is not None:
                    src, segs, n, row_bytes, dtype_str, row_shape = stored
                    upload[plan.name] = src
                    # the table rides in the batch's one upload; the host copy
                    # rides in the recipe, for stored_inflate to check its rows
                    upload[plan.name + _SEGS_SUFFIX] = segs
                    recipe.append(('stored', plan.name, segs, n, row_bytes, dtype_str,
                                   row_shape))
                else:
                    matrix = self._inflate_on_host(frames, enc)
                    upload[plan.name] = matrix
                    header_len, dtype_str, row_shape = _npy_meta(matrix[0])
                    recipe.append(('npy', plan.name, header_len, dtype_str, row_shape))
        return upload, tuple(recipe)

    @staticmethod
    def _plan_stored(frames: List[Any], enc: np.ndarray) -> Optional[Tuple[Any, ...]]:
        """``(src, segs, n, row_bytes, dtype_str, row_shape)`` when every frame
        is a stored-block deflate stream whose npy header parses from frame
        0's first bytes and whose payload after that header is ``row_bytes``
        long, the size of one row; ``segs`` skips each frame's header, so it
        writes row ``i`` to bytes ``i * row_bytes`` of a dense ``(n,
        row_bytes)`` matrix. None sends the batch to host inflate."""
        n = len(frames)
        if not n or not (enc == RAW_ENC_DEFLATE).all():
            return None
        try:
            # the npy header lives in the first ~128 inflated bytes: a bounded
            # inflate of the prefix, not of the payload the kernel exists for
            prefix = zlib.decompressobj(-15).decompress(frames[0], 512)
            header_len, dtype_str, row_shape = _npy_meta(np.frombuffer(prefix, dtype=np.uint8))
        except (zlib.error, ValueError):
            return None
        plan = raw_decode.plan_stored_batch(frames, skip=[header_len] * n)
        if plan is None:
            return None
        segs, frame_lengths = plan
        row_bytes = int(np.prod(row_shape, dtype=np.int64)) * np.dtype(dtype_str).itemsize
        if set(frame_lengths) != {row_bytes} or not row_bytes:
            return None
        # the frames are the uint8 arrays of the ship-raw kernel
        src = np.concatenate(frames)
        return src, segs, n, row_bytes, dtype_str, row_shape

    @staticmethod
    def _inflate_on_host(frames: List[Any], enc: np.ndarray) -> np.ndarray:
        """Huffman (or mixed) frames: inflate on this thread into an
        ``(n, blob_len)`` npy matrix."""
        blobs = [_inflate_frame(f, int(enc[i])) for i, f in enumerate(frames)]
        blob_len = len(blobs[0]) if blobs else 0
        matrix = np.empty((len(blobs), blob_len), dtype=np.uint8)
        for i, blob in enumerate(blobs):
            if len(blob) != blob_len:
                raise ValueError('non-uniform inflated payload lengths in a '
                                 'device-mode batch ({} vs {})'.format(len(blob), blob_len))
            matrix[i] = np.frombuffer(blob, dtype=np.uint8)
        return matrix

    def finish(self, device_columns: Dict[str, torch.Tensor],
               recipe: Tuple[Any, ...]) -> Dict[str, torch.Tensor]:
        """Consumer half: run the recipe over the uploaded tensors, on their
        device and the current stream, and return the final batch."""
        out = dict(device_columns)
        counter = self._rng_counter
        if self._needs_rng:
            self._rng_counter += 1
        for entry in recipe:
            kind, name = entry[0], entry[1]
            if kind == 'stored':
                _, _, segs, n, row_bytes, dtype_str, row_shape = entry
                flat = raw_decode.stored_inflate(
                    device_columns[name], segs, n * row_bytes,
                    device_segments=out.pop(name + _SEGS_SUFFIX))
                out[name] = raw_decode.bitcast_rows(flat.view(n, row_bytes), dtype_str,
                                                    row_shape)
                self.stored_batches += 1
            elif kind == 'npy':
                _, _, header_len, dtype_str, row_shape = entry
                out[name] = raw_decode.unpack_npy_rows(device_columns[name], header_len,
                                                       dtype_str, row_shape)
            else:
                _, _, quality, (h, w), squeeze, transform = entry
                from petastorm_tpu_torch.ops.image_decode import dct_decode_images_torch
                images = dct_decode_images_torch(device_columns[name], quality=quality)
                images = images[:, :h, :w]
                if squeeze:
                    images = images[..., 0]
                if transform is not None:
                    generator = (transform.generator(counter, images.device)
                                 if transform.needs_rng else None)
                    images = transform.apply(images, generator)
                out[name] = images
        return out

    # ------------------------------------------------------------------ ring

    def throttle(self, done: Optional[Any]) -> float:
        """Bound the decode work queued ahead of the train step: append this
        batch's completion event (None on the CPU, where work is synchronous)
        and, past the ring depth, wait for the OLDEST batch to finish, inside
        the profiler range ``petastorm_tpu_torch.loader.d2d_wait``. Returns
        the seconds the host spent blocked in ``Event.synchronize()`` (the
        loader's ``d2d_wait`` stage)."""
        if done is None:
            return 0.0
        self._ring.append(done)
        waited = 0.0
        while len(self._ring) > self._depth:
            oldest = self._ring.popleft()
            with host_span('loader', 'd2d_wait') as wait:
                oldest.synchronize()
            waited += wait.seconds
        return waited
