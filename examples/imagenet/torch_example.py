"""Train a ResNet from an ImageNet-style store with ``petastorm_tpu_torch``:
the twin of ``examples/imagenet/jax_example.py``.

- default: the ``CompressedImageCodec`` png store of
  ``examples/imagenet/schema.py``; images are decoded (``cv2``),
  center-cropped and resized on the host workers to a static shape;
- ``--on-chip-decode``: a DCT-domain store read through a field override
  (``DctCoefficientsCodec``), so the workers ship int16 coefficient blocks and
  the IDCT (J1, ``dct_decode_images_torch``) runs inside the train step on
  the card;
- ``--scan-chunk N``: the steps run through ``TorchDataLoader.scan_stream``,
  N steps a CUDA graph replay.

Random crop and flip, and the bfloat16 normalize, run in the step. The width
is set by ``--stage-sizes`` (``3 4 6 3`` for ResNet-50) and
``--num-filters``. A missing store is first written with synthetic images
(:func:`generate_store`, ``--generate-rows`` of them; the DCT store's at
``--image-hw``).

Run: ``python -m examples.imagenet.torch_example --dataset-url file:///tmp/imagenet_torch``
"""

import argparse
import os

import numpy as np

IMAGE_HW = 64
SYNTHETIC_NOUNS = {'n01440764': 'tench', 'n01443537': 'goldfish', 'n01484850': 'shark'}


def imagenet_schema(dct_hw=None, quality=90):
    """The png store's Unischema of ``examples/imagenet/schema.py`` or, with
    ``dct_hw``, its fixed-size DCT-domain variant, in the port."""
    from petastorm_tpu_torch.codecs import CompressedImageCodec, DctImageCodec, ScalarCodec
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField
    if dct_hw is None:
        image = UnischemaField('image', np.uint8, (None, None, 3),
                               CompressedImageCodec('png'), False)
    else:
        if dct_hw % 8:
            raise ValueError('dct_hw must be a multiple of 8, got {}'.format(dct_hw))
        image = UnischemaField('image', np.uint8, (dct_hw, dct_hw, 3),
                               DctImageCodec(quality=quality), False)
    return Unischema('DctImagenetSchema' if dct_hw else 'ImagenetSchema', [
        UnischemaField('noun_id', np.str_, (), ScalarCodec(np.str_), False),
        UnischemaField('text', np.str_, (), ScalarCodec(np.str_), False),
        image])


def dct_coefficients_field(image_hw, quality=90):
    """The read-time override that makes the workers emit raw coefficient
    blocks."""
    from petastorm_tpu_torch.codecs import DctCoefficientsCodec
    from petastorm_tpu_torch.unischema import UnischemaField
    return UnischemaField('image', np.int16, (image_hw // 8, image_hw // 8, 8, 8, 3),
                          DctCoefficientsCodec(quality=quality), False)


def center_resize(image, hw):
    """Center-crop to a square and nearest-neighbour resize to (hw, hw)."""
    h, w = image.shape[:2]
    side = min(h, w)
    top, left = (h - side) // 2, (w - side) // 2
    square = image[top:top + side, left:left + side]
    idx = np.arange(hw) * side // hw
    return np.ascontiguousarray(square[idx][:, idx])


def generate_store(output_url, rows=12, dct_hw=None, dct_quality=90, seed=0,
                   hw=(96, 128), rowgroup_size_mb=8):
    """``rows`` synthetic photos of random size in ``hw``, the classes in turn;
    resized to ``dct_hw`` and DCT-coded when it is given, else png."""
    from petastorm_tpu_torch.etl.dataset_metadata import write_rows
    rng = np.random.default_rng(seed)
    nouns = list(SYNTHETIC_NOUNS.items())
    data = []
    for i in range(rows):
        noun_id, text = nouns[i % len(nouns)]
        h, w = (int(rng.integers(hw[0], hw[1])) for _ in range(2))
        image = rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
        if dct_hw is not None:
            image = center_resize(image, dct_hw)
        data.append({'noun_id': noun_id, 'text': text, 'image': image})
    write_rows(output_url, imagenet_schema(dct_hw, dct_quality), data,
               rowgroup_size_mb=rowgroup_size_mb)


def make_transform(class_to_label, image_hw):
    """Host decode: the png image center-resized to ``image_hw``, the noun
    mapped to its label."""
    from petastorm_tpu_torch.transform import TransformSpec

    def _transform(row):
        row['image'] = center_resize(row['image'], image_hw)
        row['label'] = np.int64(class_to_label[row['noun_id']])
        return row

    return TransformSpec(_transform,
                         edit_fields=[('image', np.uint8, (image_hw, image_hw, 3), False),
                                      ('label', np.int64, (), False)],
                         selected_fields=['image', 'label'])


def make_label_transform(class_to_label, image_field_spec):
    """The label for a fixed-size store, the image field as it is (raw
    coefficient blocks under the field override)."""
    from petastorm_tpu_torch.transform import TransformSpec

    def _transform(row):
        row['label'] = np.int64(class_to_label[row['noun_id']])
        return row

    return TransformSpec(_transform,
                         edit_fields=[image_field_spec, ('label', np.int64, (), False)],
                         selected_fields=['image', 'label'])


def train(dataset_url, batch_size=8, epochs=1, learning_rate=1e-3,
          stage_sizes=(1, 1, 1, 1), num_filters=16, on_chip_decode=False,
          image_hw=IMAGE_HW, dct_quality=90, reader_pool_type='thread', workers_count=4,
          prefetch=2, scan_chunk=0, device=None, verbose=True):
    """Returns ``(model, loss, loader stats)``."""
    import torch
    import torch.nn.functional as F

    from petastorm_tpu_torch import TorchDataLoader, make_reader
    from petastorm_tpu_torch.models.resnet import ResNet
    from petastorm_tpu_torch.ops.image import normalize_image, random_crop_flip
    from petastorm_tpu_torch.ops.image_decode import dct_decode_images_torch
    from petastorm_tpu_torch.parallel.loader import resolve_device
    device = resolve_device(device)
    with make_reader(dataset_url, schema_fields=['noun_id'], num_epochs=1,
                     shuffle_row_groups=False) as scan_reader:
        nouns = sorted({row.noun_id for row in scan_reader})
    class_to_label = {noun: i for i, noun in enumerate(nouns)}
    torch.manual_seed(0)
    model = ResNet(stage_sizes=list(stage_sizes), num_classes=len(nouns),
                   num_filters=num_filters, device=device).train()
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate,
                                 capturable=bool(scan_chunk) and device.type == 'cuda')

    def step(batch):
        images = batch['image']
        if on_chip_decode:
            images = dct_decode_images_torch(images, quality=dct_quality)
        images = random_crop_flip(images, (image_hw - 8, image_hw - 8))
        images = normalize_image(images, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5))
        loss = F.cross_entropy(model(images), batch['label'])
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    if on_chip_decode:
        override = dct_coefficients_field(image_hw, quality=dct_quality)
        spec = ('image', np.int16, (image_hw // 8, image_hw // 8, 8, 8, 3), False)
        reader_kwargs = dict(field_overrides=[override],
                             transform_spec=make_label_transform(class_to_label, spec))
    else:
        reader_kwargs = dict(transform_spec=make_transform(class_to_label, image_hw))
    loss = None
    with make_reader(dataset_url, num_epochs=epochs, shuffle_rows=True, seed=0,
                     reader_pool_type=reader_pool_type, workers_count=workers_count,
                     **reader_kwargs) as reader:
        loader = TorchDataLoader(reader, batch_size=batch_size, drop_last=True,
                                 prefetch=prefetch, device=device)
        if scan_chunk:
            chunks = loader.scan_stream(step, chunk_batches=scan_chunk, seed=0,
                                        state=(model, optimizer))
            loss = float(chunks[-1][-1]) if chunks else None
            if verbose:
                for chunk in chunks:
                    for value in chunk.tolist():
                        print('loss {:.4f}'.format(value))
        else:
            for index, batch in enumerate(loader):
                loss = step(batch)
                if verbose:
                    print('step {} loss {:.4f}'.format(index, float(loss)))
            loss = None if loss is None else float(loss)
        stats = loader.stats.as_dict()
        if verbose:
            print('input pipeline stats:', stats)
    return model, loss, stats


def main(argv=None):
    """Run the example; returns the final loss."""
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--dataset-url', default='file:///tmp/imagenet_torch')
    parser.add_argument('--batch-size', type=int, default=8)
    parser.add_argument('--epochs', type=int, default=1)
    parser.add_argument('--on-chip-decode', action='store_true',
                        help='read a DCT store and decode on the card')
    parser.add_argument('--image-hw', type=int, default=IMAGE_HW)
    parser.add_argument('--stage-sizes', type=int, nargs='+', default=[1, 1, 1, 1],
                        help='ResNet stage depths, e.g. 3 4 6 3 for ResNet-50')
    parser.add_argument('--num-filters', type=int, default=16)
    parser.add_argument('--pool', default='thread', choices=['thread', 'process', 'dummy'])
    parser.add_argument('--workers', type=int, default=4)
    parser.add_argument('--prefetch', type=int, default=2)
    parser.add_argument('--scan-chunk', type=int, default=0,
                        help='>0: train through scan_stream, this many steps a graph '
                             'replay')
    parser.add_argument('--generate-rows', type=int, default=12,
                        help='rows of the synthetic store written when none exists')
    parser.add_argument('--device', default=None, help='cuda (default) or cpu')
    args = parser.parse_args(argv)
    if not os.path.exists(os.path.join(args.dataset_url.replace('file://', ''),
                                       '_common_metadata')):
        print('materializing {} synthetic rows to {}'.format(args.generate_rows,
                                                             args.dataset_url))
        generate_store(args.dataset_url, rows=args.generate_rows,
                       dct_hw=args.image_hw if args.on_chip_decode else None)
    _, loss, _ = train(args.dataset_url, batch_size=args.batch_size, epochs=args.epochs,
                       on_chip_decode=args.on_chip_decode, image_hw=args.image_hw,
                       stage_sizes=tuple(args.stage_sizes), num_filters=args.num_filters,
                       reader_pool_type=args.pool, workers_count=args.workers,
                       prefetch=args.prefetch, scan_chunk=args.scan_chunk,
                       device=args.device)
    print('final loss: {:.4f}'.format(loss))
    return loss


if __name__ == '__main__':
    main()
