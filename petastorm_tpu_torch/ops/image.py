"""Image augmentation on the card: per-image random crop with horizontal flip,
and normalization, on uint8 ``[B, H, W, C]`` batches (the JAX package's
layout). Plain PyTorch, like the XLA functions of ``petastorm_tpu.ops.image``
they replace.

Randomness comes from an explicit ``torch.Generator``. It does not reproduce
``jax.random``'s stream: :func:`crop_flip` takes the offsets and the flip mask
explicitly, so a test can hand both packages the same draws.
"""

import functools

import torch


@functools.lru_cache(maxsize=16)
def _channel_constants(mean, std, device):
    # made once per (mean, std, device): a tensor made from host data inside
    # a CUDA graph capture would copy from the host, which a capture refuses
    return (torch.tensor(mean, dtype=torch.float32, device=device),
            torch.tensor(std, dtype=torch.float32, device=device))


def normalize_image(images, mean, std, dtype=torch.bfloat16):
    """uint8 [B, H, W, C] -> ``(x / 255 - mean) / std`` as ``dtype``, computed in
    float32; ``mean``/``std`` are per-channel sequences. Their constants are
    made on the device once, so a call can be captured into a CUDA graph
    after a first eager call."""
    mean, std = _channel_constants(tuple(float(m) for m in mean),
                                   tuple(float(s) for s in std), images.device)
    x = images.to(torch.float32) / 255.0
    return ((x - mean) / std).to(dtype)


def crop_flip(images, offsets_y, offsets_x, flip_mask, crop_hw):
    """Crop ``crop_hw`` out of each image at ``(offsets_y[i], offsets_x[i])`` and
    mirror it horizontally where ``flip_mask[i]`` (None: no flips)."""
    b = images.shape[0]
    ch, cw = crop_hw
    device = images.device
    rows = offsets_y.to(device)[:, None] + torch.arange(ch, device=device)
    cols = offsets_x.to(device)[:, None] + torch.arange(cw, device=device)
    if flip_mask is not None:
        cols = torch.where(flip_mask.to(device)[:, None], cols.flip(1), cols)
    batch = torch.arange(b, device=device)[:, None, None]
    return images[batch, rows[:, :, None], cols[:, None, :]]


def random_crop_flip(images, crop_hw, flip=True, generator=None):
    """Random crop to ``crop_hw`` (uniform offsets) plus, when ``flip``, a
    Bernoulli(0.5) horizontal flip per image; draws come from ``generator``,
    which must live on the images' device."""
    b, h, w = images.shape[:3]
    ch, cw = crop_hw
    device = images.device
    offsets_y = torch.randint(0, h - ch + 1, (b,), generator=generator, device=device)
    offsets_x = torch.randint(0, w - cw + 1, (b,), generator=generator, device=device)
    flip_mask = None
    if flip:
        flip_mask = torch.rand((b,), generator=generator, device=device) < 0.5
    return crop_flip(images, offsets_y, offsets_x, flip_mask, crop_hw)
