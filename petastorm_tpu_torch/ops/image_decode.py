"""DCT-domain image storage: quantized 8x8 DCT coefficient blocks, decoded on
the card.

The numpy half (:func:`dct_encode_image`, :func:`dct_decode_image`,
:func:`quant_tables`) is a copy of ``petastorm_tpu.ops.image_decode``: the
same quantization tables and arithmetic, so stores and host decodes agree
byte for byte. :func:`dct_decode_images_torch` is the counterpart of
``dct_decode_images_jax``: dequantize, inverse DCT as two batched 8x8 matrix
products per block, YCbCr->RGB, round and clip to uint8. It is plain PyTorch
(the JAX version is an XLA function, not a Pallas kernel).
"""

import numpy as np

# Standard JPEG base quantization tables (Annex K): luminance and chrominance.
_LUM_BASE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], dtype=np.float32)
_CHROM_BASE = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99]], dtype=np.float32)


def _dct_matrix():
    """8x8 DCT-II basis: D = C @ F @ C.T, F = C.T @ D @ C."""
    n = np.arange(8)
    k = n[:, None]
    c = np.cos((2 * n[None, :] + 1) * k * np.pi / 16)
    c *= np.where(k == 0, np.sqrt(1.0 / 8.0), np.sqrt(2.0 / 8.0))
    return c.astype(np.float32)


_C = _dct_matrix()


def quant_tables(quality, channels):
    """libjpeg-style quality scaling of the base tables -> [8, 8, channels] float32."""
    quality = int(np.clip(quality, 1, 100))
    scale = 5000.0 / quality if quality < 50 else 200.0 - 2.0 * quality
    tables = []
    for c in range(channels):
        base = _LUM_BASE if c == 0 else _CHROM_BASE
        tables.append(np.clip(np.floor((base * scale + 50.0) / 100.0), 1, 255))
    return np.stack(tables, axis=-1).astype(np.float32)


def _rgb_to_ycbcr(x):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    return np.stack([y, cb, cr], axis=-1)


def _pad_to_blocks(x):
    h, w = x.shape[:2]
    ph, pw = (-h) % 8, (-w) % 8
    if ph or pw:
        x = np.pad(x, ((0, ph), (0, pw), (0, 0)), mode='edge')
    return x


def dct_encode_image(image, quality=75):
    """uint8 [H, W, 3] (or [H, W] / [H, W, 1] grayscale) -> int16 coefficient
    blocks [H8, W8, 8, 8, C] (edge-padded to /8)."""
    if image.dtype != np.uint8:
        raise ValueError('dct_encode_image expects uint8, got {}'.format(image.dtype))
    if image.ndim == 2:
        image = image[..., None]
    x = image.astype(np.float32)
    channels = x.shape[-1]
    if channels == 3:
        x = _rgb_to_ycbcr(x)
    elif channels != 1:
        raise ValueError('DCT codec supports 1 or 3 channels, got {}'.format(channels))
    x = _pad_to_blocks(x) - 128.0
    h, w = x.shape[:2]
    blocks = x.reshape(h // 8, 8, w // 8, 8, channels).transpose(0, 2, 1, 3, 4)
    coeffs = np.einsum('ij,hwjkc,lk->hwilc', _C, blocks, _C)
    return np.round(coeffs / quant_tables(quality, channels)).astype(np.int16)


def dct_decode_image(coeffs, quality=75, orig_hw=None):
    """int16 [H8, W8, 8, 8, C] -> uint8 [H, W, C] (or [H, W] when C == 1),
    cropped to ``orig_hw`` when given: the host decode."""
    h8, w8 = coeffs.shape[:2]
    channels = coeffs.shape[-1]
    deq = coeffs.astype(np.float32) * quant_tables(quality, channels)
    blocks = np.einsum('ji,hwjkc,kl->hwilc', _C, deq, _C)
    x = blocks.transpose(0, 2, 1, 3, 4).reshape(h8 * 8, w8 * 8, channels) + 128.0
    if channels == 3:
        x = _ycbcr_to_rgb_np(x)
    out = np.clip(np.round(x), 0, 255).astype(np.uint8)
    if orig_hw is not None:
        out = out[:orig_hw[0], :orig_hw[1]]
    return out[..., 0] if channels == 1 else out


def _ycbcr_to_rgb_np(x):
    y, cb, cr = x[..., 0], x[..., 1] - 128.0, x[..., 2] - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return np.stack([r, g, b], axis=-1)


def dct_decode_images_torch(coeffs, quality=75):
    """Batched decode on the coefficients' device: int16 [B, H8, W8, 8, 8, C]
    -> uint8 [B, H, W, C].

    Each block ``F`` becomes ``C.T @ (F * Q) @ C``, batched over every block
    and channel; the offset, color conversion and rounding run in float32."""
    import torch
    channels = coeffs.shape[-1]
    device = coeffs.device
    q = torch.from_numpy(quant_tables(quality, channels)).to(device)
    c = torch.from_numpy(_C).to(device)
    deq = coeffs.to(torch.float32) * q                       # [b, h8, w8, 8, 8, c]
    x = deq.permute(0, 1, 2, 5, 3, 4)                        # [b, h8, w8, c, j, k]
    blocks = torch.matmul(torch.matmul(c.t(), x), c)         # [b, h8, w8, c, i, l]
    b, h8, w8 = blocks.shape[:3]
    x = blocks.permute(0, 1, 4, 2, 5, 3).reshape(b, h8 * 8, w8 * 8, channels) + 128.0
    if channels == 3:
        y, cb, cr = x[..., 0], x[..., 1] - 128.0, x[..., 2] - 128.0
        x = torch.stack([y + 1.402 * cr,
                         y - 0.344136 * cb - 0.714136 * cr,
                         y + 1.772 * cb], dim=-1)
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)
