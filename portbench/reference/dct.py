"""The DCT image format of the benchmark's image stores, in NumPy.

A blob is ``b'DCT1'``, the height and width as two little-endian uint16, then
an ``.npy`` file of int16 coefficients ``[H/8, W/8, 8, 8, 3]``: the image in
JFIF's YCbCr, level-shifted by 128, cut into 8x8 blocks, each through the
orthonormal 8x8 DCT-II and divided by the JPEG Annex K tables scaled to the
quality as libjpeg scales them, then rounded. :func:`encode_blob` writes
that, :func:`decode_blob` reads it back in float64, and :func:`crop_gaps`
finds where a delivered crop of a decoded image came from.
"""

import io
import struct

import numpy as np

MAGIC = b'DCT1'

#: ITU-T T.81 Annex K, tables K.1 (luminance) and K.2 (chrominance)
LUMINANCE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], dtype=np.float64)
CHROMINANCE = np.full((8, 8), 99.0)
CHROMINANCE[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99],
                       [47, 66, 99, 99]]


def quant_tables(quality):
    """``[8, 8, 3]`` divisors at ``quality`` (libjpeg's ``jpeg_quality_scaling``)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000.0 / quality if quality < 50 else 200.0 - 2.0 * quality
    tables = [np.clip(np.floor((base * scale + 50.0) / 100.0), 1, 255)
              for base in (LUMINANCE, CHROMINANCE, CHROMINANCE)]
    return np.stack(tables, axis=-1)


def dct_basis():
    """Orthonormal 8x8 DCT-II matrix ``C``: coefficients ``C @ X @ C.T``."""
    n = np.arange(8)
    basis = np.cos((2 * n[None, :] + 1) * n[:, None] * np.pi / 16)
    basis[0] *= np.sqrt(1.0 / 8.0)
    basis[1:] *= np.sqrt(2.0 / 8.0)
    return basis


def rgb_to_ycbcr(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return np.stack([0.299 * r + 0.587 * g + 0.114 * b,
                     -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
                     0.5 * r - 0.418688 * g - 0.081312 * b + 128.0], axis=-1)


def ycbcr_to_rgb(ycc):
    y, cb, cr = ycc[..., 0], ycc[..., 1] - 128.0, ycc[..., 2] - 128.0
    return np.stack([y + 1.402 * cr, y - 0.344136 * cb - 0.714136 * cr, y + 1.772 * cb],
                    axis=-1)


def encode_blob(image, quality):
    """uint8 ``[H, W, 3]`` (H and W multiples of 8) -> a DCT blob."""
    h, w, _ = image.shape
    if h % 8 or w % 8 or image.dtype != np.uint8:
        raise ValueError('encode_blob takes uint8 images of whole 8x8 blocks')
    x = rgb_to_ycbcr(image.astype(np.float32)).astype(np.float32) - 128.0
    blocks = x.reshape(h // 8, 8, w // 8, 8, 3).transpose(0, 2, 4, 1, 3)   # h8 w8 c j k
    basis = dct_basis().astype(np.float32)
    coeffs = basis @ blocks @ basis.T                                      # h8 w8 c i l
    coeffs = coeffs.transpose(0, 1, 3, 4, 2) / quant_tables(quality).astype(np.float32)
    out = io.BytesIO()
    np.save(out, np.round(coeffs).astype(np.int16))
    return MAGIC + struct.pack('<HH', h, w) + out.getvalue()


def decode_blob(blob, quality):
    """A DCT blob -> uint8 ``[H, W, 3]``, dequantized and inverted in float64."""
    blob = bytes(blob)
    if blob[:4] != MAGIC:
        raise ValueError('not a DCT image blob')
    h, w = struct.unpack('<HH', blob[4:8])
    coeffs = np.load(io.BytesIO(blob[8:]), allow_pickle=False).astype(np.float64)
    h8, w8 = coeffs.shape[:2]
    deq = (coeffs * quant_tables(quality)).transpose(0, 1, 4, 2, 3)         # h8 w8 c i l
    basis = dct_basis()
    pixels = basis.T @ deq @ basis                                          # h8 w8 c j k
    x = pixels.transpose(0, 3, 1, 4, 2).reshape(h8 * 8, w8 * 8, 3) + 128.0
    return np.clip(np.round(ycbcr_to_rgb(x)), 0, 255).astype(np.uint8)[:h, :w]


def crop_gaps(delivered, full):
    """Where each delivered crop lies in its full image, and how far it is
    from it.

    :param delivered: float ``[N, ch, cw, 3]`` torch tensor, pixel values on
        the 0-255 scale as the program delivered them.
    :param full: uint8 ``[N, H, W, 3]`` torch tensor on the same device, the
        reference decodes of the same rows.
    :returns: ``(gaps, offsets_y, offsets_x, flips)``: per image the largest
        absolute difference over every pixel of the best placement, and that
        placement. Every offset and both mirror images are tried on three
        rows, the best by their mean absolute difference; it is then
        compared whole.
    """
    import torch
    n, ch, cw, _ = delivered.shape
    h, w = full.shape[1:3]
    full = full.to(delivered.dtype)
    probe_rows = torch.tensor([0, ch // 2, ch - 1], device=delivered.device)
    want = delivered[:, probe_rows]                                         # n 3 cw c
    best = None
    for flip in (False, True):
        source = full.flip(2) if flip else full
        for oy in range(h - ch + 1):
            rows = source[:, oy + probe_rows]                               # n 3 w c
            windows = rows.unfold(2, cw, 1)                                 # n 3 nx c cw
            err = (windows.permute(0, 2, 1, 4, 3) - want[:, None]).abs().mean(dim=(2, 3, 4))
            value, ox = err.min(dim=1)
            # a mirrored crop at offset ox of the flipped image starts at
            # w - cw - ox of the original
            ox = ((w - cw - ox) if flip else ox).to(value.dtype)
            candidate = torch.stack([value, torch.full_like(value, oy), ox,
                                     torch.full_like(value, int(flip))], dim=1)
            best = candidate if best is None else torch.where(
                (candidate[:, :1] < best[:, :1]), candidate, best)
    oy, ox, flips = best[:, 1].long(), best[:, 2].long(), best[:, 3].bool()
    gaps = torch.empty(n, dtype=delivered.dtype, device=delivered.device)
    for i in range(n):
        crop = full[i, oy[i]:oy[i] + ch, ox[i]:ox[i] + cw]
        if flips[i]:
            crop = crop.flip(1)
        gaps[i] = (delivered[i] - crop).abs().max()
    return gaps, oy, ox, flips
