"""Parity of the port's image ops (petastorm_tpu_torch.ops.image_decode /
ops.image) with petastorm_tpu's: the DCT decode against dct_decode_images_jax
within +-1 (the JAX package's own device-vs-host bound), crop/flip exact with
the JAX draws injected, and normalization to 1e-6 (float32) / 1 ulp (bfloat16)."""

import numpy as np
import pytest
import torch

from petastorm_tpu.ops import image as jax_image
from petastorm_tpu.ops import image_decode as jax_decode
from petastorm_tpu_torch.ops import image, image_decode


def _coeff_batch(b=3, hw=(16, 24), quality=80, seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, (b,) + hw + (3,), dtype=np.uint8)
    return images, np.stack([image_decode.dct_encode_image(img, quality) for img in images])


def test_numpy_half_is_identical_to_jax():
    images, coeffs = _coeff_batch()
    for img, c in zip(images, coeffs):
        np.testing.assert_array_equal(c, jax_decode.dct_encode_image(img, 80))
        np.testing.assert_array_equal(image_decode.dct_decode_image(c, 80),
                                      jax_decode.dct_decode_image(c, 80))
    np.testing.assert_array_equal(image_decode.quant_tables(90, 3),
                                  jax_decode.quant_tables(90, 3))


@pytest.mark.parametrize('channels', [3, 1])
def test_torch_dct_decode_within_one_of_jax(channels):
    rng = np.random.RandomState(channels)
    images = rng.randint(0, 255, (2, 16, 24, channels), dtype=np.uint8)
    coeffs = np.stack([image_decode.dct_encode_image(img, 75) for img in images])
    want = np.asarray(jax_decode.dct_decode_images_jax(coeffs, quality=75))
    got = image_decode.dct_decode_images_torch(torch.from_numpy(coeffs), quality=75)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1


def test_crop_flip_exact_with_jax_draws_injected():
    import jax
    rng = np.random.RandomState(3)
    images = rng.randint(0, 255, (6, 12, 10, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_image.random_crop_flip(key, images, (8, 6), flip=True))
    # the draws random_crop_flip makes, reproduced from the same key
    rng_crop, rng_flip = jax.random.split(key)
    oy = np.array(jax.random.randint(rng_crop, (6,), 0, 12 - 8 + 1))
    ox = np.array(jax.random.randint(jax.random.fold_in(rng_crop, 1), (6,), 0,
                                       10 - 6 + 1))
    flip = np.array(jax.random.bernoulli(rng_flip, 0.5, (6,)))
    assert flip.any() and not flip.all()
    got = image.crop_flip(torch.from_numpy(images), torch.from_numpy(oy),
                          torch.from_numpy(ox), torch.from_numpy(flip), (8, 6))
    np.testing.assert_array_equal(got.numpy(), want)
    no_flip = image.crop_flip(torch.from_numpy(images), torch.from_numpy(oy),
                              torch.from_numpy(ox), None, (8, 6))
    np.testing.assert_array_equal(
        no_flip.numpy(), np.asarray(jax_image.random_crop_flip(key, images, (8, 6),
                                                                flip=False)))


def test_random_crop_flip_replays_from_its_generator():
    images = torch.from_numpy(np.random.RandomState(4).randint(
        0, 255, (5, 9, 9, 3), dtype=np.uint8))
    first = image.random_crop_flip(images, (4, 4), generator=torch.Generator().manual_seed(1))
    again = image.random_crop_flip(images, (4, 4), generator=torch.Generator().manual_seed(1))
    assert first.shape == (5, 4, 4, 3)
    assert torch.equal(first, again)


def test_normalize_float32_and_bfloat16():
    rng = np.random.RandomState(5)
    images = rng.randint(0, 256, (2, 4, 5, 3), dtype=np.uint8)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    want32 = np.asarray(jax_image.normalize_image(images, mean, std, dtype=np.float32))
    got32 = image.normalize_image(torch.from_numpy(images), mean, std, dtype=torch.float32)
    np.testing.assert_allclose(got32.numpy(), want32, rtol=0, atol=1e-6)
    import jax.numpy as jnp
    want16 = np.asarray(jax_image.normalize_image(images, mean, std, dtype=jnp.bfloat16)
                        .astype(jnp.float32))
    got16 = image.normalize_image(torch.from_numpy(images), mean, std,
                                  dtype=torch.bfloat16).float().numpy()
    # one bfloat16 ulp at each value's magnitude (8 significand bits)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want16), 1e-30))) - 7)
    assert (np.abs(got16 - want16) <= ulp).all()
