"""The port's packing ops (petastorm_tpu_torch.ops.packing) against
petastorm_tpu.ops.packing: pack_sequences array for array, the segment mask
exactly, the masked dense attention and the packed loss in float32 within
1e-5 (the same float32 arithmetic, summed in another order)."""

import numpy as np
import pytest
import torch

from petastorm_tpu.ops import packing as jax_packing
from petastorm_tpu_torch.ops import packing

TOL = dict(atol=1e-5, rtol=1e-5)


def _documents(count, low, high, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 1000, size=n).astype(np.int32)
            for n in rng.randint(low, high + 1, size=count)]


def _packed_segments(seed, seq_len=64):
    """The first bin's segment ids of documents of 1-40 tokens."""
    return packing.pack_sequences(_documents(12, 1, 40, seed), seq_len)['segments'][0]


@pytest.mark.parametrize('count,low,high,seq_len,dtype', [
    (20, 1, 64, 64, np.int32), (7, 10, 30, 32, np.int64), (1, 5, 5, 8, np.int32),
    (30, 100, 256, 256, np.int16)])
def test_pack_sequences_identical_to_jax(count, low, high, seq_len, dtype):
    docs = _documents(count, low, high, seed=count)
    docs.insert(2, np.zeros(0, dtype=np.int32))   # empty documents are skipped
    got = packing.pack_sequences(docs, seq_len, dtype=dtype)
    want = jax_packing.pack_sequences(docs, seq_len, dtype=dtype)
    assert sorted(got) == sorted(want) == ['positions', 'segments', 'tokens']
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_pack_sequences_empty_input_and_errors_match_jax():
    for pack in (packing.pack_sequences, jax_packing.pack_sequences):
        empty = pack([], 16)
        assert empty['tokens'].shape == (1, 16) and not empty['segments'].any()
        with pytest.raises(ValueError, match='split it upstream'):
            pack([np.arange(17)], 16)
        with pytest.raises(ValueError, match='ndim'):
            pack([np.zeros((2, 2))], 16)


@pytest.mark.parametrize('causal', [True, False])
def test_segment_mask_matches_jax(causal):
    import jax.numpy as jnp
    seg = np.stack([_packed_segments(1), _packed_segments(2)])
    got = packing.segment_mask(torch.from_numpy(seg), torch.from_numpy(seg), causal=causal)
    want = np.asarray(jax_packing.segment_mask(jnp.asarray(seg), jnp.asarray(seg),
                                               causal=causal))
    assert got.shape == want.shape == (2, 1, 64, 64)
    np.testing.assert_array_equal(got.numpy(), want)


def test_masked_dense_attention_matches_jax():
    import jax.numpy as jnp
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(2, 64, 3, 16).astype(np.float32) for _ in range(3))
    seg = np.stack([_packed_segments(3), _packed_segments(4)])
    seg[0, 20:25] = 0   # a padding run inside the row
    got = packing.masked_dense_attention(
        *(torch.from_numpy(x) for x in (q, k, v)),
        packing.segment_mask(torch.from_numpy(seg), torch.from_numpy(seg)))
    want = jax_packing.masked_dense_attention(
        *(jnp.asarray(x) for x in (q, k, v)),
        jax_packing.segment_mask(jnp.asarray(seg), jnp.asarray(seg)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.all(got.numpy()[0, 20:25] == 0)


def test_packed_next_token_loss_matches_jax():
    import jax.numpy as jnp
    rng = np.random.RandomState(5)
    seg = np.stack([_packed_segments(5), _packed_segments(6)])
    tokens = rng.randint(0, 50, size=seg.shape).astype(np.int32)
    logits = rng.randn(2, 64, 50).astype(np.float32)
    got = packing.packed_next_token_loss(torch.from_numpy(logits), torch.from_numpy(tokens),
                                         torch.from_numpy(seg))
    want = jax_packing.packed_next_token_loss(jnp.asarray(logits), jnp.asarray(tokens),
                                              jnp.asarray(seg))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    with pytest.raises(ValueError, match='seq_len >= 2'):
        packing.packed_next_token_loss(torch.zeros(1, 1, 4), torch.zeros(1, 1), torch.zeros(1, 1))


@pytest.mark.parametrize('use_flash', [False, True])
def test_segment_causal_attention_matches_jax_dense(use_flash):
    """Both backends of the port against the JAX package's dense backend
    (head_dim 64, which the port's flash path takes)."""
    import jax.numpy as jnp
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(2, 64, 2, 64).astype(np.float32) for _ in range(3))
    seg = np.stack([_packed_segments(7), _packed_segments(8)])
    got = packing.segment_causal_attention(torch.from_numpy(seg), use_flash=use_flash)(
        *(torch.from_numpy(x) for x in (q, k, v)))
    want = jax_packing.segment_causal_attention(jnp.asarray(seg))(
        *(jnp.asarray(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
