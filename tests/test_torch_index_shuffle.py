"""J4 on the CPU: the port's random_index_shuffle against the JAX package's,
bit for bit, given the round keys JAX draws (``jax.random.randint`` of the
folded epoch key, as ``petastorm_tpu/ops/index_shuffle.py`` does), over full
and windowed positions, and over a mesh loader's shards (J9: the key of
epoch and shard, ``fold_in(fold_in(PRNGKey(seed), epoch), shard)``, vmapped
over the shards as ``petastorm_tpu/parallel/inmem_loader.py`` does); and the
port's own epoch and per-shard keys."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petastorm_tpu_torch.ops.index_shuffle import (KEY_LIMIT, epoch_round_keys,
                                                   random_index_shuffle)

SIZES = [1, 2, 3, 7, 1000, 4096, 4097, 50000]


def jax_round_keys(seed, epoch, rounds=4):
    """The keys the JAX package's shuffle draws for epoch ``epoch`` of ``seed``."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), epoch)
    return [int(k) for k in np.asarray(jax.random.randint(
        key, (rounds,), 0, np.iinfo(np.int32).max, dtype=jnp.int32))]


def _jax_shuffle(positions, seed, epoch, n):
    from petastorm_tpu.ops.index_shuffle import random_index_shuffle as reference
    key = jax.random.fold_in(jax.random.PRNGKey(seed), epoch)
    return np.asarray(reference(jnp.asarray(positions), key, n))


@pytest.mark.parametrize('n', SIZES)
def test_full_permutation_is_bit_exact(n):
    keys = jax_round_keys(7, 3)
    got = random_index_shuffle(torch.arange(n), keys, n)
    want = _jax_shuffle(np.arange(n), 7, 3, n)
    assert got.dtype == torch.int64 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert sorted(got.tolist()) == list(range(n))


@pytest.mark.parametrize('n', SIZES)
def test_windowed_positions_are_bit_exact(n):
    rng = np.random.RandomState(n)
    start = int(rng.randint(0, n))
    window = np.arange(start, min(n, start + 37))
    scattered = rng.randint(0, n, size=(3, 5))
    keys = jax_round_keys(11, 0)
    for positions in (window, scattered):
        got = random_index_shuffle(torch.from_numpy(positions), keys, n)
        np.testing.assert_array_equal(got.numpy(), _jax_shuffle(positions, 11, 0, n))
        assert got.shape == positions.shape


def test_epoch_round_keys_are_seeded_and_in_range():
    keys = epoch_round_keys(7, 0)
    assert keys == epoch_round_keys(7, 0) and len(keys) == 4
    assert all(0 <= k < KEY_LIMIT for k in keys)
    assert keys != epoch_round_keys(7, 1) and keys != epoch_round_keys(8, 0)
    assert len(epoch_round_keys(7, 0, rounds=6)) == 6
    perm = random_index_shuffle(torch.arange(1000), keys, 1000)
    assert sorted(perm.tolist()) == list(range(1000))
    assert perm.tolist() != list(range(1000))


def test_rejects_bad_arguments():
    with pytest.raises(ValueError, match='n must be'):
        random_index_shuffle(torch.arange(3), [1, 2, 3, 4], 0)
    for keys in ([], [1, 2, 3, -1], [1, 2, 3, KEY_LIMIT]):
        with pytest.raises(ValueError, match='round_keys'):
            random_index_shuffle(torch.arange(3), keys, 3)


def jax_shard_permutations(seed, epoch, shards, rows):
    """The JAX mesh loader's shard-local permutations of one epoch and the
    round keys each shard's shuffle draws."""
    import jax
    from petastorm_tpu.ops.index_shuffle import random_index_shuffle as reference
    epoch_key = jax.random.fold_in(jax.random.PRNGKey(seed), epoch)
    keys = jax.vmap(lambda s: jax.random.fold_in(epoch_key, s))(jnp.arange(shards))
    perms = jax.vmap(lambda key: reference(jnp.arange(rows), key, rows))(keys)
    round_keys = [[int(k) for k in np.asarray(jax.random.randint(
        keys[s], (4,), 0, np.iinfo(np.int32).max, dtype=jnp.int32))] for s in range(shards)]
    return np.asarray(perms), round_keys


@pytest.mark.parametrize('shards,rows', [(4, 25), (8, 12), (2, 4097)])
def test_shard_permutations_are_bit_exact_given_jax_keys(shards, rows):
    want, round_keys = jax_shard_permutations(3, 1, shards, rows)
    for shard in range(shards):
        got = random_index_shuffle(torch.arange(rows), round_keys[shard], rows)
        np.testing.assert_array_equal(got.numpy(), want[shard])


def test_shard_round_keys_differ_by_shard_and_keep_the_epoch_keys():
    keys = [epoch_round_keys(7, 2, shard=s) for s in range(4)]
    assert len({tuple(k) for k in keys}) == 4
    assert all(0 <= k < KEY_LIMIT for ks in keys for k in ks)
    assert epoch_round_keys(7, 2) not in keys
    assert epoch_round_keys(7, 2, shard=1) == keys[1] != epoch_round_keys(7, 3, shard=1)
