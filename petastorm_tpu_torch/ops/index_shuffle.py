"""J4: a seeded permutation of ``[0, n)`` evaluated pointwise, the counterpart
of ``petastorm_tpu.ops.index_shuffle`` (``random_index_shuffle``, with
``_round_fn`` and ``_encrypt``). Plain PyTorch: the JAX package's version is a
jitted XLA function, not a Pallas kernel.

The construction is the reference's: the domain is rounded up to ``2^k``
with ``k = max(1, ceil(log2 n))``, indices are split into a high ``k // 2``-bit
and a low ``k - k // 2``-bit half, and alternating Feistel rounds XOR one half
with a murmur-style keyed hash of the other, in uint32 wraparound arithmetic.
Values that land in ``[n, 2^k)`` cycle-walk (are encrypted again) until they
fall below ``n``. Given the same round keys the output is bit for bit the
reference's.

Torch has no general uint32 arithmetic, so everything runs in int64 masked
to 32 bits: :func:`_mul32` splits the multiplier so no product leaves int64,
and every right shift sees a non-negative value.

The round keys are explicit. :func:`epoch_round_keys` draws them from a
``torch.Generator`` seeded from ``(seed, epoch)``; the reference draws them
with ``jax.random.randint`` from ``fold_in(PRNGKey(seed), epoch)``. The port
does not reproduce threefry, so the same seed gives another permutation in
the two packages (a defined difference, and so do the per-shard keys of a
mesh loader's shard-local shuffle, J9); a test hands the port JAX's keys to
compare the two.

The cycle walk tests ``(x >= n).any()`` on the host after each pass, so on the
card the function syncs: the loaders call it once per epoch, eagerly, outside
any CUDA graph, and copy the result into the graph's static index buffer.
"""

import numpy as np
import torch

_DEFAULT_ROUNDS = 4
_MASK32 = 0xFFFFFFFF
#: round keys lie in [0, KEY_LIMIT), as ``jax.random.randint(..., 0, int32 max)`` draws them
KEY_LIMIT = 2 ** 31 - 1


def _mul32(value, constant):
    """``value * constant`` modulo 2^32 for int64 ``value`` in [0, 2^32) and
    a 32-bit constant, with no intermediate above 2^49."""
    low = value * (constant & 0xFFFF)
    high = ((value * (constant >> 16)) & 0xFFFF) << 16
    return (low + high) & _MASK32


def _round_fn(value, round_key, mask):
    """Murmur3-style mixing of one Feistel half under a round key (uint32 wrap)."""
    h = _mul32(value ^ round_key, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h & mask


def _encrypt(x, round_keys, right_bits, left_mask, right_mask):
    left = (x >> right_bits) & left_mask
    right = x & right_mask
    for i, round_key in enumerate(round_keys):
        if i % 2 == 0:
            left = left ^ _round_fn(right, round_key, left_mask)
        else:
            right = right ^ _round_fn(left, round_key, right_mask)
    return (left << right_bits) | right


def _splitmix64(value):
    value = (value + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    value = ((value ^ (value >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    value = ((value ^ (value >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return value ^ (value >> 31)


def epoch_round_keys(seed, epoch, rounds=_DEFAULT_ROUNDS, shard=None):
    """``rounds`` round keys in ``[0, 2^31 - 1)`` for epoch ``epoch`` of base
    seed ``seed``, from a CPU ``torch.Generator`` seeded from both. The CPU
    generator keeps 32 bits of its seed, so ``(seed, epoch)`` is mixed
    (splitmix64) into those bits rather than packed side by side.

    ``shard`` (a mesh loader's shard-local shuffle) mixes the shard in once
    more, as the JAX package folds the shard into the epoch's key
    (``fold_in(epoch_key, shard)``); None gives the single-device keys."""
    mixed = _splitmix64(_splitmix64(int(seed) & 0xFFFFFFFFFFFFFFFF) ^ (int(epoch) & _MASK32))
    if shard is not None:
        mixed = _splitmix64(mixed ^ (int(shard) & _MASK32))
    generator = torch.Generator().manual_seed(mixed & _MASK32)
    return torch.randint(0, KEY_LIMIT, (rounds,), generator=generator).tolist()


def random_index_shuffle(positions, round_keys, n):
    """Map ``positions`` in ``[0, n)`` through the keyed permutation of
    ``[0, n)`` that ``round_keys`` select, elementwise.

    :param positions: integer tensor of indices in ``[0, n)`` (any shape, any
        device); ``torch.arange(n)`` gives the whole permutation.
    :param round_keys: a sequence of Python ints in ``[0, 2^31 - 1)``, one per
        Feistel round.
    :param n: domain size.
    :return: int64 tensor (torch's index type; the reference returns int32)
        of ``positions``' shape on their device: ``perm[positions]``.
    """
    n = int(n)
    if n < 1:
        raise ValueError('n must be >= 1')
    round_keys = [int(key) for key in round_keys]
    if not round_keys or any(not 0 <= key < KEY_LIMIT for key in round_keys):
        raise ValueError('round_keys must be a non-empty sequence of ints in [0, 2^31 - 1), '
                         'got {}'.format(round_keys))
    x = torch.as_tensor(positions).to(torch.int64)
    if n == 1:
        return torch.zeros_like(x)
    k = max(1, int(np.ceil(np.log2(n))))
    left_bits = k // 2
    right_bits = k - left_bits
    left_mask = (1 << left_bits) - 1
    right_mask = (1 << right_bits) - 1
    x = _encrypt(x, round_keys, right_bits, left_mask, right_mask)
    while True:
        outside = x >= n
        if not bool(outside.any()):
            return x
        # re-encrypt only the out-of-range lanes; the cipher is a bijection on
        # [0, 2^k) and 2^k < 2n, so the walk ends (expected < 2 passes)
        x = torch.where(outside, _encrypt(x, round_keys, right_bits, left_mask, right_mask), x)
