"""The device draw's u32 seed chain: Threefry-2x32 in plain Python.

The reference derives each fanout draw's seed from (base_seed, epoch,
step, rank, layer) with ``jax.random`` (``repro/pipeline/
vectorized_sampler.py:DeviceSampler._seed``)::

    key = jax.random.key(base_seed)
    for x in (epoch, step, rank, layer):
        key = jax.random.fold_in(key, x)
    seed = jax.random.bits(key, (), jnp.uint32)

With jax's default Threefry-2x32 implementation and
``jax_threefry_partitionable=True`` (the default since jax 0.5) that is:

  * ``key(s)`` is the pair ``(0, s)``;
  * ``fold_in(k, x)`` is ``threefry2x32(k, (0, x))``;
  * ``bits(k)`` is ``o0 ^ o1`` of ``threefry2x32(k, (0, 0))``.

This module computes the same u32 without jax, so the port draws exactly
the reference's minibatches (``tests/test_torch_sample_draw.py`` holds it
against ``jax.random`` live).  Nothing else in the port uses
``jax.random``.
"""
from __future__ import annotations

from typing import Tuple

_U32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Key = Tuple[int, int]


def _rotl(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & _U32


def threefry2x32(key: Key, count: Key) -> Key:
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), as
    ``jax._src.prng.threefry2x32`` computes it for one pair of words."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ _PARITY)
    x0 = (count[0] + ks[0]) & _U32
    x1 = (count[1] + ks[1]) & _U32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _U32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _U32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _U32
    return x0, x1


def _u32(name: str, x: int) -> int:
    x = int(x)
    if not 0 <= x <= _U32:
        raise ValueError(f"{name}={x} is outside the uint32 range that "
                         f"jax.random.fold_in takes")
    return x


def key(seed: int) -> Key:
    """``jax.random.key(seed)``: jax takes the seed as an int32 (without
    x64), so it must lie in [0, 2^31)."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"base seed {seed} is outside [0, 2^31)")
    return 0, seed


def fold_in(k: Key, x: int) -> Key:
    """``jax.random.fold_in(k, x)`` for an x in [0, 2^32)."""
    return threefry2x32(k, (0, _u32("fold_in data", x)))


def bits32(k: Key) -> int:
    """``jax.random.bits(k, (), jnp.uint32)`` (partitionable Threefry)."""
    o0, o1 = threefry2x32(k, (0, 0))
    return o0 ^ o1


def draw_seed(base_seed: int, epoch: int, step: int, rank: int,
              layer: int) -> int:
    """The u32 seed of one (epoch, step, rank, layer) fanout draw."""
    k = key(base_seed)
    for x in (epoch, step, rank, layer):
        k = fold_in(k, x)
    return bits32(k)
