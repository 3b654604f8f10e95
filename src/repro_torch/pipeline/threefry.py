"""``jax.random``'s Threefry-2x32 streams without jax: the device draw's
u32 seed chain in plain Python, and ``split``, ``bits`` and ``uniform``
over whole arrays as torch tensors.

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
against ``jax.random`` live).

The array forms follow the same partitionable Threefry:

  * ``split(k, n)``: key i is ``threefry2x32(k, (0, i))``;
  * ``random_bits(k, shape)``: element i (flat, row-major) is ``o0 ^ o1``
    of ``threefry2x32(k, (i >> 32, i & 0xFFFFFFFF))``;
  * ``uniform(k, shape, lo, hi)``: jax's ``_uniform`` on those bits.

:func:`threefry2x32_tensor` carries the u32 words' bits in int32
tensors (adds wrap as u32 adds do), with the 20 rounds unrolled in
Python, so the same code runs on the CPU and on the card (about 130
elementwise launches per call); the AEP push selection draws its uniforms
with it
(``train/gnn_trainer.py:default_push_uniforms``), the models' initial
weights their normals (``models/normal.py``) and the LM serving example
its prompt (:func:`randint`).  ``tests/test_torch_rng.py``
holds both to ``jax.random`` bit for bit.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

_U32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Key = Tuple[int, int]
# many keys at once: the two words of each, as int32 tensors of their bits
Keys = Tuple[torch.Tensor, torch.Tensor]


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


# ---------------------------------------------------------------------------
# whole arrays, as torch tensors
# ---------------------------------------------------------------------------
def _i32(c: int) -> int:
    """The int32 whose bits are the u32 ``c``."""
    c &= _U32
    return c - (1 << 32) if c >> 31 else c


def _add(x: torch.Tensor, w, c: int = 0) -> torch.Tensor:
    """``x`` plus the u32 word ``w`` (an int, or an int32 tensor of the
    words' bits) plus ``c``, wrapping as u32 adds do."""
    return x + (w + c if torch.is_tensor(w) else _i32(w + c))


def threefry2x32_tensor(key, x0: torch.Tensor,
                        x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`threefry2x32` elementwise over the count words ``x0``, ``x1``:
    int32 tensors holding the u32 words' bits (adds wrap as u32 adds do;
    a right shift is masked to make it logical), on their device.  The
    key's words are ints, or int32 tensors that broadcast with the counts
    (a key per element, :data:`Keys`)."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ _PARITY)
    x0 = _add(x0, ks[0])
    x1 = _add(x1, ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << r) | ((x1 >> (32 - r)) & ((1 << r) - 1))) ^ x0
        x0 = _add(x0, ks[(i + 1) % 3])
        x1 = _add(x1, ks[(i + 2) % 3], i + 1)
    return x0, x1


def split(k: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(k, num)`` (partitionable Threefry)."""
    o0, o1 = threefry2x32_tensor(k, torch.zeros(num, dtype=torch.int32),
                                 torch.arange(num, dtype=torch.int32))
    return [(a & _U32, b & _U32) for a, b in zip(o0.tolist(), o1.tolist())]


def random_bits(k: Key, shape: Sequence[int],
                device=None) -> torch.Tensor:
    """``jax.random.bits(k, shape, jnp.uint32)`` as an int32 tensor of the
    u32 values' bits on ``device`` (fewer than 2^31 elements, so the flat
    index's high word is 0)."""
    n = int(np.prod(shape, dtype=np.int64))
    if n >= 1 << 31:
        raise ValueError(f"{n} random words: at most 2^31 - 1 are drawn")
    lo = torch.arange(n, dtype=torch.int32, device=device)
    o0, o1 = threefry2x32_tensor(k, torch.zeros_like(lo), lo)
    return (o0 ^ o1).reshape(tuple(shape))


def _uniform_bits(bits: torch.Tensor, minval: float,
                  maxval: float) -> torch.Tensor:
    lo = np.float32(minval)
    scale = np.float32(np.float32(maxval) - lo)
    f = (((bits >> 9) & 0x7FFFFF) | 0x3F800000).view(torch.float32) - 1.0
    u = (f.double() * float(scale) + float(lo)).float()
    return torch.clamp_min(u, float(lo))


def uniform(k: Key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform(k, shape, jnp.float32, minval, maxval)``, bit
    for bit: the top 23 bits as the mantissa of a float ``f`` in [1, 2),
    ``f - 1`` scaled by ``maxval - minval`` (in float32) plus ``minval``,
    then floored at ``minval``.  XLA fuses the scale and the add into one
    FMA, rounded once; here both run in float64, where they are exact for
    the bounds the port draws with (``f - 1`` is a multiple of 2^-23, so
    the product and the sum fit in 53 bits), and are rounded to float32
    once."""
    return _uniform_bits(random_bits(k, shape, device), minval, maxval)


def _randint_check(minval: int, maxval: int) -> None:
    if not 0 <= minval < maxval < 2 ** 31:
        raise ValueError(f"randint over [{minval}, {maxval}) is outside "
                         f"what is drawn here")


def _randint_bits(hi: torch.Tensor, lo: torch.Tensor, minval: int,
                  maxval: int) -> torch.Tensor:
    hi = hi.long() & _U32
    lo = lo.long() & _U32
    span = maxval - minval
    mult = ((2 ** 16 % span) ** 2 & _U32) % span
    off = (((hi % span) * mult & _U32) + lo % span) & _U32
    return (minval + off % span).int()


def randint(k: Key, shape: Sequence[int], minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` (int32), bit for
    bit, for ``0 <= minval < maxval < 2^31``: two words per element from
    ``split(k)``'s two keys, ``hi % span * ((2^16 % span)^2 % span) + lo %
    span`` with every product and sum wrapping as a u32, then ``% span``,
    plus ``minval``."""
    _randint_check(minval, maxval)
    k1, k2 = split(k, 2)
    return _randint_bits(random_bits(k1, shape, device),
                         random_bits(k2, shape, device), minval, maxval)


# ---------------------------------------------------------------------------
# a key per row: [K] keys, n draws each, in one pass
# ---------------------------------------------------------------------------
def fold_in_keys(k: Key, xs: torch.Tensor) -> Keys:
    """``fold_in(k, x)`` for every x of the int32 tensor ``xs``."""
    return threefry2x32_tensor(k, torch.zeros_like(xs), xs)


def split_keys(keys: Keys, num: int = 2) -> List[Keys]:
    """``split`` of each key: ``num`` :data:`Keys` of the keys' shape."""
    i = torch.arange(num, dtype=torch.int32, device=keys[0].device)
    o0, o1 = threefry2x32_tensor((keys[0][..., None], keys[1][..., None]),
                                 torch.zeros_like(i), i)
    return [(o0[..., j], o1[..., j]) for j in range(num)]


def random_bits_keys(keys: Keys, n: int) -> torch.Tensor:
    """``random_bits(key, (n,))`` of each key, stacked: [*keys' shape, n]."""
    i = torch.arange(n, dtype=torch.int32, device=keys[0].device)
    o0, o1 = threefry2x32_tensor((keys[0][..., None], keys[1][..., None]),
                                 torch.zeros_like(i), i)
    return o0 ^ o1


def randint_keys(keys: Keys, n: int, minval: int,
                 maxval: int) -> torch.Tensor:
    """``randint(key, (n,), minval, maxval)`` of each key, stacked."""
    _randint_check(minval, maxval)
    k1, k2 = split_keys(keys, 2)
    return _randint_bits(random_bits_keys(k1, n), random_bits_keys(k2, n),
                         minval, maxval)


def uniform_keys(keys: Keys, n: int, minval: float = 0.0,
                 maxval: float = 1.0) -> torch.Tensor:
    """``uniform(key, (n,), minval, maxval)`` of each key, stacked."""
    return _uniform_bits(random_bits_keys(keys, n), minval, maxval)
