"""Host-side threefry2x32 keys, bit-equal to ``jax.random``'s default PRNG.

The reference's language model draws its noise seeds from JAX keys:
``lm_apply`` starts from ``jax.random.key(0)``, splits it once per layer
(``models/transformer.py:355``), and ``amm_dense`` turns the layer's key
into an int32 kernel seed with ``jax.random.randint(key, (), 0,
2**31 - 1, int32)`` (``models/common.py:246-248``).  This module computes
the same integers with numpy uint32 arithmetic on the host, so the port's
kernels receive the reference's seeds.  It runs on scalars, once per
engine.  ``random_bits``, ``uniform`` and ``bernoulli`` draw whole
arrays of ``jax.random``'s bits as torch tensors on a named device (the
keyed fault masks of ``core.faults``), in int64 arithmetic masked to 32
bits.

A key is a pair of uint32 words ``(k1, k2)``, as JAX stores a threefry
key.  ``split`` follows JAX's partitionable scheme (the default from jax
0.5 on: ``jax_threefry_partitionable=True``): the counts of an
``n``-key split are the 64-bit iota ``0 .. n-1`` cut into a high and a
low uint32 word.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["Key", "key", "split", "fold_in", "random_bits32", "randint",
           "threefry2x32", "layer_seeds", "random_bits", "uniform",
           "bernoulli"]

Key = Tuple[int, int]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block function (20 rounds), elementwise.

    All four operands are uint32 (scalars or arrays that broadcast);
    returns the two uint32 output words.  The round structure is JAX's
    ``_threefry2x32_lowering``: five groups of four rounds, the key
    schedule ``(k1, k2, k1 ^ k2 ^ 0x1BD11BDA)`` injected after each group
    with the group index added to the second word.
    """
    with np.errstate(over="ignore"):
        ks = [np.uint32(k1), np.uint32(k2)]
        ks.append(ks[0] ^ ks[1] ^ _PARITY)
        x = [np.asarray(x1, np.uint32) + ks[0],
             np.asarray(x2, np.uint32) + ks[1]]
        for g in range(5):
            for r in _ROTATIONS[g % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(g + 1) % 3]
            x[1] = x[1] + ks[(g + 2) % 3] + np.uint32(g + 1)
    return x[0], x[1]


def key(seed: int) -> Key:
    """``jax.random.key(seed)`` with 64-bit types off (JAX's default):
    the seed is taken as a 32-bit integer, so the high word is 0."""
    return (0, int(seed) & 0xFFFFFFFF)


def split(k: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(k, num)`` under the partitionable scheme."""
    counts = np.arange(num, dtype=np.uint64)
    hi = (counts >> np.uint64(32)).astype(np.uint32)
    lo = (counts & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b1, b2 = threefry2x32(k[0], k[1], hi, lo)
    return [(int(a), int(b)) for a, b in zip(b1, b2)]


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)``: the threefry block of the key on
    the count ``(0, data)`` (``data`` as uint32), as JAX seeds a key from
    a 32-bit integer."""
    b1, b2 = threefry2x32(k[0], k[1], np.uint32(0),
                          np.uint32(int(data) & 0xFFFFFFFF))
    return (int(b1), int(b2))


def random_bits32(k: Key) -> int:
    """One uint32 of ``jax.random.bits(k, (), uint32)``: the threefry
    block of count 0, its two words xor-ed."""
    b1, b2 = threefry2x32(k[0], k[1], np.uint32(0), np.uint32(0))
    return int(b1 ^ b2)


def randint(k: Key, minval: int = 0, maxval: int = 2 ** 31 - 1) -> int:
    """``jax.random.randint(k, (), minval, maxval, jnp.int32)``.

    JAX's two-word modulus: the key is split in two, each half gives 32
    random bits, and ``(hi % span) * mult + lo % span`` is reduced mod
    ``span`` in uint32 arithmetic that wraps, with ``mult = 2^32 mod
    span`` computed as ``((2^16 % span)^2) % span`` -- the square wraps
    too, as it does in JAX.
    """
    if not -2 ** 31 <= minval and maxval <= 2 ** 31 - 1:
        raise ValueError("randint covers the int32 range only")
    k1, k2 = split(k)
    hi = np.uint32(random_bits32(k1))
    lo = np.uint32(random_bits32(k2))
    with np.errstate(over="ignore"):
        span = np.uint32((maxval - minval) & 0xFFFFFFFF) if maxval > minval \
            else np.uint32(1)
        mult = np.uint32(1 << 16) % span
        mult = (mult * mult) % span
        off = ((hi % span) * mult + lo % span) % span
    val = (minval + int(off)) & 0xFFFFFFFF
    return val - (1 << 32) if val >= 1 << 31 else val


@functools.lru_cache(maxsize=64)
def layer_seeds(seed, n_layers: int) -> Tuple[int, ...]:
    """The noise seed ``amm_dense`` derives in each layer of ``lm_apply``.

    Starts from ``key(seed)`` (or from ``seed`` itself when it is a
    ``Key``); each layer splits the running key into (next key, layer
    key) and draws ``randint(layer key)``.  A tuple of ``n_layers``
    Python ints, cached: an engine computes it once.
    """
    k = tuple(seed) if isinstance(seed, tuple) else key(seed)
    out = []
    for _ in range(n_layers):
        k, sub = split(k)
        out.append(randint(sub))
    return tuple(out)


# ------------------------------------------------------- tensor draws
_M32 = 0xFFFFFFFF


def _threefry_t(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor):
    """``threefry2x32`` on int64 tensors holding uint32 values: every sum
    is masked to 32 bits, rotations shift inside the int64 range."""
    ks = (k1, k2, k1 ^ k2 ^ int(_PARITY))
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = (((x[1] << r) | (x[1] >> (32 - r))) & _M32) ^ x[0]
        x[0] = (x[0] + ks[(g + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(g + 2) % 3] + g + 1) & _M32
    return x[0], x[1]


def random_bits(k: Key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` under the partitionable
    scheme, as an int64 tensor of uint32 values on ``device`` (None: the
    GPU, raising without one; "cpu"): the threefry block of each
    element's row-major flat index, cut into a (high, low) word pair, its
    two output words xor-ed."""
    shape = tuple(int(d) for d in shape)
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(n, dtype=torch.int64, device=resolve_device(device))
    b1, b2 = _threefry_t(int(k[0]), int(k[1]), idx >> 32, idx & _M32)
    return (b1 ^ b2).reshape(shape)


def uniform(k: Key, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(k, shape)`` in float32 on [0, 1): the top 23
    random bits as the mantissa of a float in [1, 2), minus 1."""
    bits = (random_bits(k, shape, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(k: Key, p: float, shape, device=None) -> torch.Tensor:
    """``jax.random.bernoulli(k, p, shape)``: ``uniform < float32(p)``."""
    u = uniform(k, shape, device)
    return u < torch.tensor(p, dtype=torch.float32, device=u.device)
