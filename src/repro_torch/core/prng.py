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
bits.  ``normal`` draws ``jax.random.normal``'s float32 normals bit for
bit: on a CUDA device through the hand-written kernel of
``kernels.normal``, on the CPU through ``normal_plain``.

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
           "threefry2x32", "key_seed", "layer_keys", "layer_seeds",
           "random_bits", "uniform", "bernoulli", "erfinv_from_bits",
           "fma_f32", "folded_scale", "normal", "normal_from_bits",
           "normal_plain"]

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
def layer_keys(rng, n_layers: int) -> Tuple[Key, ...]:
    """The key each layer of ``lm_apply`` hands its ``amm_dense`` calls.

    Starts from ``key(rng)`` (or from ``rng`` itself when it is a
    ``Key``); each layer splits the running key into (next key, layer
    key), as ``key, sub = jax.random.split(key)`` in the reference's layer
    scan.  A tuple of ``n_layers`` keys, cached: an engine computes it
    once.
    """
    k = tuple(rng) if isinstance(rng, tuple) else key(rng)
    out = []
    for _ in range(n_layers):
        k, sub = split(k)
        out.append(sub)
    return tuple(out)


@functools.lru_cache(maxsize=1024)
def key_seed(k: Key) -> int:
    """The int32 noise seed ``amm_dense`` derives from its key, as the
    reference does (``randint(k)``), cached: a layer's key recurs every
    step."""
    return randint(k)


@functools.lru_cache(maxsize=64)
def layer_seeds(seed, n_layers: int) -> Tuple[int, ...]:
    """The noise seed ``amm_dense`` derives in each layer of ``lm_apply``:
    ``key_seed`` of each of ``layer_keys(seed, n_layers)``.  A tuple of
    ``n_layers`` Python ints, cached."""
    return tuple(key_seed(sub) for sub in layer_keys(seed, n_layers))


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


# ------------------------------------------------------- normal draws
def _f32_const(bits: int) -> float:
    """The float32 of the given bit pattern, as a Python float."""
    return float(np.array([bits], np.uint32).view(np.float32)[0])


# jax.random.normal(key, shape, float32) on XLA:CPU, read from the
# compiled program: the uniform u = max(lo, 2 f + lo) on [lo, 1) with lo
# = nextafter(-1, 0); then sqrt(2) * erf_inv(u), where erf_inv is XLA's
# ErfInv32 (w = -log1p(-u*u); a degree-8 polynomial in w - 2.5 for w <
# 5, else in sqrt(w) - 3; times u), log1p is XLA's (a Cephes rational
# form for |y| < sqrt(2) - 1, else log(1 + y)) and log is XLA:CPU's
# (Cephes' logf: three polynomial chains in the reduced mantissa, the
# exponent added back through ln 2 split in two).  Each *_FMA step below
# is one the compiler fused; every other step rounds on its own.
_LO = _f32_const(0xBF7FFFFF)
_SQRT2 = _f32_const(0x3FB504F3)
_SQRTHF = _f32_const(0x3F3504F3)
_MIN_NORM = _f32_const(0x00800000)
_LOG_P = tuple(_f32_const(b) for b in (
    0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A, 0xBDFE5D4F, 0x3E11E9BF,
    0xBE2AAE50, 0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA))
_LOG_Q1, _LOG_Q2 = _f32_const(0xB95E8083), _f32_const(0x3F318000)
_LOG1P_SMALL = _f32_const(0x3ED413CD)          # sqrt(2) - 1
_LOG1P_NUM = tuple(_f32_const(b) for b in (
    0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C, 0x4273CC76,
    0x426473AD, 0x41A05101))
_LOG1P_DEN = tuple(_f32_const(b) for b in (
    0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3, 0x43586D8A,
    0x42707982))
_ERFINV_LT5 = tuple(_f32_const(b) for b in (
    0x32F16588, 0x34B84B36, 0xB66C7357, 0xB6935AC1, 0x396532DB,
    0xBAA45408, 0xBB88E4EF, 0x3E7C8F63, 0x3FC02E2F))
_ERFINV_GE5 = tuple(_f32_const(b) for b in (
    0xB951F09B, 0x38D3B56B, 0x3AB0DC72, 0xBB70BDE7, 0x3BBC127B,
    0xBBF9C5D7, 0x3C1AA57E, 0x3F8036DB, 0x40354F7E))


def fma_f32(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (a fused multiply-add), on CPU
    tensors or numbers that broadcast.

    The product of two float32 values is exact in float64; the sum is
    rounded to float64 by round-to-odd (TwoSum gives the exact error; a
    sum with an error and an even last bit steps one unit toward it),
    which leaves the final rounding to float32 correct: float64 carries
    more than twice float32's 24 bits plus two.
    """
    f64 = torch.float64
    a, b, c = (torch.as_tensor(v, dtype=torch.float32).to(f64)
               for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)).add_(c - bb)
    bits = s.view(torch.int64)
    fix = (err != 0) & ((bits & 1) == 0)
    # one unit up in magnitude where the error points away from zero
    step = torch.where((err > 0) == (s > 0), 1, -1)
    return (bits + fix * step).view(f64).to(torch.float32)


def _div_f32(a, b):
    """float32 division rounded once (through float64, which is exact
    for the quotient's rounding: 53 >= 2 * 24 + 2)."""
    return (a.to(torch.float64) / b.to(torch.float64)).to(torch.float32)


def _sqrt_f32(a):
    """float32 square root rounded once (through float64, as above)."""
    return torch.sqrt(a.to(torch.float64)).to(torch.float32)


def _log_f32(t: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 log of positive finite ``t``."""
    t = torch.clamp_min(t, _MIN_NORM)
    bits = t.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    low = m < _SQRTHF
    x = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = torch.where(low, e - 1.0, e)
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    a = fma_f32(x, fma_f32(x, p[0], p[1]), p[2])
    b = fma_f32(x, fma_f32(x, p[3], p[4]), p[5])
    c = fma_f32(x, fma_f32(x, p[6], p[7]), p[8])
    poly = fma_f32(x3, fma_f32(x3, a, b), c)
    y = fma_f32(x3, poly, e * _LOG_Q1)           # the x3 * poly product fused
    return fma_f32(e, _LOG_Q2, fma_f32(-0.5, x2, x) + y)


def _log1p_f32(y: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p of ``y`` in (-1, 0]: each branch computed on
    the elements that take it."""
    out = torch.empty_like(y)
    small = y.abs() < _LOG1P_SMALL
    ys = y[small]
    y2 = ys * ys
    den = torch.ones_like(ys)
    for c in _LOG1P_DEN:
        den = fma_f32(ys, den, c)
    num = torch.full_like(ys, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = fma_f32(ys, num, c)
    out[small] = ys + fma_f32(-0.5, y2, (ys * y2) * _div_f32(num, den))
    out[~small] = _log_f32(y[~small] + 1.0)
    return out


def _erfinv_f32(u: torch.Tensor) -> torch.Tensor:
    """XLA's ErfInv32 of ``u`` in (-1, 1)."""
    lp = _log1p_f32(u * -u)                        # -w
    lt5 = lp > -5.0
    t = torch.where(lt5, -2.5 - lp, _sqrt_f32(-lp) - 3.0)

    def coef(i):
        return torch.where(lt5, torch.tensor(_ERFINV_LT5[i]),
                           torch.tensor(_ERFINV_GE5[i]))
    p = fma_f32(t, coef(0), coef(1))
    for i in range(2, 9):
        p = fma_f32(t, p, coef(i))
    p = torch.where(u.abs() == 1.0, torch.tensor(float("inf")), p)
    return u * p


def erfinv_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``erf_inv(u)`` of ``jax.random.normal``'s uniform ``u`` drawn from
    each uint32 of ``bits`` (an integer CPU tensor), in plain PyTorch:
    the top 23 bits as the uniform's mantissa, then XLA's ErfInv32."""
    mant = (((bits.to(torch.int64) & _M32) >> 9) | 0x3F800000).to(torch.int32)
    f = mant.view(torch.float32) - 1.0
    u = torch.clamp_min(fma_f32(f, 2.0, _LO), _LO)
    return _erfinv_f32(u)


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.normal``'s float32 value of each uint32 of ``bits``:
    ``sqrt(2) * erfinv_from_bits(bits)``.  A function of the top 23 bits
    alone, so its 2^23 inputs can be checked exhaustively."""
    return erfinv_from_bits(bits) * _SQRT2


def folded_scale(c2: float) -> float:
    """``c2 * sqrt(2)`` as XLA folds it inside a program that computes
    ``c2 * jax.random.normal(...)``: both rounded to float32, their
    product rounded to float32; the draw's own ``* sqrt(2)`` then goes,
    and the product with ``erf_inv(u)`` fuses into the add after it."""
    return float(np.float32(c2) * np.float32(_SQRT2))


def normal_plain(k: Key, shape, *, acc=None, c1: float = 0.0,
                 c2: float = 0.0, order: str = "acc") -> torch.Tensor:
    """``jax.random.normal(k, shape, float32)`` bit for bit in plain
    PyTorch on the CPU; with ``acc`` (a float32 tensor of ``shape``, on
    whose device the plain version then runs: the card's copy is timed)
    the value of ``acc + c1 + c2 * z`` as XLA compiles it, returned
    (``acc`` is not written): ``order="acc"`` gives ``fma(c2s,
    erf_inv(u), acc + c1)`` (the sum ``acc + c1`` formed first),
    ``order="noise"`` gives ``acc + fma(c2s, erf_inv(u), c1)`` (``c1 + c2
    * z`` formed first), with ``c2s = folded_scale(c2)``."""
    bits = random_bits(k, shape, "cpu" if acc is None else acc.device)
    if acc is None:
        return normal_from_bits(bits)
    ei = erfinv_from_bits(bits)
    c1 = torch.tensor(c1, dtype=torch.float32)
    c2s = folded_scale(c2)
    if order == "acc":
        return fma_f32(c2s, ei, acc + c1)
    if order == "noise":
        return acc + fma_f32(c2s, ei, c1)
    raise ValueError(f"unknown order {order!r}")


def normal(k: Key, shape, device=None, *, acc=None, c1: float = 0.0,
           c2: float = 0.0, order: str = "acc") -> torch.Tensor:
    """``jax.random.normal(k, shape, float32)`` bit for bit, as a float32
    tensor on ``device`` (None: the GPU, raising without one; "cpu": the
    plain version).  On the GPU one launch of the ``normal_draw`` kernel
    (``kernels.normal``); with ``acc`` the draw is folded into it in
    place as ``normal_plain``'s epilogue.  The one place in ``core``
    that reaches a kernel."""
    from ..kernels.normal import normal_draw
    return normal_draw(k, shape, device=device, acc=acc, c1=c1, c2=c2,
                       order=order)
