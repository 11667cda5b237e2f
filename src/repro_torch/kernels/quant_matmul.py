"""Fused quantized matmul with calibrated counter-hash noise.

Counterpart of ``repro.kernels.quant_matmul``: the paper's section II.B
white-noise error model run at model scale,

    out = (x_q @ w_q + eps) * s_x * s_w,
    eps = mu * K + sigma * sqrt(K) * z,   z ~ N(0, 1) per output element,

with ``x_q = clip(rint(x / s_x), -2^(wl-1), 2^(wl-1) - 1)`` (and ``w_q``
alike), the product accumulated in f32 over K chunks of ``min(bk, K)``
added in K order, and ``z`` drawn from a squares-style uint32 counter
hash keyed on (seed, logical tile (i, j) of ``min(bm, M)`` x
``min(bn, N)``, row and column inside the tile).

One hand-written CUDA kernel computes it (``csrc/quant_matmul.cu``); it
replaces the Pallas kernel ``repro/kernels/quant_matmul.py::
quant_matmul_kernel``.  ``quant_matmul_plain`` is the same function in
plain PyTorch.  The wrapper ``quant_matmul`` runs the plain version for
CPU tensors only; for CUDA tensors it launches the kernel or raises, and
counts its launches in ``quant_matmul.launches``.

Where the port differs from the reference on purpose: the K tail past K
counts as zero.  The Pallas kernel reads an unmasked last K block
(``bk = min(512, K)`` does not divide K = 896 or 4864), which gives NaN
in interpret mode; the port computes ``quant_matmul_ref``'s function
(ROADMAP C5).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..device import pin_fp32

__all__ = ["hash_normal", "hash_words", "hash_words_plain",
           "noise_scalars", "quant_matmul", "quant_matmul_plain",
           "quant_matmul_tolerance"]

_M32 = 0xFFFFFFFF
_U = 2.0 ** -24            # unit roundoff of float32
# bound on |z_a - z_b| between two f32 Box-Muller evaluations of the same
# uniforms: log, cos and sqrt within a few ulps each (2^-23 relative) on
# |z| < 5.7 give about 3e-6; this allows five times that
Z_TOL = 2.0 ** -16


# ------------------------------------------------------------- the hash
def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 tensors holding uint32 values, without
    the 64-bit product overflowing: b is split into 16-bit halves."""
    b = torch.as_tensor(b, dtype=torch.int64, device=a.device)
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rot16(x: torch.Tensor) -> torch.Tensor:
    return ((x >> 16) | (x << 16)) & _M32


def _squares(x: torch.Tensor, key: int) -> torch.Tensor:
    x = _rot16(_mul32(x, key))
    x = _rot16((_mul32(x, x) + key) & _M32)
    return (_mul32(x, x) + key) & _M32


def _words(r, c, seed: int, salt) -> tuple:
    """The hash's two uint32 words (as int64) for tile-local ``r``, ``c``."""
    ctr = (_mul32(r, 0x9E3779B9) + _mul32(c, 0x85EBCA6B)) & _M32
    ctr = (ctr + _mul32(torch.full_like(ctr, seed & _M32), 0xC2B2AE35)) & _M32
    ctr = (ctr + _mul32(salt & _M32, 0x27D4EB2F)) & _M32
    return _squares(ctr, 0xB5AD4ECE), _squares(ctr ^ 0xDEADBEEF, 0x548C9DEC)


def _box_muller(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    u1 = w1.to(torch.float32) / 4294967296.0
    u2 = w2.to(torch.float32) / 4294967296.0
    u1 = torch.clamp(u1, 1e-7, 1.0)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
        (2.0 * math.pi) * u2)


def _grid(m: int, n: int, bm: int, bn: int, device):
    """Tile-local row/column and salt of every element of an (m, n)
    output cut into (bm, bn) tiles, as int64 tensors that broadcast."""
    gr = torch.arange(m, dtype=torch.int64, device=device)[:, None]
    gc = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    salt = (gr // bm) * 7919 + gc // bn
    return gr % bm, gc % bn, salt


def hash_words_plain(m: int, n: int, seed: int, *, bm: int, bn: int,
                     device="cpu") -> tuple:
    """Plain version of the uniforms: (w1, w2) int64 (m, n) tensors."""
    r, c, salt = _grid(m, n, bm, bn, device)
    return _words(r, c, seed, salt)


def hash_normal(shape, seed: int, salt: int, device="cpu") -> torch.Tensor:
    """The reference's ``_hash_normal(shape, seed, salt)`` for one tile:
    Box-Muller over the hash of the tile-local (row, column)."""
    rows, cols = shape
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    return _box_muller(*_words(r, c, seed,
                               torch.tensor(salt, dtype=torch.int64,
                                            device=device)))


def noise_scalars(mu: float, sigma: float, k: int) -> tuple:
    """(mu_k, sig_k) as float32, rounded as the reference rounds them:
    ``mu * K`` is a Python (double) product cast to f32 once, and
    ``sigma * sqrt(K)`` is an f32 product of f32 operands."""
    mu_k = np.float32(float(mu) * k)
    sig_k = np.float32(np.float32(sigma) * np.sqrt(np.float32(k)))
    return float(mu_k), float(sig_k)


# ------------------------------------------------------ the plain version
def _codes(v: torch.Tensor, s: torch.Tensor, wl: int) -> torch.Tensor:
    lim = float(2 ** (wl - 1))
    return torch.clamp(torch.round(v / s), -lim, lim - 1)


def _tiles(m: int, k: int, n: int, bm: int, bk: int, bn: int) -> tuple:
    return min(bm, m), min(bk, k), min(bn, n)


def quant_matmul_plain(x, w, s_x, s_w, mu: float, sigma: float, *, wl: int,
                       seed: int, bm: int, bk: int, bn: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device.

    The chunk products go to ``torch.matmul`` in full f32 (TF32 pinned
    off); each chunk's partial sum is added to the accumulator in K order.
    """
    m, k = x.shape
    n = w.shape[1]
    bm, bk, bn = _tiles(m, k, n, bm, bk, bn)
    xq = _codes(x, s_x, wl)
    wq = _codes(w, s_w, wl)
    acc = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for k0 in range(0, k, bk):
        acc = acc + xq[:, k0:k0 + bk] @ wq[k0:k0 + bk]
    mu_k, sig_k = noise_scalars(mu, sigma, k)
    z = _box_muller(*hash_words_plain(m, n, seed, bm=bm, bn=bn,
                                      device=x.device))
    eps = mu_k + sig_k * z
    return (acc + eps) * (s_x * s_w)


def quant_matmul_tolerance(x, w, s_x, s_w, mu: float, sigma: float, *,
                           wl: int, bk: int = 512) -> torch.Tensor:
    """Elementwise bound on |a - b| for two f32 evaluations of
    ``quant_matmul`` on the same inputs (a float64 (M, N) tensor).

    Both quantize to the same integer codes (true division, half-even
    rounding) and differ only in rounding:

    * the accumulator: with ``T = |x_q| @ |w_q|`` and ``u = 2^-24``, a sum
      of K products in chunks, in any order, is within ``(K + chunks) *
      u * T`` of the exact sum (first order), on each side; but where
      every chunk's ``T`` is an integer below 2^24 each chunk partial is
      exact and the chunks are added in the same order, so the two
      accumulators are equal;
    * the noise: the normals differ by at most ``Z_TOL``, and
      ``mu_k + sig_k * z`` rounds twice (``|z| < 6``); with ``sig_k = 0``
      both sides add exactly ``mu_k``;
    * the accumulator plus noise, and the descale, round once each.

    The bound is therefore zero where the two must agree bit for bit:
    exact chunk partials and ``sigma = 0``.
    """
    m, k = x.shape
    bk = min(bk, k)
    xq = _codes(x, s_x, wl).to(torch.float64).abs()
    wq = _codes(w, s_w, wl).to(torch.float64).abs()
    t = torch.zeros((m, w.shape[1]), dtype=torch.float64, device=x.device)
    exact = True
    for k0 in range(0, k, bk):
        t_c = xq[:, k0:k0 + bk] @ wq[k0:k0 + bk]
        exact = exact and bool(t_c.numel() == 0 or t_c.amax() < 2 ** 24)
        t = t + t_c
    mu_k, sig_k = noise_scalars(mu, sigma, k)
    eps_mag = abs(mu_k) + 6.0 * abs(sig_k)
    if exact and sig_k == 0.0:
        return torch.zeros_like(t)
    acc_err = 0.0 if exact else 2 * (k + -(-k // bk)) * _U * t
    noise_err = 0.0 if sig_k == 0.0 else \
        abs(sig_k) * Z_TOL + 4 * _U * eps_mag
    round_err = 4 * _U * (t + eps_mag)
    return (acc_err + noise_err + round_err) * (float(s_x) * float(s_w))


# ------------------------------------------------------------- the wrapper
def _scalar(s, dev: torch.device) -> torch.Tensor:
    t = torch.as_tensor(s, dtype=torch.float32)
    if t.numel() != 1:
        raise ValueError(f"a scale must be one number, got shape "
                         f"{tuple(t.shape)}")
    return t.reshape(()).to(dev)


def _check(x, w, wl: int, bm: int, bk: int, bn: int) -> None:
    for t in (x, w):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError("quant_matmul takes float32 tensors, got "
                            f"{getattr(t, 'dtype', type(t))}")
        if not t.is_contiguous():
            raise ValueError("quant_matmul takes contiguous tensors")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"expected x (M, K) and w (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    if not 2 <= wl <= 16:
        raise ValueError(f"unsupported wl={wl}: the codes need 2..16 bits")
    if min(bm, bk, bn) < 1:
        raise ValueError(f"tile sizes must be positive: {(bm, bk, bn)}")
    if x.shape[1] >= 2 ** 31 or x.shape[0] * w.shape[1] >= 2 ** 31:
        raise ValueError("quant_matmul dimensions exceed the kernel's "
                         "int32 indexing")


def quant_matmul(x, w, s_x, s_w, mu: float = 0.0, sigma: float = 0.0, *,
                 wl: int = 16, seed: int = 0, bm: int = 128, bk: int = 512,
                 bn: int = 128) -> torch.Tensor:
    """Fused quantize -> matmul -> noise -> descale; (M, N) float32.

    x: (M, K) and w: (K, N) contiguous float32 tensors on one device;
    s_x, s_w: the quantization scales (real value = code * s), numbers or
    one-element tensors (a scale already on the card is passed to the
    kernel by pointer); mu, sigma: the multiplier's per-product error
    moments in the integer domain; seed: the noise seed (an int32 value,
    as the reference draws it); bm, bk, bn: the reference's logical
    tiles, which fix the hash's tiling and the K chunking.
    """
    _check(x, w, wl, bm, bk, bn)
    pin_fp32()
    sx, sw = _scalar(s_x, x.device), _scalar(s_w, x.device)
    if not x.is_cuda:
        return quant_matmul_plain(x, w, sx, sw, mu, sigma, wl=wl, seed=seed,
                                  bm=bm, bk=bk, bn=bn)
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    if k == 0:
        raise ValueError("quant_matmul needs K >= 1")
    bm, bk, bn = _tiles(m, k, n, bm, bk, bn)
    partial = torch.empty((-(-k // bk), m, n), dtype=torch.float32,
                          device=x.device)
    mu_k, sig_k = noise_scalars(mu, sigma, k)
    from ._build import library
    lib = library("quant_matmul")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.quant_matmul_launch(
            x.data_ptr(), w.data_ptr(), sx.data_ptr(), sw.data_ptr(),
            partial.data_ptr(), out.data_ptr(), m, k, n, wl, bm, bk, bn,
            seed & 0xFFFFFFFF, mu_k, sig_k, stream)
    if err != 0:
        raise RuntimeError(f"quant_matmul failed: CUDA error {err} "
                           f"({lib.quant_matmul_error_string(err).decode()})")
    quant_matmul.launches += 1
    if quant_matmul.capture is not None:
        quant_matmul.capture.append(dict(
            x=x, w=w, s_x=sx, s_w=sw, mu=mu, sigma=sigma, wl=wl, seed=seed,
            bm=bm, bk=bk, bn=bn, out=out))
    return out


quant_matmul.launches = 0
# a list to record every launch's operands and output into (a check of
# the main path against the plain version on the same inputs), or None
quant_matmul.capture = None


def hash_words(m: int, n: int, seed: int, *, bm: int, bn: int,
               device=None) -> tuple:
    """The hash's (w1, w2) uniforms as int64 (m, n) tensors.

    On a CUDA device they come from the kernel's own device code
    (``qm_hash_words_launch``), so a comparison with ``hash_words_plain``
    checks the kernel's uniforms bit for bit; on the CPU this is the
    plain version.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return hash_words_plain(m, n, seed, bm=bm, bn=bn, device=dev)
    from ._build import library
    lib = library("quant_matmul")
    w1 = torch.empty((m, n), dtype=torch.int32, device=dev)
    w2 = torch.empty_like(w1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.qm_hash_words_launch(w1.data_ptr(), w2.data_ptr(), m, n,
                                       bm, bn, seed & 0xFFFFFFFF, stream)
    if err != 0:
        raise RuntimeError(f"qm_hash_words failed: CUDA error {err}")
    return tuple(t.to(torch.int64) & _M32 for t in (w1, w2))
