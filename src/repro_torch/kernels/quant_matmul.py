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

The kernel takes one of two routes, both one launch, by
``quant_matmul_plan``: the decode route (M up to ``DECODE_MAX_M``) streams
w once through a thread-block cluster that splits K into slabs inside the
K chunks, and the tiled route (prefill) runs an exact int8 tensor-core
product over byte-split codes.  ``quant_matmul_emulated`` sums in the
plan's order in plain PyTorch.

Where the port differs from the reference on purpose: the K tail past K
counts as zero.  The Pallas kernel reads an unmasked last K block
(``bk = min(512, K)`` does not divide K = 896 or 4864), which gives NaN
in interpret mode; the port computes ``quant_matmul_ref``'s function
(ROADMAP C5).
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..device import pin_fp32

__all__ = ["DECODE_MAX_M", "MAX_CHUNK", "QuantMatmulPlan", "hash_normal", "hash_words",
           "hash_words_plain", "noise_scalars", "quant_codes",
           "quant_matmul", "quant_matmul_emulated", "quant_matmul_plain",
           "quant_matmul_plan", "quant_matmul_tolerance",
           "quotient_mismatches"]

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


@functools.lru_cache(maxsize=1024)
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


# --------------------------------------------------------------- the plan
SMS = 132                  # streaming multiprocessors of an H100 SXM
DECODE_MAX_M = 64          # rows up to which the decode route runs:
                           # faster than the tiled one at both of
                           # qwen2-0.5b's MLP shapes through 64 rows,
                           # slower at 128 (chip_smoke.py's route lines)
SMEM_LIMIT = 220 * 1024    # dynamic shared memory a block may take
DECODE_SMEM = 200 * 1024   # the decode route's budget of it
DECODE_RING = 4 * 4 * 256 * 4   # its cp.async ring of w, floats
TILE = (128, 64, 64)       # the tiled route's block tile (M, N, K)
MAX_CHUNK = 32768          # the longest K chunk: rows the tiled route's
                           # int32 sums hold exactly
TILED_BASE = (4 * (2 * TILE[0] * (TILE[2] + 4) + 2 * TILE[2] * (TILE[1] + 4))
              + 2 * (TILE[0] + TILE[1]) * (TILE[2] + 16)
              + 4 * (TILE[0] + TILE[1]))


class QuantMatmulPlan(NamedTuple):
    """One launch of the kernel: its route, grid and cluster, and its
    K slabs.

    ``slabs`` lists ``(k0, k1, chunk, rank)``: the rows ``[k0, k1)``,
    inside K chunk ``chunk``, that rank ``rank`` of a cluster sums into
    one partial (decode: a rank holds ``rows`` rows, cut at the chunk
    boundaries; tiled: one 64-row stage of a rank's whole chunks).
    """
    route: str          # "decode" or "tiled"
    grid: tuple         # (x, y, z) blocks
    cluster: int        # blocks per cluster: the ranks splitting K
    tn: int             # output columns per block
    rows: int           # K rows per rank (decode); K (tiled)
    mr: int             # output rows per block
    slabs: tuple
    smem: int           # dynamic shared memory a block, bytes


def _row_group(m: int) -> int:
    return next(r for r in (1, 2, 4, 8, 16) if r >= min(m, 16))


@functools.lru_cache(maxsize=4096)
def quant_matmul_plan(m: int, k: int, n: int, bk: int = 512,
                      max_decode_m: int = DECODE_MAX_M) -> QuantMatmulPlan:
    """The launch plan of ``quant_matmul`` at (m, k) x (k, n) with K
    chunks of ``min(bk, k)``; ``csrc/quant_matmul.cu`` forms the same
    slabs from (route, cluster, tn, rows).

    Decode (m <= ``max_decode_m`` and the slabs fit in shared memory):
    up to 8 ranks a cluster, each at least 64 rows (a multiple of 8) of
    K, each rank's rows cut at the chunk boundaries; row groups of 1, 2,
    4, 8 or 16; the tile width (32, 64 or 128 columns) and rank count
    with the fewest waves of blocks, then the most blocks in them (one
    block an SM streams at about the memory's share of an SM, and each
    block has a fixed cost), then the wider tile.  Tiled: 128 x 64
    output tiles, each chunk in 64-row stages, whole chunks split over
    up to 8 ranks where that shortens the longest rank's stages times
    the waves.
    """
    if min(m, k, n, bk) < 1:
        raise ValueError(f"quant_matmul_plan needs positive sizes, got "
                         f"{(m, k, n, bk)}")
    bk = min(bk, k)
    if bk > MAX_CHUNK:
        raise ValueError(f"K chunks of {bk} rows exceed the kernel's "
                         f"{MAX_CHUNK}")
    chunks = -(-k // bk)
    if m <= max_decode_m:
        mr = _row_group(m)
        groups = -(-m // mr)

        def layout(tn, r):
            rows = -(-(-(-k // r)) // 8) * 8
            ranks = -(-k // rows)
            blocks = -(-n // tn) * ranks * groups
            waves = -(-blocks // SMS)
            per_rank = min(chunks, (rows - 1) // bk + 2)
            smem = 4 * (DECODE_RING + rows * mr + 8 * mr * tn
                        + (ranks * per_rank + 1) * -(-(mr * tn) // ranks))
            return (-waves, blocks / (waves * SMS), tn), ranks, rows, smem
        fits = [layout(tn, r) for tn in (32, 64, 128)
                for r in range(1, min(8, -(-k // 64)) + 1)]
        fits = [f for f in fits if f[3] <= DECODE_SMEM]
        if fits:
            (_, _, tn), ranks, rows, smem = max(fits)   # fewest waves, ...
            slabs = []
            for r in range(ranks):
                lo, hi = r * rows, min((r + 1) * rows, k)
                while lo < hi:
                    c = lo // bk
                    end = min(hi, (c + 1) * bk)
                    slabs.append((lo, end, c, r))
                    lo = end
            return QuantMatmulPlan("decode", (ranks, -(-n // tn), groups),
                                   ranks, tn, rows, mr, tuple(slabs), smem)
    tm, tn, tk = TILE
    tiles = -(-n // tn) * -(-m // tm)
    stages = [-(-(min((c + 1) * bk, k) - c * bk) // tk) for c in range(chunks)]

    def split(r):
        """The chunks [c0, c1) of each of r ranks."""
        return [(q * chunks // r, (q + 1) * chunks // r) for q in range(r)]

    def cost(r):
        """Waves of one block an SM, times the longest rank's stages."""
        return -(-tiles * r // SMS) * max(sum(stages[a:b]) for a, b in split(r))
    ranks = min((r for r in range(1, min(8, chunks) + 1)
                 if r == 1 or _tiled_smem(chunks, r) <= SMEM_LIMIT),
                key=lambda r: (cost(r), r))
    slabs = tuple((k0, min(k0 + tk, c * bk + bk, k), c, q)
                  for q, (a, b) in enumerate(split(ranks))
                  for c in range(a, b)
                  for k0 in range(c * bk, min(c * bk + bk, k), tk))
    return QuantMatmulPlan("tiled", (ranks, -(-n // tn), -(-m // tm)), ranks,
                           tn, k, tm, slabs, _tiled_smem(chunks, ranks))


def _tiled_smem(chunks: int, ranks: int) -> int:
    """The tiled route's shared memory a block (``tiled_smem``)."""
    tm, tn, _ = TILE
    inbox = chunks * -(-(tm * tn) // ranks) if ranks > 1 else 0
    return TILED_BASE + 4 * inbox


def quant_matmul_emulated(x, w, s_x, s_w, mu: float, sigma: float, *,
                          wl: int, seed: int, bm: int = 128, bk: int = 512,
                          bn: int = 128, plan=None) -> torch.Tensor:
    """``quant_matmul`` summed in the kernel's order, in plain PyTorch.

    Each slab of ``plan`` (default: ``quant_matmul_plan``'s) gives one
    partial; a chunk's partial adds its slabs in the plan's order; the
    chunk partials are added to the accumulator in K order.  Decode
    slabs are f32 products (the kernel's order inside a slab differs);
    tiled slabs are exact integer sums (float64 holds them: |sum| <
    2^45), rounded to f32 once per chunk, as the kernel does.
    """
    m, k = x.shape
    n = w.shape[1]
    bm, bk, bn = _tiles(m, k, n, bm, bk, bn)
    plan = plan or quant_matmul_plan(m, k, n, bk)
    xq = _codes(x, s_x, wl)
    wq = _codes(w, s_w, wl)
    chunks = -(-k // bk)
    exact = plan.route == "tiled"
    if exact:
        xq, wq = xq.double(), wq.double()
    parts = [None] * chunks
    for k0, k1, c, _ in plan.slabs:
        p = xq[:, k0:k1] @ wq[k0:k1]
        parts[c] = p if parts[c] is None else parts[c] + p
    if exact:
        parts = [p.to(torch.float32) for p in parts]
    acc = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for p in parts:
        acc = acc + p
    mu_k, sig_k = noise_scalars(mu, sigma, k)
    z = _box_muller(*hash_words_plain(m, n, seed, bm=bm, bn=bn,
                                      device=x.device))
    return (acc + (mu_k + sig_k * z)) * (s_x * s_w)


# ------------------------------------------------------------- the wrapper
def _scalar(s, dev: torch.device) -> torch.Tensor:
    if isinstance(s, torch.Tensor) and s.dtype == torch.float32 \
            and s.dim() == 0 and s.device == dev:
        return s
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
    if min(bk, x.shape[1]) > MAX_CHUNK:
        raise ValueError(f"K chunks of {min(bk, x.shape[1])} rows exceed "
                         f"the kernel's {MAX_CHUNK}")
    if x.shape[1] >= 2 ** 31 or x.shape[0] * w.shape[1] >= 2 ** 31:
        raise ValueError("quant_matmul dimensions exceed the kernel's "
                         "int32 indexing")


_ROUTES = {"decode": 0, "tiled": 1}


def _launch(x, w, sx, sw, out, mu: float, sigma: float, *, wl: int,
            seed: int, bm: int, bk: int, bn: int,
            plan: QuantMatmulPlan) -> None:
    """One launch of the kernel on CUDA operands the wrapper checked,
    with ``bm, bk, bn`` already cut to the shape; raises on a launch
    error."""
    m, k = x.shape
    mu_k, sig_k = noise_scalars(mu, sigma, k)
    from ._build import library
    lib = library("quant_matmul")
    dev = x.device
    args = (x.data_ptr(), w.data_ptr(), sx.data_ptr(), sw.data_ptr(),
            out.data_ptr(), m, k, w.shape[1], wl, bm, bk, bn,
            seed & 0xFFFFFFFF, mu_k, sig_k, _ROUTES[plan.route],
            plan.cluster, plan.tn, plan.rows)
    # the launch goes to the current device: switch only when x is elsewhere
    with contextlib.nullcontext() if dev.index == torch.cuda.current_device() \
            else torch.cuda.device(dev):
        err = lib.quant_matmul_launch(
            *args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quant_matmul failed: CUDA error {err} "
                           f"({lib.quant_matmul_error_string(err).decode()})")


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
    tiles, which fix the hash's tiling and the K chunking (a chunk of at
    most ``MAX_CHUNK`` rows).
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
    _launch(x, w, sx, sw, out, mu, sigma, wl=wl, seed=seed, bm=bm, bk=bk,
            bn=bn, plan=quant_matmul_plan(m, k, n, bk))
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0


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


def quant_codes(v: torch.Tensor, s, wl: int) -> torch.Tensor:
    """``clip(rint(v / s), -2^(wl-1), 2^(wl-1) - 1)`` as float32.

    On a CUDA tensor the kernel's own quantizer computes it
    (``qm_codes_launch``: the exact quotient without a division per
    element), so a comparison with the CPU's true division checks the
    kernel's codes bit for bit; on the CPU this is the plain version.
    """
    v = v.to(torch.float32).contiguous()
    s = _scalar(s, v.device)
    if not v.is_cuda:
        return _codes(v, s, wl)
    from ._build import library
    lib = library("quant_matmul")
    out = torch.empty_like(v)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.qm_codes_launch(v.data_ptr(), s.data_ptr(), out.data_ptr(),
                                  v.numel(), wl, stream)
    if err != 0:
        raise RuntimeError(f"qm_codes failed: CUDA error {err}")
    return out


def quotient_mismatches(s: torch.Tensor) -> int:
    """For each divisor in ``s`` (a CUDA float32 tensor of values in
    [2^-38, 2^38]), over every dividend significand in [1, 2) and its
    negative: how many of the kernel's fast quotients differ from the
    true division (``__fdiv_rn``) bit for bit.  Quotients depend on the
    operands' significands alone while nothing underflows or overflows,
    so divisors with distinct significands cover that range."""
    from ._build import library
    lib = library("quant_matmul")
    s = s.to(torch.float32).contiguous()
    bad = torch.zeros((), dtype=torch.int64, device=s.device)
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        err = lib.qm_quotient_check_launch(s.data_ptr(), s.numel(),
                                           bad.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"qm_quotient_check failed: CUDA error {err}")
    return int(bad)
