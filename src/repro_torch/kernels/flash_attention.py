"""Flash attention, exact and on the Broken-Booth datapath.

Counterpart of ``repro.kernels.flash_attention``.  Two hand-written CUDA
kernels (the library ``flash_attention`` holds head dims 16, 32 and 64,
``csrc/flash_attention.cuh``; ``flash_attention_wide`` 80 and 128,
``csrc/flash_attention_wide.cuh``, so that nvcc builds the two sources
side by side), each with a plain PyTorch version of the same function
beside it:

  ``flash_attention``      replaces the Pallas kernel
      ``repro/kernels/flash_attention.py::_attn_kernel``: the exact
      forward, blockwise online softmax in f32.
  ``flash_attention_amm``  replaces the Pallas kernel
      ``repro/kernels/flash_attention.py::_attn_amm_kernel`` with its tile
      body ``_amm_tile_step``: every tile's score and value products
      through the amm datapath, straight-through toward the exact f32
      product (``exact + (approx - exact)``), P quantized in the tile.

As in the reference, the wrapper of the amm kernel quantizes Q (already
scaled by 1/sqrt(d)), K and V per (batch*head, block) with the amm
quantizer, on the host side of the grid, and hands the kernel codes (as
int16) and scales.  The plain version (the counterpart of
``_flash_amm_xla``) also decodes K's digit planes there, once per call;
the kernels decode K's and V's codes themselves: at head dims 16-64 the
digits in registers, at 80 and 128 (tensor-core route) the byte planes
once per tile into shared memory.

Dead tiles.  A KV tile is dead for a q-block when every (row, key) pair
in it is masked: under causal, when its first key lies past the block's
last row, and when it starts at or past the valid KV length.  The live
tiles of a q-block are a prefix of the KV axis (``live_kv_tiles`` counts
them), and tile 0 is always live, so no row's running max stays at
-1e30.  In a dead tile every weight is ``exp(-1e30 - m) = 0`` and the
rescale ``exp(m - m) = 1``: the running sum and accumulator come through
bit for bit, so both kernels skip dead tiles.  On the amm datapath that
holds for kind 0 only: P's codes are 0 there and a kind-0 product of
code 0 is 0, but kind 1 subtracts the sign bit of every negative digit
before the truncating shift, ``(0 - 1) >> m_r = -1``, so a dead tile's
approximate P V product is not 0 and kind 1 computes every tile, as the
reference does.  The residuals of a skipped tile hold what a dead kind-0
tile forms: P's codes 0, its scale 1e-12 (the quantizer's floor) and its
P V product 0; its score products, which nothing reads through the mask,
hold 0 (``DEAD_SCORE``).  The plain versions form every tile, as the
reference does, which gives the same bits; the amm one writes
``DEAD_SCORE`` into the score residual of the tiles the kernel skips.

Schedule.  Each kernel block owns one (q-block, batch*head) and walks
the live tiles of its q-block; blocks are numbered heaviest first (the
last causal q-block of every head, then the one before), so the card
takes the longest blocks in its first wave.  K and V tiles arrive by
``cp.async`` in 16-byte (f32) and 8-byte (int16 code) copies, the next
copy under the current products.

Head dims 16-64 keep the design of ``csrc/flash_attention.cuh``: the
exact kernel forms Q K^T on the tensor cores in 3xTF32 (each f32 operand
split into a TF32 high and low part, hi*hi + hi*lo + lo*hi with the f32
accumulator drained into f32 registers after every 8-term step; the
error model is in the CUDA source and stays inside ``flash_tolerance``'s
score term) and P V with FFMA on the CUDA cores; the amm kernel forms
its integer Broken-Booth products on the CUDA cores (``bbm_dot.cuh``).

Head dims 80 and 128 have kernels of their own
(``csrc/flash_attention_wide.cuh``), each with two routes that a pure
function of the call picks and ``<wrapper>.mma_launches`` counts apart
from ``.launches``; neither falls back to the other.  The exact kernel
(``flash_exact_route``): from ``PV_3XTF32_MIN_SKV`` keys on ("tf32") P V
also runs in 3xTF32 on the tensor cores, P kept in registers from the
score accumulator to P V's operand, which the same error model admits
inside the tolerance's sum term from that length on; over shorter KV
lengths ("ffma") P V runs with FFMA.  The amm kernel (``flash_amm_route``):
where ``bbm_dot_route`` says "mma", both integer products run on the
int8 tensor cores in the contracted form of ``csrc/bbm_mma.cuh``, the
multiplier's Booth planes (K's, V's) decoded once per tile, each product
one chunk (every such operating point's chunk holds a tile) whose int32
sum is flushed to f32 as before, so every residual keeps its bits;
elsewhere ("tile") the CUDA-core products.  Both amm
routes keep the float products in f32 FFMA (``flash_amm_compare``
derives its code-movement bound from two f32 evaluations).

A wrapper runs the plain version only for tensors on the CPU; on CUDA
tensors it launches its kernel or raises, and counts its launches in
``<wrapper>.launches``.  The two float orders (tensor-core and FFMA
chains in the kernels, matmuls in the plain versions, XLA's dots in the
reference) and ``expf`` against other exponentials differ in rounding.
The exact kernel agrees with its plain version and the reference within
``flash_tolerance``.  Two evaluations of the amm kernel's function are
held against each other by ``flash_amm_compare``: the approximate score
products bit-equal, P's codes and scales within what the float
differences can move, the approximate P V products bit-equal where P's
codes agree, and the output within a bound charged only for the codes
that really moved.

``flash_attention_amm(..., residuals=True)`` also returns what every
tile formed: its approximate score product, P's codes and scale, and its
approximate P V product (the kernel writes them beside its output).
``flash_amm_compare`` reads all four; the backward
(``models.attention._FlashAmmSTE``) feeds the score and P V products to
``flash_amm_plain(..., residuals_in=)`` and takes the reference's
straight-through gradient without forming a Broken-Booth product again.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..device import pin_fp32
from .booth_rows import amm_chunk_len, booth_precode, num_corr_rows
from .bbm_matmul import bbm_dot_route, dot_scaled_chunked

__all__ = ["DEAD_SCORE", "FLASH_AMM_BK", "FLASH_AMM_BQ", "NEG_INF",
           "PV_3XTF32_MIN_SKV", "flash_amm_compare", "flash_amm_operands",
           "flash_amm_plain", "flash_amm_route",
           "flash_attention", "flash_attention_amm", "flash_attention_plain",
           "flash_exact_route", "flash_tolerance", "live_kv_tiles",
           "quantize_blocks"]

NEG_INF = -1e30
# the score residual of a skipped tile (read by nothing: the mask covers it)
DEAD_SCORE = 0.0

# flash-amm tile sizes: the chunked-amm reference runs at the same
# blocking for the equality contract (quantization is per block)
FLASH_AMM_BQ = 128
FLASH_AMM_BK = 128

_U = 2.0 ** -24               # unit roundoff of f32
_EXP_REL = 2.0 ** -21         # two f32 exps of one argument: a few ulps
# the kernels' instantiations: every head dim a registered config runs
# through them (whisper-base 64; zamba2-2.7b 80; grok-1-314b,
# llama3.2-3b, yi-34b, qwen1.5-110b, chameleon-34b 128) and 16, 32
_HEAD_DIMS = (16, 32, 64, 80, 128)
_WIDE_DIMS = (80, 128)        # the kernels of csrc/flash_attention_wide.cuh
_MAX_TILE = 128
# the fewest keys at which the exact kernels' error model
# (csrc/flash_attention_wide.cuh) admits 3xTF32 for P V inside
# flash_tolerance's sum term: (30.04 + ceil(Skv / 8) + ceil(Skv / 32) - 2) u
# <= (Skv + 8) u
PV_3XTF32_MIN_SKV = 26
# the C entry points' route numbers
_EXACT_ROUTES = {"ffma": 0, "tf32": 1}
_AMM_ROUTES = {"tile": 0, "mma": 1}


def quantize_blocks(t: torch.Tensor, wl: int, dtype=torch.int32):
    """``amm_quantize`` of every (..., rows, cols) slice of ``t`` at once:
    (codes of ``dtype``, f32 scales of shape (..., 1, 1)), each slice with
    its own scale, bit-identical to quantizing the slices one by one."""
    lim = 2 ** (wl - 1) - 1
    tf = t.to(torch.float32)
    s = torch.clamp_min(torch.amax(torch.abs(tf), dim=(-2, -1),
                                   keepdim=True) * (1.0 / lim), 1e-12)
    codes = torch.clamp(torch.round(tf / s), -lim - 1, lim)
    return codes.to(dtype), s


def _check_qkv(q, k, v, name: str) -> None:
    for t in (q, k, v):
        if not isinstance(t, torch.Tensor) or not t.is_floating_point():
            raise TypeError(f"{name} takes float tensors, got "
                            f"{getattr(t, 'dtype', type(t))}")
        if t.dim() != 4:
            raise ValueError(f"{name} takes (B, H, S, D) tensors, got "
                             f"{tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"operands on {q.device} and {t.device}")
    if k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)}/"
                         f"{tuple(v.shape)} do not match (the caller "
                         f"repeats KV heads for GQA)")
    if q.shape[2] == 0 or k.shape[2] == 0:
        raise ValueError(f"{name} needs non-empty sequences")


def _tiles(sq: int, skv: int, bq: int, bk: int) -> tuple:
    if not (1 <= bq <= _MAX_TILE and 1 <= bk <= _MAX_TILE):
        raise ValueError(f"tile sizes must be in 1..{_MAX_TILE}, got "
                         f"{(bq, bk)}")
    return min(bq, sq), min(bk, skv)


def _stream(dev: torch.device):
    return torch.cuda.current_stream(dev).cuda_stream


def _library(d: int):
    """The built library of the kernels at head dim ``d``."""
    from ._build import library
    return library("flash_attention" if d <= 64 else "flash_attention_wide")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernels copy
    rows with 16-byte ``cp.async``)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_exact_route(d: int, skv: int) -> str:
    """The exact kernel's P V route at head dim ``d`` over ``skv`` keys:
    "tf32" (3xTF32 on the tensor cores) at the wide head dims from
    ``PV_3XTF32_MIN_SKV`` keys on, else "ffma" (the only route at d <=
    64).  A pure function of its arguments."""
    return "tf32" if d in _WIDE_DIMS and skv >= PV_3XTF32_MIN_SKV \
        else "ffma"


def flash_amm_route(d: int, wl: int, vbl: int, kind: int) -> str:
    """The amm kernel's integer route at head dim ``d``: "mma" (the int8
    tensor cores) at the wide head dims where ``bbm_dot_route`` says
    "mma" and a chunk (``amm_chunk_len``) holds a whole tile's product,
    as every such chunk does (511 products at least), so that each
    product is flushed once; else "tile" (the CUDA cores; the only route
    at d <= 64).  A pure function of its arguments."""
    return "mma" if d in _WIDE_DIMS \
        and bbm_dot_route(wl, vbl, kind) == "mma" \
        and amm_chunk_len(wl, vbl) >= _MAX_TILE else "tile"


def live_kv_tiles(sq: int, skv: int, bq: int, bk: int, *, causal: bool,
                  kv_len: int | None = None) -> list:
    """The number of live KV tiles of each q-block: ``n[i]`` for the
    q-block of rows ``[i bq, min((i + 1) bq, sq))``.

    Tiles of ``bk`` keys over ``skv`` positions, of which the first
    ``kv_len`` (default all) are valid.  A tile is live for a q-block when
    some (row, key) pair in it is unmasked: its first key is below
    ``kv_len`` and, under causal, not past the block's last row.  Both
    conditions bound the key from above, so the live tiles are the first
    ``n[i]``, and ``n`` never decreases with ``i``.  The kernels compute
    the same count in ``csrc/flash_attention.cuh`` (``live_tiles``).
    """
    kv_len = skv if kv_len is None else kv_len
    n_valid = min(-(-skv // bk), -(-kv_len // bk))
    counts = []
    for i in range(-(-sq // bq)):
        last = min((i + 1) * bq, sq) - 1
        counts.append(min(n_valid, last // bk + 1) if causal else n_valid)
    return counts


# ------------------------------------------------------- exact (B4)
def flash_attention_plain(q, k, v, *, causal: bool = True, bq: int = 128,
                          bk: int = 128) -> torch.Tensor:
    """Plain version of the exact kernel: ``_attn_kernel``'s online
    softmax over KV blocks of ``bk``, every query row at once (rows are
    independent, so the q blocking changes nothing).  It forms every
    block, the dead ones too, which the kernel skips: their weights are
    0 and their rescale 1, so that changes no bit.  (B, H, S, D)."""
    pin_fp32()
    b, h, sq, d = q.shape
    skv = k.shape[2]
    bq, bk = _tiles(sq, skv, bq, bk)
    nk = -(-skv // bk)
    qf = q.to(torch.float32)
    kf = F.pad(k.to(torch.float32), (0, 0, 0, nk * bk - skv))
    vf = F.pad(v.to(torch.float32), (0, 0, 0, nk * bk - skv))
    scale = 1.0 / (d ** 0.5)
    dev = q.device
    q_pos = torch.arange(sq, device=dev)[:, None]
    m = torch.full((b, h, sq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev)
    for j in range(nk):
        kj = kf[:, :, j * bk:(j + 1) * bk]
        vj = vf[:, :, j * bk:(j + 1) * bk]
        s = (qf @ kj.transpose(-1, -2)) * scale
        k_pos = j * bk + torch.arange(bk, device=dev)[None, :]
        live = k_pos < skv
        if causal:
            live = live & (q_pos >= k_pos)
        s = torch.where(live, s, NEG_INF)
        m_cur = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_cur)
        alpha = torch.exp(m - m_cur)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ vj
        m = m_cur
    return (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, bq: int = 128,
                    bk: int = 128) -> torch.Tensor:
    """Exact blockwise attention.  q: (B, H, Sq, D); k, v: (B, H, Skv, D)
    with matched head counts (the caller repeats KV heads for GQA).
    Returns (B, H, Sq, D) in q's dtype.

    ``bq`` and ``bk`` (1..128) are the plain version's tiles, which it
    runs on CPU tensors.  The kernels take their own (64 query rows by
    64 keys at head dims 16-64, 128 by 32 at 80 and 128): rows are
    independent, so the row tile changes no bit, and the KV tile moves
    only the rounding of the sums, within ``flash_tolerance``.  The
    kernels take head dims 16, 32, 64, 80 and 128; the plain version
    any.  On a CUDA tensor the call runs ``flash_exact_route(d, Skv)``'s
    route (counted in ``.mma_launches`` where P V ran on the tensor
    cores).
    """
    _check_qkv(q, k, v, "flash_attention")
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, bq=bq, bk=bk)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    _tiles(sq, skv, bq, bk)
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention's kernel takes head_dim in "
                         f"{_HEAD_DIMS} (every registered config's), got "
                         f"{d}")
    qc, kc, vc = (_aligned(t.to(torch.float32).reshape(b * h, t.shape[2], d))
                  for t in (q, k, v))
    out = torch.empty((b * h, sq, d), dtype=torch.float32, device=q.device)
    route = flash_exact_route(d, skv)
    lib = _library(d)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(),
            b * h, sq, skv, d, int(causal), 1.0 / (d ** 0.5),
            _EXACT_ROUTES[route], _stream(q.device))
    if err != 0:
        raise RuntimeError(
            f"flash_attention failed on route {route}: error {err} "
            f"({lib.flash_attention_error_string(err).decode()})")
    flash_attention.launches += 1
    flash_attention.mma_launches += route == "tf32"
    return out.reshape(b, h, sq, d).to(q.dtype)


flash_attention.launches = 0
flash_attention.mma_launches = 0     # P V on the tensor cores ("tf32")


def _stats(q, k, v):
    """Per (b, h): max |q| / sqrt(d), max |k|, max |v| as float64."""
    d = q.shape[-1]
    amax = lambda t: t.detach().to(torch.float64).abs().amax(  # noqa: E731
        dim=(-2, -1))
    return amax(q) / math.sqrt(d), amax(k), amax(v)


def flash_tolerance(q, k, v) -> torch.Tensor:
    """Bound on |a - b| between two f32 evaluations of exact attention
    on the same (B, H, S, D) inputs; a (B, H, 1, 1) float64 tensor.

    Each evaluation is within E of the exact real-number result:

    * a score ``q.k / sqrt(d)`` is a d-term dot product, within
      ``(d + 2) u * d * A * K`` of its exact value in any summation order
      (A = max |q| / sqrt(d), K = max |k|, u = 2^-24), and ``s - m``
      rounds once more (|s - m| <= 2 d A K);
    * ``exp`` is within a few ulps (2^-21 relative);
    * so every weight ``p`` is within a factor e^(+-eps) of exact, with
      ``eps = (d + 6) u d A K + 2^-21``, and the normalized output, a
      convex combination of V's rows, within ``(e^(2 eps) - 1) V``
      (V = max |v|);
    * the sums over Skv positions (numerator, denominator, in blocks) add
      ``2 (Skv + 8) u V``.

    Two evaluations differ by at most 2E.
    """
    d = q.shape[-1]
    skv = k.shape[2]
    a, kk, vv = _stats(q, k, v)
    eps = (d + 6) * _U * d * a * kk + _EXP_REL
    e = (torch.expm1(2 * eps) + 2 * (skv + 8) * _U) * vv
    return (2 * e)[..., None, None]


# --------------------------------------------------------- amm (B3)
def flash_amm_operands(q, k, v, *, wl: int, bq: int = FLASH_AMM_BQ,
                       bk: int = FLASH_AMM_BK) -> dict:
    """The host side of the grid (the reference's ``flash_attention_amm``
    before its dispatch): pad the sequences to whole tiles, scale Q by
    1/sqrt(d), and quantize Q, K and V per (batch*head, block).

    Returns ``qf, kf, vf`` f32 (BH, S_pad, D), ``qc, kc, vc`` int16 codes
    of the same shapes (wl <= 16; the kernel copies them as they are),
    ``qs`` (BH, nq), ``ks, vs`` (BH, nk) scales, and the geometry
    ``shape, bq, bk, skv``.
    """
    b, h, sq, d = q.shape
    skv = k.shape[2]
    bq, bk = _tiles(sq, skv, bq, bk)
    nq, nk = -(-sq // bq), -(-skv // bk)
    bh = b * h
    pad_q = (0, 0, 0, nq * bq - sq)
    pad_k = (0, 0, 0, nk * bk - skv)
    qf = F.pad(q.to(torch.float32), pad_q).reshape(bh, nq * bq, d) \
        * (1.0 / d ** 0.5)
    kf = F.pad(k.to(torch.float32), pad_k).reshape(bh, nk * bk, d)
    vf = F.pad(v.to(torch.float32), pad_k).reshape(bh, nk * bk, d)
    i16 = torch.int16
    qc, qs = quantize_blocks(qf.reshape(bh, nq, bq, d), wl, i16)
    kc, ks = quantize_blocks(kf.reshape(bh, nk, bk, d), wl, i16)
    vc, vs = quantize_blocks(vf.reshape(bh, nk, bk, d), wl, i16)
    return {"qf": qf.contiguous(), "kf": kf.contiguous(),
            "vf": vf.contiguous(),
            "qc": qc.reshape(bh, nq * bq, d).contiguous(),
            "kc": kc.reshape(bh, nk * bk, d).contiguous(),
            "vc": vc.reshape(bh, nk * bk, d).contiguous(),
            "qs": qs.reshape(bh, nq).contiguous(),
            "ks": ks.reshape(bh, nk).contiguous(),
            "vs": vs.reshape(bh, nk).contiguous(),
            "shape": (b, h, sq, d), "bq": bq, "bk": bk, "skv": skv}


def flash_amm_plain(ops: dict, *, wl: int, vbl: int, kind: int,
                    causal: bool = True, residuals: bool = False,
                    residuals_in: dict | None = None):
    """Plain version of the amm kernel on ``flash_amm_operands``: the
    reference's ``_amm_tile_step`` under its ``_flash_amm_xla`` loop,
    every (batch*head, q-block) at once, the KV blocks in order.  It
    forms every tile, the dead ones too: at kind 0 their P codes, scale
    and P V product are what the kernel writes for a tile it skips, and
    their score product, which the mask hides, becomes ``DEAD_SCORE`` in
    the residuals, as the kernel leaves it.

    Returns the (BH, S_pad, D) f32 output and, with ``residuals``, the
    dict the kernel writes beside it (``flash_attention_amm``).
    ``residuals_in``: the ``s`` and ``pv`` of an earlier run, taken in
    place of forming the approximate products.  The straight-through sums
    detach them, so autograd through this call is the reference's
    straight-through gradient at that run's values
    (``models.attention._FlashAmmSTE``).
    """
    if residuals and residuals_in is not None:
        raise ValueError("residuals and residuals_in exclude each other")
    pin_fp32()
    bq, bk, skv = ops["bq"], ops["bk"], ops["skv"]
    bh, sqp, d = ops["qf"].shape
    nq, nk = sqp // bq, ops["kf"].shape[1] // bk
    dev = ops["qf"].device
    qf = ops["qf"].reshape(bh, nq, bq, d)
    kf = ops["kf"].reshape(bh, nk, bk, d)
    vf = ops["vf"].reshape(bh, nk, bk, d)
    if residuals_in is None:
        qc = ops["qc"].to(torch.int32).reshape(bh, nq, bq, d)
        vc = ops["vc"].reshape(bh, nk, bk, d)
        qs = ops["qs"][:, :, None, None]
        # K's digit planes, decoded once per call over the K^T code
        # blocks: (wl//2, bh, nk, d, bk)
        kmag, kneg = booth_precode(ops["kc"].reshape(bh, nk, bk, d)
                                   .transpose(-1, -2), wl)
    else:
        s_in = residuals_in["s"].reshape(bh, nq, bq, nk, bk)
    q_pos = (torch.arange(nq, device=dev)[:, None, None] * bq
             + torch.arange(bq, device=dev)[None, :, None])
    m = torch.full((bh, nq, bq, 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((bh, nq, bq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((bh, nq, bq, d), dtype=torch.float32, device=dev)
    res = {"s": [], "pv": [], "pc": [], "ps": []}
    for j in range(nk):
        exact = qf @ kf[:, j:j + 1].transpose(-1, -2)      # (bh, nq, bq, bk)
        if residuals_in is None:
            yq = dot_scaled_chunked(qc, kmag[:, :, j:j + 1],
                                    kneg[:, :, j:j + 1], wl=wl, vbl=vbl,
                                    kind=kind, f32_dots=True)
            approx = yq * (qs * ops["ks"][:, j, None, None, None])
        else:
            approx = s_in[:, :, :, j]
        s = exact + (approx - exact).detach()
        if residuals:
            res["s"].append(approx)
        k_pos = j * bk + torch.arange(bk, device=dev)[None, None, :]
        live = k_pos < skv
        if causal:
            live = live & (q_pos >= k_pos)
        s = torch.where(live, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pe = p @ vf[:, j:j + 1]
        if residuals_in is None:
            pc, s_p = quantize_blocks(p, wl)
            vmag, vneg = booth_precode(vc[:, j:j + 1], wl)
            yv = dot_scaled_chunked(pc, vmag, vneg, wl=wl, vbl=vbl,
                                    kind=kind, f32_dots=True)
            approx = yv * (s_p * ops["vs"][:, j, None, None, None])
        else:
            approx = residuals_in["pv"][:, j].reshape(bh, nq, bq, d)
        if residuals:
            res["pv"].append(approx)
            res["pc"].append(pc.to(torch.int16))
            res["ps"].append(s_p.reshape(bh, nq))
        acc = acc * alpha + (pe + (approx - pe).detach())
        m = m_new
    out = (acc / torch.clamp_min(l, 1e-30)).reshape(bh, sqp, d)
    if not residuals:
        return out
    s_res = torch.stack(res["s"], dim=3)               # (bh, nq, bq, nk, bk)
    if kind == 0:
        # the tiles the kernel skips (kind 0 only) hold DEAD_SCORE
        counts = torch.tensor(live_kv_tiles(sqp, nk * bk, bq, bk,
                                            causal=causal, kv_len=skv),
                              device=dev)
        dead = torch.arange(nk, device=dev)[None, :] >= counts[:, None]
        s_res = s_res.masked_fill(dead[None, :, None, :, None], DEAD_SCORE)
    return out, {"s": s_res.reshape(bh, sqp, nk * bk),
                 "pv": torch.stack(res["pv"], dim=1).reshape(bh, nk, sqp, d),
                 "pc": torch.stack(res["pc"], dim=3).reshape(bh, sqp,
                                                             nk * bk),
                 "ps": torch.stack(res["ps"], dim=2), "bq": bq, "bk": bk}


def _amm_launch(ops: dict, *, wl: int, vbl: int, kind: int, causal: bool,
                residuals: bool = False, route=None):
    """One counted launch of the amm kernel on ``ops`` (CUDA tensors):
    ``route`` None takes ``flash_amm_route``'s; "mma" or "tile" forces
    one (for comparing the two on the same inputs), and the kernel
    refuses a route it cannot compute."""
    bh, sqp, d = ops["qf"].shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention_amm's kernel takes head_dim in "
                         f"{_HEAD_DIMS} (every registered config's), got "
                         f"{d}")
    skvp = ops["kf"].shape[1]
    bq, bk = ops["bq"], ops["bk"]
    dev = ops["qf"].device
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((bh, sqp, d), **f32)
    res = None
    if residuals:
        res = {"s": torch.empty((bh, sqp, skvp), **f32),
               "pv": torch.empty((bh, skvp // bk, sqp, d), **f32),
               "pc": torch.empty((bh, sqp, skvp), dtype=torch.int16,
                                 device=dev),
               "ps": torch.empty((bh, sqp // bq, skvp // bk), **f32),
               "bq": bq, "bk": bk}
    ptr = lambda n: 0 if res is None else res[n].data_ptr()  # noqa: E731
    inv_lim = float(np.float32(1.0 / (2 ** (wl - 1) - 1)))
    # the kernel copies whole rows of the f32 tiles and int16 codes
    tiles = [_aligned(ops[n]) for n in ("qf", "kf", "vf", "qc", "kc",
                                        "vc")] + [
        ops[n].contiguous() for n in ("qs", "ks", "vs")]
    if route is None:
        route = flash_amm_route(d, wl, vbl, kind)
    elif route not in _AMM_ROUTES:
        raise ValueError(f"unknown route {route!r} (expected one of "
                         f"{tuple(_AMM_ROUTES)})")
    lib = _library(d)
    with torch.cuda.device(dev):
        err = lib.flash_attention_amm_launch(
            *(t.data_ptr() for t in tiles),
            out.data_ptr(), ptr("s"), ptr("pv"), ptr("pc"), ptr("ps"),
            bh, sqp, skvp, d, bq, bk, ops["skv"], int(causal),
            wl, vbl, kind, num_corr_rows(wl, vbl), amm_chunk_len(wl, vbl),
            inv_lim, _AMM_ROUTES[route], _stream(dev))
    if err != 0:
        raise RuntimeError(
            f"flash_attention_amm failed on route {route}: error {err} "
            f"({lib.flash_attention_error_string(err).decode()})")
    flash_attention_amm.launches += 1
    flash_attention_amm.mma_launches += route == "mma"
    return (out, res) if residuals else out


def flash_attention_amm(q, k, v, *, wl: int, vbl: int, kind: int,
                        causal: bool = True, bq: int = FLASH_AMM_BQ,
                        bk: int = FLASH_AMM_BK, residuals: bool = False):
    """Flash attention on the Broken-Booth datapath.  (B, H, S, D) in/out.

    q: (B, H, Sq, D); k, v: (B, H, Skv, D) with matched head counts.
    wl/vbl/kind: the dot-form lowering (``AmmRuntime.attn_lowering``).
    The kernels take head dims 16, 32, 64, 80 and 128; the plain version
    any.  On a CUDA tensor the call runs ``flash_amm_route``'s route
    (counted in ``.mma_launches`` on the tensor cores).  ``residuals``:
    also return the dict of what every tile formed: the
    approximate score products ``s`` (B*H, Sq_pad, Skv_pad), P's codes
    ``pc`` (int16, the same shape) and scales ``ps`` (B*H, nq, nk), the
    approximate P V products ``pv`` (B*H, nk, Sq_pad, D), and the tiling
    ``bq``, ``bk``.
    """
    _check_qkv(q, k, v, "flash_attention_amm")
    if kind not in (0, 1) or wl % 2 or not 2 <= wl <= 16 \
            or not 0 <= vbl < wl:
        raise ValueError(f"unsupported lowering wl={wl} vbl={vbl} "
                         f"kind={kind}")
    ops = flash_amm_operands(q, k, v, wl=wl, bq=bq, bk=bk)
    run = _amm_launch if q.is_cuda else flash_amm_plain
    got = run(ops, wl=wl, vbl=vbl, kind=kind, causal=causal,
              residuals=residuals)
    out, res = got if residuals else (got, None)
    b, h, sq, d = ops["shape"]
    out = out[:, :sq].reshape(b, h, sq, d).to(q.dtype)
    return (out, res) if residuals else out


flash_attention_amm.launches = 0
flash_attention_amm.mma_launches = 0     # the int8 tensor cores ("mma")

# exp(-110) is below the smallest f32: larger score gaps weigh nothing
_GAP_CAP = 110.0


def flash_amm_compare(ops: dict, a: dict, b: dict, *, wl: int, vbl: int,
                      causal: bool, q_pos=None) -> dict:
    """Hold two evaluations of flash-amm attention on the same operands
    against each other, with a bound derived from what differs between
    them.  Returns a report; its ``ok`` is the verdict.

    ops: ``flash_amm_operands`` of the inputs, or the same fields for
    another blocking of the rows: ``qf`` (G, R, D) queries scaled by
    1/sqrt(d), ``kf``, ``vf`` (G, C, D), V's codes ``vc`` (G, C, D) and
    scales ``vs`` (G, nk), ``bq`` (rows per P tile), ``bk``, ``skv``.
    ``q_pos``: each row's query position (default: the row index).
    a, b: ``{"out": (G, R', D) with R' <= R, "s", "pc", "ps", "pv"}``,
    the last four in the layout of ``flash_attention_amm``'s residuals.

    Both evaluations quantize Q, K and V to the same codes, so they
    differ only where floats round.  With u = 2^-24:

    1. the approximate score products ``s`` are bit-equal (integer
       products of equal codes, descaled alike);
    2. each score the softmax sees, ``exact + (approx - exact)``, is
       within ``delta = 1.01 u (2 |s| + E)`` of ``s`` (E = |q| . |k|):
       the exact product's own rounding cancels but for u of it;
    3. so a row's running max moves by at most ``dm``, the row's largest
       delta, and every weight ``p``, ``alpha`` and the sum ``l`` is
       within a factor ``e^(+-eta)`` of its real value from ``s``, with
       ``eta = 4 dm + 2.02 u gap + (nk + 1)(2^-21 + 2u) + (bk + 2 nk +
       4) u`` (gap: the row's score range, capped where exp underflows;
       2^-21 bounds the error of one f32 exp);
    4. P's tile scales agree within ``expm1(2 eta) + 4u``, relatively,
       and a P code moves by at most ``floor(lim (expm1(2 eta) + the
       scale's change + 4u)(1 + 4u)) + 1`` steps;
    5. a tile's approximate P V products are bit-equal where its P codes
       and scale agree.  Elsewhere they differ by at most ``|dc| (|v| +
       4 (4^R - 1) / 3) + R 2^vbl`` per moved code in the code domain (a
       step of the multiplicand moves ``a bq`` by ``|bq| <= |v| + 2 (4^R
       - 1) / 3`` and each of the R truncated rows' floors by at most
       ``2^(1 - m_r)`` steps plus one), times the scales, plus the scale's
       change and the roundings of the chunk sums and the descale;
    6. the outputs ``sum_j w_j (pe_j + (pv_j - pe_j)) / l`` differ by at
       most ``(1 + F) sum_j (W_j / L)[charge_j + (F + 2.1u)(|pv_a| +
       |pv_b|) + 2.2u PE_j] + u (|out_a| + |out_b|)``, with the real
       weights W_j / L from ``s``, ``F = expm1(2 eta) + (2 nk + 2) u`` and
       ``PE_j = P . |v|``.

    A wrong tile scale or mask moves many codes by many steps (4); a
    wrong rescale or sum moves the output far beyond (6), which is the
    size of the float roundings plus one code step for each code that
    really moved.
    """
    u = _U
    f64 = torch.float64
    qf, kf, vf = (ops[n].detach().to(f64) for n in ("qf", "kf", "vf"))
    g, r, d = qf.shape
    c = kf.shape[1]
    bq, bk = ops["bq"], ops["bk"]
    nq, nk = r // bq, c // bk
    dev = qf.device
    lim = 2 ** (wl - 1) - 1
    rows = num_corr_rows(wl, vbl)
    pos = torch.arange(r, device=dev) if q_pos is None \
        else torch.as_tensor(q_pos, device=dev)
    k_pos = torch.arange(c, device=dev)
    live = (k_pos < ops["skv"])[None, :]
    if causal:
        live = live & (pos[:, None] >= k_pos[None, :])
    live = live.expand(r, c)[None]
    # 2-3: the real-number softmax from s, and how far a float one moves
    s = a["s"].to(f64)
    delta = torch.where(live, 1.01 * u * (2 * s.abs() + qf.abs()
                                          @ kf.abs().transpose(-1, -2)), 0.0)
    dm = delta.amax(-1, keepdim=True)                          # (G, R, 1)
    st = torch.where(live, s, -math.inf).reshape(g, r, nk, bk)
    mt = torch.cummax(st.amax(-1), dim=-1).values              # (G, R, nk)
    if not bool(torch.isfinite(mt[..., 0]).all()):
        raise ValueError("every row needs a live key in the first tile")
    p = torch.exp(st - mt[..., None])
    w = torch.exp(mt - mt[..., -1:])
    wgt = (w / (w * p.sum(-1)).sum(-1, keepdim=True))[..., None]
    gap = torch.where(live, (mt[..., -1:] - s).clamp(max=_GAP_CAP),
                      0.0).amax(-1, keepdim=True)
    eta = (4 * dm + 2.02 * u * gap + (nk + 1) * (2.0 ** -21 + 2 * u)
           + (bk + 2 * nk + 4) * u)                            # (G, R, 1)
    fr = torch.expm1(2 * eta)
    # 4: P's scales and codes
    ps_a, ps_b = (x["ps"].to(f64) for x in (a, b))             # (G, nq, nk)
    ps_rel = (ps_a - ps_b).abs() / ps_b
    fr_tile = torch.expm1(2 * eta.reshape(g, nq, bq).amax(-1, keepdim=True))
    rel = ps_rel.repeat_interleave(bq, dim=1)[..., None]      # (G, R, nk, 1)
    dc = (a["pc"].to(torch.int32) - b["pc"].to(torch.int32)).abs().to(
        f64).reshape(g, r, nk, bk)
    steps = torch.floor(lim * (fr[..., None] + rel + 4 * u) * (1 + 4 * u)) + 1
    # 5: the P V products, against the Broken-Booth products that moved
    pv_a, pv_b = (x["pv"].to(f64).permute(0, 2, 1, 3) for x in (a, b))
    vcl = ops["vc"].to(f64).abs().reshape(g, nk, bk, d) \
        + 4 * (4 ** rows - 1) / 3
    sc = (ps_a.repeat_interleave(bq, dim=1)
          * ops["vs"].to(f64)[:, None, :])[..., None]         # (G, R, nk, 1)
    n_chunks = -(-bk // amm_chunk_len(wl, vbl))
    mag = pv_a.abs() + pv_b.abs()
    charge = ((torch.einsum("grjk,gjkd->grjd", dc, vcl)
               + rows * 2.0 ** vbl * (dc > 0).sum(-1, keepdim=True))
              * sc * (1 + 2 * u) + pv_b.abs() * rel + 2 * u * mag
              + 2 * (n_chunks + 1) * u * sc * torch.einsum(
                  "grjk,gjkd->grjd", a["pc"].to(f64).abs().reshape(
                      g, r, nk, bk), vcl))
    diff = (pv_a - pv_b).abs()
    agree = ((dc.sum(-1, keepdim=True) == 0) & (rel == 0)).expand_as(diff)
    # 6: the outputs
    pe = torch.einsum("grjk,gjkd->grjd", p, vf.abs().reshape(g, nk, bk, d))
    f_ = (fr + (2 * nk + 2) * u)[..., None]                   # (G, R, 1, 1)
    bound = (wgt * (charge + (f_ + 2.1 * u) * mag + 2.2 * u * pe)).sum(2) \
        * (1 + f_[:, :, 0])
    out_a, out_b = (x["out"].detach().to(f64).reshape(g, -1, d)
                    for x in (a, b))
    bound = bound[:, :out_a.shape[1]] + u * (out_a.abs() + out_b.abs())
    err = (out_a - out_b).abs()
    rep = {
        "scores_equal": torch.equal(a["s"], b["s"]),
        "scales_ok": bool((ps_rel <= fr_tile + 4 * u).all()),
        "code_steps_ok": bool((dc <= steps).all()),
        "pv_equal_where_codes_agree": bool((diff[agree] == 0).all()),
        "pv_within_charge": bool((diff <= charge).all()),
        "out_within_bound": bool((err <= bound).all()),
        "codes": dc.numel(), "codes_moved": int((dc > 0).sum()),
        "max_code_step": int(dc.max()), "max_scale_rel": float(ps_rel.max()),
        "max_err": float(err.max()), "max_bound": float(bound.max()),
        "worst_ratio": float((err / bound).max()),
    }
    rep["ok"] = all(rep[k] for k in (
        "scores_equal", "scales_ok", "code_steps_ok",
        "pv_equal_where_codes_agree", "pv_within_charge", "out_within_bound"))
    return rep
