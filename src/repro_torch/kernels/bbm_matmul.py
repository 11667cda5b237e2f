"""The bit-exact Broken-Booth matmul on the folded dot form.

Counterpart of the dot-form half of ``repro.kernels.bbm_matmul``.  Every
Broken-Booth product is ``2^vbl * M`` with

    M(x, w) = x*bq + sum_{r<R} ((d_r*x - kind*neg_r) >> m_r),  m_r = vbl-2r

(``booth_rows``: ``bq = booth_high_value``, ``R = num_corr_rows``), so
``sum_k bbm(x, w)`` is ``2^vbl`` times an integer that int32 holds
exactly over a K-chunk of ``amm_chunk_len``.  The plain versions here
are the reference's contraction schedule in PyTorch: ``_dot_scaled``
writes each truncated row's K-sum as a digit dot minus one-hot residue
dots (``_MOD_BRANCHES``), ``bbm_matmul_scaled`` and ``dot_scaled_chunked``
chunk K and add the chunk partials in f32 in chunk order, and
``bbm_matmul_dynamic`` quantizes both operands per call (attention).

One hand-written CUDA kernel computes the contracted form on the card:
``bbm_dot_scaled`` (``csrc/bbm_dot.cu``), which replaces the XLA
lowering ``repro/kernels/bbm_matmul.py::_dot_scaled``.  It sits behind
``bbm_matmul_dynamic`` and ``models.common._amm_bitexact_approx``.  The
K-sum of the bracket above equals the sum of the per-product floors, so the kernel
forms each product directly on the CUDA cores, with no one-hot
contraction, and keeps the reference's chunking: an int32 partial per
chunk, f32 adds in chunk order, then ``* 2^vbl``.  It takes the weight
operand as int32 codes and decodes their radix-4 digits in the kernel:
the codes are a quarter of the bytes of the packed planes' inputs, and
the decode is a few integer operations per weight element, amortized
over the block's rows.  The wrapper runs the plain version only for
tensors on the CPU; on CUDA tensors it launches the kernel or raises,
and counts its launches in ``bbm_dot_scaled.launches``.

torch's CUDA matmul has no int32 route (``torch._int_mm`` takes int8),
so on the card the plain versions run only the reference's own f32 route
(``f32_dots=True``: exact within ``f32_exact_chunk_len``, TF32 pinned
off).  The s32 route (``bbm_matmul_scaled``, ``f32_dots=False``, or an
operating point with no f32 envelope) raises in ``_dot_i32`` for
operands off the CPU: a caller who wants the plain version there passes
CPU tensors, and the card's route is ``bbm_dot_scaled``.  The ``fault=`` hooks of the reference are ROADMAP
item A11 and raise.
"""
from __future__ import annotations

import torch

from ..core.booth import num_pp_rows
from ..device import pin_fp32
from .booth_rows import (amm_chunk_len, booth_high_value, booth_precode,
                         f32_exact_chunk_len, num_corr_rows, signed_digit,
                         split_signed)
from .ref import amm_quantize

__all__ = ["bbm_dot_scaled", "bbm_dot_scaled_plain", "bbm_matmul_dynamic",
           "bbm_matmul_scaled", "dot_scaled_chunked"]

_FAULTS = "fault injection is ROADMAP item A11"

# the (signed digit, raw sign bit) pairs a radix-4 row can take, per kind:
# each pair is one dense contraction of the dot form's residue term
_MOD_BRANCHES = {0: ((1, 0), (2, 0), (-1, 0), (-2, 0)),
                 1: ((1, 0), (2, 0), (0, 1), (-1, 1), (-2, 1))}


def _dot_i32(x: torch.Tensor, y: torch.Tensor, *, f32_chunk: int = 0):
    """int32 contraction ``x @ y`` (leading batch axes broadcast).

    ``f32_chunk = 0``: one int32 matmul, on the CPU only (torch has no
    int32 matmul on the card; operands elsewhere raise).  A positive
    ``f32_chunk`` (``f32_exact_chunk_len``) splits K into chunks
    whose every product and partial sum is an integer below 2^24, so the
    f32 matmul computes it exactly; bit-identical either way.
    """
    if not f32_chunk:
        if x.device.type != "cpu" or y.device.type != "cpu":
            raise ValueError(
                f"the int32 contraction runs on the CPU only (operands on "
                f"{x.device}, {y.device}); on the card use the f32 route "
                f"(f32_dots=True) where f32_exact_chunk_len > 0, or the "
                f"bbm_dot_scaled kernel")
        return x @ y
    pin_fp32()
    k = x.shape[-1]
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    acc = None
    for lo in range(0, k, f32_chunk):
        part = (xf[..., lo:lo + f32_chunk] @ yf[..., lo:lo + f32_chunk, :]
                ).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def _dot_scaled(x_s, wmag, wneg, *, wl: int, vbl: int, kind: int,
                f32_chunk: int = 0):
    """``sum_k bbm(x, w) / 2^vbl`` as dense contractions, int32.

    x_s: (..., M, K) signed codes; wmag/wneg: (wl//2, ..., K, N) digit
    planes.  Each truncated row's K-sum is ``[dot(x, d_r) - kind *
    sum_k neg_r - sum_k residue] >> m_r``, the residue term one one-hot
    contraction per (digit, sign) pair; exact within ``amm_chunk_len``.
    """
    bq = booth_high_value(wmag, wneg, wl=wl, vbl=vbl)
    acc = _dot_i32(x_s, bq, f32_chunk=f32_chunk)
    for r in range(num_corr_rows(wl, vbl)):
        m = vbl - 2 * r
        mask = (1 << m) - 1
        d = signed_digit(wmag[r], wneg[r])
        rowdot = _dot_i32(x_s, d, f32_chunk=f32_chunk)
        if kind:
            rowdot = rowdot - torch.sum(wneg[r], dim=-2, dtype=torch.int32
                                        ).unsqueeze(-2)
        xm = x_s & mask
        modsum = None
        for v, s in _MOD_BRANCHES[kind]:
            t = (v * xm - s) & mask
            ind = (d == v) if kind == 0 else (d == v) & (wneg[r] == s)
            part = _dot_i32(t, ind.to(torch.int32), f32_chunk=f32_chunk)
            modsum = part if modsum is None else modsum + part
        acc = acc + ((rowdot - modsum) >> m)
    return acc


def _check_planes(x, wmag, wneg, wl: int) -> None:
    if wmag.shape != wneg.shape or wmag.shape[0] != num_pp_rows(wl) \
            or wmag.shape[-2] != x.shape[-1]:
        raise ValueError(f"digit planes {tuple(wmag.shape)}/"
                         f"{tuple(wneg.shape)} do not match wl={wl}, "
                         f"K={x.shape[-1]}")


def dot_scaled_chunked(x, wmag, wneg, *, wl: int, vbl: int, kind: int,
                       f32_dots: bool = False):
    """``sum_k bbm(x, w)`` as f32 at full product scale, any K.

    K is chunked by ``amm_chunk_len``; each chunk's int32 partial
    (``_dot_scaled``) is cast to f32 and the partials are added in chunk
    order, then multiplied by 2^vbl (exact).  ``f32_dots`` routes the
    contractions through the exact-envelope f32 matmuls (bit-identical;
    s32 where the operating point has no f32 envelope).  x: (..., M, K)
    int32 codes; planes (wl//2, ..., K, N).
    """
    _check_planes(x, wmag, wneg, wl)
    kk = x.shape[-1]
    _, x_s = split_signed(x, wl)
    chunk = amm_chunk_len(wl, vbl)
    f32_chunk = f32_exact_chunk_len(wl, vbl) if f32_dots else 0
    acc = None
    for lo in range(0, kk, chunk):
        part = _dot_scaled(x_s[..., lo:lo + chunk],
                           wmag[..., lo:lo + chunk, :],
                           wneg[..., lo:lo + chunk, :], wl=wl, vbl=vbl,
                           kind=kind, f32_chunk=f32_chunk)
        part = part.to(torch.float32)
        acc = part if acc is None else acc + part
    return acc * float(1 << vbl)


def bbm_matmul_scaled(x, wmag, wneg, *, wl: int, vbl: int, kind: int = 0,
                      fault=None):
    """``sum_k bbm(x[m,k], w[k,n])`` as f32 (M, N), any K: the amm
    datapath's plain version (s32 contractions, as the reference), on
    CPU tensors only (on the card, ``bbm_dot_scaled`` on the codes).

    The reference pads K to whole chunks and scans; zero codes decode to
    all-zero digits and contribute nothing to any contraction, so the
    ragged chunk loop here gives the same partials in the same order.
    """
    if fault is not None:
        raise NotImplementedError(f"fault=: {_FAULTS}")
    return dot_scaled_chunked(x, wmag, wneg, wl=wl, vbl=vbl, kind=kind)


def bbm_matmul_dynamic(a, b, *, wl: int, vbl: int, kind: int = 0,
                       fault=None):
    """Both operands dynamic (the attention products): quantize ``a``
    (M, K) and ``b`` (K, N) per call with ``amm_quantize``, contract the
    codes on the datapath (``bbm_dot_scaled``: the kernel on the card),
    descale.  Returns (M, N) in ``a.dtype``."""
    if fault is not None:
        raise NotImplementedError(f"fault=: {_FAULTS}")
    aq, s_a = amm_quantize(a, wl)
    bq, s_b = amm_quantize(b, wl)
    yq = bbm_dot_scaled(aq.contiguous(), bq.contiguous(), wl=wl, vbl=vbl,
                        kind=kind)
    return (yq * (s_a * s_b)).to(a.dtype)


# ----------------------------------------------------------- kernel B2
def bbm_dot_scaled_plain(x, w, *, wl: int, vbl: int, kind: int):
    """Plain version of the kernel: decode ``w``'s digit planes and run
    the chunked dot form through the f32 route.  On the card only where
    the operating point has an f32 envelope (``f32_exact_chunk_len`` > 0);
    elsewhere it raises there, and runs on CPU tensors."""
    mag, neg = booth_precode(w, wl)
    return dot_scaled_chunked(x, mag, neg, wl=wl, vbl=vbl, kind=kind,
                              f32_dots=True)


def _check(x, w, wl: int, vbl: int, kind: int) -> None:
    for t in (x, w):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError("bbm_dot_scaled takes int32 code tensors, got "
                            f"{getattr(t, 'dtype', type(t))}")
        if not t.is_contiguous():
            raise ValueError("bbm_dot_scaled takes contiguous tensors")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"expected x (M, K) and w (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    if wl % 2 or not 2 <= wl <= 16:
        raise ValueError(f"unsupported wl={wl}: even, 2..16 bits")
    if not 0 <= vbl < wl:
        raise ValueError(f"vbl={vbl} outside [0, wl)")
    if kind not in (0, 1):
        raise ValueError(f"kind must be 0 or 1, got {kind}")
    if x.numel() >= 2 ** 31 or w.numel() >= 2 ** 31 \
            or x.shape[0] * w.shape[1] >= 2 ** 31:
        raise ValueError("bbm_dot_scaled dimensions exceed the kernel's "
                         "int32 indexing")


def bbm_dot_scaled(x, w, *, wl: int, vbl: int, kind: int) -> torch.Tensor:
    """``sum_k bbm(x[m,k], w[k,n])`` as f32 (M, N) at full product scale.

    x: (M, K) and w: (K, N) contiguous int32 wl-bit codes (either view:
    the low wl bits are read, signed) on one device; ``w`` is the Booth
    multiplier operand.  Bit-identical to ``bbm_matmul_scaled`` on
    ``w``'s digit planes.
    """
    _check(x, w, wl, vbl, kind)
    if not x.is_cuda:
        return bbm_dot_scaled_plain(x, w, wl=wl, vbl=vbl, kind=kind)
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    from ._build import library
    lib = library("bbm_dot")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bbm_dot_scaled_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n, wl, vbl,
            kind, num_corr_rows(wl, vbl), amm_chunk_len(wl, vbl), stream)
    if err != 0:
        raise RuntimeError(f"bbm_dot_scaled failed: CUDA error {err} "
                           f"({lib.bbm_dot_error_string(err).decode()})")
    bbm_dot_scaled.launches += 1
    return out


bbm_dot_scaled.launches = 0

