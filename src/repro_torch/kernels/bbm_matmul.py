"""The bit-exact Broken-Booth matmul: the rows form, the folded dot form,
and the model-scale chunked datapath with keyed fault injection.

Counterpart of ``repro.kernels.bbm_matmul``.  Every Broken-Booth product
is ``2^vbl * M`` with

    M(x, w) = x*bq + sum_{r<R} ((d_r*x - kind*neg_r) >> m_r),  m_r = vbl-2r

(``booth_rows``: ``bq = booth_high_value``, ``R = num_corr_rows``), so
``sum_k bbm(x, w)`` is ``2^vbl`` times an integer that int32 holds
exactly over a K-chunk of ``amm_chunk_len``.  Entry points:

  ``bbm_matmul`` / ``bbm_matmul_precoded``  ``out = sum_k (bbm(x, w) >>
      shift)`` in int32 on raw weight codes or precoded digit planes;
      ``form`` "rows", "dot" or None (auto: the dot form, but the rows
      form when ``shift > vbl`` and ``M*K*N > _DOT_CORR_BUDGET``, the
      reference's rule, whatever the device).
  ``bbm_matmul_scaled``  ``sum_k bbm(x, w)`` as f32 at full product scale,
      K chunked by ``amm_chunk_len``, int32 chunk partials added in f32 in
      chunk order (the amm datapath); ``fault=`` injects a
      ``core.faults.FaultSpec``: plane faults on the caller's unpadded
      planes before the chunk split, accumulator faults per chunk.
  ``bbm_matmul_dynamic``  both operands quantized per call
      (``amm_quantize``), then the datapath (attention's products).

Four hand-written CUDA kernels compute them on the card, each with its
plain PyTorch version beside it:

  ``bbm_matmul_rows`` (``csrc/bbm_matmul.cu``) replaces the Pallas kernel
      ``repro/kernels/bbm_matmul.py::bbm_matmul_kernel``: each product
      walks its wl/2 Booth rows from the planes, >> shift, int32 sums.
  ``bbm_matmul_dot`` (same file) replaces the XLA twin ``_matmul_dotform``:
      per product ``M``, with the reference's shift rules.
  ``bbm_dot_scaled`` (``csrc/bbm_dot.cu``) replaces the XLA lowering
      ``_dot_scaled`` behind the bitexact MLP products: codes in, digits
      decoded in the kernel, the reference's chunking.
  ``bbm_dot_planes`` (same file): the planes-in entry of that kernel,
      behind ``bbm_matmul_scaled`` and a faulted ``bbm_matmul_dynamic``,
      with the keyed accumulator upsets drawn in the kernel (threefry on
      each output's flat index, a host-computed key per chunk: no mask
      tensor, which at exact Booth's chunk of 1 would be K*M*N).

Both kernel families read digit planes as well as codes, so faulted
planes (not the decode of any code) go through them unchanged.  The plain
versions are the reference's schedules in PyTorch (the dot form's
one-hot contractions ``_dot_scaled``, the rows form in row blocks, so
that neither materializes more than ``_ROW_BLOCK`` int32 products at
once).  A wrapper runs the plain version only for tensors on the CPU; on
CUDA tensors it launches its kernel or raises, and counts its launches
in ``<wrapper>.launches``.

torch's CUDA matmul has no int32 route (``torch._int_mm`` takes int8):
on the card the plain versions take the reference's own exact-f32 route
(``f32_exact_chunk_len``, TF32 pinned off) where the operating point has
one; the s32 route (``_dot_i32`` with ``f32_chunk=0``) raises for
operands off the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.booth import num_pp_rows
from ..core.faults import (FaultSpec, acc_fault_keys, apply_acc_fault,
                           apply_plane_faults)
from ..device import pin_fp32
from .booth_rows import (amm_chunk_len, bbm_rows_product_precoded,
                         booth_high_value, booth_precode,
                         f32_exact_chunk_len, num_corr_rows, resolve_form,
                         scaled_trunc_rows, signed_digit, split_signed)
from .ref import amm_quantize

__all__ = ["bbm_dot_planes", "bbm_dot_planes_plain", "bbm_dot_scaled",
           "bbm_dot_scaled_plain", "bbm_matmul", "bbm_matmul_dot",
           "bbm_matmul_dot_plain", "bbm_matmul_dynamic",
           "bbm_matmul_precoded", "bbm_matmul_rows", "bbm_matmul_rows_plain",
           "bbm_matmul_scaled", "dot_scaled_chunked", "matmul_form"]

# auto-form only: above this many (M, K, N) products the shift > vbl
# branch of the dot form (a per-product floor, an (M, K, N) temporary in
# the reference) gives way to the rows form; an explicit form="dot" is
# honored regardless
_DOT_CORR_BUDGET = 1 << 26

# plain versions only: the most (rows, K, N) int32 products one block of
# the rows form or the shift > vbl dot form materializes
_ROW_BLOCK = 1 << 24

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


def _chunk_sums(x_s, wmag, wneg, *, wl: int, vbl: int, kind: int,
                f32_chunk: int, fault=None):
    """f32 sum of the int32 chunk partials (``_dot_scaled`` per K-chunk
    of ``amm_chunk_len``, each XORed with chunk ``ci``'s accumulator
    fault) in chunk order, times 2^vbl.  The reference pads K to whole
    chunks; padded zero codes contribute nothing to any contraction, so
    the ragged last chunk here gives the same partials."""
    kk = x_s.shape[-1]
    chunk = amm_chunk_len(wl, vbl)
    acc = None
    for ci, lo in enumerate(range(0, kk, chunk)):
        part = _dot_scaled(x_s[..., lo:lo + chunk],
                           wmag[..., lo:lo + chunk, :],
                           wneg[..., lo:lo + chunk, :], wl=wl, vbl=vbl,
                           kind=kind, f32_chunk=f32_chunk)
        part = apply_acc_fault(part, fault, ci).to(torch.float32)
        acc = part if acc is None else acc + part
    return acc * float(1 << vbl)


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
    _, x_s = split_signed(x, wl)
    f32_chunk = f32_exact_chunk_len(wl, vbl) if f32_dots else 0
    return _chunk_sums(x_s, wmag, wneg, wl=wl, vbl=vbl, kind=kind,
                       f32_chunk=f32_chunk)


def bbm_matmul_scaled(x, wmag, wneg, *, wl: int, vbl: int, kind: int = 0,
                      fault: FaultSpec | None = None):
    """``sum_k bbm(x[m,k], w[k,n])`` as f32 (M, N), any K: the amm
    datapath.  x: (M, K) int32 codes; wmag/wneg: (wl//2, K, N) planes.

    ``fault``: plane faults hit the caller's (wl//2, K, N) planes before
    the chunk split, so ``ref.amm_faulty_ref`` faults the same cells;
    accumulator faults XOR each chunk's int32 partial, folded by the chunk
    index.  ``None`` or a disabled spec changes nothing.  CUDA tensors
    launch the planes-in kernel ``bbm_dot_planes``; other tensors run the
    reference's s32 schedule (on the CPU only).
    """
    _check_planes(x, wmag, wneg, wl)
    wmag, wneg = apply_plane_faults(wmag, wneg, fault, vbl=vbl)
    if x.is_cuda:
        acc_fault = fault if fault is not None \
            and fault.target == "acc" else None
        return bbm_dot_planes(x.contiguous(), wmag.contiguous(),
                              wneg.contiguous(), wl=wl, vbl=vbl, kind=kind,
                              fault=acc_fault)
    _, x_s = split_signed(x, wl)
    return _chunk_sums(x_s, wmag, wneg, wl=wl, vbl=vbl, kind=kind,
                       f32_chunk=0, fault=fault)


def bbm_matmul_dynamic(a, b, *, wl: int, vbl: int, kind: int = 0,
                       fault: FaultSpec | None = None):
    """Both operands dynamic (the attention products): quantize ``a``
    (M, K) and ``b`` (K, N) per call with ``amm_quantize``, contract the
    codes on the datapath, descale.  Returns (M, N) in ``a.dtype``.

    Unfaulted (``None`` or a disabled spec), the codes go to
    ``bbm_dot_scaled`` (the kernel on the card); an enabled ``fault``
    decodes ``b``'s digit planes and runs ``bbm_matmul_scaled`` with it,
    as the reference does, bit-identical to ``ref.amm_faulty_ref``.
    """
    aq, s_a = amm_quantize(a, wl)
    bq, s_b = amm_quantize(b, wl)
    if fault is None or not fault.enabled:
        yq = bbm_dot_scaled(aq.contiguous(), bq.contiguous(), wl=wl,
                            vbl=vbl, kind=kind)
    else:
        mag, neg = booth_precode(bq, wl)
        yq = bbm_matmul_scaled(aq, mag, neg, wl=wl, vbl=vbl, kind=kind,
                               fault=fault)
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



# ------------------------------------------------ kernel B2, planes in
def _acc_fault(fault):
    """The accumulator fault a planes-in call applies: ``None`` for no
    spec or a disabled one; plane faults belong on the planes first."""
    if fault is None or not fault.enabled:
        return None
    if fault.target != "acc":
        raise ValueError("bbm_dot_planes applies accumulator faults only; "
                         "fault the planes first (apply_plane_faults)")
    return fault


def bbm_dot_planes_plain(x, wmag, wneg, *, wl: int, vbl: int, kind: int,
                         fault: FaultSpec | None = None):
    """Plain version of the planes-in kernel: the chunked dot form through
    the f32 route (s32 where the operating point has no f32 envelope: on
    the CPU only), each chunk's partial XORed with its accumulator fault.
    """
    _, x_s = split_signed(x, wl)
    return _chunk_sums(x_s, wmag, wneg, wl=wl, vbl=vbl, kind=kind,
                       f32_chunk=f32_exact_chunk_len(wl, vbl),
                       fault=_acc_fault(fault))


def bbm_dot_planes(x, wmag, wneg, *, wl: int, vbl: int, kind: int,
                   fault: FaultSpec | None = None) -> torch.Tensor:
    """``sum_k bbm(x[m,k], w[k,n])`` as f32 (M, N) on ``w``'s digit
    planes, with ``fault``'s accumulator upsets (an "acc" spec, or None).

    x: (M, K) contiguous int32 codes; wmag/wneg: (wl//2, K, N) contiguous
    int32 planes in the decode domain (faulted ones too), on one device.
    Bit-identical to ``bbm_matmul_scaled`` on the same planes.
    """
    _check_operands("bbm_dot_planes", x, wmag, wneg, wl=wl, vbl=vbl,
                    kind=kind, shift=None)
    if vbl >= wl:
        raise ValueError(f"vbl={vbl} outside [0, wl)")
    acc_fault = _acc_fault(fault)
    if not x.is_cuda:
        return bbm_dot_planes_plain(x, wmag, wneg, wl=wl, vbl=vbl,
                                    kind=kind, fault=acc_fault)
    m, k = x.shape
    n = wmag.shape[2]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    chunk = amm_chunk_len(wl, vbl)
    keys = None if acc_fault is None else torch.from_numpy(acc_fault_keys(
        acc_fault, -(-k // chunk)).view(np.int32)).to(x.device)
    p = 0.0 if acc_fault is None else float(np.float32(acc_fault.p))
    bit = 0 if acc_fault is None else acc_fault.bit
    from ._build import library
    lib = library("bbm_dot")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bbm_dot_planes_launch(
            x.data_ptr(), wmag.data_ptr(), wneg.data_ptr(),
            None if keys is None else keys.data_ptr(), p, bit,
            out.data_ptr(), m, k, n, wl, vbl, kind, num_corr_rows(wl, vbl),
            chunk, stream)
    if err != 0:
        raise RuntimeError(f"bbm_dot_planes failed: CUDA error {err} "
                           f"({lib.bbm_dot_error_string(err).decode()})")
    bbm_dot_planes.launches += 1
    return out


bbm_dot_planes.launches = 0


# --------------------------------------------- kernel B1 and its twin
def _matmul_envelope(k: int, wl: int, shift: int) -> None:
    """The result's int32 envelope, ``K * max|product >> shift| < 2^31``.
    The dot form accumulates at scale ``2^-max(vbl, shift)`` and is never
    looser (``booth_rows.dotform_scaled_bound``): one check gates both."""
    if k * (2 ** max(2 * wl - 1 - shift, 0)) >= 2 ** 31:
        raise ValueError(
            f"accumulation may overflow int32: K={k}, wl={wl}, shift={shift};"
            " raise `shift` (fixed-point rescale) or reduce K")


def _check_operands(name: str, x, wmag, wneg, *, wl: int, vbl: int,
                    kind: int, shift) -> None:
    """Refuse what the planes-in kernels do not take (``shift=None``: the
    f32 entry, which has no shift and no int32 envelope)."""
    for t in (x, wmag, wneg):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError(f"{name} takes int32 tensors, got "
                            f"{getattr(t, 'dtype', type(t))}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
        if t.device != x.device:
            raise ValueError(f"operands on {t.device} and {x.device}")
    if x.dim() != 2 or wmag.dim() != 3 or wmag.shape != wneg.shape:
        raise ValueError(f"expected x (M, K) and planes (wl//2, K, N), got "
                         f"{tuple(x.shape)}, {tuple(wmag.shape)}, "
                         f"{tuple(wneg.shape)}")
    if wl % 2 or not 2 <= wl <= 16:
        raise ValueError(f"unsupported wl={wl}: even, 2..16 bits")
    if wmag.shape[0] != num_pp_rows(wl) or wmag.shape[1] != x.shape[1]:
        raise ValueError(f"digit planes {tuple(wmag.shape)} do not match "
                         f"wl={wl}, K={x.shape[1]}")
    if not 0 <= vbl <= min(2 * wl, 31):
        raise ValueError(f"unsupported vbl={vbl}")
    if kind not in (0, 1):
        raise ValueError(f"kind must be 0 or 1, got {kind}")
    if shift is not None:
        if not 0 <= shift <= 31:
            raise ValueError(f"unsupported shift={shift}")
        _matmul_envelope(x.shape[1], wl, shift)
    m, n = x.shape[0], wmag.shape[2]
    if x.numel() >= 2 ** 31 or wmag.numel() >= 2 ** 31 or m * n >= 2 ** 31 \
            or -(-m // 64) > 65535:
        raise ValueError(f"{name} dimensions exceed the kernel's int32 "
                         f"indexing or grid")


def _row_step(k: int, n: int) -> int:
    return max(1, _ROW_BLOCK // max(1, k * n))


def bbm_matmul_rows_plain(x, wmag, wneg, *, wl: int, vbl: int, kind: int,
                          shift: int) -> torch.Tensor:
    """Plain version of the rows kernel: ``bbm_rows_product_precoded``
    (multiply-free, as the kernel) over blocks of rows of ``x``, >> shift,
    int32 sums over K."""
    _, x_s = split_signed(x, wl)
    m, k = x.shape
    n = wmag.shape[2]
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    step = _row_step(k, n)
    for lo in range(0, m, step):
        prod = bbm_rows_product_precoded(
            x_s[lo:lo + step, :, None], wmag[:, None], wneg[:, None], wl=wl,
            vbl=vbl, kind=kind, multiply_free=True)
        if shift:
            prod = prod >> shift
        out[lo:lo + step] = torch.sum(prod, dim=1, dtype=torch.int32)
    return out


def bbm_matmul_rows(x, wmag, wneg, *, wl: int, vbl: int, kind: int = 0,
                    shift: int = 0) -> torch.Tensor:
    """Rows-form Broken-Booth matmul: x (M, K) int32 codes, planes
    (wl//2, K, N), all contiguous int32 on one device.

    CUDA tensors launch the ``bbm_matmul_rows`` kernel; CPU tensors run
    ``bbm_matmul_rows_plain``.  Returns (M, N) int32 sums of shifted
    products.
    """
    _check_operands("bbm_matmul_rows", x, wmag, wneg, wl=wl, vbl=vbl,
                    kind=kind, shift=shift)
    if not x.is_cuda:
        return bbm_matmul_rows_plain(x, wmag, wneg, wl=wl, vbl=vbl,
                                     kind=kind, shift=shift)
    return _launch_matmul(bbm_matmul_rows, x, wmag, wneg, wl=wl, vbl=vbl,
                          kind=kind, shift=shift)


bbm_matmul_rows.launches = 0


def _matmul_dotform(x, wmag, wneg, *, wl: int, vbl: int, kind: int,
                    shift: int, f32_chunk: int = 0):
    """Dot-form matmul, bit-identical to the rows form: the contracted
    ``_dot_scaled`` when ``shift <= vbl``; for ``shift > vbl`` the
    per-product floor ``M >> (shift - vbl)`` before the K sum, in blocks
    of rows; ``<< (vbl - shift)`` when ``vbl > shift``.  ``f32_chunk``:
    the exact-f32 route of ``_dot_i32``."""
    _, x_s = split_signed(x, wl)
    u = max(shift - vbl, 0)       # per-product residual rescale
    if u == 0:
        acc = _dot_scaled(x_s, wmag, wneg, wl=wl, vbl=vbl, kind=kind,
                          f32_chunk=f32_chunk)
    else:
        m, k = x.shape
        n = wmag.shape[2]
        wq = booth_high_value(wmag, wneg, wl=wl, vbl=vbl)    # (K, N)
        acc = torch.empty((m, n), dtype=torch.int32, device=x.device)
        step = _row_step(k, n)
        for lo in range(0, m, step):
            xb = x_s[lo:lo + step, :, None]
            q = scaled_trunc_rows(xb, wmag[:, None], wneg[:, None], wl=wl,
                                  vbl=vbl, kind=kind)
            m_prod = xb * wq[None]
            if q is not None:
                m_prod = m_prod + q
            acc[lo:lo + step] = torch.sum(m_prod >> u, dim=1,
                                          dtype=torch.int32)
    if vbl > shift:
        acc = acc << (vbl - shift)
    return acc


def bbm_matmul_dot_plain(x, wmag, wneg, *, wl: int, vbl: int, kind: int,
                         shift: int) -> torch.Tensor:
    """Plain version of the dot kernel: ``_matmul_dotform`` on the exact
    f32 route where the operating point has one (any device), else s32
    (the CPU only)."""
    return _matmul_dotform(x, wmag, wneg, wl=wl, vbl=vbl, kind=kind,
                           shift=shift,
                           f32_chunk=f32_exact_chunk_len(wl, vbl))


def bbm_matmul_dot(x, wmag, wneg, *, wl: int, vbl: int, kind: int = 0,
                   shift: int = 0) -> torch.Tensor:
    """Dot-form Broken-Booth matmul, same contract as ``bbm_matmul_rows``.

    CUDA tensors launch the ``bbm_matmul_dot`` kernel; CPU tensors run
    ``bbm_matmul_dot_plain``.
    """
    _check_operands("bbm_matmul_dot", x, wmag, wneg, wl=wl, vbl=vbl,
                    kind=kind, shift=shift)
    if not x.is_cuda:
        return bbm_matmul_dot_plain(x, wmag, wneg, wl=wl, vbl=vbl,
                                    kind=kind, shift=shift)
    return _launch_matmul(bbm_matmul_dot, x, wmag, wneg, wl=wl, vbl=vbl,
                          kind=kind, shift=shift,
                          extra=(num_corr_rows(wl, vbl),))


bbm_matmul_dot.launches = 0


def _launch_matmul(wrapper, x, wmag, wneg, *, wl: int, vbl: int,
                   kind: int, shift: int, extra=()) -> torch.Tensor:
    """Launch ``wrapper``'s kernel (``<name>_launch`` in the library) and
    count it in ``wrapper.launches``; an empty output or K = 0 launches
    nothing and counts nothing."""
    fn_name = wrapper.__name__ + "_launch"
    m, k = x.shape
    n = wmag.shape[2]
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    from ._build import library
    lib = library("bbm_matmul")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, fn_name)(
            x.data_ptr(), wmag.data_ptr(), wneg.data_ptr(), out.data_ptr(),
            m, k, n, wl, vbl, kind, shift, *extra, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err} "
                           f"({lib.bbm_matmul_error_string(err).decode()})")
    wrapper.launches += 1
    return out


# ---------------------------------------------------------- entry points
def matmul_form(form, m: int, k: int, n: int, *, shift: int,
                vbl: int) -> str:
    """The accumulate form a ``bbm_matmul_precoded`` call runs: ``form``,
    or for None the dot form, except the rows form when ``shift > vbl``
    and ``m*k*n > _DOT_CORR_BUDGET`` (the reference's rule, on every
    device)."""
    if form is None and shift > vbl and m * k * n > _DOT_CORR_BUDGET:
        return "rows"
    return resolve_form(form)


def bbm_matmul_precoded(x, wmag, wneg, *, wl: int, vbl: int, kind: int = 0,
                        shift: int = 0, form: str | None = None):
    """Approximate matmul on precoded weight-digit planes.

    x: (M, K) int32 codes; wmag, wneg: (wl//2, K, N) planes from
    ``booth_precode`` of the (K, N) weight codes (faulted planes too).
    form: "rows", "dot" or None (``matmul_form``); bit-identical either
    way.  Runs on the tensors' device.  Returns (M, N) int32.
    """
    mm, kk = x.shape
    n_rows, kk2, nn = wmag.shape
    if wmag.shape != wneg.shape:
        raise ValueError(f"mag/neg plane shapes differ: "
                         f"{tuple(wmag.shape)} vs {tuple(wneg.shape)}")
    if n_rows != num_pp_rows(wl) or kk != kk2:
        raise ValueError(f"digit planes {tuple(wmag.shape)} do not match "
                         f"wl={wl}, K={kk}")
    kernel = bbm_matmul_dot if matmul_form(
        form, mm, kk, nn, shift=shift, vbl=vbl) == "dot" else bbm_matmul_rows
    return kernel(x.contiguous(), wmag.contiguous(), wneg.contiguous(),
                  wl=wl, vbl=vbl, kind=kind, shift=shift)


def bbm_matmul(x, w, *, wl: int, vbl: int, kind: int = 0, shift: int = 0,
               form: str | None = None):
    """Bit-exact approximate matmul, x: (M, K) and w: (K, N) int32 codes:
    precodes ``w`` once and dispatches to ``bbm_matmul_precoded``."""
    wmag, wneg = booth_precode(w, wl)
    return bbm_matmul_precoded(x, wmag, wneg, wl=wl, vbl=vbl, kind=kind,
                               shift=shift, form=form)
