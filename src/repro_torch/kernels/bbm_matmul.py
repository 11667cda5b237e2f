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

``bbm_dot_coded_batched`` (same file) is B2's batched codes-in entry
(decode attention on the int-code KV cache, ``amm_dot``): two routes,
chosen by ``bbm_coded_route`` from (wl, vbl, kind, per, block) alone,
the int8 tensor cores (``csrc/bbm_coded_mma.cuh``, ``mma.sync`` steps 16
deep, ``bbm_dot_coded_mma_emulated``) or the CUDA-core
``bbm_coded_kernel``.

``bbm_dot_scaled``, ``bbm_dot_planes`` and ``bbm_matmul_dot`` each have
two routes on the card, chosen by ``bbm_dot_route`` from (wl, vbl, kind,
shift) alone: the int8 tensor-core route (``csrc/bbm_mma.cuh``) where
every K-chunk holds at least one ``MMA_K_STEP`` of products, the operand
bytes need at most two significances and (for ``bbm_matmul_dot``) shift
<= vbl; the CUDA-core tile (``csrc/bbm_tile.cuh``) elsewhere.  The
tensor-core route contracts the floor form of each truncated row,

    sum_{r<R} floor((d_r x - kind neg_r) / 2^m_r)
      = sum_{r<R} (x >> m_r) d_r + b_r(x) B2_r
        - (kind 0) nz1_r(x) [d_r = -1] - nz2_r(x) [d_r = -2]
        - (kind 1) neg_r

(``b_r`` bit m_r - 1 of x; ``nz1_r``, ``nz2_r``: x mod 2^m_r, x mod
2^(m_r - 1) nonzero; ``B2_r = [d_r = 2] - [d_r = -2]``), so every term
is a product of an x-side byte and a weight-side byte at one scale: no
shift, and the chunk partial is the integer ``lo + 256 hi`` of two int32
sums (``bbm_mma_operands``, ``bbm_dot_mma_emulated``).

Both kernel families read digit planes as well as codes, so faulted
planes (not the decode of any code) go through them unchanged.  The plain
versions are the reference's schedules in PyTorch (the dot form's
one-hot contractions ``_dot_scaled``, the rows form in row blocks, so
that neither materializes more than ``_ROW_BLOCK`` int32 products at
once).  A wrapper runs the plain version only for tensors on the CPU; on
CUDA tensors it launches its kernel or raises, and counts its launches
in ``<wrapper>.launches`` (the tensor-core route's share also in
``<wrapper>.mma_launches``).

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

__all__ = ["CODED_K_STEP", "MMA_K_STEP", "bbm_coded_route",
           "bbm_dot_coded_batched", "bbm_dot_coded_batched_plain",
           "bbm_dot_coded_mma_emulated", "bbm_dot_mma_emulated",
           "bbm_dot_planes", "bbm_dot_planes_plain", "bbm_dot_route",
           "bbm_dot_scaled", "bbm_dot_scaled_plain", "bbm_matmul",
           "bbm_matmul_coded", "bbm_matmul_coded_kblocks", "bbm_matmul_dot",
           "bbm_matmul_dot_plain", "bbm_matmul_dynamic",
           "bbm_matmul_precoded", "bbm_matmul_rows", "bbm_matmul_rows_plain",
           "bbm_matmul_scaled", "bbm_mma_operands", "dot_scaled_chunked",
           "matmul_form", "mma_widths"]

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


def _coded_one(a, b_codes, s_b, *, wl, vbl, kind, block, per):
    """One slice through the batched entry: ``a`` (M, K) float quantized
    per call, ``s_b`` (J,) f32."""
    aq, s_a = amm_quantize(a, wl)
    s_b = torch.as_tensor(s_b, dtype=torch.float32, device=aq.device)
    out = bbm_dot_coded_batched(
        aq.contiguous()[None, None], s_a.reshape(1, 1), b_codes[None, None],
        s_b[None, None], wl=wl, vbl=vbl, kind=kind, block=block, per=per)
    return out[0, 0].to(a.dtype)


def bbm_matmul_coded(a, b_codes, s_b, *, wl: int, vbl: int, kind: int = 0):
    """Codes-in sibling of ``bbm_matmul_dynamic``: ``a`` (M, K) float is
    quantized per call, ``b_codes`` (K, N) arrive as wl-bit codes with a
    scalar or per-column (N,) scale ``s_b``; ``yq * (s_a * s_b)`` in
    ``a.dtype``.  With ``s_b`` the scale ``amm_quantize`` derives for the
    float ``b``, bit-equal to ``bbm_matmul_dynamic(a, b)``.  One slice of
    ``bbm_dot_coded_batched`` (``per="column"``)."""
    s_b = torch.as_tensor(s_b, dtype=torch.float32, device=a.device)
    return _coded_one(a, b_codes, s_b.expand(b_codes.shape[1]), wl=wl,
                      vbl=vbl, kind=kind, block=1, per="column")


def bbm_matmul_coded_kblocks(a, b_codes, s_b, *, wl: int, vbl: int,
                             kind: int = 0, block: int):
    """``bbm_matmul_coded`` with one ``b`` scale per K-block of ``block``
    rows (the value product against the V cache): each block contracts
    alone and is descaled by ``s_a * s_b[j]``, the blocks added in f32 in
    block order, the first as is; ``a``'s scale is that of the whole
    (M, K) slice.  s_b: (K // block,) f32.  One slice of
    ``bbm_dot_coded_batched`` (``per="kblock"``)."""
    return _coded_one(a, b_codes, s_b, wl=wl, vbl=vbl, kind=kind,
                      block=block, per="kblock")


# ------------------------------------------------ the tensor-core route
# products one k32 int8 tensor-core step (wgmma m64n128k32) contracts per
# (m, n): the route's K step, the shortest K-chunk it takes
MMA_K_STEP = 32

# triplet (u_{2r+1}, u_{2r}, u_{2r-1}) of a radix-4 row -> byte of each
# weight-side plane: the signed digit, B2 = [d = 2] - [d = -2], and the
# kind-0 indicators -[d = -1], -[d = -2]; a row's sign bit is triplet
# bit 2.  Planes map (mag, neg) to one triplet of the same digit and sign.
_TRIPLET_D = (0, 1, 1, 2, -2, -1, -1, 0)
_TRIPLET_B2 = (0, 0, 0, 1, -1, 0, 0, 0)
_TRIPLET_NI1 = (0, 0, 0, 0, 0, -1, -1, 0)
_TRIPLET_NI2 = (0, 0, 0, 0, -1, 0, 0, 0)
_PLANE_TRIPLET = (0, 1, 3, 3, 7, 5, 4, 4)      # index mag | neg << 2


def _byte_count(lo: int, hi: int) -> int:
    """Bytes of a signed integer in [lo, hi]: one s8, or a u8 low byte
    under an s8 high byte."""
    return 1 if -128 <= lo and hi <= 127 else 2


def mma_widths(wl: int, vbl: int) -> tuple:
    """(x bytes, bq bytes, bytes of x >> m_r for each truncated row) of
    the tensor-core route's operands at (wl, vbl); bq's bytes hold any
    digits in [-2, 2] (faulted planes too)."""
    rows = num_corr_rows(wl, vbl)
    bq = sum(2 << (2 * r - vbl) for r in range(rows, num_pp_rows(wl)))
    signed = lambda bits: _byte_count(-2 ** bits, 2 ** bits - 1)  # noqa
    return (signed(wl - 1), _byte_count(-bq, bq),
            tuple(signed(wl - 1 - (vbl - 2 * r)) for r in range(rows)))


def bbm_dot_route(wl: int, vbl: int, kind: int, shift=None) -> str:
    """The route of a B2 call (``shift=None``) or of ``bbm_matmul_dot`` at
    ``shift``: "mma" (the int8 tensor cores) where ``amm_chunk_len(wl,
    vbl) >= MMA_K_STEP``, the x and bq bytes need at most two
    significances (an int32 pair ``lo + 256 hi``) and shift <= vbl; else
    "tile" (the CUDA-core tile: chunks of a few products, exact Booth's
    chunk of 1, the per-product floor of shift > vbl).  A pure function
    of its arguments; ``kind`` selects no route."""
    if kind not in (0, 1):
        raise ValueError(f"kind must be 0 or 1, got {kind}")
    if _mma_refusal(wl, vbl, shift) is None \
            and amm_chunk_len(wl, vbl) >= MMA_K_STEP:
        return "mma"
    return "tile"


def _mma_refusal(wl: int, vbl: int, shift):
    """Why the tensor-core route cannot compute the call, or None."""
    if shift is not None and shift > vbl:
        return (f"shift={shift} > vbl={vbl} floors each product before "
                f"the K sum: no contraction form")
    xb, bqb, _ = mma_widths(wl, vbl)
    if xb + bqb > 3:
        return (f"x and bq both take two bytes at wl={wl} vbl={vbl}: their "
                f"product needs a third significance")
    return None


def _pick_route(name: str, route, wl: int, vbl: int, kind: int,
                shift=None) -> str:
    """``route`` (forced by a test's hook, checked) or the rule's."""
    if route is None:
        return bbm_dot_route(wl, vbl, kind, shift)
    if route not in ("mma", "tile"):
        raise ValueError(f"{name}: unknown route {route!r} (expected "
                         f"'mma', 'tile' or None)")
    why = _mma_refusal(wl, vbl, shift) if route == "mma" else None
    if why is not None:
        raise ValueError(f"{name}: route 'mma' cannot compute this call: "
                         f"{why}")
    return route


def _triplets(w=None, wmag=None, wneg=None, *, wl: int):
    """(wl//2, K, N) int64 row triplets of codes ``w`` or of planes."""
    if w is not None:
        u = (w.to(torch.int64) & ((1 << wl) - 1)) << 1
        return torch.stack([(u >> (2 * r)) & 7
                            for r in range(num_pp_rows(wl))])
    table = torch.tensor(_PLANE_TRIPLET, dtype=torch.int64,
                         device=wmag.device)
    return table[(wmag.to(torch.int64) & 3) | ((wneg.to(torch.int64) & 1)
                                               << 2)]


def _split(v, nbytes: int):
    """[(byte, significance)] of int64 ``v``: one s8, or u8 low + s8
    high."""
    return [(v, 0)] if nbytes == 1 else [(v & 255, 0), (v >> 8, 1)]


def bbm_mma_operands(x, *, w=None, wmag=None, wneg=None, wl: int,
                     vbl: int, kind: int):
    """The tensor-core route's byte operands: a list of (A (M, K), B (K,
    N), significance) int64 tensors, each A and B a byte (u8 or s8 range)
    as the kernel forms it, with ``sum_k M(x, w)`` over any K range equal
    to ``sum (A @ B) * 256^significance`` over the list.  ``w`` codes or
    (``wmag``, ``wneg``) planes (wl//2, K, N)."""
    xb, bqb, fbytes = mma_widths(wl, vbl)
    _, xs = split_signed(x, wl)
    xs = xs.to(torch.int64)
    t = _triplets(w, wmag, wneg, wl=wl)
    look = lambda tab: torch.tensor(tab, dtype=torch.int64,  # noqa: E731
                                    device=t.device)[t]
    d, b2 = look(_TRIPLET_D), look(_TRIPLET_B2)
    rows = num_corr_rows(wl, vbl)
    bq = sum((d[r] << (2 * r - vbl) for r in range(rows, num_pp_rows(wl))),
             torch.zeros_like(d[0]))
    out = [(a, b, sa + sb) for a, sa in _split(xs, xb)
           for b, sb in _split(bq, bqb)]
    for r in range(rows):
        m = vbl - 2 * r
        out += [(a, d[r], sa) for a, sa in _split(xs >> m, fbytes[r])]
        out.append(((xs >> (m - 1)) & 1, b2[r], 0))
        if kind == 0:
            out.append((((xs & ((1 << m) - 1)) != 0).to(torch.int64),
                        look(_TRIPLET_NI1)[r], 0))
            out.append((((xs & ((1 << (m - 1)) - 1)) != 0).to(torch.int64),
                        look(_TRIPLET_NI2)[r], 0))
    if kind == 1 and rows:
        neg = sum(t[r] >> 2 for r in range(rows))
        out.append((torch.ones_like(xs), -neg, 0))
    return out


def _wrap_i32(v):
    """int64 -> int32 modulo 2^32 (the kernel's int32 sums wrap)."""
    return (((v + 2 ** 31) % 2 ** 32) - 2 ** 31).to(torch.int32)


def bbm_dot_mma_emulated(x, *, w=None, wmag=None, wneg=None, wl: int,
                         vbl: int, kind: int, shift=None, fault=None):
    """The tensor-core route's arithmetic in plain PyTorch (CPU): per
    K-chunk, the two int32 sums ``lo`` and ``hi`` of
    ``bbm_mma_operands``' byte products (exact in int64 here, modulo 2^32
    in the kernel), the partial ``lo + 256 hi`` modulo 2^32, then the
    kernel's epilogue.  ``shift=None``: the chunked f32 datapath of
    ``bbm_dot_scaled`` / ``bbm_dot_planes`` (``fault``: an accumulator
    spec, each chunk's partial XORed before its f32 add, the adds in
    chunk order, scaled by 2^vbl each: exact); an int ``shift`` <= vbl:
    ``bbm_matmul_dot``'s one int32 sum over K, ``<< (vbl - shift)``."""
    why = _mma_refusal(wl, vbl, shift)
    if why is not None:
        raise ValueError(why)
    ops = bbm_mma_operands(x, w=w, wmag=wmag, wneg=wneg, wl=wl, vbl=vbl,
                           kind=kind)
    k = x.shape[1]
    if k == 0:
        n = (w if w is not None else wmag).shape[-1]
        return torch.zeros((x.shape[0], n), dtype=torch.float32
                           if shift is None else torch.int32)
    chunk = amm_chunk_len(wl, vbl) if shift is None else k
    out = None
    for ci, lo in enumerate(range(0, k, chunk)):
        part = [torch.zeros((x.shape[0], ops[0][1].shape[1]),
                            dtype=torch.int64) for _ in range(2)]
        for a, b, sig in ops:
            part[sig] += a[:, lo:lo + chunk] @ b[lo:lo + chunk]
        p = _wrap_i32(_wrap_i32(part[0]).to(torch.int64)
                      + 256 * _wrap_i32(part[1]).to(torch.int64))
        if shift is not None:
            return _wrap_i32(p.to(torch.int64) << (vbl - shift))
        p = apply_acc_fault(p, _acc_fault(fault), ci).to(torch.float32)
        p = p * float(1 << vbl)
        out = p if out is None else out + p
    return out


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
    ``w``'s digit planes.  On the card the launch takes
    ``bbm_dot_route``'s route.
    """
    return _bbm_dot_scaled_on(None, x, w, wl=wl, vbl=vbl, kind=kind)


def _bbm_dot_scaled_on(route, x, w, *, wl: int, vbl: int,
                       kind: int) -> torch.Tensor:
    """``bbm_dot_scaled`` on ``route`` ("mma" or "tile", checked: one
    that cannot compute the call raises; None: the rule's), the hook
    through which the tests and ``chip_smoke.py`` force a route."""
    _check(x, w, wl, vbl, kind)
    route = _pick_route("bbm_dot_scaled", route, wl, vbl, kind)
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
        if route == "mma":
            err = lib.bbm_dot_scaled_mma_launch(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n, wl,
                vbl, kind, amm_chunk_len(wl, vbl), stream)
        else:
            err = lib.bbm_dot_scaled_launch(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n, wl,
                vbl, kind, num_corr_rows(wl, vbl), amm_chunk_len(wl, vbl),
                stream)
    if err != 0:
        raise RuntimeError(f"bbm_dot_scaled failed: CUDA error {err} "
                           f"({lib.bbm_dot_error_string(err).decode()})")
    bbm_dot_scaled.launches += 1
    bbm_dot_scaled.mma_launches += route == "mma"
    return out


bbm_dot_scaled.launches = 0
bbm_dot_scaled.mma_launches = 0      # the tensor-core route's share



# ------------------------------------------- kernel B2, batched codes in
CODED_PER = ("column", "kblock")


def _coded_args(a, s_a, b, s_b, block, per, live) -> None:
    """The batched entry's operand checks (any device)."""
    if a.dtype != torch.int32 or a.dim() != 4 or not a.is_contiguous():
        raise ValueError(f"a: (B1, B2, M, K) contiguous int32 codes, got "
                         f"{a.dtype} {tuple(a.shape)}")
    b1, b2, m, k = a.shape
    if k == 0:
        raise ValueError("bbm_dot_coded_batched: empty contraction (K = 0)")
    if b.dim() != 4 or tuple(b.shape[:3]) != (b1, b2, k) \
            or b.dtype not in (torch.int8, torch.int16, torch.int32):
        raise ValueError(f"b: (B1, B2, K, N) int8/int16/int32 codes "
                         f"matching a {tuple(a.shape)}, got {b.dtype} "
                         f"{tuple(b.shape)}")
    n = b.shape[3]
    for t in (b, s_a, s_b, live):
        if t is not None and t.device != a.device:
            raise ValueError(f"operands on {a.device} and {t.device}")
    if per not in CODED_PER:
        raise ValueError(f"per must be one of {CODED_PER}, got {per!r}")
    if s_a is None or s_a.dtype != torch.float32 \
            or tuple(s_a.shape) != (b1, b2):
        raise ValueError(f"s_a: (B1, B2) f32, got "
                         f"{None if s_a is None else tuple(s_a.shape)}")
    if not isinstance(block, int) or block < 1:
        raise ValueError(f"block must be a positive int, got {block!r}")
    axis = n if per == "column" else k
    if per == "kblock" and k % block:
        raise ValueError(f"K={k} not a multiple of block={block}")
    if s_b is None or s_b.dtype != torch.float32 or s_b.dim() != 3 \
            or tuple(s_b.shape[:2]) != (b1, b2) \
            or s_b.shape[2] != -(-axis // block):
        raise ValueError(f"s_b: (B1, B2, {-(-axis // block)}) f32 for "
                         f"per={per!r}, block={block}, got "
                         f"{None if s_b is None else tuple(s_b.shape)}")
    if live is not None and (live.dim() != 1 or live.shape[0] != b1):
        raise ValueError(f"live: (B1,) positions, got {tuple(live.shape)}")


def _live_codes(b, per: str, live):
    """``b`` (B1, B2, K, N) as int32 codes, those at or past ``live`` along
    the blocked axis (N for ``per="column"``, K for "kblock") zeroed."""
    bc = b.to(torch.int32)
    if live is None:
        return bc
    k, n = b.shape[2:]
    at = torch.arange(n if per == "column" else k, device=b.device)
    keep = at[None, :] < live.to(torch.int64)[:, None]
    keep = keep[:, None, None, :] if per == "column" \
        else keep[:, None, :, None]
    return torch.where(keep, bc, 0)


# products one int8 mma.sync.m16n8k16 step contracts per output: the
# batched entry's tensor-core K step, the shortest chunk and K-block it
# takes
CODED_K_STEP = 16


def bbm_coded_route(wl: int, vbl: int, kind: int, per: str,
                    block: int) -> str:
    """The route of a ``bbm_dot_coded_batched`` call: "mma" (the int8
    tensor cores, ``csrc/bbm_coded_mma.cuh``) where the operand bytes need
    at most two significances (``_mma_refusal``), every K-chunk of
    ``amm_chunk_len(wl, vbl)`` products holds a ``CODED_K_STEP`` step and,
    for ``per="kblock"``, so does every K-block of ``block`` rows; else
    "tile" (the CUDA-core ``bbm_coded_kernel``: chunks of a few products,
    as WL 16 / VBL 3's 7, short K-blocks, three-significance points).  A
    pure function of its arguments; ``kind`` selects no route."""
    if kind not in (0, 1):
        raise ValueError(f"kind must be 0 or 1, got {kind}")
    if per not in CODED_PER:
        raise ValueError(f"per must be one of {CODED_PER}, got {per!r}")
    if _mma_refusal(wl, vbl, None) is None \
            and amm_chunk_len(wl, vbl) >= CODED_K_STEP \
            and (per == "column" or block >= CODED_K_STEP):
        return "mma"
    return "tile"


def bbm_dot_coded_mma_emulated(a, s_a, b, s_b, *, wl: int, vbl: int,
                               kind: int, block: int, per="column",
                               live=None):
    """The tensor-core route of ``bbm_dot_coded_batched`` in plain PyTorch
    (CPU): per slice, per K-chunk (per K-block's chunks, restarting at
    each block, for ``per="kblock"``), the two int32 sums ``lo`` and
    ``hi`` of ``bbm_mma_operands``' byte products on the live codes
    (exact in int64 here, modulo 2^32 in the kernel), the partial ``lo +
    256 hi`` modulo 2^32, its f32 adds in chunk order from 0, then the
    kernel's descale ``(yq 2^vbl) (s_a s_b)`` per column, or per K-block
    with the parts added in block order, the first as is.  Raises where
    ``bbm_coded_route`` says "tile"."""
    _coded_args(a, s_a, b, s_b, block, per, live)
    if bbm_coded_route(wl, vbl, kind, per, block) != "mma":
        raise ValueError(f"the tensor-core route does not take wl={wl} "
                         f"vbl={vbl} per={per!r} block={block}")
    b1, b2, m, k = a.shape
    n = b.shape[3]
    bc = _live_codes(b, per, live)
    chunk = amm_chunk_len(wl, vbl)
    scale = float(1 << vbl)
    out = torch.empty((b1, b2, m, n), dtype=torch.float32)
    for i in range(b1):
        for j in range(b2):
            ops = bbm_mma_operands(a[i, j], w=bc[i, j], wl=wl, vbl=vbl,
                                   kind=kind)

            def yq(lo, hi):      # f32 chunk sums of rows lo:hi
                acc = torch.zeros((m, n), dtype=torch.float32)
                for c0 in range(lo, hi, chunk):
                    c1 = min(hi, c0 + chunk)
                    part = [torch.zeros((m, n), dtype=torch.int64)
                            for _ in range(2)]
                    for x_b, w_b, sig in ops:
                        part[sig] += x_b[:, c0:c1] @ w_b[c0:c1]
                    p = _wrap_i32(_wrap_i32(part[0]).to(torch.int64)
                                  + 256 * _wrap_i32(part[1]).to(torch.int64))
                    acc = acc + p.to(torch.float32)
                return acc
            if per == "column":
                cols = s_b[i, j].repeat_interleave(block)[:n]
                out[i, j] = (yq(0, k) * scale) * (s_a[i, j] * cols)[None, :]
                continue
            acc = None
            for jb, lo in enumerate(range(0, k, block)):
                part = (yq(lo, lo + block) * scale) * (s_a[i, j]
                                                       * s_b[i, j, jb])
                acc = part if acc is None else acc + part
            out[i, j] = acc
    return out


def bbm_dot_coded_batched_plain(a, s_a, b, s_b, *, wl: int, vbl: int,
                                kind: int, block: int, per="column",
                                live=None):
    """Plain version of the batched entry: ``bbm_dot_scaled_plain`` over
    the slices (over each K-block's rows in turn for ``per="kblock"``),
    then the descale in the reference's expression order; codes at or
    past ``live`` along the blocked axis zeroed first."""
    _coded_args(a, s_a, b, s_b, block, per, live)
    b1, b2, m, k = a.shape
    n = b.shape[3]
    bc = _live_codes(b, per, live)

    def yq(lo, hi):        # (B1, B2, M, N): the slices' rows lo:hi
        out = bbm_dot_scaled_plain(
            a[..., lo:hi].reshape(-1, m, hi - lo).contiguous(),
            bc[:, :, lo:hi].reshape(-1, hi - lo, n).contiguous(), wl=wl,
            vbl=vbl, kind=kind)
        return out.reshape(b1, b2, m, n)
    if per == "column":
        cols = s_b.repeat_interleave(block, dim=-1)[..., :n]
        return yq(0, k) * (s_a[..., None] * cols)[:, :, None, :]
    acc = None
    for j, lo in enumerate(range(0, k, block)):
        part = yq(lo, lo + block) * (s_a * s_b[..., j])[..., None, None]
        acc = part if acc is None else acc + part
    return acc


def bbm_dot_coded_batched(a, s_a, b, s_b, *, wl: int, vbl: int, kind: int,
                          block: int, per="column", live=None):
    """``B1 * B2`` independent codes-in products in one launch: the score
    and value products of decode attention on the int-code KV cache, one
    slice per (slot, kv-head).

    a: (B1, B2, M, K) contiguous int32 codes (each slice quantized with
    its own scale ``s_a`` (B1, B2) f32); b: (B1, B2, K, N) int8, int16
    or int32 codes in any strides (a view of the cache itself); ``yq`` is
    each slice's f32 sum at full product scale (``bbm_dot_scaled``).
    ``s_b`` (B1, B2, J) f32 (any strides): ``per="column"`` gives ``yq *
    (s_a * s_b[..., n // block])`` (the score product against per-block K
    scales; J = ceil(N / block));
    ``per="kblock"`` descales each K-block of ``block`` rows by ``s_a *
    s_b[..., j]`` before the f32 add in block order (the value product;
    J = K / block).  ``live`` (B1,): positions of the blocked axis at or
    past ``live[i]`` read as zero codes.  Returns (B1, B2, M, N) f32,
    bit-equal to ``bbm_matmul_coded`` / ``bbm_matmul_coded_kblocks`` of
    each slice on its masked codes.  CUDA tensors launch
    ``bbm_coded_route``'s kernel (``csrc/bbm_coded_mma.cuh`` on the int8
    tensor cores, else ``bbm_coded_kernel`` of ``csrc/bbm_dot.cu``),
    counted in ``bbm_dot_coded_batched.launches`` (the tensor-core share
    also in ``.mma_launches``); CPU tensors run the plain version.
    """
    _coded_args(a, s_a, b, s_b, block, per, live)
    if not a.is_cuda:
        return bbm_dot_coded_batched_plain(a, s_a, b, s_b, wl=wl, vbl=vbl,
                                           kind=kind, block=block, per=per,
                                           live=live)
    out, route = _coded_launch(None, a, s_a, b, s_b, wl=wl, vbl=vbl,
                               kind=kind, block=block, per=per, live=live)
    if out.numel():
        bbm_dot_coded_batched.launches += 1
        bbm_dot_coded_batched.mma_launches += route == "mma"
    return out


def _coded_launch(route, a, s_a, b, s_b, *, wl: int, vbl: int, kind: int,
                  block: int, per: str, live=None):
    """(out, route): one launch, uncounted, of ``route``'s kernel ("mma"
    or "tile"; None: ``bbm_coded_route``'s) on CUDA operands.  The
    wrapper's launch, and the hook through which ``chip_smoke.py`` and the
    tests drive the CUDA-core kernel where the rule takes the tensor
    cores; a route that cannot compute the call raises."""
    _coded_args(a, s_a, b, s_b, block, per, live)
    if wl % 2 or not 2 <= wl <= 16 or not 0 <= vbl < wl \
            or kind not in (0, 1):
        raise ValueError(f"unsupported operating point wl={wl} vbl={vbl} "
                         f"kind={kind}")
    rule = bbm_coded_route(wl, vbl, kind, per, block)
    route = rule if route is None else route
    if route not in ("mma", "tile"):
        raise ValueError(f"unknown route {route!r}")
    if route == "mma" and rule != "mma":
        raise ValueError(f"route 'mma' cannot compute wl={wl} vbl={vbl} "
                         f"per={per!r} block={block}")
    if not a.is_cuda:
        raise ValueError("the batched entry's kernels take CUDA tensors")
    b1, b2, m, k = a.shape
    n = b.shape[3]
    out = torch.empty((b1, b2, m, n), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out, route
    if b1 * b2 >= 65536 or max(m * k, k * n, m * n) >= 2 ** 31:
        raise ValueError("bbm_dot_coded_batched dimensions exceed the "
                         "kernel's grid or int32 indexing")
    live32 = None if live is None else live.to(torch.int32).contiguous()
    s_a = s_a.contiguous()
    from ._build import library
    lib = library("bbm_dot")
    args = (a.data_ptr(), s_a.data_ptr(), b.data_ptr(), b.element_size(),
            *b.stride(), s_b.data_ptr(), *s_b.stride(),
            None if live32 is None else live32.data_ptr(), out.data_ptr(),
            b1, b2, m, k, n, wl, vbl, kind)
    tail = (amm_chunk_len(wl, vbl), 1 if per == "column" else 2, block)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if route == "mma":
            err = lib.bbm_dot_coded_mma_launch(*args, *tail, stream)
        else:
            err = lib.bbm_dot_coded_batched_launch(
                *args, num_corr_rows(wl, vbl), *tail, stream)
    if err != 0:
        raise RuntimeError(f"bbm_dot_coded_batched ({route}) failed: CUDA "
                           f"error {err} "
                           f"({lib.bbm_dot_error_string(err).decode()})")
    return out, route


bbm_dot_coded_batched.launches = 0
bbm_dot_coded_batched.mma_launches = 0     # the tensor-core share


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
    Bit-identical to ``bbm_matmul_scaled`` on the same planes.  On the
    card the launch takes ``bbm_dot_route``'s route.
    """
    return _bbm_dot_planes_on(None, x, wmag, wneg, wl=wl, vbl=vbl,
                              kind=kind, fault=fault)


def _bbm_dot_planes_on(route, x, wmag, wneg, *, wl: int, vbl: int,
                       kind: int, fault: FaultSpec | None = None):
    """``bbm_dot_planes`` on ``route``, as ``_bbm_dot_scaled_on``."""
    _check_operands("bbm_dot_planes", x, wmag, wneg, wl=wl, vbl=vbl,
                    kind=kind, shift=None)
    if vbl >= wl:
        raise ValueError(f"vbl={vbl} outside [0, wl)")
    route = _pick_route("bbm_dot_planes", route, wl, vbl, kind)
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
        kptr = None if keys is None else keys.data_ptr()
        if route == "mma":
            words = torch.empty((k, n), dtype=torch.int32, device=x.device)
            err = lib.bbm_dot_planes_mma_launch(
                x.data_ptr(), wmag.data_ptr(), wneg.data_ptr(),
                words.data_ptr(), kptr, p, bit, out.data_ptr(), m, k, n, wl,
                vbl, kind, chunk, stream)
        else:
            err = lib.bbm_dot_planes_launch(
                x.data_ptr(), wmag.data_ptr(), wneg.data_ptr(), kptr, p,
                bit, out.data_ptr(), m, k, n, wl, vbl, kind,
                num_corr_rows(wl, vbl), chunk, stream)
    if err != 0:
        raise RuntimeError(f"bbm_dot_planes failed: CUDA error {err} "
                           f"({lib.bbm_dot_error_string(err).decode()})")
    bbm_dot_planes.launches += 1
    bbm_dot_planes.mma_launches += route == "mma"
    return out


bbm_dot_planes.launches = 0
bbm_dot_planes.mma_launches = 0


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

    CUDA tensors launch the ``bbm_matmul_dot`` kernel on
    ``bbm_dot_route``'s route at ``shift``; CPU tensors run
    ``bbm_matmul_dot_plain``.
    """
    return _bbm_matmul_dot_on(None, x, wmag, wneg, wl=wl, vbl=vbl,
                              kind=kind, shift=shift)


def _bbm_matmul_dot_on(route, x, wmag, wneg, *, wl: int, vbl: int,
                       kind: int = 0, shift: int = 0) -> torch.Tensor:
    """``bbm_matmul_dot`` on ``route``, as ``_bbm_dot_scaled_on``."""
    _check_operands("bbm_matmul_dot", x, wmag, wneg, wl=wl, vbl=vbl,
                    kind=kind, shift=shift)
    route = _pick_route("bbm_matmul_dot", route, wl, vbl, kind, shift)
    if not x.is_cuda:
        return bbm_matmul_dot_plain(x, wmag, wneg, wl=wl, vbl=vbl,
                                    kind=kind, shift=shift)
    if route == "mma":
        return _launch_matmul(bbm_matmul_dot, x, wmag, wneg, wl=wl, vbl=vbl,
                              kind=kind, shift=shift, mma=True)
    return _launch_matmul(bbm_matmul_dot, x, wmag, wneg, wl=wl, vbl=vbl,
                          kind=kind, shift=shift,
                          extra=(num_corr_rows(wl, vbl),))


bbm_matmul_dot.launches = 0
bbm_matmul_dot.mma_launches = 0


def _launch_matmul(wrapper, x, wmag, wneg, *, wl: int, vbl: int,
                   kind: int, shift: int, extra=(),
                   mma: bool = False) -> torch.Tensor:
    """Launch ``wrapper``'s kernel (``<name>_launch`` in the library, or
    ``<name>_mma_launch`` on the tensor-core route, which takes a (K, N)
    scratch for the packed planes) and count it in ``wrapper.launches``;
    an empty output or K = 0 launches nothing and counts nothing
    (``wrapper.mma_launches`` counts the tensor-core route's share)."""
    fn_name = wrapper.__name__ + ("_mma_launch" if mma else "_launch")
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
        ptrs = (x.data_ptr(), wmag.data_ptr(), wneg.data_ptr())
        if mma:
            words = torch.empty((k, n), dtype=torch.int32, device=x.device)
            ptrs += (words.data_ptr(),)
        err = getattr(lib, fn_name)(*ptrs, out.data_ptr(), m, k, n, wl,
                                    vbl, kind, shift, *extra, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err} "
                           f"({lib.bbm_matmul_error_string(err).decode()})")
    wrapper.launches += 1
    if mma:
        wrapper.mma_launches += 1
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
