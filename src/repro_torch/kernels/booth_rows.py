"""Shared Broken-Booth row arithmetic, split into decode and accumulate.

Counterpart of ``repro.kernels.booth_rows``: the same functions on int32
tensors, on whatever device the tensors live on.  The tap bank (or weight
matrix) is the constant Booth multiplier operand, so its radix-4 digits
are decoded once (``booth_precode``) into ``(mag, neg)`` planes with the
row axis leading, and every product then walks the rows
(``bbm_rows_product_precoded``).  ``mag`` is the digit magnitude in
{0, 1, 2}; ``neg`` the raw ``b_{2r+1}`` bit (the 111 triplet gives mag 0,
neg 1, which Type1 truncation exposes).

The dot form rests on ``(p >> m) << m == p - (p & (2^m - 1))``: every
Broken-Booth product is ``a_s * b_s - correction(a mod 2^vbl, planes)``,
and folding the correction's linear term back in shows every product is
divisible by ``2^vbl``:

    bbm(a, b) == 2^vbl * [ a*bq + sum_{r<R} ((d_r*a - neg_r*kind) >> m_r) ]

with ``bq = booth_high_value`` and ``R = num_corr_rows``.  The CUDA
kernels in ``fir_kernel`` run exactly these row semantics.

torch integer notes: sums pass ``dtype=torch.int32`` (torch widens int32
sums to int64 otherwise), and Python-int operands keep int32.
"""
from __future__ import annotations

import torch

from ..core.booth import num_pp_rows
from ..core.faults import apply_plane_faults

__all__ = ["amm_chunk_len", "bbm_rows_product", "bbm_rows_product_precoded",
           "bbm_rows_product_dotform", "booth_correction",
           "booth_high_value", "booth_precode", "booth_precode_faulty",
           "booth_value",
           "dotform_scaled_bound", "f32_exact_chunk_len", "num_corr_rows",
           "resolve_form", "scaled_trunc_rows", "signed_digit",
           "split_signed"]


def split_signed(x: torch.Tensor, wl: int):
    """(unsigned wl-bit view, signed reinterpretation) of int32 codes."""
    xu = x & ((1 << wl) - 1)
    return xu, torch.where(xu >= (1 << (wl - 1)), xu - (1 << wl), xu)


def booth_precode(bu, wl: int):
    """Decode phase: radix-4 digit planes of unsigned wl-bit codes ``bu``.

    Returns ``(mag, neg)`` int32 tensors of shape ``(wl//2,) + bu.shape``.
    """
    bu = torch.as_tensor(bu).to(torch.int32) & ((1 << wl) - 1)
    mags, negs = [], []
    prev_hi = None
    for r in range(num_pp_rows(wl)):
        b_hi = (bu >> (2 * r + 1)) & 1
        b_mid = (bu >> (2 * r)) & 1
        b_lo = torch.zeros_like(b_mid) if r == 0 else prev_hi
        prev_hi = b_hi
        d = -2 * b_hi + b_mid + b_lo
        mags.append(torch.abs(d))
        negs.append(b_hi)
    return torch.stack(mags), torch.stack(negs)


def booth_precode_faulty(bu, wl: int, fault=None, *, vbl: int = 0):
    """Decode phase with hardware faults injected into the digit planes:
    ``booth_precode`` then ``core.faults.apply_plane_faults``.  A
    ``None``/disabled/non-"plane" spec returns the clean decode; ``vbl``
    scopes ``rows="corr"`` faults to the truncated rows."""
    mag, neg = booth_precode(bu, wl)
    return apply_plane_faults(mag, neg, fault, vbl=vbl)


def bbm_rows_product_precoded(a_s, mag, neg, *, wl: int, vbl: int, kind: int,
                              multiply_free: bool = False):
    """Accumulate phase: Broken-Booth product from precoded digit planes.

    ``a_s`` is a signed int32 tensor; ``mag[r]`` / ``neg[r]`` broadcast
    against it.  ``multiply_free`` picks the row-contribution form, same
    values either way: True selects among ``{0, a_s, a_s << 1}`` and
    negates (the silicon's partial-product generator, and what the CUDA
    rows kernel does); False folds the sign into the digit and multiplies
    once per row.
    """
    a2 = a_s << 1 if multiply_free else None
    prod = None
    for r in range(num_pp_rows(wl)):
        m_r = mag[r]
        s_r = neg[r]
        m = max(0, vbl - 2 * r)           # bits nullified in this row
        if multiply_free:
            pos = torch.where(m_r == 2, a2, torch.where(m_r == 1, a_s, 0))
        if kind == 0:
            if multiply_free:
                rows = torch.where(s_r == 1, -pos, pos)
            else:
                rows = signed_digit(m_r, s_r) * a_s
            contrib = (rows >> m) << m    # floor for two's complement
        else:
            if not multiply_free:
                pos = m_r * a_s
            rows = torch.where(s_r == 1, -pos - 1, pos)
            contrib = (rows >> m) << m
            if m == 0:                    # S dot survives only at m == 0
                contrib = contrib + s_r
        term = contrib << (2 * r)
        prod = term if prod is None else prod + term
    return prod


def signed_digit(mag_r, neg_r):
    """Signed Booth digit of one row plane: ``d = -mag`` when ``neg``."""
    return torch.where(neg_r == 1, -mag_r, mag_r)


def num_corr_rows(wl: int, vbl: int) -> int:
    """Rows whose break column is nonzero: only they feed the correction."""
    return min(num_pp_rows(wl), (vbl + 1) // 2)


def booth_value(mag, neg, *, wl: int):
    """Signed multiplier value reconstructed from its digit planes."""
    val = None
    for r in range(num_pp_rows(wl)):
        term = signed_digit(mag[r], neg[r]) << (2 * r)
        val = term if val is None else val + term
    return val


def booth_correction(a_s, mag, neg, *, wl: int, vbl: int, kind: int):
    """Low-bit correction ``c >= 0`` with ``bbm(a, b) == a_s*b_s - c``.

    Every masked term depends only on the low ``m_r <= vbl`` bits of
    ``a``; the 111 "negative zero" triplet lands in Type1's
    ``((rows - neg) & mask) + neg`` as the dropped all-ones row.
    """
    a_low = a_s & ((1 << vbl) - 1)
    corr = None
    for r in range(num_corr_rows(wl, vbl)):
        m = vbl - 2 * r
        mask = (1 << m) - 1
        rows = signed_digit(mag[r], neg[r]) * a_low
        if kind == 0:
            term = rows & mask
        else:
            term = ((rows - neg[r]) & mask) + neg[r]
        t = term << (2 * r)
        corr = t if corr is None else corr + t
    if corr is None:
        shape = torch.broadcast_shapes(a_s.shape, mag[0].shape)
        corr = torch.zeros(shape, dtype=torch.int32, device=a_s.device)
    return corr


def bbm_rows_product_dotform(a_s, mag, neg, *, wl: int, vbl: int, kind: int):
    """Third bit-exact accumulate form: exact product minus correction."""
    b_s = booth_value(mag, neg, wl=wl)
    return a_s * b_s - booth_correction(a_s, mag, neg, wl=wl, vbl=vbl,
                                        kind=kind)


def booth_high_value(mag, neg, *, wl: int, vbl: int):
    """Truncation-surviving digit value, pre-divided by ``2^vbl``:
    ``bq = sum_{r >= R} d_r << (2r - vbl)``; ``vbl = 0`` gives
    ``booth_value``."""
    bq = None
    for r in range(num_corr_rows(wl, vbl), num_pp_rows(wl)):
        term = signed_digit(mag[r], neg[r]) << (2 * r - vbl)
        bq = term if bq is None else bq + term
    if bq is None:
        bq = torch.zeros(mag[0].shape, dtype=torch.int32, device=mag.device)
    return bq


def scaled_trunc_rows(a_s, mag, neg, *, wl: int, vbl: int, kind: int):
    """``Q = sum_{r<R} ((d_r*a - neg_r*kind) >> m_r)``, the folded dot
    form's truncated-row term at the ``2^-vbl`` product scale.  Returns
    ``None`` when no row is truncated (``vbl = 0``)."""
    q = None
    for r in range(num_corr_rows(wl, vbl)):
        rowp = signed_digit(mag[r], neg[r]) * a_s
        if kind == 1:
            rowp = rowp - neg[r]
        qr = rowp >> (vbl - 2 * r)
        q = qr if q is None else q + qr
    return q


def dotform_scaled_bound(k: int, wl: int, vbl: int, shift: int) -> int:
    """Worst-case |accumulator| of the dot form: accumulating at scale
    ``2^-max(vbl, shift)`` bounds partial sums by
    ``k * 2^(2wl - 1 - max(vbl, shift))``, never looser than the rows
    envelope."""
    return k * 2 ** max(2 * wl - 1 - max(vbl, shift), 0)


def amm_chunk_len(wl: int, vbl: int) -> int:
    """Largest K-chunk the contracted dot form accumulates int32-exactly
    (scaled total, per-row digit contraction, per-row mod term)."""
    bound = 2 ** 31 - 1
    c = bound >> max(2 * wl - 1 - vbl, 0)
    if num_corr_rows(wl, vbl):
        c = min(c, bound >> (wl + 1), bound >> vbl)
    return max(c, 1)


def f32_exact_chunk_len(wl: int, vbl: int) -> int:
    """Largest K-chunk the dot form contracts exactly in float32 (every
    partial sum an integer <= 2^24); may be 0."""
    bound = 1 << 24
    c = bound >> max(2 * wl - 1 - vbl, 0)
    if num_corr_rows(wl, vbl):
        c = min(c, bound >> (wl + 1), bound >> vbl)
    return c


def resolve_form(form: str | None) -> str:
    """Accumulate-form selection: "rows" | "dot" | None (auto: "dot").

    The filterbank entry points still route oversized auto-form calls on
    the GPU to "rows" (``fir_kernel.auto_form``).
    """
    if form in (None, "dot"):
        return "dot"
    if form == "rows":
        return "rows"
    raise ValueError(f"unknown accumulate form {form!r} "
                     f"(expected 'rows', 'dot' or None)")


def bbm_rows_product(a_s, bu, *, wl: int, vbl: int, kind: int):
    """Broken-Booth product of signed ``a_s`` and unsigned wl-bit ``bu``:
    decode then accumulate."""
    mag, neg = booth_precode(bu, wl)
    return bbm_rows_product_precoded(a_s, mag, neg, wl=wl, vbl=vbl,
                                     kind=kind)
