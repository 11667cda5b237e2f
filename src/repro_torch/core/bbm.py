"""Broken-Booth Multiplier (the paper's contribution), Type0 and Type1.

Counterpart of ``repro.core.bbm``: the closed-form integer formulas for
the dot-diagram truncation of Fig. 1, columns below VBL nullified.

Type0 — rows carry d_i * A as a complete two's-complement value; zeroing
the low ``m_i = max(0, VBL - 2i)`` bits floors toward -inf:

    p = sum_i floor(d_i * A / 2^m_i) * 2^m_i * 4^i

Type1 — negative rows are one's-complemented only; the S (+1) dot sits in
column 2i and is dropped when 2i < VBL.  The 111 "negative zero" triplet
gives mag = 0, neg = 1 (an all-ones row plus S):

    row_i = mag_i * A                 if neg_i == 0
          = -(mag_i * A) - 1         if neg_i == 1
    p = sum_i [ floor(row_i / 2^m_i) * 2^m_i + neg_i * (m_i == 0) ] * 4^i

VBL = 0 reduces both types to the exact Booth product.
"""
from __future__ import annotations

import torch

from .booth import booth_digits, num_pp_rows, to_signed

__all__ = ["bbm_mul", "bbm_type0", "bbm_type1"]


def _row_masks(wl: int, vbl: int, device):
    # int32-safety: |approx| <= |exact| + ceil(vbl/2)*2^vbl must fit in 31
    # bits; the paper never exceeds vbl = wl - 1
    limit = 2 * wl - 6 if wl >= 14 else 2 * wl
    if not 0 <= vbl <= limit:
        raise ValueError(f"vbl={vbl} outside int32-safe range [0, {limit}] "
                         f"for wl={wl}")
    i = torch.arange(num_pp_rows(wl), dtype=torch.int32, device=device)
    m = torch.clamp(vbl - 2 * i, min=0)
    one = torch.ones_like(i)
    return m, one << m, one << (2 * i)


def bbm_type0(a, b, wl: int, vbl: int) -> torch.Tensor:
    """Broken-Booth Type0 product of signed wl-bit a, b (int32 in/out)."""
    a_s = to_signed(a, wl)[..., None]
    d, _ = booth_digits(b, wl)
    _, two_m, weight = _row_masks(wl, vbl, d.device)
    rows = d * a_s
    trunc = torch.div(rows, two_m, rounding_mode="floor") * two_m
    return torch.sum(trunc * weight, dim=-1, dtype=torch.int32)


def bbm_type1(a, b, wl: int, vbl: int) -> torch.Tensor:
    """Broken-Booth Type1 product of signed wl-bit a, b (int32 in/out)."""
    a_s = to_signed(a, wl)[..., None]
    d, neg = booth_digits(b, wl)
    m, two_m, weight = _row_masks(wl, vbl, d.device)
    pos_val = torch.abs(d) * a_s
    row = torch.where(neg == 1, -pos_val - 1, pos_val)
    trunc = torch.div(row, two_m, rounding_mode="floor") * two_m
    s_dot = ((neg == 1) & (m == 0)).to(torch.int32)
    return torch.sum((trunc + s_dot) * weight, dim=-1, dtype=torch.int32)


def bbm_mul(a, b, wl: int, vbl: int, kind: int = 0) -> torch.Tensor:
    """Dispatcher: kind=0 -> Type0, kind=1 -> Type1."""
    if kind == 0:
        return bbm_type0(a, b, wl, vbl)
    if kind == 1:
        return bbm_type1(a, b, wl, vbl)
    raise ValueError(f"unknown BBM kind {kind}")
