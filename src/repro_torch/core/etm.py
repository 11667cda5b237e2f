"""Error-Tolerant Multiplier (Kyaw, Goh & Yeo, paper ref [5]).

Counterpart of ``repro.core.etm``: the wl-bit operands split at
``split`` into a multiplication part (high bits) and a
non-multiplication part (low bits).  If either high part is non-zero,
the high parts multiply exactly, the cross terms at full precision, and
the low-part product is approximated column-wise (each column the OR of
its dots, then every column below the highest active one set to 1);
otherwise both operands are small and multiply exactly.  split = 0 is
the exact multiplier.  Int32 tensor operations on the operands' device.
"""
from __future__ import annotations

import torch

from .booth import to_unsigned

__all__ = ["etm_mul"]


def etm_mul(a, b, wl: int, split: int = 0) -> torch.Tensor:
    """ETM product of unsigned wl-bit a, b.  split=0 -> exact multiplier."""
    au = to_unsigned(a, wl)
    bu = to_unsigned(b, wl)
    if split == 0:
        return au * bu
    mask_lo = (1 << split) - 1
    a_hi, a_lo = au >> split, au & mask_lo
    b_hi, b_lo = bu >> split, bu & mask_lo
    dev = au.device
    j = torch.arange(split, dtype=torch.int32, device=dev)
    aj = (a_lo[..., None] >> j) & 1                          # (..., split)
    cols = []
    for c in range(2 * split - 1):
        kk = c - j
        valid = (kk >= 0) & (kk < split)
        bk = (b_lo[..., None] >> torch.clamp(kk, 0, split - 1)) & 1
        cols.append(torch.any(valid & ((aj & bk) == 1), dim=-1))
    bits = torch.stack(cols, dim=-1)                         # (..., 2*split-1)
    # fill: bit i becomes 1 if any column >= i is 1
    filled = torch.flip(torch.cumsum(torch.flip(bits.to(torch.int32), [-1]),
                                     dim=-1), [-1]) > 0
    shifts = torch.arange(2 * split - 1, dtype=torch.int32, device=dev)
    low_approx = torch.sum(filled.to(torch.int32) << shifts, dim=-1,
                           dtype=torch.int32)
    big = ((a_hi * b_hi) << (2 * split)) \
        + ((a_hi * b_lo + b_hi * a_lo) << split) + low_approx
    both_small = (a_hi == 0) & (b_hi == 0)
    return torch.where(both_small, au * bu, big)
