"""Broken-Array Multiplier (Mahdiani et al., paper ref [1]).

Counterpart of ``repro.core.bam``: the unsigned carry-save array
multiplier with the dots right of the Vertical Breaking Level and the
rows below the Horizontal Breaking Level removed,

    p = sum_{i >= hbl} b_i * ( a & ~(2^{max(0, vbl-i)} - 1) ) * 2^i

as int32 tensor operations on the operands' device (sums wrap mod 2^32
as the reference's do).  Signed datapaths use it through its magnitude
(``core.multipliers``).
"""
from __future__ import annotations

import torch

from .booth import to_unsigned

__all__ = ["bam_mul"]


def bam_mul(a, b, wl: int, vbl: int, hbl: int = 0) -> torch.Tensor:
    """BAM product of unsigned wl-bit a, b (int32 in/out, 2*wl-bit result)."""
    au = to_unsigned(a, wl)[..., None]
    bu = to_unsigned(b, wl)[..., None]
    i = torch.arange(wl, dtype=torch.int32, device=au.device)
    b_i = (bu >> i) & 1
    m = torch.clamp(vbl - i, min=0)
    a_masked = au & ~((torch.ones_like(m) << m) - 1)
    row = torch.where(i >= hbl, b_i * a_masked, 0)
    return torch.sum(row << i, dim=-1, dtype=torch.int32)
