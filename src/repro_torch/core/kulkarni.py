"""Underdesigned 2x2-block multiplier (Kulkarni et al., paper ref [3])
with the paper's added K parameter.

Counterpart of ``repro.core.kulkarni``: the 2x2 block computes a*b
exactly except 3*3 -> 7; a wl-bit unsigned multiplier is (wl/2)^2 such
blocks on 2-bit digits,

    p = sum_{i,j} m(A_i, B_j) * 4^{i+j}

and the blocks lying entirely right of the vertical line at column K
(``2*(i+j) + 3 < K``) are the approximate ones.  K = 0 is exact.  Int32
tensor operations on the operands' device.
"""
from __future__ import annotations

import torch

from .booth import to_unsigned

__all__ = ["kulkarni_mul"]


def kulkarni_mul(a, b, wl: int, k: int = 0) -> torch.Tensor:
    """Kulkarni 2x2-block product of unsigned wl-bit a, b."""
    if wl % 2 != 0:
        raise ValueError("kulkarni multiplier needs an even word length")
    n = wl // 2
    au = to_unsigned(a, wl)[..., None]
    bu = to_unsigned(b, wl)[..., None]
    i = torch.arange(n, dtype=torch.int32, device=au.device)
    ai = ((au >> (2 * i)) & 3)[..., :, None]                # (..., n, 1)
    bj = ((bu >> (2 * i)) & 3)[..., None, :]                # (..., 1, n)
    exact = ai * bj
    approx = exact - 2 * ((ai == 3) & (bj == 3)).to(torch.int32)
    col = 2 * (i[:, None] + i[None, :])                     # block LSB column
    m = torch.where((col + 3) < k, approx, exact)
    return torch.sum(m << col, dim=(-2, -1), dtype=torch.int32)
