"""Radix-4 modified Booth recoding and the exact Booth multiplier.

Counterpart of ``repro.core.booth``.  Functions take int32 tensors of
signed two's-complement wl-bit codes (wl <= 16 keeps every intermediate
inside int32) and work on whatever device the tensors live on.

Booth digit conventions (Weste & Harris, paper ref [10]):

    triplet (b_{2i+1}, b_{2i}, b_{2i-1}) with b_{-1} = 0
    d_i   = -2*b_{2i+1} + b_{2i} + b_{2i-1}        in {-2,-1,0,1,2}
    neg_i = b_{2i+1}                               ("S" dot of row i)

``neg_i`` is the hardware sign/increment flag: the triplet 111 yields
d_i = 0 but neg_i = 1 (the "negative zero" row), which Type1 truncation
exposes.
"""
from __future__ import annotations

import torch

__all__ = ["num_pp_rows", "booth_digits", "booth_mul_exact", "to_signed",
           "to_unsigned"]


def _int32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int32)


def num_pp_rows(wl: int) -> int:
    """Number of radix-4 Booth partial products for an even word length."""
    if wl % 2 != 0:
        raise ValueError(f"modified Booth needs an even word length, got {wl}")
    return wl // 2


def to_signed(x, wl: int) -> torch.Tensor:
    """Reinterpret the low ``wl`` bits of ``x`` as a signed integer."""
    x = _int32(x) & ((1 << wl) - 1)
    return torch.where(x >= (1 << (wl - 1)), x - (1 << wl), x)


def to_unsigned(x, wl: int) -> torch.Tensor:
    """Low ``wl`` bits of ``x`` as a non-negative integer."""
    return _int32(x) & ((1 << wl) - 1)


def booth_digits(b, wl: int):
    """Radix-4 Booth digits and hardware neg flags of ``b``.

    Returns ``(d, neg)``, each of shape ``b.shape + (wl//2,)``, int32.
    """
    n = num_pp_rows(wl)
    bu = to_unsigned(b, wl)[..., None]
    i = torch.arange(n, dtype=torch.int32, device=bu.device)
    b_hi = (bu >> (2 * i + 1)) & 1
    b_mid = (bu >> (2 * i)) & 1
    # b_{2i-1}: for i = 0 this is the implicit 0
    b_lo = torch.where(i == 0, 0, (bu >> torch.clamp(2 * i - 1, min=0)) & 1)
    d = -2 * b_hi + b_mid + b_lo
    return d.to(torch.int32), b_hi.to(torch.int32)


def booth_mul_exact(a, b, wl: int) -> torch.Tensor:
    """Exact signed product via Booth recoding: sum_i d_i * a * 4**i."""
    a_s = to_signed(a, wl)[..., None]
    d, _ = booth_digits(b, wl)
    i = torch.arange(num_pp_rows(wl), dtype=torch.int32, device=d.device)
    weight = torch.ones_like(i) << (2 * i)
    return torch.sum(d * a_s * weight, dim=-1, dtype=torch.int32)
