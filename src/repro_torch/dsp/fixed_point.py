"""Fixed-point quantization helpers (Q-format, two's complement).

Counterpart of ``repro.dsp.fixed_point``.  Values live in [-1, 1) as
Q(1, wl-1): q = round(x * 2^(wl-1)) clipped to the signed wl-bit range,
carried in int32 masked to wl bits so they feed the multipliers directly.
"""
from __future__ import annotations

import torch

__all__ = ["quantize", "dequantize", "requant_scale"]


def quantize(x, wl: int) -> torch.Tensor:
    """Real [-1,1) -> signed wl-bit integer code (int32, masked to wl bits).

    Rounds half to even in the input's float precision, as the reference
    does in float32.
    """
    scale = float(1 << (wl - 1))
    x = torch.as_tensor(x, dtype=torch.float32)
    q = torch.clamp(torch.round(x * scale), -scale, scale - 1).to(torch.int32)
    return q & ((1 << wl) - 1)


def dequantize(q_signed, wl: int) -> torch.Tensor:
    """Signed integer code -> real (float32)."""
    return torch.as_tensor(q_signed).to(torch.float32) / float(1 << (wl - 1))


def requant_scale(wl: int) -> float:
    """Scale of a full-precision product of two Q(1, wl-1) values."""
    return float(1 << (2 * (wl - 1)))
