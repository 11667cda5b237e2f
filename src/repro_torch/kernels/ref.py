"""Closed-form oracles for the port's kernels, and the amm quantizer
(``repro.kernels.ref``)."""
from __future__ import annotations

import torch

from ..core.bbm import bbm_type0, bbm_type1
from ..device import pin_fp32

__all__ = ["amm_quantize", "amm_scale", "fir_bank_ref", "quant_matmul_ref"]


def amm_scale(v, wl: int) -> torch.Tensor:
    """The dynamic quantization scale of ``amm_quantize``: a 0-dim f32
    tensor on ``v``'s device, ``max|v| * (1/lim)`` floored at 1e-12."""
    lim = 2 ** (wl - 1) - 1
    vf = torch.as_tensor(v).to(torch.float32)
    # multiply by the reciprocal constant, as the reference writes it
    # (XLA turns a division by a constant into this multiply inside
    # compiled programs); the division by the runtime scale stays true
    return torch.clamp_min(torch.amax(torch.abs(vf)) * (1.0 / lim), 1e-12)


def amm_quantize(v, wl: int):
    """(int32 codes, f32 dynamic scale): the amm quantizer.

    Codes are ``clip(round(v / s), -lim - 1, lim)`` with ``lim =
    2^(wl-1) - 1`` and ``s = amm_scale(v, wl)``, computed in float32
    whatever v's dtype (bf16 cannot hold the wl = 16 bound 32767: its
    nearest value 32768 would wrap to -32768 in the Booth decode), with a
    true division by the runtime scale and rounding half to even.
    """
    lim = 2 ** (wl - 1) - 1
    vf = torch.as_tensor(v).to(torch.float32)
    s = amm_scale(vf, wl)
    codes = torch.clamp(torch.round(vf / s), -lim - 1, lim)
    return codes.to(torch.int32), s


def quant_matmul_ref(x, w, s_x, s_w, *, wl: int = 16) -> torch.Tensor:
    """Quantize -> one exact f32 matmul -> descale (no noise).

    The reference's oracle at mu = sigma = 0 (its keyed-noise branch
    draws with ``jax.random.normal``, whose bits are not ported).  The
    scales are cast to f32 first, as the kernel receives them.
    """
    pin_fp32()
    lim = float(2 ** (wl - 1))
    s_x = torch.as_tensor(s_x, dtype=torch.float32, device=x.device)
    s_w = torch.as_tensor(s_w, dtype=torch.float32, device=x.device)
    xq = torch.clamp(torch.round(x / s_x), -lim, lim - 1)
    wq = torch.clamp(torch.round(w / s_w), -lim, lim - 1)
    return (xq @ wq) * (s_x * s_w)


def fir_bank_ref(x, w, *, wl: int, vbl: int, kind: int = 0, shift: int = 0):
    """y[c,n] = sum_k (bbm(x[c,n-k], h[c,k]) >> shift), zero initial state.

    x: (C, N) codes, w: (C, taps) codes; built on the closed forms in
    ``core.bbm`` over the materialized (C, N, taps) window.
    """
    fn = bbm_type0 if kind == 0 else bbm_type1
    n = x.shape[1]
    taps = w.shape[1]
    xp = torch.nn.functional.pad(x, (taps - 1, 0))
    # win[c, n, k] = x[c, n - k] (zeros before the signal starts)
    idx = (torch.arange(n, device=x.device)[:, None] + (taps - 1)
           - torch.arange(taps, device=x.device)[None, :])
    win = xp[:, idx]
    prod = fn(win, w[:, None, :], wl, vbl)
    if shift:
        prod = prod >> shift
    return torch.sum(prod, dim=-1, dtype=torch.int32)
