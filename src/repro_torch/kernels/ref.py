"""Closed-form oracles for the port's kernels (``repro.kernels.ref``)."""
from __future__ import annotations

import torch

from ..core.bbm import bbm_type0, bbm_type1

__all__ = ["fir_bank_ref"]


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
