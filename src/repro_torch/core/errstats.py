"""Error characterization of approximate multipliers (paper section II.B).

Counterpart of ``repro.core.errstats.characterize``: apply every input
pair exhaustively (``2^(2*wl)`` pairs; the default for wl <= 12) or a
seeded sample, and report the Table I moments of

    error = approximate output - accurate output            (Eq. 1)

The raw int32 error vectors come from the port's closed forms
(``core.multipliers.mul``) on CPU tensors, chunk by chunk exactly as the
reference chunks them and with the same ``np.random.default_rng(seed)``
draws; the moments accumulate on the host in float64, in the same order,
so both packages report the same floats.  This is one-time host
calibration, not a serving path: it runs on the CPU whatever device the
model later runs on.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .booth import to_signed
from .multipliers import MulSpec, mul

__all__ = ["ErrorStats", "characterize"]


@dataclasses.dataclass(frozen=True)
class ErrorStats:
    """Error moments of an approximate multiplier over a given input set."""
    mean: float
    mse: float
    prob: float          # P(error != 0)
    min: float
    max: float
    var: float
    n: int

    @property
    def std(self) -> float:
        return float(np.sqrt(max(self.var, 0.0)))


def _err(spec: MulSpec, a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    e = mul(spec)(a, b) - to_signed(a, spec.wl) * to_signed(b, spec.wl)
    return e.numpy().astype(np.float64)


def characterize(spec: MulSpec, *, exhaustive: Optional[bool] = None,
                 sample: int = 1 << 20, seed: int = 0,
                 chunk: int = 1 << 8) -> ErrorStats:
    """Characterize ``spec`` exhaustively (default for wl <= 12) or sampled."""
    wl = spec.wl
    if exhaustive is None:
        exhaustive = wl <= 12
    s = ss = nz = 0.0
    mn, mx = np.inf, -np.inf
    n = 0

    def add(err):
        nonlocal s, ss, nz, mn, mx, n
        s += err.sum()
        ss += (err * err).sum()
        nz += np.count_nonzero(err)
        mn = min(mn, float(err.min()))
        mx = max(mx, float(err.max()))
        n += err.size

    if exhaustive:
        b = torch.arange(1 << wl, dtype=torch.int32)
        for lo in range(0, 1 << wl, chunk):
            a = torch.arange(lo, min(lo + chunk, 1 << wl),
                             dtype=torch.int32)
            add(_err(spec, a[:, None], b))
    else:
        rng = np.random.default_rng(seed)
        done = 0
        while done < sample:
            m = min(chunk * chunk, sample - done)
            a = torch.from_numpy(rng.integers(0, 1 << wl, size=m,
                                              dtype=np.int32))
            b = torch.from_numpy(rng.integers(0, 1 << wl, size=m,
                                              dtype=np.int32))
            add(_err(spec, a, b))
            done += m
    mean = s / n
    mse = ss / n
    return ErrorStats(mean=mean, mse=mse, prob=nz / n, min=mn, max=mx,
                      var=mse - mean * mean, n=n)
