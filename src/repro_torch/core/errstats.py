"""Error characterization of approximate multipliers (paper section II.B).

Counterpart of ``repro.core.errstats``: apply every input pair
exhaustively (``2^(2*wl)`` pairs; the default for wl <= 12; the paper's
Table I is wl = 12, N = 2^24) or a seeded sample, and report the Table I
moments of

    error = approximate output - accurate output            (Eq. 1)
    MSE   = (1/N) * sum_i error(i)^2                        (Eq. 2)

plus the error histogram of Fig. 2.  Each chunk's raw int32 error vector
comes from the port's closed forms (``core.multipliers.mul``) on the
device, chunk by chunk exactly as the reference chunks them and with the
same ``np.random.default_rng(seed)`` draws; the moments accumulate on
the host in float64, in the same order, so both packages report the
same floats.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .booth import to_signed
from .multipliers import MulSpec, mul

__all__ = ["ErrorStats", "PAPER_TABLE1", "characterize", "error_histogram"]

# the paper's Table I (Broken-Booth Type0, WL 12, all 2^24 input pairs):
# VBL -> (mean, MSE, P(error != 0), min)
PAPER_TABLE1 = {
    3: (-3.50, 2.22e1, 0.6875, -1.10e1),
    6: (-6.15e1, 5.05e3, 0.9375, -1.71e2),
    9: (-7.89e2, 7.52e5, 0.9893, -2.22e3),
    12: (-8.53e3, 8.33e7, 0.9983, -2.32e4),
}

# a float64 sum of integers is exact while every partial sum stays below
# 2^53; the Table I sums reach about 1e15 (wl 12, 2^24 squared errors)
_EXACT = float(2 ** 53)


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

    def row(self) -> str:
        return (f"mean={self.mean:+.4g} mse={self.mse:.4g} "
                f"prob={self.prob:.4f} min={self.min:+.4g} max={self.max:+.4g}")


def _err(spec: MulSpec, a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    """The int32 error of every product of ``a`` and ``b`` (broadcast),
    computed on their device, as float64 on the host."""
    e = mul(spec)(a, b) - to_signed(a, spec.wl) * to_signed(b, spec.wl)
    return e.cpu().numpy().astype(np.float64)


def _exhaustive_chunks(spec: MulSpec, chunk: int, dev):
    """The error of each chunk of first operands against every second
    operand, in the reference's order."""
    wl = spec.wl
    b = torch.arange(1 << wl, dtype=torch.int32, device=dev)
    for lo in range(0, 1 << wl, chunk):
        a = torch.arange(lo, min(lo + chunk, 1 << wl), dtype=torch.int32,
                         device=dev)
        yield _err(spec, a[:, None], b)


def characterize(spec: MulSpec, *, exhaustive: Optional[bool] = None,
                 sample: int = 1 << 20, seed: int = 0,
                 chunk: int = 1 << 8, device=None) -> ErrorStats:
    """Characterize ``spec`` exhaustively (default for wl <= 12) or sampled.

    ``device``: where the error vectors are computed (None: the GPU,
    raising without one; "cpu").  Raises if a float64 sum could leave the
    integers it holds exactly (past 2^53), where its float would stop
    being the reference's.
    """
    dev = resolve_device(device)
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
        # every term is an integer and |e| <= e * e, so the squares' sum
        # bounds every partial sum of both: below 2^53 all are exact
        if ss >= _EXACT:
            raise ValueError(f"{spec}: the float64 error sums pass 2^53 and "
                             f"would stop being exact")

    if exhaustive:
        for err in _exhaustive_chunks(spec, chunk, dev):
            add(err)
    else:
        rng = np.random.default_rng(seed)
        done = 0
        while done < sample:
            m = min(chunk * chunk, sample - done)
            a = torch.from_numpy(rng.integers(0, 1 << wl, size=m,
                                              dtype=np.int32)).to(dev)
            b = torch.from_numpy(rng.integers(0, 1 << wl, size=m,
                                              dtype=np.int32)).to(dev)
            add(_err(spec, a, b))
            done += m
    mean = s / n
    mse = ss / n
    return ErrorStats(mean=mean, mse=mse, prob=nz / n, min=mn, max=mx,
                      var=mse - mean * mean, n=n)


def error_histogram(spec: MulSpec, bins: int = 81, device=None):
    """Fig. 2: percentage distribution of error normalized to
    2^(2*wl - 1).

    Exhaustive over all pairs (wl <= 10 as in the paper's figure); the
    bin range adapts to the observed error span (two passes, the first
    being ``characterize``).  Returns (bin_centers_normalized,
    percentage) as numpy float64 arrays.
    """
    dev = resolve_device(device)
    norm = float(1 << (2 * spec.wl - 1))
    st = characterize(spec, device=dev)
    lo_e = st.min / norm
    hi_e = st.max / norm
    span = max(hi_e - lo_e, 1e-12)
    edges = np.linspace(lo_e - 0.02 * span, hi_e + 0.02 * span, bins + 1)
    counts = np.zeros(bins, dtype=np.float64)
    for err in _exhaustive_chunks(spec, 256, dev):
        c, _ = np.histogram(err.ravel() / norm, bins=edges)
        counts += c
    pct = 100.0 * counts / counts.sum()
    centers = 0.5 * (edges[:-1] + edges[1:])
    return centers, pct
