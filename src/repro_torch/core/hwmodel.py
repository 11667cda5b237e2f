"""Analytic hardware cost model (area / power / delay / PDP).

Counterpart of ``repro.core.hwmodel``, host code with the same functions,
constants and fits (numpy and scipy).

The paper reports Synopsys DC + PrimeTime numbers in 90 nm.  Without a
synthesis flow we model the hardware structurally and calibrate a small
number of global coefficients against the paper's own tables, then *report
model-vs-paper deltas* in the benchmarks (never silently substituting).

Structural inventory (radix-4 Booth, word length ``wl``, rows n = wl/2):

  * dot count        T(wl)       = n*(wl+1) - 1      (matches the paper's
                                   "36 bits out of 77" for wl=12, vbl=11)
  * nullified dots   Z(wl, vbl)  = sum_i max(0, vbl - 2i)
  * recoders         n
  * final CPA bits   2*wl - vbl

Area  = a_dot*(T - Z) + a_rec*n + a_cpa*(2wl - vbl)
Power = p_dot*sum_c r_c*(1 + phi*R_c) + p_rec*n + p_cpa*(2wl - vbl)
        where r_c = live rows feeding product column c and R_c = live dots in
        all columns right of c.  The phi term models glitch *propagation*:
        transitions generated on the right ripple left through the
        compressor tree, so truncating right-hand columns reduces switching
        activity in every remaining column — which is exactly the paper's
        observation that power falls faster than area.
Delay = t_rec + t_csa*log2(max_c r_c) + t_cpa*log2(2wl - vbl)

Coefficients (a_*, p_*, g) are least-squares fit to the eight Table II/III
mean reductions; delay terms to the two reported T_min values (1.21 ns
accurate / 1.13 ns approximate at wl=16).  The synthesis power/delay curve of
Fig. 3 is modeled with the standard sizing hyperbola P(T) ~ 1/(T - T_in).

BAM and Kulkarni get the same treatment on their own dot inventories so the
Fig. 5/6 PDP-vs-MSE comparison is like-for-like.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
from scipy.optimize import least_squares

from .multipliers import MulSpec

__all__ = [
    "PAPER_POWER_REDUCTION", "PAPER_AREA_REDUCTION", "PAPER_TABLE4",
    "dot_inventory", "area", "power", "tmin", "power_at", "pdp_avg",
    "fir_power", "quap",
]

# ----------------------------------------------------------------------------
# Paper ground truth used for calibration + benchmark comparison
# ----------------------------------------------------------------------------
# Table II / III mean reductions (%) for (wl, vbl=wl-1)
PAPER_POWER_REDUCTION: Dict[int, float] = {4: 28.0, 8: 56.3, 12: 58.6, 16: 57.4}
PAPER_AREA_REDUCTION: Dict[int, float] = {4: 19.7, 8: 33.4, 12: 41.8, 16: 41.6}
# Fig. 3 / §III.A
PAPER_TMIN_ACCURATE_NS = 1.21
PAPER_TMIN_APPROX_NS = 1.13
# Table IV: (wl, vbl) -> (snr_db, clock_ns, area_um2, power_mw)
PAPER_TABLE4 = {
    (16, 0): (25.35, 4.78, 1.22e5, 3.63),
    (16, 13): (25.0, 4.78, 1.07e5, 3.01),
    (14, 0): (23.1, 4.78, 1.13e5, 2.91),
}
FIR_TAPS = 30


# ----------------------------------------------------------------------------
# Structural inventories
# ----------------------------------------------------------------------------
def _booth_columns(wl: int, vbl: int) -> np.ndarray:
    """Live-row count r_c per product column c for the broken Booth array."""
    n = wl // 2
    cols = np.zeros(2 * wl, dtype=np.int64)
    for i in range(n):
        lo = max(2 * i, vbl)
        hi = min(2 * i + wl + 2, 2 * wl)          # row spans wl+2 dots
        if hi > lo:
            cols[lo:hi] += 1
    return cols


def _bam_columns(wl: int, vbl: int, hbl: int = 0) -> np.ndarray:
    cols = np.zeros(2 * wl, dtype=np.int64)
    for i in range(hbl, wl):
        lo = max(i, vbl)
        hi = i + wl
        if hi > lo:
            cols[lo:hi] += 1
    return cols


def _kulkarni_cells(wl: int, k: int) -> Tuple[float, float]:
    """(cell_cost, switch_cost) of the 2x2-block multiplier with line K.

    An approximate 2x2 block drops the MSB output and its AND plane
    (Kulkarni et al. report ~45% power saving per block); we model its
    cost as 0.55x an exact block, plus the compression tree of the block
    outputs (unaffected by K except through narrower columns).
    """
    n = wl // 2
    cells = switch = 0.0
    for i in range(n):
        for j in range(n):
            c = 0.55 if 2 * (i + j) + 3 < k else 1.0
            cells += c
            switch += c * (1 + 0.15 * (i + j))    # deeper columns glitch more
    return cells, switch


def dot_inventory(spec: MulSpec) -> Dict[str, float]:
    """Active/total dot counts + live-row column profile for a spec."""
    if spec.name in ("booth", "bbm0", "bbm1"):
        cols0 = _booth_columns(spec.wl, 0)
        cols = _booth_columns(spec.wl, 0 if spec.name == "booth" else spec.param)
        total = spec.wl // 2 * (spec.wl + 1) - 1
        nullified = sum(max(0, (spec.param if spec.name != "booth" else 0) - 2 * i)
                        for i in range(spec.wl // 2))
    elif spec.name == "bam":
        cols0 = _bam_columns(spec.wl, 0, 0)
        cols = _bam_columns(spec.wl, spec.param, spec.hbl)
        total = int(cols0.sum())
        nullified = total - int(cols.sum())
    elif spec.name == "etm":
        # low half replaced by OR chains (~15% of a dot), highs exact
        split = spec.param
        cols0 = _bam_columns(spec.wl, 0, 0)
        total = int(cols0.sum())
        low_dots = split * split
        active = float(total - low_dots + 0.15 * (2 * split - 1))
        return {"total": float(total), "active": active,
                "cols": _bam_columns(spec.wl, 0, 0), "cols0": cols0}
    elif spec.name == "kulkarni":
        cells0, _ = _kulkarni_cells(spec.wl, 0)
        cells, _ = _kulkarni_cells(spec.wl, spec.param)
        return {"total": 4 * cells0, "active": 4 * cells,
                "cols": np.array([]), "cols0": np.array([])}
    else:
        raise ValueError(spec.name)
    return {"total": float(total), "active": float(total - nullified),
            "cols": cols, "cols0": cols0}


# ----------------------------------------------------------------------------
# Calibrated model
# ----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class HwParams:
    a_dot: float
    a_rec: float
    a_cpa: float
    p_dot: float
    p_rec: float
    p_cpa: float
    phi: float        # glitch-propagation factor (per live right-hand dot)
    t_rec: float      # ns
    t_csa: float      # ns per log2 compressor level
    t_cpa: float      # ns per log2 CPA bit


def _propagated_activity(cols: np.ndarray, phi: float) -> float:
    """sum_c r_c * (1 + phi * live-dots-right-of-c)."""
    cols = cols.astype(np.float64)
    cum_right = np.concatenate([[0.0], np.cumsum(cols)[:-1]])
    return float(np.sum(cols * (1.0 + phi * cum_right)))


def _area_raw(p: "HwParams", wl: int, vbl: int) -> float:
    inv = dot_inventory(MulSpec("bbm0", wl, vbl))
    return (p.a_dot * inv["active"] + p.a_rec * (wl // 2)
            + p.a_cpa * (2 * wl - vbl))


def _power_raw(p: "HwParams", wl: int, vbl: int) -> float:
    cols = _booth_columns(wl, vbl)
    act = _propagated_activity(cols, p.phi)
    return p.p_dot * act + p.p_rec * (wl // 2) + p.p_cpa * (2 * wl - vbl)


@lru_cache(maxsize=1)
def calibrate() -> HwParams:
    """Fit global coefficients to the paper's Tables II/III + T_min pair."""
    wls = [4, 8, 12, 16]

    def area_res(x):
        a_rec, a_cpa = x
        p = HwParams(1.0, a_rec, a_cpa, 1.0, 0, 0, 0, 0, 0, 0)
        return [100 * (1 - _area_raw(p, wl, wl - 1) / _area_raw(p, wl, 0))
                - PAPER_AREA_REDUCTION[wl] for wl in wls]

    asol = least_squares(area_res, np.array([2.0, 1.0]),
                         bounds=([0, 0], [50, 50]))
    a_rec, a_cpa = asol.x

    def power_res(x):
        p_rec, p_cpa, phi = x
        p = HwParams(1.0, 0, 0, 1.0, p_rec, p_cpa, phi, 0, 0, 0)
        return [100 * (1 - _power_raw(p, wl, wl - 1) / _power_raw(p, wl, 0))
                - PAPER_POWER_REDUCTION[wl] for wl in wls]

    psol = least_squares(power_res, np.array([2.0, 1.0, 0.05]),
                         bounds=([0, 0, 0], [50, 50, 1.0]))
    p_rec, p_cpa, phi = psol.x

    # delay terms: two equations (accurate & approx T_min at wl=16), plus a
    # fixed recode latency of 0.15 ns (one gate level + wiring in 90 nm).
    t_rec = 0.15
    cols_acc = _booth_columns(16, 0)
    cols_app = _booth_columns(16, 15)

    def dres(x):
        t_csa, t_cpa = x
        da = t_rec + t_csa * np.log2(cols_acc.max()) + t_cpa * np.log2(32)
        dp = t_rec + t_csa * np.log2(cols_app.max()) + t_cpa * np.log2(32 - 15)
        return [da - PAPER_TMIN_ACCURATE_NS, dp - PAPER_TMIN_APPROX_NS]

    dsol = least_squares(dres, np.array([0.2, 0.1]), bounds=(0, 2))
    t_csa, t_cpa = dsol.x
    return HwParams(1.0, a_rec, a_cpa, 1.0, p_rec, p_cpa, phi,
                    t_rec, t_csa, t_cpa)


# ----------------------------------------------------------------------------
# Public model queries
# ----------------------------------------------------------------------------
def area(spec: MulSpec) -> float:
    """Relative area (a.u.); booth-family uses the calibrated fit."""
    p = calibrate()
    if spec.name in ("booth", "bbm0", "bbm1"):
        vbl = 0 if spec.name == "booth" else spec.param
        return _area_raw(p, spec.wl, vbl)
    inv = dot_inventory(spec)
    if spec.name == "bam":
        return p.a_dot * inv["active"] + p.a_cpa * (2 * spec.wl - spec.param)
    return p.a_dot * inv["active"] + p.a_cpa * 2 * spec.wl   # kulkarni


def power(spec: MulSpec) -> float:
    """Relative average power at a relaxed clock (a.u.)."""
    p = calibrate()
    if spec.name in ("booth", "bbm0", "bbm1"):
        vbl = 0 if spec.name == "booth" else spec.param
        pw = _power_raw(p, spec.wl, vbl)
        if spec.name == "bbm1":
            # Type1 drops whole row incrementers whose S dot is nullified:
            # a half-adder chain of ~(wl+2) bits, active on ~half the cycles
            # (P(neg row) = 1/2 under random inputs).
            n_dropped = sum(1 for i in range(spec.wl // 2)
                            if 2 * i < spec.param)
            pw -= 0.25 * (spec.wl + 2) * n_dropped * p.p_dot
        return pw
    inv = dot_inventory(spec)
    if spec.name == "bam":
        act = _propagated_activity(inv["cols"], p.phi)
        return p.p_dot * act + p.p_cpa * (2 * spec.wl - spec.param)
    if spec.name == "etm":
        inv2 = dot_inventory(spec)
        act = _propagated_activity(inv2["cols"], p.phi)
        frac = inv2["active"] / inv2["total"]
        return p.p_dot * act * frac + p.p_cpa * 2 * spec.wl
    _, switch = _kulkarni_cells(spec.wl, spec.param)
    return p.p_dot * 4 * switch + p.p_cpa * 2 * spec.wl


def tmin(spec: MulSpec) -> float:
    """Minimum achievable clock period (ns) under the delay model."""
    p = calibrate()
    if spec.name in ("booth", "bbm0", "bbm1"):
        vbl = 0 if spec.name == "booth" else spec.param
        cols = _booth_columns(spec.wl, vbl)
        cpa_bits = max(2 * spec.wl - vbl, 2)
    elif spec.name == "bam":
        cols = _bam_columns(spec.wl, spec.param, spec.hbl)
        cpa_bits = max(2 * spec.wl - spec.param, 2)
    elif spec.name == "etm":
        cols = _bam_columns(spec.wl, 0, 0)
        cpa_bits = 2 * spec.wl - spec.param
    else:  # kulkarni: ripple of 2x2 blocks ~ array of depth wl/2
        cols = np.array([max(spec.wl // 2, 2)])
        cpa_bits = 2 * spec.wl
    depth = max(float(cols.max()), 2.0)
    return p.t_rec + p.t_csa * np.log2(depth) + p.t_cpa * np.log2(cpa_bits)


def power_at(spec: MulSpec, t_ns: float) -> float:
    """Fig. 3 sizing curve: power grows hyperbolically approaching T_min."""
    t0 = tmin(spec)
    base = power(spec)
    # calibrated so P(2*Tmin) ~= base and P(Tmin) ~= 2.2*base (Fig. 3 shape)
    kappa = 0.35
    t_int = 0.75 * t0                      # intrinsic delay asymptote
    return base * (0.9 + kappa * (t0 - t_int) / max(t_ns - t_int, 1e-3))


def pdp_avg(spec: MulSpec, relaxed_ns: float = 1.75) -> float:
    """Average PDP of the paper's steps 2-4: min-delay PDP and 1.75 ns PDP."""
    t0 = tmin(spec)
    pdp_fast = power_at(spec, t0) * t0
    pdp_slow = power_at(spec, relaxed_ns) * relaxed_ns
    return 0.5 * (pdp_fast + pdp_slow)


# ----------------------------------------------------------------------------
# FIR filter power (Table IV calibration)
# ----------------------------------------------------------------------------
@lru_cache(maxsize=1)
def _fir_coeffs() -> Tuple[float, float, float]:
    """Solve P_filter = u*30*Pm(wl,vbl) + v*wl + w through Table IV's cases."""
    rows = []
    rhs = []
    for (wl, vbl), (_, _, _, pw) in PAPER_TABLE4.items():
        rows.append([FIR_TAPS * power(MulSpec("bbm0", wl, vbl)), wl, 1.0])
        rhs.append(pw)
    sol, *_ = np.linalg.lstsq(np.array(rows), np.array(rhs), rcond=None)
    return tuple(sol)


def fir_power(wl: int, vbl: int) -> float:
    """Modeled FIR filter power (mW) for the paper's 30-tap filter."""
    u, v, w = _fir_coeffs()
    return u * FIR_TAPS * power(MulSpec("bbm0", wl, vbl)) + v * wl + w


def fir_area(wl: int, vbl: int) -> float:
    """Modeled FIR area (um^2), scaled off case 1 of Table IV."""
    ref_area = PAPER_TABLE4[(16, 0)][2]
    # multipliers are ~55% of filter area at wl=16 (from case1 vs case3 slope)
    mult_frac = 0.55
    rel = area(MulSpec("bbm0", wl, vbl)) / area(MulSpec("bbm0", 16, 0))
    wl_frac = wl / 16.0
    return ref_area * (mult_frac * rel + (1 - mult_frac) * wl_frac)


def quap(snr_db: float, area_saving_pct: float, power_saving_pct: float) -> float:
    """QUAP = (SNR_out)^2 * area_saving(%) * power_saving(%) (paper Eq. 3)."""
    return (snr_db ** 2) * area_saving_pct * power_saving_pct
