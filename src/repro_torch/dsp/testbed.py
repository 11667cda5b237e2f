"""SNR testbed of Fig. 7 (Shim & Shanbhag, paper ref [12]).

Counterpart of ``repro.dsp.testbed``; the signals are numpy from a seed,
so both packages filter the same inputs.

Input  x[n] = d1[n] + d2[n] + d3[n] + eta[n]:
  d1 — desired signal, passband      [0,        0.25*pi]
  d2 — on the transition band        [0.35*pi,  0.60*pi]
  d3 — in the stopband               [0.70*pi,  0.95*pi]
  each d_i unit-power white Gaussian noise ideally band-limited to a
  0.25*pi-wide band; eta white Gaussian noise at -30 dB PSD.

    SNR_out = 10 log10( var(d1) / E|d1 - y|^2 )   (y: filter output)

The filter's integer group delay is compensated before differencing.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.multipliers import MulSpec
from .fir import FIR_DELAY, design_lowpass, fir_apply, fir_apply_real

__all__ = ["TestSignals", "make_signals", "make_filterbank_signals",
           "snr_db", "run_filter_case", "run_filterbank_case"]

BANDS = [(0.0, 0.125), (0.175, 0.30), (0.35, 0.475)]  # cycles/sample
NOISE_PSD_DB = -30.0


@dataclasses.dataclass
class TestSignals:
    x: np.ndarray        # filter input
    d1: np.ndarray       # desired signal
    n: int


def _bandlimited_noise(rng, n: int, lo: float, hi: float) -> np.ndarray:
    """Unit-power Gaussian noise ideally band-limited to [lo, hi] c/s."""
    spec = np.fft.rfft(rng.standard_normal(n))
    f = np.fft.rfftfreq(n)
    mask = (f >= lo) & (f <= hi)
    spec[~mask] = 0.0
    sig = np.fft.irfft(spec, n)
    return sig / sig.std()


def make_signals(n: int = 1 << 14, seed: int = 0) -> TestSignals:
    rng = np.random.default_rng(seed)
    d = [_bandlimited_noise(rng, n, lo, hi) for lo, hi in BANDS]
    eta = rng.standard_normal(n) * np.sqrt(10.0 ** (NOISE_PSD_DB / 10.0))
    x = d[0] + d[1] + d[2] + eta
    return TestSignals(x=x, d1=d[0], n=n)


def snr_db(d1: np.ndarray, y: np.ndarray, delay: int = 0) -> float:
    """10 log10(var(d1) / E|d1 - y|^2) with delay compensation."""
    if delay:
        d1a = d1[: len(d1) - delay]
        ya = y[delay:]
    else:
        d1a, ya = d1, y
    # trim filter warm-up
    d1a, ya = d1a[64:], ya[64:]
    err = d1a - ya
    return 10.0 * np.log10(np.var(d1a) / np.mean(err * err))


def run_filter_case(spec: MulSpec | None, signals: TestSignals | None = None,
                    h: np.ndarray | None = None, *, backend: str = "host",
                    device=None) -> float:
    """SNR_out for one filter realization.

    spec=None -> double-precision filter; otherwise the fixed-point filter
    with the given multiplier spec through ``fir_apply`` on ``device``.
    """
    sig = signals or make_signals()
    hh = design_lowpass() if h is None else h
    if spec is None:
        y = fir_apply_real(sig.x, hh)
    else:
        # host keeps the exact full-precision accumulation; the int32
        # kernel backend needs the minimal safe rescale at wl = 16
        shift = 0 if backend == "host" else None
        y = fir_apply(sig.x, hh, spec, backend=backend, shift=shift,
                      device=device)
    return snr_db(sig.d1, y, FIR_DELAY)


def make_filterbank_signals(channels: int, n: int = 1 << 13,
                            seed: int = 0) -> list[TestSignals]:
    """Independent testbed realizations, one per filterbank channel."""
    return [make_signals(n=n, seed=seed + c) for c in range(channels)]


def run_filterbank_case(spec: MulSpec | None, channels: int = 4, *,
                        signals: list[TestSignals] | None = None,
                        h_banks: np.ndarray | None = None,
                        backend: str = "host", n: int = 1 << 13,
                        device=None) -> list[float]:
    """Per-channel SNR_out for a multi-channel filterbank run; channels
    alternate between two tap banks by default (the paper's design plus a
    re-weighted variant)."""
    sigs = signals or make_filterbank_signals(channels, n=n)
    if h_banks is None:
        h_banks = np.stack([design_lowpass(), design_lowpass(
            stop_weight=0.5)])
    x = np.stack([s.x for s in sigs])
    h = h_banks[np.arange(channels) % len(h_banks)]
    if spec is None:
        y = fir_apply_real(x, h)
    else:
        y = fir_apply(x, h, spec, backend=backend, device=device)
    return [snr_db(s.d1, y[c], FIR_DELAY) for c, s in enumerate(sigs)]
