"""Fixed-point FIR filtering built on approximate multipliers (paper §III.C).

Counterpart of ``repro.dsp.fir``: a 30-tap-order Parks--McClellan
low-pass filter whose tap multipliers are Broken-Booth multipliers,
modelled bit-exactly:

  * samples and coefficients quantized to Q(1, wl-1) in host float64,
  * every tap product from the selected multiplier, with an optional
    per-product arithmetic right shift (the fixed-point MAC rescale),
  * products accumulated at full precision.

``fir_apply`` is the one datapath entry point, for single signals (N,) or
filterbanks (C, N) with per-channel tap banks (C, taps), as real taps or
a ``PrecodedBank``.  Backends:

  backend="host"  the reference's host datapath: per-tap accumulate or the
                  dot form on the bank's digit planes; supports every
                  datapath ("full" / "wlbit") and falls back to the
                  windowed (C, N, taps) product array off the hot path
  backend="cuda"  the filterbank kernels (``kernels.fir_bbm_bank_precoded``),
                  the counterpart of the reference's "pallas"; Booth-family
                  specs, full-precision datapath

Both run on ``device``: ``None`` is the GPU, where every Booth-family hot
path launches a hand-written kernel; ``"cpu"`` runs the kernels' plain
versions (the role of the reference's "pallas-interpret").  Quantize and
descale stay in host numpy float64, pinned by the bit-exactness
contract; only the int32 codes cross to the device, one copy each way
per dispatch.  For Booth-family specs every backend and device gives the
same floats, bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.signal import remez

from ..core.multipliers import MulSpec, mul
from ..device import resolve_device
from ..kernels.booth_rows import booth_precode, resolve_form
from ..kernels.fir_kernel import auto_form, fir_bbm_bank_precoded, \
    min_safe_shift
from .fixed_point import requant_scale

__all__ = ["design_lowpass", "fir_apply_real", "fir_apply",
           "fir_apply_fixed", "PrecodedBank", "FIR_DELAY", "BBM_KINDS"]

# paper testbed: passband edge 0.25*pi, guard (transition) band 0.1*pi
PASS_EDGE = 0.125      # in cycles/sample (omega / 2pi)
STOP_EDGE = 0.175
NUM_TAPS = 31          # order 30 -> integer group delay of 15
FIR_DELAY = (NUM_TAPS - 1) // 2

# specs the kernels implement natively: name -> closed-form kind
BBM_KINDS = {"booth": 0, "bbm0": 0, "bbm1": 1}


def design_lowpass(num_taps: int = NUM_TAPS,
                   stop_weight: float = 0.27) -> np.ndarray:
    """Parks-McClellan equiripple low-pass design for the paper's testbed.

    ``stop_weight`` is calibrated so the double-precision testbed gives
    the paper's SNR_out of 25.7 dB (docs/filterbank.md §Testbed
    calibration).
    """
    h = remez(num_taps, [0.0, PASS_EDGE, STOP_EDGE, 0.5], [1.0, 0.0],
              weight=[1.0, stop_weight])
    return h.astype(np.float64)


def fir_apply_real(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """Double-precision reference filtering (same alignment as fixed path).

    Accepts (N,)/(taps,) or batched (C, N)/(C, taps) like ``fir_apply``.
    """
    x2, h2, squeeze = _normalize(np.asarray(x, np.float64),
                                 np.asarray(h, np.float64))
    y = np.stack([np.convolve(x2[c], h2[c], mode="full")[: x2.shape[1]]
                  for c in range(x2.shape[0])])
    return y[0] if squeeze else y


def _normalize(x, h):
    """-> (x (C, N), h (C, taps), squeeze) with h broadcast per channel."""
    x = np.asarray(x)
    h = np.asarray(h)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    if h.ndim == 1:
        h = np.broadcast_to(h, (x.shape[0], h.shape[0]))
    if h.shape[0] != x.shape[0]:
        raise ValueError(f"{h.shape[0]} tap banks for {x.shape[0]} channels")
    return x, h, squeeze


def _window(x_int: torch.Tensor, taps: int) -> torch.Tensor:
    """(..., n, taps) sliding window of past samples: w[.., n, k] = x[.., n-k].

    Positions before the signal start hold zero codes (the delay line's
    initial state); only the fallback path materializes this array.
    """
    n = x_int.shape[-1]
    idx = (torch.arange(n, device=x_int.device)[:, None]
           - torch.arange(taps, device=x_int.device)[None, :])
    return torch.where(idx >= 0, x_int[..., idx.clamp(min=0)], 0)


def _tap_products(x_int, h_int, spec: MulSpec) -> torch.Tensor:
    """(C, N, taps) per-tap products — windowed fallback path only."""
    w = _window(x_int, h_int.shape[-1])
    return mul(spec)(w, h_int[..., None, :])


def _delayed(xq: np.ndarray, k: int) -> np.ndarray:
    """x delayed by k samples with zero codes before the signal starts."""
    if k == 0:
        return xq
    xd = np.zeros_like(xq)
    xd[:, k:] = xq[:, :-k]
    return xd


def _descale(acc, wl: int, shift: int, amp: np.ndarray) -> np.ndarray:
    """Shared accumulator -> real mapping (identical across backends)."""
    return acc * float(1 << shift) / requant_scale(wl) / amp


def _amp(x2: np.ndarray) -> np.ndarray:
    """Per-channel input scale so |x| < 1 with headroom; undone at output.

    Per channel, so a channel's codes and output bits do not depend on
    what else shares the batch (serving determinism).
    """
    xmax = np.max(np.abs(x2), axis=-1, keepdims=True)
    return 1.0 / np.where(xmax > 0, 1.0001 * xmax, 1.0)


def _quantize64(x: np.ndarray, wl: int) -> np.ndarray:
    """Float64 host quantizer: real [-1,1) -> signed integers (int64),
    round half to even."""
    scale = float(1 << (wl - 1))
    return np.clip(np.round(np.asarray(x, np.float64) * scale),
                   -scale, scale - 1).astype(np.int64)


def _codes32(q: np.ndarray, wl: int) -> np.ndarray:
    """Signed integers -> masked wl-bit int32 codes for the device."""
    return (q & ((1 << wl) - 1)).astype(np.int32)


def _to_device(codes: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(codes)).to(device)


def _to_host(acc: torch.Tensor) -> np.ndarray:
    return acc.cpu().numpy().astype(np.float64)


class PrecodedBank:
    """Tap banks quantized and Booth-precoded once, reused across calls.

    h: (B, taps) real tap banks (or (taps,) for a single bank).  The
    digit planes (wl//2, B, taps) of Booth-family specs at wl <= 16 live
    on ``device`` (None: the GPU), ready for either accumulate form.
    ``take(idx)`` gathers per-request banks by index, never re-quantizing
    or re-decoding.  ``precode=False`` defers the decode to the first read
    of ``planes``.
    """

    def __init__(self, h, spec: MulSpec, *, precode: bool = True,
                 device=None):
        h2 = np.atleast_2d(np.asarray(h, np.float64))
        if h2.ndim != 2:
            raise ValueError(f"tap banks must be (B, taps), got {h2.shape}")
        self.spec = spec
        self.device = resolve_device(device)
        self.h_real = h2
        self.hq = _quantize64(h2, spec.wl)          # int64 host codes
        self._planes = None                         # (mag, neg) digit planes
        if precode:
            self.planes                             # eager decode, cached

    @property
    def num_banks(self) -> int:
        return self.h_real.shape[0]

    @property
    def taps(self) -> int:
        return self.h_real.shape[1]

    @property
    def planes(self):
        """(mag, neg) int32 digit planes of shape (wl//2, B, taps) on the
        bank's device; ``None`` for specs no kernel implements."""
        if self._planes is None and self.spec.name in BBM_KINDS \
                and self.spec.wl <= 16:
            codes = _to_device(_codes32(self.hq, self.spec.wl), self.device)
            self._planes = booth_precode(codes, self.spec.wl)
        return self._planes

    def take(self, idx) -> "PrecodedBank":
        """Bank rows gathered per request: an index, never a re-decode."""
        idx = np.asarray(idx, np.int64)
        out = object.__new__(PrecodedBank)
        out.spec = self.spec
        out.device = self.device
        out.h_real = self.h_real[idx]
        out.hq = self.hq[idx]
        out._planes = None if self._planes is None else tuple(
            p[:, _to_device(idx, self.device), :] for p in self._planes)
        return out


def fir_apply(x: np.ndarray, h, spec: MulSpec | None = None, *,
              backend: str = "host", datapath: str = "full",
              shift: int | None = None, form: str | None = None,
              device=None) -> np.ndarray:
    """Bit-exact fixed-point filtering with the given multiplier spec.

    x: (N,) or (C, N); h: real taps (taps,) or (C, taps), or a
    ``PrecodedBank`` whose rows match the channels (``spec`` then defaults
    to the bank's, and the bank must live on ``device``).  Output has the
    shape of ``x``, aligned with ``fir_apply_real``.

    datapath="full"  — products accumulated at full precision.
    datapath="wlbit" — each product rounded back to Q(1, wl-1) and summed
                       in a saturating wl-bit accumulator (host only).
    shift — per-product right shift before accumulation; ``None`` picks 0
    when the int32 envelope allows it and the minimal safe value
    otherwise (wl = 16 at 31 taps needs 5).
    form — Booth-family accumulate form: "rows", "dot" or None (auto).
    device — None (the GPU; raises without one) or "cpu".
    """
    resolve_form(form)     # validate early; selection happens per path
    dev = resolve_device(device)
    bank = h if isinstance(h, PrecodedBank) else None
    if bank is not None:
        if spec is not None and spec != bank.spec:
            raise ValueError(f"spec {spec} does not match the precoded "
                             f"bank's {bank.spec}")
        if bank.device != dev:
            raise ValueError(f"the bank lives on {bank.device}, the call "
                             f"runs on {dev}")
        spec = bank.spec
        x2 = np.asarray(x)
        squeeze = x2.ndim == 1
        if squeeze:
            x2 = x2[None, :]
        if bank.num_banks == 1 and x2.shape[0] > 1:
            bank = bank.take(np.zeros(x2.shape[0], np.int64))
        if bank.num_banks != x2.shape[0]:
            raise ValueError(f"{bank.num_banks} precoded banks for "
                             f"{x2.shape[0]} channels")
        taps = bank.taps
    else:
        if spec is None:
            raise ValueError("spec is required unless h is a PrecodedBank")
        x2, h2, squeeze = _normalize(x, h)
        taps = h2.shape[1]
    wl = spec.wl
    if shift is None:
        # the rescale exists for the int32 kernel envelope; wlbit models its
        # own rounding and wl > 16 only runs on the exact int64 host path
        shift = 0 if (datapath == "wlbit" or wl > 16) \
            else min_safe_shift(taps, wl)
    amp = _amp(x2)
    xq = _quantize64(x2 * amp, wl)
    if bank is None:
        # one-shot bank: the decode waits for the first ``planes`` read
        bank = PrecodedBank(h2, spec, precode=False, device=dev)
    if backend == "cuda":
        y = _apply_cuda(xq, bank, datapath=datapath, shift=shift, amp=amp,
                        form=form)
    elif backend == "host":
        y = _apply_host(xq, bank, datapath=datapath, shift=shift, amp=amp,
                        form=form)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return y[0] if squeeze else y


def _apply_cuda(xq, bank: PrecodedBank, *, datapath, shift, amp, form=None):
    """The filterbank kernels on the bank's cached digit planes: one copy
    of the codes in, one dispatch, one copy out."""
    spec = bank.spec
    if spec.name not in BBM_KINDS:
        raise ValueError(f"backend='cuda' supports Booth-family specs "
                         f"{sorted(BBM_KINDS)}, not {spec.name!r}")
    if datapath != "full":
        raise ValueError("backend='cuda' implements the full-precision "
                         "accumulator datapath only")
    wl = spec.wl
    if wl > 16:
        raise ValueError("the int32 kernel datapath supports wl <= 16")
    vbl = 0 if spec.name == "booth" else spec.param
    hmag, hneg = bank.planes
    out = fir_bbm_bank_precoded(_to_device(_codes32(xq, wl), bank.device),
                                hmag, hneg, wl=wl, vbl=vbl,
                                kind=BBM_KINDS[spec.name], shift=shift,
                                form=form)
    return _descale(_to_host(out), wl, shift, amp)


def _apply_host(xq, bank: PrecodedBank, *, datapath, shift, amp, form=None):
    """Host datapath: exact contraction or per-tap accumulate, by form.

      * exact specs run a per-tap loop in int64 numpy (any wl),
      * Booth-family approximate specs inside the int32 envelope run one
        dispatch on the bank's digit planes: the dot form by default, the
        rows form (the reference's per-tap ``_fir_accum_device``) for
        ``form="rows"`` or an oversized auto-form call on the GPU.  On the
        GPU both launch their kernel.

    Everything else (wlbit, non-Booth multipliers, sub-envelope shifts)
    falls back to the windowed (C, N, taps) product array.
    """
    spec = bank.spec
    wl = spec.wl
    hq = bank.hq
    taps = hq.shape[1]
    if datapath not in ("full", "wlbit"):
        raise ValueError(f"unknown datapath {datapath!r}")
    if datapath == "wlbit" and shift:
        raise ValueError("datapath='wlbit' models its own product rounding; "
                         "use shift=0")
    lim = float(1 << (wl - 1))

    booth_hot = (datapath == "full" and spec.name in BBM_KINDS
                 and wl <= 16 and min_safe_shift(taps, wl) <= shift)
    vbl = 0 if spec.name == "booth" else spec.param
    if booth_hot:
        if auto_form(form, xq.shape[0], xq.shape[1], taps,
                     bank.device) == "dot":
            hmag, hneg = bank.planes     # decoded once per bank, cached
            acc = fir_bbm_bank_precoded(
                _to_device(_codes32(xq, wl), bank.device), hmag, hneg,
                wl=wl, vbl=vbl, kind=BBM_KINDS[spec.name], shift=shift,
                form="dot")
            return _descale(_to_host(acc), wl, shift, amp)
    elif form == "dot":
        raise ValueError("form='dot' needs a Booth-family spec on the "
                         "full-precision datapath inside the int32 "
                         "envelope")

    if spec.is_exact:
        # exact quantized path in int64 numpy: valid for any wl
        acc = np.zeros(xq.shape, np.float64)
        for k in range(taps):
            prod = _delayed(xq, k) * hq[:, k:k + 1]
            if shift:
                prod = prod >> shift        # arithmetic shift == floor
            if datapath == "full":
                acc += prod.astype(np.float64)
            else:
                p_wl = np.clip(np.round(prod / lim), -lim, lim - 1)
                acc = np.clip(acc + p_wl, -lim, lim - 1)
        return _descale(acc, wl, shift, amp) if datapath == "full" \
            else acc / lim / amp

    if wl > 16:
        raise ValueError("approximate fixed-point path supports wl <= 16 "
                         "(int32-exact); the paper's operating point is 16")
    xc = _to_device(_codes32(xq, wl), bank.device)
    if booth_hot:
        hmag, hneg = bank.planes
        acc = fir_bbm_bank_precoded(xc, hmag, hneg, wl=wl, vbl=vbl,
                                    kind=BBM_KINDS[spec.name], shift=shift,
                                    form="rows")
        return _descale(_to_host(acc), wl, shift, amp)

    # windowed fallback: per-tap products materialized, then reduced
    hc = _to_device(_codes32(hq, wl), bank.device)
    prod = _tap_products(xc, hc, spec).cpu().numpy().astype(np.int64)
    if shift:
        prod = prod >> shift
    if datapath == "full":
        return _descale(prod.astype(np.float64).sum(axis=-1), wl, shift, amp)
    # round each 2wl-bit product back to Q(1, wl-1), saturate, then sum in a
    # saturating wl-bit accumulator (left-to-right tap order)
    p_wl = np.clip(np.round(prod.astype(np.float64) / lim), -lim, lim - 1)
    acc = np.zeros(prod.shape[:-1])
    for k in range(p_wl.shape[-1]):
        acc = np.clip(acc + p_wl[..., k], -lim, lim - 1)
    return acc / lim / amp


def fir_apply_fixed(x: np.ndarray, h: np.ndarray, spec: MulSpec,
                    datapath: str = "full", device=None) -> np.ndarray:
    """Original host-only entry point (shift 0)."""
    return fir_apply(x, h, spec, backend="host", datapath=datapath, shift=0,
                     device=device)
