"""Carry the reference's parameters across to the port, through numpy.

For the filterbank slice the parameters are the tap banks: the arrays of
a reference ``PrecodedBank`` (real taps, int64 codes, digit planes)
become the port's bank, so both packages then compute the same thing.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.multipliers import MulSpec
from .device import resolve_device
from .dsp.fir import PrecodedBank

__all__ = ["precoded_bank_from_numpy"]


def precoded_bank_from_numpy(h_real, hq, mag, neg, spec, *,
                             device=None) -> PrecodedBank:
    """A ``PrecodedBank`` holding the given arrays as they are.

    h_real: (B, taps) float64 real taps; hq: (B, taps) int64 codes;
    mag, neg: (wl//2, B, taps) digit planes, or both ``None`` for specs
    without planes.  ``spec`` is any object with the ``MulSpec`` fields
    (the reference's own spec works).  Nothing is re-quantized or
    re-decoded.
    """
    spec = MulSpec(spec.name, spec.wl, spec.param, spec.hbl)
    h_real = np.atleast_2d(np.asarray(h_real, np.float64))
    hq = np.asarray(hq, np.int64).reshape(h_real.shape)
    bank = object.__new__(PrecodedBank)
    bank.spec = spec
    bank.device = resolve_device(device)
    bank.h_real = h_real
    bank.hq = hq
    bank._planes = None
    if (mag is None) != (neg is None):
        raise ValueError("pass both digit planes or neither")
    if mag is not None:
        shape = (spec.wl // 2,) + hq.shape
        planes = tuple(np.asarray(p) for p in (mag, neg))
        if any(p.shape != shape for p in planes):
            raise ValueError(f"digit planes must be {shape}, got "
                             f"{[p.shape for p in planes]}")
        bank._planes = tuple(
            torch.from_numpy(p.astype(np.int32)).to(bank.device)
            for p in planes)
    return bank
