"""Public filterbank entry points on the port's kernels.

Counterpart of the filterbank half of ``repro.kernels.ops``.  Where the
reference picks Pallas' interpreter off-TPU, these take ``device``:
``None`` means the GPU (and raises without one), ``"cpu"`` runs the
kernels' plain versions.  Inputs may be numpy arrays or tensors; outputs
are int32 tensors on the device.  The int32 envelope
``taps * 2^(2*wl-1-shift) < 2^31`` is checked before dispatch and covers
both accumulate forms.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from .fir_kernel import fir_bbm_bank, fir_bbm_bank_precoded

__all__ = ["fir_filterbank", "fir_filterbank_precoded"]


def _on(t, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(t).to(device=dev, dtype=torch.int32)


def fir_filterbank(x, h, *, wl: int, vbl: int, kind: int = 0,
                   shift: int = 0, form=None, device=None) -> torch.Tensor:
    """Batched multi-channel Broken-Booth FIR (int32 codes in/out).

    x: (C, N) signal codes, h: (C, taps) per-channel tap banks (or
    (taps,) shared).
    """
    dev = resolve_device(device)
    return fir_bbm_bank(_on(x, dev), _on(h, dev), wl=wl, vbl=vbl, kind=kind,
                        shift=shift, form=form)


def fir_filterbank_precoded(x, hmag, hneg, *, wl: int, vbl: int,
                            kind: int = 0, shift: int = 0, form=None,
                            device=None) -> torch.Tensor:
    """Filterbank on precoded tap-digit planes (int32 codes in/out).

    hmag, hneg: (wl//2, C, taps) digit planes from ``booth_precode``;
    decode once per bank, reuse across every call that shares it.
    """
    dev = resolve_device(device)
    return fir_bbm_bank_precoded(_on(x, dev), _on(hmag, dev), _on(hneg, dev),
                                 wl=wl, vbl=vbl, kind=kind, shift=shift,
                                 form=form)
