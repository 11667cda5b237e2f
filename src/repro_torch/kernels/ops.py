"""Public entry points on the port's kernels.

Counterpart of ``repro.kernels.ops``: the Broken-Booth matmul and
filterbank entry points, ``quant_matmul`` and ``flash_attention`` (which
take the tensors' device, as every kernel wrapper does).  Where the
reference picks Pallas' interpreter off-TPU, these take ``device``:
``None`` means the GPU (and raises without one), ``"cpu"`` runs the
kernels' plain versions.  Inputs may be numpy arrays or tensors; outputs
are int32 tensors on the device.  The int32 envelopes
``K * 2^(2*wl-1-shift) < 2^31`` (matmul) and ``taps * 2^(2*wl-1-shift)
< 2^31`` (filterbank) are checked before dispatch and cover both
accumulate forms.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .bbm_matmul import _matmul_envelope
from .bbm_matmul import bbm_matmul as _bbm_matmul
from .bbm_matmul import bbm_matmul_precoded as _bbm_matmul_precoded
from .fir_kernel import fir_bbm_bank, fir_bbm_bank_precoded
from .flash_attention import flash_attention
from .quant_matmul import quant_matmul

__all__ = ["bbm_matmul", "bbm_matmul_precoded", "fir_filterbank",
           "fir_filterbank_precoded", "flash_attention", "quant_matmul"]


def _on(t, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(t).to(device=dev, dtype=torch.int32)


def bbm_matmul(x, w, *, wl: int, vbl: int, kind: int = 0, shift: int = 0,
               form=None, device=None) -> torch.Tensor:
    """Bit-exact Broken-Booth matmul (int32 codes in/out): x (M, K), w
    (K, N).  form: "rows" | "dot" | None (auto), see
    ``kernels.bbm_matmul.matmul_form``."""
    _matmul_envelope(np.shape(x)[-1], wl, shift)
    dev = resolve_device(device)
    return _bbm_matmul(_on(x, dev), _on(w, dev), wl=wl, vbl=vbl, kind=kind,
                       shift=shift, form=form)


def bbm_matmul_precoded(x, wmag, wneg, *, wl: int, vbl: int, kind: int = 0,
                        shift: int = 0, form=None,
                        device=None) -> torch.Tensor:
    """Broken-Booth matmul on precoded weight-digit planes.

    wmag, wneg: (wl//2, K, N) planes from ``booth_precode``: decode the
    constant weight operand once, reuse across calls.
    """
    _matmul_envelope(np.shape(x)[-1], wl, shift)
    dev = resolve_device(device)
    return _bbm_matmul_precoded(_on(x, dev), _on(wmag, dev), _on(wneg, dev),
                                wl=wl, vbl=vbl, kind=kind, shift=shift,
                                form=form)


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
