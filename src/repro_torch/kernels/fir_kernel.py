"""Multi-channel direct-form FIR filterbank with Broken-Booth tap products.

Counterpart of ``repro.kernels.fir_kernel``:

    y[c, n] = sum_k shift(bbm(x[c, n-k], h[c, k]))

for ``C`` channels, each with its own wl-bit tap bank, zero initial
state, and an optional per-product arithmetic right shift (the MAC
rescale that keeps the int32 accumulator inside its envelope).  Two
hand-written CUDA kernels compute it (``csrc/fir_bank.cu``), each with a
plain PyTorch version of the same function beside it:

  ``fir_bank_rows``  replaces the Pallas kernel
      ``repro/kernels/fir_kernel.py::_fir_bank_kernel``: walks the wl/2
      Booth rows of every tap product (``form="rows"``).
  ``fir_bank_dot``   replaces the XLA dot form
      ``repro/kernels/fir_kernel.py::_fir_bank_dotform``: the exact
      contraction against ``bq`` plus the ``ceil(vbl/2)`` truncated rows
      (``form="dot"``).

What bounds them on the H100: int32 ALU issue.  A (C, N) call moves only
8*C*N bytes but evaluates about C*N*taps*wl/2 rows (rows) or does
C*N*taps*(1 + ceil(vbl/2)) multiply-adds (dot).  Each block therefore
keeps all operands of that arithmetic in shared memory: its samples plus
the taps-1 before them (read straight from device memory, so blocks need
no carried halo and run in any order) and its channel's digit planes,
packed one word per tap.

A wrapper runs the plain version only for tensors on the CPU.  For CUDA
tensors it launches its kernel or raises; it never falls back.  Each
wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.booth import num_pp_rows
from .booth_rows import (bbm_rows_product_precoded, booth_high_value,
                         booth_precode, resolve_form, scaled_trunc_rows,
                         split_signed)

__all__ = ["auto_form", "fir_bank_dot", "fir_bank_dot_plain",
           "fir_bank_rows", "fir_bank_rows_plain", "fir_bbm",
           "fir_bbm_bank", "fir_bbm_bank_precoded", "min_safe_shift"]

# auto-form only: above this many int32 elements (C * N * taps) a GPU call
# keeps the streaming rows kernel, as the reference's accelerator rule
# does; an explicit form="dot" is honored regardless
_DOT_WINDOW_BUDGET = 1 << 26

# shared memory a block may use on Hopper (227 KB)
_SMEM_LIMIT = 232448
_TILE = 512          # outputs per block, kThreads * kPerThread in the source


def min_safe_shift(taps: int, wl: int) -> int:
    """Smallest per-product shift keeping the int32 accumulator safe."""
    shift = 0
    while taps * (2 ** max(2 * wl - 1 - shift, 0)) >= 2 ** 31:
        shift += 1
    return shift


def _check_envelope(taps: int, wl: int, shift: int) -> None:
    if taps * (2 ** max(2 * wl - 1 - shift, 0)) >= 2 ** 31:
        raise ValueError(
            f"accumulator may overflow int32: taps={taps}, wl={wl}, "
            f"shift={shift}; raise `shift` to >= {min_safe_shift(taps, wl)}")


def auto_form(form, channels: int, n: int, taps: int, device) -> str:
    """The accumulate form a call runs: "rows" or "dot".

    ``form=None`` picks the dot form, except on the GPU when
    ``channels * n * taps`` exceeds ``_DOT_WINDOW_BUDGET``: then the
    streaming rows kernel (the reference's accelerator rule, keyed here on
    the tensors' device instead of the JAX backend).
    """
    if form is None and torch.device(device).type == "cuda" \
            and channels * n * taps > _DOT_WINDOW_BUDGET:
        return "rows"
    return resolve_form(form)


def _check_operands(x, planes, *, wl: int, vbl: int, shift: int,
                    extra_smem: int) -> int:
    """Refuse what the kernels do not take; returns ``taps``."""
    for t in (x,) + planes:
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError("fir_bank kernels take int32 tensors, got "
                            f"{getattr(t, 'dtype', type(t))}")
        if not t.is_contiguous():
            raise ValueError("fir_bank kernels take contiguous tensors")
        if t.device != x.device:
            raise ValueError(f"operands on {t.device} and {x.device}")
    hmag, hneg = planes
    if x.dim() != 2 or hmag.dim() != 3 or hmag.shape != hneg.shape:
        raise ValueError(f"expected x (C, N) and planes (wl//2, C, taps), "
                         f"got {tuple(x.shape)}, {tuple(hmag.shape)}, "
                         f"{tuple(hneg.shape)}")
    n_rows, hc, taps = hmag.shape
    if n_rows != num_pp_rows(wl) or hc != x.shape[0] or taps < 1:
        raise ValueError(f"digit planes {tuple(hmag.shape)} do not match "
                         f"wl={wl}, channels={x.shape[0]}")
    if not (2 <= wl <= 16 and 0 <= vbl <= min(2 * wl, 31)
            and 0 <= shift <= 31):
        raise ValueError(f"unsupported wl={wl}, vbl={vbl}, shift={shift}")
    _check_envelope(taps, wl, shift)
    if x.is_cuda:
        smem = 4 * (_TILE + 2 * taps - 1) + extra_smem * taps
        if smem > _SMEM_LIMIT or x.shape[0] > 65535:
            raise ValueError(f"{taps} taps x {x.shape[0]} channels exceed "
                             f"the kernel's shared memory or grid")
    return taps


def _launch(fn_name: str, x, *ptrs, wl: int, vbl: int, kind: int,
            shift: int, taps: int) -> torch.Tensor:
    from ._build import library
    lib = library("fir_bank")
    out = torch.empty_like(x)
    channels, n = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, fn_name)(
            x.data_ptr(), *(p.data_ptr() for p in ptrs), out.data_ptr(),
            channels, n, taps, wl, vbl, kind, shift, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err} "
                           f"({lib.fir_bank_error_string(err).decode()})")
    return out


# ----------------------------------------------------------- rows kernel
def fir_bank_rows_plain(x, hmag, hneg, *, wl: int, vbl: int, kind: int,
                        shift: int) -> torch.Tensor:
    """Plain PyTorch version of the rows kernel: the per-tap
    ``bbm_rows_product_precoded`` loop over the zero-padded delay line."""
    n = x.shape[1]
    taps = hmag.shape[2]
    _, x_s = split_signed(x, wl)
    xp = F.pad(x_s, (taps - 1, 0))
    acc = torch.zeros_like(x_s)
    for k in range(taps):
        a_s = xp[:, taps - 1 - k:taps - 1 - k + n]
        prod = bbm_rows_product_precoded(
            a_s, hmag[:, :, k, None], hneg[:, :, k, None], wl=wl, vbl=vbl,
            kind=kind, multiply_free=True)
        if shift:
            prod = prod >> shift
        acc = acc + prod
    return acc


def fir_bank_rows(x, hmag, hneg, *, wl: int, vbl: int, kind: int = 0,
                  shift: int = 0) -> torch.Tensor:
    """Rows-form filterbank: x (C, N) int32 codes, planes (wl//2, C, taps).

    CUDA tensors launch the ``fir_bank_rows`` kernel; CPU tensors run
    ``fir_bank_rows_plain``.  Returns (C, N) int32 accumulator values.
    """
    taps = _check_operands(x, (hmag, hneg), wl=wl, vbl=vbl, shift=shift,
                           extra_smem=0)
    if not x.is_cuda:
        return fir_bank_rows_plain(x, hmag, hneg, wl=wl, vbl=vbl, kind=kind,
                                   shift=shift)
    if x.numel() == 0:
        return torch.empty_like(x)
    out = _launch("fir_bank_rows_launch", x, hmag, hneg, wl=wl, vbl=vbl,
                  kind=kind, shift=shift, taps=taps)
    fir_bank_rows.launches += 1
    return out


fir_bank_rows.launches = 0


# ------------------------------------------------------------ dot kernel
def fir_bank_dot_plain(x, hmag, hneg, *, wl: int, vbl: int, kind: int,
                       shift: int) -> torch.Tensor:
    """Plain PyTorch version of the dot kernel: the per-tap branch of the
    reference's ``_fir_bank_dotform``.  Every Broken-Booth product is
    ``2^vbl * (a*bq + Q)``, accumulated at scale ``2^-max(vbl, shift)``."""
    n = x.shape[1]
    taps = hmag.shape[2]
    _, x_s = split_signed(x, wl)
    bq = booth_high_value(hmag, hneg, wl=wl, vbl=vbl)        # (C, taps)
    xp = F.pad(x_s, (taps - 1, 0))
    u = max(shift - vbl, 0)       # per-product residual rescale
    acc = torch.zeros_like(x_s)
    for k in range(taps):
        a = xp[:, taps - 1 - k:taps - 1 - k + n]
        m_k = a * bq[:, k:k + 1]
        q = scaled_trunc_rows(a, hmag[:, :, k, None], hneg[:, :, k, None],
                              wl=wl, vbl=vbl, kind=kind)
        if q is not None:
            m_k = m_k + q
        if u:
            m_k = m_k >> u        # shift > vbl: floor per product
        acc = acc + m_k
    if vbl > shift:
        acc = acc << (vbl - shift)
    return acc


def fir_bank_dot(x, hmag, hneg, *, wl: int, vbl: int, kind: int = 0,
                 shift: int = 0) -> torch.Tensor:
    """Dot-form filterbank, same contract as ``fir_bank_rows``.

    ``bq = booth_high_value(planes)`` is bank-sized setup in plain torch;
    CUDA tensors then launch the ``fir_bank_dot`` kernel, CPU tensors run
    ``fir_bank_dot_plain``.
    """
    taps = _check_operands(x, (hmag, hneg), wl=wl, vbl=vbl, shift=shift,
                           extra_smem=4)
    if not x.is_cuda:
        return fir_bank_dot_plain(x, hmag, hneg, wl=wl, vbl=vbl, kind=kind,
                                  shift=shift)
    if x.numel() == 0:
        return torch.empty_like(x)
    bq = booth_high_value(hmag, hneg, wl=wl, vbl=vbl).to(torch.int32)
    out = _launch("fir_bank_dot_launch", x, bq.contiguous(), hmag, hneg,
                  wl=wl, vbl=vbl, kind=kind, shift=shift, taps=taps)
    fir_bank_dot.launches += 1
    return out


fir_bank_dot.launches = 0


# ----------------------------------------------------------- entry points
def fir_bbm_bank_precoded(x, hmag, hneg, *, wl: int, vbl: int, kind: int = 0,
                          shift: int = 0, form: str | None = None):
    """Broken-Booth FIR filterbank on precoded tap-digit planes.

    x: (C, N) int32 wl-bit signal codes, one row per channel.
    hmag, hneg: (wl//2, C, taps) int32 digit planes from ``booth_precode``
        of the (C, taps) tap bank.
    form: "rows", "dot" or None (auto, see ``auto_form``).  Bit-identical
        either way.  Runs on the tensors' device.
    Returns (C, N) int32 accumulator values (sum of shifted products).
    The kernel wrappers check shapes and the int32 envelope before any
    dispatch.
    """
    channels, n = x.shape
    kernel = fir_bank_dot if auto_form(form, channels, n, hmag.shape[-1],
                                       x.device) == "dot" else fir_bank_rows
    return kernel(x.contiguous(), hmag.contiguous(), hneg.contiguous(),
                  wl=wl, vbl=vbl, kind=kind, shift=shift)


def fir_bbm_bank(x, h, *, wl: int, vbl: int, kind: int = 0, shift: int = 0,
                 form: str | None = None):
    """Bit-exact Broken-Booth FIR filterbank from raw tap codes.

    x: (C, N) int32 codes; h: (C, taps) int32 tap codes, or (taps,) to
    share one bank across all channels.  Precodes ``h`` once and
    dispatches to ``fir_bbm_bank_precoded``.
    """
    if h.dim() == 1:
        h = h[None, :].expand(x.shape[0], h.shape[0])
    hmag, hneg = booth_precode(h, wl)
    return fir_bbm_bank_precoded(x, hmag, hneg, wl=wl, vbl=vbl, kind=kind,
                                 shift=shift, form=form)


def fir_bbm(x, h, *, wl: int, vbl: int, kind: int = 0, shift: int = 0,
            form: str | None = None):
    """Single-channel Broken-Booth FIR: x (N,) codes, h (taps,) codes."""
    return fir_bbm_bank(x[None, :], h[None, :], wl=wl, vbl=vbl, kind=kind,
                        shift=shift, form=form)[0]
