"""Multi-channel direct-form FIR filterbank with Broken-Booth tap products.

Counterpart of ``repro.kernels.fir_kernel``:

    y[c, n] = sum_k shift(bbm(x[c, n-k], h[c, k]))

for ``C`` channels, each with its own wl-bit tap bank, zero initial
state, and an optional per-product arithmetic right shift (the MAC
rescale that keeps the int32 accumulator inside its envelope).  Two
wrappers compute it on the card (``csrc/fir_bank.cu``), each with a plain
PyTorch version of the same function beside it:

  ``fir_bank_rows``  replaces the Pallas kernel
      ``repro/kernels/fir_kernel.py::_fir_bank_kernel`` (``form="rows"``).
  ``fir_bank_dot``   replaces the XLA dot form
      ``repro/kernels/fir_kernel.py::_fir_bank_dotform`` (``form="dot"``).

Each has two routes on the card, chosen by ``fir_bank_route`` from (wl,
vbl, kind, shift, taps) alone:

  "mma"        wherever shift <= vbl, x and bq are not both two bytes
      wide and the band fits in shared memory (``csrc/fir_mma.cuh``).
      Every product is then ``2^vbl * M`` and each ``>> shift`` is exact,
      so the tap sum is one contraction: the floor split of the
      contracted dot form (``bbm_matmul.bbm_mma_operands``) as int8 byte
      products on the tensor cores, a banded (Toeplitz) product of the x
      window and the channel's taps (``fir_mma_band``), exact in two int32
      sums ``lo + 256 hi``.  Both wrappers take it: the forms are one
      function there.  ``fir_mma_emulated`` is its arithmetic on the CPU.
  "cuda-core"  the hand-written CUDA-core kernels, bound by int32 issue:
      ``fir_bank_rows`` walks the wl/2 Booth rows of every tap product,
      ``fir_bank_dot`` the exact contraction against ``bq`` plus the
      ``ceil(vbl/2)`` truncated rows, each block keeping its samples and
      its channel's digit planes in shared memory.  They serve shift > vbl
      (a floor per product: no contraction form), exact Booth's two-byte
      x and bq, and bands too large for shared memory.

A wrapper runs the plain version only for tensors on the CPU.  For CUDA
tensors it launches its route's kernel or raises; it never falls back.
Each wrapper counts its launches in ``<wrapper>.launches`` and the
tensor-core route's share in ``<wrapper>.mma_launches``; tests and
``chip_smoke.py`` force a route only through the private hooks
``_fir_bank_rows_on`` and ``_fir_bank_dot_on``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.booth import num_pp_rows
from .bbm_matmul import _mma_refusal, _wrap_i32, bbm_mma_operands, mma_widths
from .booth_rows import (bbm_rows_product_precoded, booth_high_value,
                         booth_precode, num_corr_rows, resolve_form,
                         scaled_trunc_rows, split_signed)

__all__ = ["auto_form", "fir_bank_dot", "fir_bank_dot_plain",
           "fir_bank_route", "fir_bank_rows", "fir_bank_rows_plain",
           "fir_bbm", "fir_bbm_bank", "fir_bbm_bank_precoded",
           "fir_mma_band", "fir_mma_emulated", "fir_mma_smem",
           "min_safe_shift"]

# auto-form only: above this many int32 elements (C * N * taps) a GPU call
# keeps the streaming rows kernel, as the reference's accelerator rule
# does; an explicit form="dot" is honored regardless
_DOT_WINDOW_BUDGET = 1 << 26

# shared memory a block may use on Hopper (227 KB)
_SMEM_LIMIT = 232448
_TILE = 512          # outputs per block, kThreads * kPerThread in the source

# the tensor-core route (csrc/fir_mma.cuh): outputs a row of the x window
# (the band's width, wgmma's N), the k step, and its most k steps
_MMA_B = 64
_MMA_K_STEP = 32
_MMA_MAX_K_STEPS = 16


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


def _check_operands(x, planes, *, wl: int, vbl: int, shift: int) -> int:
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
    if x.is_cuda and x.shape[0] > 65535:
        raise ValueError(f"{x.shape[0]} channels exceed the kernels' grid")
    return taps


# ---------------------------------------------------------------- routes
def fir_mma_band(taps: int) -> tuple:
    """The tensor-core route's band at ``taps``: (P, k steps, the live
    column range of each k step).  Row j of the x window holds samples
    ``64 j + m - P`` (m < 32 * k steps) and the band
    ``H[m][i] = h[i + P - m]`` where ``0 <= i + P - m < taps``, else 0,
    so ``y[64 j + i] = sum_m A[j][m] H[m][i]``; P is taps - 1 rounded up
    to a multiple of 4.  A k step whose band is zero in one half of the 64
    columns multiplies the other half only."""
    p = -(-(taps - 1) // 4) * 4
    steps = -(-(p + _MMA_B) // _MMA_K_STEP)
    cols = []
    for s in range(steps):
        lo = _MMA_K_STEP * s - p
        hi = _MMA_K_STEP * s + _MMA_K_STEP - 1 - p + taps - 1
        cols.append((0, 32) if hi < 32 else (32, 64) if lo >= 32
                    else (0, 64))
    return p, steps, cols


def fir_mma_smem(wl: int, vbl: int, kind: int, taps: int) -> int:
    """Shared memory (bytes) of the smallest tensor-core block: the band's
    byte planes (bq's, then d_r, B2_r and at kind 0 -I1_r, -I2_r per
    truncated row; 2 KB a plane a k step) and the staged x of one 64-row
    group (4-sample groups of 16-bit lanes, 40 words a 16 groups)."""
    _, bqb, _ = mma_widths(wl, vbl)
    planes = bqb + num_corr_rows(wl, vbl) * (2 if kind else 4)
    _, steps, _ = fir_mma_band(taps)
    groups = (_MMA_B * 63 + _MMA_K_STEP * steps) // 4
    return steps * planes * 32 * _MMA_B + 4 * 40 * -(-groups // 16)


def _fir_mma_refusal(wl: int, vbl: int, kind: int, shift: int, taps: int):
    """Why the tensor-core route cannot compute the call, or None."""
    why = _mma_refusal(wl, vbl, shift)
    if why is None and (fir_mma_band(taps)[1] > _MMA_MAX_K_STEPS
                        or fir_mma_smem(wl, vbl, kind, taps) > _SMEM_LIMIT):
        why = (f"the band of {taps} taps at wl={wl} vbl={vbl} kind={kind} "
               f"exceeds the kernel's shared memory")
    return why


def fir_bank_route(wl: int, vbl: int, kind: int, shift: int,
                   taps: int) -> str:
    """The route of a filterbank call on the card: "mma" (the int8 tensor
    cores) where shift <= vbl, x and bq need at most two significances
    together and the band fits in shared memory; else "cuda-core" (the
    CUDA-core rows and dot kernels).  A pure function of its arguments,
    the same for both wrappers; ``kind`` selects no route."""
    if kind not in (0, 1):
        raise ValueError(f"kind must be 0 or 1, got {kind}")
    if _fir_mma_refusal(wl, vbl, kind, shift, taps) is None:
        return "mma"
    return "cuda-core"


def _pick_route(name: str, route, wl: int, vbl: int, kind: int, shift: int,
                taps: int) -> str:
    """``route`` (forced by a test's hook, checked) or the rule's."""
    if route is None:
        return fir_bank_route(wl, vbl, kind, shift, taps)
    if route not in ("mma", "cuda-core"):
        raise ValueError(f"{name}: unknown route {route!r} (expected "
                         f"'mma', 'cuda-core' or None)")
    if kind not in (0, 1):
        raise ValueError(f"kind must be 0 or 1, got {kind}")
    why = _fir_mma_refusal(wl, vbl, kind, shift, taps) \
        if route == "mma" else None
    if why is not None:
        raise ValueError(f"{name}: route 'mma' cannot compute this call: "
                         f"{why}")
    return route


def fir_mma_emulated(x, hmag, hneg, *, wl: int, vbl: int, kind: int,
                     shift: int) -> torch.Tensor:
    """The tensor-core route's arithmetic in plain PyTorch (CPU): per
    channel, the x window's rows of 64 outputs (zero history before the
    signal, zeros past it) against the band of the taps' digit planes
    (``fir_mma_band``), the byte operands of ``bbm_mma_operands`` summed
    per k step over its live columns into ``lo`` and ``hi`` (exact in
    int64 here, modulo 2^32 in the kernel), then the epilogue: ``lo +
    256 hi``, at kind 1 plus the channel's constant ``-sum_k sum_{r<R}
    neg_r`` (the kernel's stand-in for the ones plane, which this drops),
    ``<< (vbl - shift)``, wrapping as int32.  For tests: no route calls
    it."""
    why = _mma_refusal(wl, vbl, shift)
    if why is not None:
        raise ValueError(why)
    c, n = x.shape
    taps = hmag.shape[2]
    p, steps, cols = fir_mma_band(taps)
    rows = max(-(-n // _MMA_B), 1)
    k = _MMA_K_STEP * steps
    _, xs = split_signed(x, wl)
    span = _MMA_B * (rows - 1) + k
    win = F.pad(xs.to(torch.int64), (p, span - p - n)).unfold(1, k, _MMA_B)
    idx = (torch.arange(_MMA_B)[None, :] + p
           - torch.arange(k)[:, None]).to(hmag.device)       # (K, 64)
    live = (idx >= 0) & (idx < taps)
    band = [torch.where(live, pl[:, :, idx.clamp(0, taps - 1)], 0)
            for pl in (hmag, hneg)]                          # (rows, C, K, 64)
    r_corr = num_corr_rows(wl, vbl)
    out = torch.empty((c, n), dtype=torch.int32)
    for ch in range(c):
        ops = bbm_mma_operands(win[ch], wmag=band[0][:, ch],
                               wneg=band[1][:, ch], wl=wl, vbl=vbl,
                               kind=kind)
        negc = 0
        if kind == 1 and r_corr:
            ops.pop()         # the ones plane against -sum_r neg_r
            negc = -int((hneg[:r_corr, ch].to(torch.int64) & 1).sum())
        part = [torch.zeros((rows, _MMA_B), dtype=torch.int64)
                for _ in range(2)]
        for s, (lo, hi) in enumerate(cols):
            ks = slice(_MMA_K_STEP * s, _MMA_K_STEP * (s + 1))
            for a, b, sig in ops:
                part[sig][:, lo:hi] += a[:, ks] @ b[ks, lo:hi]
        y = _wrap_i32(_wrap_i32(part[0]).to(torch.int64)
                      + 256 * _wrap_i32(part[1]).to(torch.int64) + negc)
        y = _wrap_i32(y.to(torch.int64) << (vbl - shift))
        out[ch] = y.reshape(-1)[:n]
    return out


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


def _check_cuda_core_smem(x, taps: int, extra_smem: int) -> None:
    """The CUDA-core kernels' block: its samples, the taps - 1 before
    them, and ``extra_smem`` bytes a tap."""
    if 4 * (_TILE + 2 * taps - 1) + extra_smem * taps > _SMEM_LIMIT:
        raise ValueError(f"{taps} taps exceed the CUDA-core kernels' "
                         f"shared memory")


def _run(wrapper, route, plain, x, hmag, hneg, *, wl: int, vbl: int,
         kind: int, shift: int) -> torch.Tensor:
    """A wrapper's call on ``route`` (checked; None: the rule's)."""
    name = wrapper.__name__
    taps = _check_operands(x, (hmag, hneg), wl=wl, vbl=vbl, shift=shift)
    route = _pick_route(name, route, wl, vbl, kind, shift, taps)
    if not x.is_cuda:
        return plain(x, hmag, hneg, wl=wl, vbl=vbl, kind=kind, shift=shift)
    if x.numel() == 0:
        return torch.empty_like(x)
    kw = dict(wl=wl, vbl=vbl, kind=kind, shift=shift, taps=taps)
    if route == "mma":
        out = _launch("fir_bank_mma_launch", x, hmag, hneg, **kw)
    elif wrapper is fir_bank_rows:
        _check_cuda_core_smem(x, taps, 0)
        out = _launch("fir_bank_rows_launch", x, hmag, hneg, **kw)
    else:
        _check_cuda_core_smem(x, taps, 4)
        bq = booth_high_value(hmag, hneg, wl=wl, vbl=vbl).to(torch.int32)
        out = _launch("fir_bank_dot_launch", x, bq.contiguous(), hmag, hneg,
                      **kw)
    wrapper.launches += 1
    wrapper.mma_launches += route == "mma"
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

    CUDA tensors launch ``fir_bank_route``'s kernel; CPU tensors run
    ``fir_bank_rows_plain``.  Returns (C, N) int32 accumulator values.
    """
    return _fir_bank_rows_on(None, x, hmag, hneg, wl=wl, vbl=vbl, kind=kind,
                             shift=shift)


def _fir_bank_rows_on(route, x, hmag, hneg, *, wl: int, vbl: int,
                      kind: int = 0, shift: int = 0) -> torch.Tensor:
    """``fir_bank_rows`` on ``route`` ("mma" or "cuda-core", checked: one
    that cannot compute the call raises, on any device; None: the
    rule's), the hook through which the tests and ``chip_smoke.py``
    force a route."""
    return _run(fir_bank_rows, route, fir_bank_rows_plain, x, hmag, hneg,
                wl=wl, vbl=vbl, kind=kind, shift=shift)


fir_bank_rows.launches = 0
fir_bank_rows.mma_launches = 0      # the tensor-core route's share


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

    CUDA tensors launch ``fir_bank_route``'s kernel (on the CUDA-core
    route after ``bq = booth_high_value(planes)``, bank-sized setup in
    plain torch); CPU tensors run ``fir_bank_dot_plain``.
    """
    return _fir_bank_dot_on(None, x, hmag, hneg, wl=wl, vbl=vbl, kind=kind,
                            shift=shift)


def _fir_bank_dot_on(route, x, hmag, hneg, *, wl: int, vbl: int,
                     kind: int = 0, shift: int = 0) -> torch.Tensor:
    """``fir_bank_dot`` on ``route``, as ``_fir_bank_rows_on``."""
    return _run(fir_bank_dot, route, fir_bank_dot_plain, x, hmag, hneg,
                wl=wl, vbl=vbl, kind=kind, shift=shift)


fir_bank_dot.launches = 0
fir_bank_dot.mma_launches = 0


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
