"""Runtime guards for the serving datapath.

Counterpart of ``repro.core.guards``.  The engine-facing half: the guard
configuration, the structured per-flush verdict, and the per-row finite
/ error-budget checks the filterbank engine runs on every flush, numpy
on the host.  The envelope half: ``code_range_check`` and
``scaled_bound_check``, which the reference writes as ``checkify``
checks inside a jitted function, are eager checks here, reduced on the
tensor's device and raised on the host as ``GuardError`` (a
``ValueError``, as the reference's ``JaxRuntimeError`` is) with the
reference's messages.  Outside ``checkify_call`` each check reads its
verdict at once; inside, the verdicts stay on the device until the
function returns, and the first that tripped is raised then (one
synchronization for all of them), as ``checkify``'s error value is.
No hot path calls them.
"""
from __future__ import annotations

import contextvars
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["GuardConfig", "GuardError", "GuardReport", "checkify_call",
           "code_range_check", "finite_rows", "guard_rows",
           "scaled_bound_check"]


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Which runtime guards an engine runs, and the error budget.

    ``budget_every = 0`` disables the (costly: one extra exact forward)
    budget audit; ``N > 0`` audits every Nth flush.  The budget is mean
    absolute error per audited row against the exact datapath — ``None``
    disables even on audited rows.
    """
    finite: bool = True
    envelope: bool = True
    budget_abs: Optional[float] = None
    budget_every: int = 0

    @property
    def budget_active(self) -> bool:
        return self.budget_every > 0 and self.budget_abs is not None


@dataclasses.dataclass
class GuardReport:
    """Structured verdict of one guarded flush.

    ``row_ok`` is the per-row verdict the degradation policy acts on;
    ``tripped`` names every guard that failed ("finite", "budget");
    ``nonfinite`` counts bad elements and ``budget_err`` is the worst
    audited per-row mean absolute error.
    """
    ok: bool = True
    row_ok: Optional[np.ndarray] = None
    tripped: Tuple[str, ...] = ()
    nonfinite: int = 0
    budget_err: Optional[float] = None

    def trip(self, name: str):
        self.ok = False
        if name not in self.tripped:
            self.tripped = self.tripped + (name,)


def finite_rows(y) -> np.ndarray:
    """Per-row finiteness verdict: (rows,) bool, True = every element
    finite; the reduction is over all trailing axes."""
    arr = np.asarray(y)
    return np.isfinite(arr).reshape(arr.shape[0], -1).all(axis=-1)


def guard_rows(y, cfg: GuardConfig, *, y_exact=None) -> GuardReport:
    """Run the configured host-side guards over a (rows, ...) output.

    ``y_exact``: exact-datapath reference for the same rows, passed on
    audited flushes only; when present and a budget is configured, rows
    whose mean absolute error exceeds ``budget_abs`` trip the budget
    guard.
    """
    arr = np.asarray(y)
    rep = GuardReport(row_ok=np.ones(arr.shape[0], bool))
    if cfg.finite:
        fin = finite_rows(arr)
        if not fin.all():
            rep.trip("finite")
            rep.nonfinite = int((~np.isfinite(arr)).sum())
            rep.row_ok &= fin
    if y_exact is not None and cfg.budget_abs is not None:
        ref = np.asarray(y_exact, np.float64)
        err = np.abs(arr.astype(np.float64) - ref)
        per_row = err.reshape(err.shape[0], -1).mean(axis=-1)
        # a non-finite row already tripped above; keep the budget verdict
        # meaningful for the finite rows
        per_row = np.where(np.isfinite(per_row), per_row, np.inf)
        rep.budget_err = float(per_row.max())
        over = per_row > cfg.budget_abs
        if over.any():
            rep.trip("budget")
            rep.row_ok &= ~over
    return rep


# ------------------------------------------------------- envelope checks
class GuardError(ValueError):
    """An envelope check tripped; the message is the reference's."""


# the verdicts (ok, message) deferred by the innermost checkify_call of
# this thread or task, or None outside one
_deferred: contextvars.ContextVar = contextvars.ContextVar("deferred",
                                                          default=None)


def _check(ok: torch.Tensor, msg: str) -> None:
    msg = f"{msg} (`check` failed)"
    checks = _deferred.get()
    if checks is not None:
        checks.append((ok, msg))
    elif not bool(ok):
        raise GuardError(msg)


def code_range_check(codes: torch.Tensor, wl: int,
                     what: str = "codes") -> None:
    """Every quantized code inside the signed wl-bit range.  The quantizer
    clips, so a trip means the datapath was handed codes it never
    produced: a corrupted cache entry, a fault injection's overreach, an
    integration bug."""
    lim = 1 << (wl - 1)
    _check(torch.all((codes >= -lim) & (codes < lim)),
           f"{what} outside the signed {wl}-bit envelope "
           f"[{-lim}, {lim - 1}]")


def scaled_bound_check(acc: torch.Tensor, bound: int,
                       what: str = "accumulator") -> None:
    """|scaled partial| within the dot form's int32 bound (``booth_rows
    .dotform_scaled_bound``, or any caller bound): the runtime
    counterpart of the static envelope assertion, catching what static
    analysis cannot (faulted planes, corrupted codes)."""
    _check(torch.max(torch.abs(acc)) <= bound,
           f"{what} left the int32 envelope (bound {int(bound)})")


def checkify_call(fn, *args, **kwargs):
    """Run ``fn``, which may call the checks above, and raise the first
    check that tripped, in call order, on the host once ``fn`` returns
    (its verdicts read in one transfer).  Returns ``fn``'s
    output when no check trips."""
    checks = []
    token = _deferred.set(checks)
    try:
        out = fn(*args, **kwargs)
    finally:
        _deferred.reset(token)
    if checks:
        dev = checks[0][0].device
        oks = torch.stack([ok.to(dev) for ok, _ in checks]).tolist()
        for good, (_, msg) in zip(oks, checks):
            if not good:
                raise GuardError(msg)
    return out
