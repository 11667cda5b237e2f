"""Host-side runtime guards for the serving datapath.

Counterpart of the engine-facing half of ``repro.core.guards``: the
guard configuration, the structured per-flush verdict, and the per-row
finite / error-budget checks the filterbank engine runs on every flush.
All of it is numpy on the host.  (The reference's in-jit checkify guards
come with the faults-and-guards item of the port.)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["GuardConfig", "GuardReport", "finite_rows", "guard_rows"]


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
