"""Serving engine for the paper's workload: the batched FIR filterbank.

Counterpart of ``FilterRequest`` and ``FilterbankEngine`` in
``repro.serve.engine`` (the LM ``Scheduler`` joins this module in a later
slice).  Filtering requests accumulate into channel slots and are served
by one multi-channel Broken-Booth filterbank dispatch per flush
(``dsp.fir_apply``).  The tap banks are fixed for the engine's lifetime,
so their quantization and Booth recode happen once, at construction
(``dsp.PrecodedBank``), and every flush gathers the cached digit planes
by request index.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..core.guards import GuardConfig, guard_rows
from ..core.multipliers import MulSpec
from ..device import resolve_device
from ..dsp.fir import BBM_KINDS, PrecodedBank, fir_apply
from ..kernels.booth_rows import resolve_form

__all__ = ["FilterRequest", "FilterbankEngine"]


@dataclasses.dataclass
class FilterRequest:
    rid: int
    signal: np.ndarray            # 1-D real samples
    bank: int = 0                 # which tap bank filters this request


class FilterbankEngine:
    """Batched FIR serving: N pending requests -> one filterbank dispatch.

    Each request names the tap bank that filters it.  ``flush`` pads the
    pending signals to a common length, stacks them into a (C, N) batch,
    gathers the per-request banks out of the precoded cache, runs the
    batch through ``dsp.fir_apply`` in one call on ``device`` (None: the
    GPU, where the filterbank kernels are built here, before any request,
    so a kernel that cannot build fails construction instead of being
    quarantined request by request), and returns each request's output
    trimmed to its own length.
    """

    def __init__(self, h_banks: np.ndarray, spec: MulSpec, *,
                 backend: str = "host", max_channels: int = 64,
                 form: Optional[str] = None,
                 guard: Optional[GuardConfig] = None, max_retries: int = 1,
                 device=None):
        h_banks = np.atleast_2d(np.asarray(h_banks, np.float64))
        self.device = resolve_device(device)
        self.h_banks = h_banks
        self.spec = spec
        if backend not in ("host", "cuda"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.max_channels = max_channels
        resolve_form(form)    # fail fast: flush() dequeues before it serves
        if form == "dot" and (spec.name not in BBM_KINDS or spec.wl > 16):
            # reject at construction what every flush would reject
            raise ValueError(f"form='dot' needs a Booth-family spec at "
                             f"wl <= 16, not {spec}")
        self.form = form          # "rows" | "dot" | None (auto)
        self.guard = guard
        self.max_retries = max_retries
        self._apply = fir_apply
        if self.device.type == "cuda":
            from ..kernels._build import library
            library("fir_bank")
        self.bank = PrecodedBank(h_banks, spec, device=self.device)
        self._pending: List[FilterRequest] = []
        self._next_rid = 0
        self._dispatches = 0      # audit cadence counter (guard.budget_every)
        # requests the degradation path gave up on: {rid: repr(error)}
        self.failed: Dict[int, str] = {}
        self.stats = {"dispatches": 0, "served": 0, "retries": 0,
                      "bisections": 0, "quarantined": 0, "guard_trips": 0,
                      "exact_reserves": 0}

    def submit(self, signal: np.ndarray, bank: int = 0) -> int:
        """Queue one signal; returns its request id."""
        if not 0 <= bank < len(self.h_banks):
            raise ValueError(f"unknown tap bank {bank}")
        rid = self._next_rid
        self._next_rid += 1
        self._pending.append(FilterRequest(rid, np.asarray(signal), bank))
        return rid

    def flush(self) -> Dict[int, np.ndarray]:
        """Serve every pending request; returns {rid: filtered signal}.

        A raising dispatch is retried up to ``max_retries`` times; a batch
        that still fails is bisected until the poison request is alone
        and quarantined into ``self.failed``, while every healthy request
        of the batch is served.  The queue is dequeued before serving, so
        a poison request cannot wedge later flushes.  With ``guard`` set,
        tripped channels are re-served on the exact datapath.
        """
        results: Dict[int, np.ndarray] = {}
        while self._pending:
            batch = self._pending[: self.max_channels]
            self._pending = self._pending[self.max_channels:]
            self._serve(batch, results)
        return results

    def _stack(self, batch: List[FilterRequest]) -> np.ndarray:
        n = max(len(r.signal) for r in batch)
        x = np.zeros((len(batch), n))
        for c, r in enumerate(batch):
            x[c, : len(r.signal)] = r.signal
        return x

    def _dispatch(self, batch: List[FilterRequest]) -> np.ndarray:
        """One filterbank call with bounded retry; raises when exhausted."""
        x = self._stack(batch)
        h = self.bank.take([r.bank for r in batch])
        for attempt in range(self.max_retries + 1):
            self.stats["dispatches"] += 1
            self._dispatches += 1
            try:
                return np.asarray(self._apply(
                    x, h, self.spec, backend=self.backend, form=self.form,
                    device=self.device))
            except Exception:
                if attempt == self.max_retries:
                    raise
                self.stats["retries"] += 1

    def _serve(self, batch: List[FilterRequest],
               results: Dict[int, np.ndarray]):
        """Serve one batch with bisection quarantine + runtime guards."""
        try:
            y = self._dispatch(batch)
        except Exception as e:
            if len(batch) == 1:
                self.failed[batch[0].rid] = repr(e)
                self.stats["quarantined"] += 1
                return
            self.stats["bisections"] += 1
            mid = len(batch) // 2
            self._serve(batch[:mid], results)
            self._serve(batch[mid:], results)
            return
        bad = self._guard_channels(batch, y)
        for c, r in enumerate(batch):
            if c in bad:
                results[r.rid] = self._reserve_exact(r)
            else:
                results[r.rid] = y[c, : len(r.signal)]
            self.stats["served"] += 1

    def _guard_channels(self, batch: List[FilterRequest],
                        y: np.ndarray) -> set:
        """Indices of channels whose runtime guards tripped this dispatch."""
        if self.guard is None:
            return set()
        y_exact = None
        if self.guard.budget_active \
                and self._dispatches % self.guard.budget_every == 0:
            # sampled accuracy audit: the same batch on the exact datapath
            y_exact = self._exact_batch(batch)
        rep = guard_rows(y, self.guard, y_exact=y_exact)
        if rep.ok:
            return set()
        bad = {c for c in range(len(batch)) if not rep.row_ok[c]}
        self.stats["guard_trips"] += len(bad)
        return bad

    def _exact_spec(self) -> MulSpec:
        """Exact-Booth comparand at this engine's word length."""
        return MulSpec("booth", self.spec.wl, 0)

    def _exact_batch(self, batch: List[FilterRequest]) -> np.ndarray:
        x = self._stack(batch)
        h = self.h_banks[[r.bank for r in batch]]
        return np.asarray(self._apply(x, h, self._exact_spec(),
                                      backend="host", form=None,
                                      device=self.device))

    def _reserve_exact(self, r: FilterRequest) -> np.ndarray:
        """Serve one guard-tripped request on the exact datapath."""
        self.stats["exact_reserves"] += 1
        y = self._apply(r.signal[None, :], self.h_banks[[r.bank]],
                        self._exact_spec(), backend="host", form=None,
                        device=self.device)
        return np.asarray(y)[0]
