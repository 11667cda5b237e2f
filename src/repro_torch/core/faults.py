"""Keyed, deterministic hardware-fault injection for the Broken-Booth
datapath.

Counterpart of ``repro.core.faults``.  A ``FaultSpec`` names a fault
site, model and rate, and every mask it draws is a pure function of
``(spec.seed, site indices)``: the masks are ``jax.random.bernoulli``'s
bits, reproduced by ``core.prng`` (threefry2x32 on the flat index,
``jax_threefry_partitionable`` on), so the port faults exactly the cells
the reference faults and the faulted datapath is held to
``assert_array_equal`` against the reference and against the scalar
oracle ``kernels.ref.amm_faulty_ref``.

Fault sites (``target``):

  "plane"  the radix-4 Booth digit planes of the multiplier operand:
           per digit the magnitude select ``(mag_lo, mag_hi)`` and the
           sign flag ``neg``.  ``lane`` picks the faulty line; ``rows``
           confines the site to the truncated correction rows
           (``"corr"``) or not (``"all"``).  A select driven to the unused
           ``11`` code resolves to the 2A line (``mag = 2``), so faulted
           planes stay in the decode domain every accumulate form reads.
  "acc"    one bit of the int32 accumulator: each K-chunk's partial sum
           is XORed with a keyed rate-``p`` mask at bit ``bit``, keyed by
           (chunk index, output element).

Fault models (``model``): "flip" (each cell flips with rate ``p``),
"stuck0" / "stuck1" (a keyed fraction ``p`` of cells reads 0 / 1).

``FaultSpec()`` (rate 0) is the no-fault spec: every application is the
identity.  The masks land on the device of the tensor they fault.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import prng

__all__ = ["FaultSpec", "acc_fault_keys", "apply_acc_fault",
           "apply_plane_faults", "plane_fault_mask"]

_LANES = ("mag_lo", "mag_hi", "neg", "all")
_MODELS = ("flip", "stuck0", "stuck1")
_TARGETS = ("plane", "acc")
_ROWS = ("all", "corr")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault site + model + rate, deterministically keyed by ``seed``."""
    target: str = "plane"     # "plane" | "acc"
    model: str = "flip"       # "flip" | "stuck0" | "stuck1"
    p: float = 0.0            # fault rate (flip) / defect coverage (stuck)
    lane: str = "all"         # plane: "mag_lo" | "mag_hi" | "neg" | "all"
    rows: str = "all"         # plane: "all" | "corr" (truncated rows only)
    bit: int = 12             # acc: accumulator bit the upset lands on
    seed: int = 0             # keys every mask draw

    def __post_init__(self):
        if self.target not in _TARGETS:
            raise ValueError(f"unknown fault target {self.target!r}")
        if self.model not in _MODELS:
            raise ValueError(f"unknown fault model {self.model!r}")
        if self.lane not in _LANES:
            raise ValueError(f"unknown plane lane {self.lane!r}")
        if self.rows not in _ROWS:
            raise ValueError(f"unknown row selector {self.rows!r}")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"fault rate must be in [0, 1], got {self.p}")
        if not 0 <= self.bit < 31:
            raise ValueError(f"accumulator bit must be in [0, 31), "
                             f"got {self.bit}")

    @property
    def enabled(self) -> bool:
        return self.p > 0.0


def _key(spec: FaultSpec, *folds: int) -> prng.Key:
    k = prng.key(spec.seed)
    for f in folds:
        k = prng.fold_in(k, f)
    return k


def acc_fault_keys(spec: FaultSpec, n_chunks: int) -> np.ndarray:
    """(n_chunks, 2) uint32: the keys of chunks ``0 .. n_chunks - 1``'s
    accumulator masks, ``_key(spec, 23, ci)``, folded in one vectorized
    threefry call (for kernels that draw the masks themselves)."""
    k = _key(spec, 23)
    b1, b2 = prng.threefry2x32(k[0], k[1], np.uint32(0),
                               np.arange(n_chunks, dtype=np.uint32))
    return np.stack([b1, b2], axis=1).astype(np.uint32)


def plane_fault_mask(spec: FaultSpec, shape, lane_idx: int, device=None):
    """Boolean fault-site mask for one plane bit-lane, keyed and pure:
    it depends only on ``(spec.seed, lane_idx, shape)``.  ``device``:
    None means the GPU (raising without one), "cpu" the host."""
    return prng.bernoulli(_key(spec, 17, lane_idx), spec.p, shape, device)


def _fault_bit(bitval, mask, model: str):
    """Apply one fault model to a 0/1 bit plane at the masked cells."""
    if model == "flip":
        return torch.where(mask, 1 - bitval, bitval)
    if model == "stuck0":
        return torch.where(mask, 0, bitval)
    return torch.where(mask, 1, bitval)        # stuck1


def apply_plane_faults(mag, neg, spec: FaultSpec | None, *, vbl: int = 0):
    """Faulted ``(mag, neg)`` digit planes; identity for a disabled spec.

    ``mag``/``neg`` are ``booth_precode`` planes of shape ``(wl//2,
    ...)``.  Each bit-lane is faulted in turn; a select driven to ``11``
    saturates to ``mag = 2``.  ``rows="corr"`` confines the site to the
    first ``(vbl + 1) // 2`` rows (without the row cap of
    ``num_corr_rows``, as the reference counts them).
    """
    if spec is None or not spec.enabled or spec.target != "plane":
        return mag, neg
    lanes = {"mag_lo": mag & 1, "mag_hi": (mag >> 1) & 1, "neg": neg}
    for i, name in enumerate(("mag_lo", "mag_hi", "neg")):
        if spec.lane not in (name, "all"):
            continue
        mask = plane_fault_mask(spec, mag.shape, i, mag.device)
        if spec.rows == "corr":
            n_corr = (vbl + 1) // 2
            row_ok = (torch.arange(mag.shape[0], device=mag.device)
                      < n_corr).reshape((-1,) + (1,) * (mag.dim() - 1))
            mask = mask & row_ok
        lanes[name] = _fault_bit(lanes[name], mask, spec.model)
    new_mag = torch.clamp_max(lanes["mag_lo"] + 2 * lanes["mag_hi"], 2)
    return new_mag.to(mag.dtype), lanes["neg"].to(neg.dtype)


def apply_acc_fault(acc, spec: FaultSpec | None, chunk_idx: int = 0):
    """XOR a keyed rate-``p`` upset mask into accumulator bit ``bit``.

    ``acc`` is the int32 partial of K-chunk ``chunk_idx``, which folds
    into the key.  Identity for a disabled or non-"acc" spec.
    """
    if spec is None or not spec.enabled or spec.target != "acc":
        return acc
    mask = prng.bernoulli(_key(spec, 23, chunk_idx), spec.p, acc.shape,
                          acc.device)
    return acc ^ (mask.to(acc.dtype) << spec.bit)
