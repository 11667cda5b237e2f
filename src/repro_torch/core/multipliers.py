"""Registry of approximate multipliers behind one uniform interface.

Counterpart of ``repro.core.multipliers``.  ``MulSpec(name, wl, param,
hbl)`` validates exactly as the reference does and accepts every
registered family; ``mul(spec)(a, b)`` maps int32 tensors of wl-bit
operands to int32 products.  This slice implements the Booth family
(``booth``, ``bbm0``, ``bbm1``); the comparison multipliers ``bam``,
``kulkarni`` and ``etm`` are ROADMAP item A14 and raise
``NotImplementedError`` when called.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from .bbm import bbm_type0, bbm_type1
from .booth import booth_mul_exact

__all__ = ["MulSpec", "mul", "MULTIPLIERS", "EXACT"]


@dataclasses.dataclass(frozen=True)
class MulSpec:
    name: str = "booth"
    wl: int = 16
    param: int = 0          # VBL or K
    hbl: int = 0            # BAM only

    def __post_init__(self):
        if self.name not in MULTIPLIERS:
            raise ValueError(f"unknown multiplier {self.name!r}")
        if self.wl % 2 != 0:
            raise ValueError("word length must be even")

    @property
    def is_exact(self) -> bool:
        """Does this spec reduce to the exact signed product?

        ``booth`` ignores both knobs; ``hbl`` only exists for ``bam``;
        every other design is exact iff its precision knob is 0.
        """
        if self.name == "booth":
            return True
        if self.name == "bam":
            return self.param == 0 and self.hbl == 0
        return self.param == 0


def _not_ported(name: str) -> Callable:
    def fn(a, b, wl, param, hbl):
        raise NotImplementedError(
            f"multiplier {name!r} is not ported yet (ROADMAP item A14)")
    return fn


MULTIPLIERS = {
    "booth": lambda a, b, wl, param, hbl: booth_mul_exact(a, b, wl),
    "bbm0": lambda a, b, wl, param, hbl: bbm_type0(a, b, wl, param),
    "bbm1": lambda a, b, wl, param, hbl: bbm_type1(a, b, wl, param),
    "bam": _not_ported("bam"),
    "kulkarni": _not_ported("kulkarni"),
    "etm": _not_ported("etm"),
}

EXACT = MulSpec("booth", 16, 0)


def mul(spec: MulSpec) -> Callable:
    """Return f(a, b) -> approximate signed product for the given spec."""
    fn = MULTIPLIERS[spec.name]
    return lambda a, b: fn(a, b, spec.wl, spec.param, spec.hbl)
