"""Registry of approximate multipliers behind one uniform interface.

Counterpart of ``repro.core.multipliers``.  ``MulSpec(name, wl, param,
hbl)`` validates exactly as the reference does; ``mul(spec)(a, b)`` maps
int32 tensors of wl-bit operands to int32 products, on their device.
The Booth family (``booth``, ``bbm0``, ``bbm1``) takes two's-complement
operands natively; the unsigned comparison multipliers ``bam``,
``kulkarni`` and ``etm`` are applied sign-magnitude, as the paper does
("no difference between BAM and its signed counterpart, in terms of
MSE"): ``p = sign(a) * sign(b) * m(|a|, |b|)``.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import torch

from .bam import bam_mul
from .bbm import bbm_type0, bbm_type1
from .booth import booth_mul_exact, to_signed
from .etm import etm_mul
from .kulkarni import kulkarni_mul

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


def _signed_wrap(unsigned_fn: Callable, a, b, wl: int, **kw):
    a_s = to_signed(a, wl)
    b_s = to_signed(b, wl)
    sign = torch.sign(a_s) * torch.sign(b_s)
    return sign * unsigned_fn(torch.abs(a_s), torch.abs(b_s), wl=wl, **kw)


MULTIPLIERS = {
    "booth": lambda a, b, wl, param, hbl: booth_mul_exact(a, b, wl),
    "bbm0": lambda a, b, wl, param, hbl: bbm_type0(a, b, wl, param),
    "bbm1": lambda a, b, wl, param, hbl: bbm_type1(a, b, wl, param),
    "bam": lambda a, b, wl, param, hbl: _signed_wrap(
        partial(bam_mul, hbl=hbl), a, b, wl, vbl=param),
    "kulkarni": lambda a, b, wl, param, hbl: _signed_wrap(
        kulkarni_mul, a, b, wl, k=param),
    "etm": lambda a, b, wl, param, hbl: _signed_wrap(
        etm_mul, a, b, wl, split=param),
}

EXACT = MulSpec("booth", 16, 0)


def mul(spec: MulSpec) -> Callable:
    """Return f(a, b) -> approximate signed product for the given spec."""
    fn = MULTIPLIERS[spec.name]
    return lambda a, b: fn(a, b, spec.wl, spec.param, spec.hbl)
