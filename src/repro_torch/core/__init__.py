"""Core arithmetic: the paper's Broken-Booth multiplier (Booth family)."""
from .bbm import bbm_mul, bbm_type0, bbm_type1
from .booth import (booth_digits, booth_mul_exact, num_pp_rows, to_signed,
                    to_unsigned)
from .faults import FaultSpec, apply_acc_fault, apply_plane_faults
from .guards import GuardConfig, GuardReport, finite_rows, guard_rows
from .multipliers import EXACT, MULTIPLIERS, MulSpec, mul

__all__ = [
    "booth_digits", "booth_mul_exact", "num_pp_rows", "to_signed",
    "to_unsigned", "bbm_mul", "bbm_type0", "bbm_type1",
    "EXACT", "MULTIPLIERS", "MulSpec", "mul",
    "FaultSpec", "apply_acc_fault", "apply_plane_faults",
    "GuardConfig", "GuardReport", "finite_rows", "guard_rows",
]
