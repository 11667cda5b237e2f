"""Core arithmetic: the paper's Broken-Booth multiplier and its comparands."""
from .bam import bam_mul
from .bbm import bbm_mul, bbm_type0, bbm_type1
from .booth import (booth_digits, booth_mul_exact, num_pp_rows, to_signed,
                    to_unsigned)
from .errstats import ErrorStats, characterize, error_histogram
from .faults import FaultSpec, apply_acc_fault, apply_plane_faults
from .guards import GuardConfig, GuardReport, finite_rows, guard_rows
from .kulkarni import kulkarni_mul
from .multipliers import EXACT, MULTIPLIERS, MulSpec, mul
from .noise import NoiseModel, inject_dot_error, make_noise_model

__all__ = [
    "booth_digits", "booth_mul_exact", "num_pp_rows", "to_signed",
    "to_unsigned", "bbm_mul", "bbm_type0", "bbm_type1", "bam_mul",
    "kulkarni_mul", "EXACT", "MULTIPLIERS", "MulSpec", "mul",
    "ErrorStats", "characterize", "error_histogram",
    "FaultSpec", "apply_acc_fault", "apply_plane_faults",
    "GuardConfig", "GuardReport", "finite_rows", "guard_rows",
    "NoiseModel", "inject_dot_error", "make_noise_model",
]
