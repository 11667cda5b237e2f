"""The paper's own 'architecture': the 30-tap FIR filter testbed."""
from ..core.multipliers import MulSpec

WL = 16
VBL_OPERATING = 13       # paper's chosen operating point
SPEC_ACCURATE = MulSpec("booth", WL, 0)
SPEC_APPROX = MulSpec("bbm0", WL, VBL_OPERATING)
