"""Fixed-point DSP substrate: FIR filterbank + SNR testbed (paper §III.C)."""
from .fixed_point import dequantize, quantize, requant_scale
from .fir import (BBM_KINDS, FIR_DELAY, PrecodedBank, design_lowpass,
                  fir_apply, fir_apply_fixed, fir_apply_real)
from .testbed import (TestSignals, make_filterbank_signals, make_signals,
                      run_filter_case, run_filterbank_case, snr_db)

__all__ = [
    "dequantize", "quantize", "requant_scale",
    "BBM_KINDS", "FIR_DELAY", "PrecodedBank", "design_lowpass", "fir_apply",
    "fir_apply_fixed", "fir_apply_real",
    "TestSignals", "make_filterbank_signals", "make_signals",
    "run_filter_case", "run_filterbank_case", "snr_db",
]
