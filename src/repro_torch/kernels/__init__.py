"""Hand-written CUDA kernels for Hopper, their plain versions, and oracles.

Importing this package builds nothing: the kernels compile on first use
(``kernels._build``).
"""
from .booth_rows import (amm_chunk_len, bbm_rows_product_dotform,
                         booth_correction, booth_high_value, booth_precode,
                         booth_value, dotform_scaled_bound,
                         f32_exact_chunk_len, resolve_form)
from .fir_kernel import (fir_bank_dot, fir_bank_rows, fir_bbm, fir_bbm_bank,
                         fir_bbm_bank_precoded, min_safe_shift)
from .ops import fir_filterbank, fir_filterbank_precoded

__all__ = ["amm_chunk_len", "bbm_rows_product_dotform", "booth_correction",
           "booth_high_value", "booth_precode", "booth_value",
           "dotform_scaled_bound", "f32_exact_chunk_len", "fir_bank_dot",
           "fir_bank_rows", "fir_bbm", "fir_bbm_bank",
           "fir_bbm_bank_precoded", "fir_filterbank",
           "fir_filterbank_precoded", "min_safe_shift", "resolve_form"]
