"""Hand-written CUDA kernels for Hopper, their plain versions, and oracles.

Importing this package builds nothing: the kernels compile on first use
(``kernels._build``).  As in ``repro.kernels``, ``bbm_matmul`` here is the
public entry point of ``ops`` (with its envelope and ``device=``); the
module of that name is ``importlib.import_module(
"repro_torch.kernels.bbm_matmul")``.
"""
from .booth_rows import (amm_chunk_len, bbm_rows_product_dotform,
                         booth_correction, booth_high_value, booth_precode,
                         booth_precode_faulty, booth_value,
                         dotform_scaled_bound, f32_exact_chunk_len,
                         resolve_form)
from .bbm_matmul import (bbm_dot_planes, bbm_dot_scaled, bbm_matmul_dot,
                         bbm_matmul_dynamic, bbm_matmul_rows,
                         bbm_matmul_scaled, dot_scaled_chunked)
from .fir_kernel import (fir_bank_dot, fir_bank_rows, fir_bbm, fir_bbm_bank,
                         fir_bbm_bank_precoded, min_safe_shift)
from .flash_attention import flash_attention_amm
from .ops import (bbm_matmul, bbm_matmul_precoded, fir_filterbank,
                  fir_filterbank_precoded, flash_attention)
from .quant_matmul import quant_matmul, quant_matmul_plain

__all__ = ["amm_chunk_len", "bbm_dot_planes", "bbm_dot_scaled",
           "bbm_matmul", "bbm_matmul_dot", "bbm_matmul_dynamic",
           "bbm_matmul_precoded", "bbm_matmul_rows", "bbm_matmul_scaled",
           "bbm_rows_product_dotform", "booth_correction",
           "booth_high_value", "booth_precode", "booth_precode_faulty",
           "booth_value",
           "dot_scaled_chunked", "dotform_scaled_bound",
           "f32_exact_chunk_len", "fir_bank_dot",
           "fir_bank_rows", "fir_bbm", "fir_bbm_bank",
           "fir_bbm_bank_precoded", "fir_filterbank",
           "fir_filterbank_precoded", "flash_attention",
           "flash_attention_amm", "min_safe_shift", "quant_matmul",
           "quant_matmul_plain", "resolve_form"]
