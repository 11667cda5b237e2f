"""The LM zoo's dense family with the paper's approximate matmul as a
layer (``repro.models``)."""
from .common import AmmRuntime, amm_dense, amm_dot
from .transformer import (ModelRuntime, init_cache, lm_apply, lm_init,
                          lm_table)

__all__ = ["AmmRuntime", "amm_dense", "amm_dot", "ModelRuntime",
           "init_cache", "lm_apply", "lm_init", "lm_table"]
