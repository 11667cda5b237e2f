"""The LM zoo's dense, VLM, MoE (GQA and multi-head latent attention),
SSM (Mamba2) and hybrid (Zamba2) families with the paper's approximate
matmul as a layer (``repro.models``)."""
from .common import AmmRuntime, amm_dense, amm_dot, cross_entropy_loss
from .transformer import (ModelRuntime, init_cache, lm_amm_planes,
                          lm_apply, lm_init, lm_logical_axes, lm_loss,
                          lm_table)

__all__ = ["AmmRuntime", "amm_dense", "amm_dot", "cross_entropy_loss",
           "ModelRuntime", "init_cache", "lm_amm_planes", "lm_apply",
           "lm_init", "lm_logical_axes", "lm_loss", "lm_table"]
