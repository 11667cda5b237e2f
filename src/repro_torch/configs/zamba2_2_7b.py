"""Zamba2-2.7B hybrid: Mamba2 backbone + shared attention block every 6
layers (weights reused; the per-invocation LoRA deltas of the reference
implementation are deliberately omitted — the shared-block scheme itself
is what the hybrid family exercises) [arXiv:2411.15242]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    head_dim=80, d_ff=10240, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_chunk=128,
    shared_attn_every=6,
)
