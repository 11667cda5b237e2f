"""Chameleon-34B: early-fusion VLM; VQ image tokens arrive pre-tokenized via
the stub frontend (they are ordinary vocab entries) [arXiv:2405.09818]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    head_dim=128, d_ff=22016, vocab=65536, qk_norm=True,
    frontend="vision",
)
