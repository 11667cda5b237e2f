"""Llama-3.2-3B: small llama3 dense GQA [hf:meta-llama/Llama-3.2-1B]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
    head_dim=128, d_ff=8192, vocab=128256,
    tie_embeddings=True, rope_theta=5e5,
)
