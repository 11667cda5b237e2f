"""Whisper-base backbone: encoder-decoder transformer; the conv audio
frontend is a stub (callers pass precomputed frame embeddings of shape
(B, encoder_len, d_model)) [arXiv:2212.04356].

As in the reference, positions are encoded by RoPE (the original uses
sinusoidal and learned embeddings); the config covers the transformer
backbone only.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    head_dim=64, d_ff=2048, vocab=51865,
    is_encoder_decoder=True, n_encoder_layers=6, encoder_len=1500,
    frontend="audio",
)
