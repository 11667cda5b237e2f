"""Architecture and approximate-multiplier configuration dataclasses.

Counterpart of ``repro.configs.base`` (``AmmConfig``, ``ArchConfig``,
``reduced``), field for field, so a configuration reads the same in both
packages.  The shape catalogue of the reference (``ShapeConfig``) belongs
to its dry run and is not needed here.
"""
from __future__ import annotations

import dataclasses

__all__ = ["AmmConfig", "ArchConfig", "reduced"]


@dataclasses.dataclass(frozen=True)
class AmmConfig:
    """Approximate matmul (the paper's technique) as a model-level feature.

    mode:
      "off"      exact f32 matmuls (baseline hardware)
      "noise"    WL-bit fixed-point quantization plus calibrated white-noise
                 error injection (paper section II.B)
      "bitexact" the true Broken-Booth datapath (the dot form on the
                 ``bbm_dot_scaled`` kernel)
    apply_to: "mlp", "attn" or "all" -- which matmul families route
    through the approximation.  use_pallas (mode="noise"): the fused
    ``quant_matmul`` kernel (the name is the reference's flag; here it
    selects the hand-written CUDA kernel).
    """
    mode: str = "off"
    mul: str = "bbm0"
    wl: int = 16
    param: int = 13            # VBL (or K for kulkarni)
    apply_to: str = "mlp"
    use_pallas: bool = False

    def __post_init__(self):
        if self.apply_to not in ("mlp", "attn", "all"):
            raise ValueError(f"apply_to must be 'mlp', 'attn' or 'all', "
                             f"got {self.apply_to!r}")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    # --- MLA (deepseek) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- MTP (deepseek) ---
    mtp_depth: int = 0
    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    ssm_conv: int = 4
    ssm_groups: int = 1
    # --- hybrid (zamba2) ---
    shared_attn_every: int = 0
    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_len: int = 1500
    # --- modality frontend stub ---
    frontend: str = "none"
    # --- paper technique ---
    amm: AmmConfig = dataclasses.field(default_factory=AmmConfig)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim


def reduced(cfg: ArchConfig, *, layers: int = 2, d_model: int = 64,
            vocab: int = 512) -> ArchConfig:
    """Tiny same-family config for CPU tests (the reference's rule)."""
    scale = d_model / cfg.d_model

    def sc(x, lo=1):
        return max(lo, int(round(x * scale)))
    heads = max(2, min(cfg.n_heads, 4))
    kv = max(1, min(cfg.n_kv_heads, heads))
    return dataclasses.replace(
        cfg,
        n_layers=layers, d_model=d_model,
        n_heads=heads, n_kv_heads=kv, head_dim=d_model // heads,
        d_ff=4 * d_model if cfg.d_ff else 0,
        vocab=vocab,
        n_experts=min(cfg.n_experts, 8), top_k=min(cfg.top_k, 2),
        moe_d_ff=2 * d_model if cfg.moe_d_ff else 0,
        first_k_dense=min(cfg.first_k_dense, 1),
        q_lora_rank=sc(cfg.q_lora_rank, 8) if cfg.q_lora_rank else 0,
        kv_lora_rank=sc(cfg.kv_lora_rank, 8) if cfg.kv_lora_rank else 0,
        qk_nope_dim=16 if cfg.qk_nope_dim else 0,
        qk_rope_dim=8 if cfg.qk_rope_dim else 0,
        v_head_dim=16 if cfg.v_head_dim else 0,
        ssm_state=min(cfg.ssm_state, 16), ssm_headdim=16, ssm_chunk=16,
        shared_attn_every=2 if cfg.shared_attn_every else 0,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        encoder_len=32 if cfg.is_encoder_decoder else cfg.encoder_len,
        mtp_depth=cfg.mtp_depth,
    )
