"""DeepSeek-V3 671B: MLA + 1 shared/256 routed top-8 MoE + MTP.

[arXiv:2412.19437; hf].  Assigned spec: 61L d_model=7168 128H d_ff=2048
(routed expert width) vocab=129280.  First 3 layers dense (d_ff 18432) and
MTP depth 1 per the paper.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    head_dim=128, d_ff=18432, vocab=129280,
    n_experts=256, n_shared_experts=1, top_k=8, moe_d_ff=2048,
    first_k_dense=3,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    mtp_depth=1, rope_theta=1e4,
)
