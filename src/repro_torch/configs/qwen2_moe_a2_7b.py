"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=151_936,
    n_experts=60, n_experts_per_tok=4, moe_d_ff=1408,
    shared_expert_d_ff=5632,  # 4 shared experts fused: 4 x 1408
    qkv_bias=True, rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
)
