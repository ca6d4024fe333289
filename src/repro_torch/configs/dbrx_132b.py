"""dbrx-132b [moe] — 16 experts top-4, fine-grained MoE.
[hf:databricks/dbrx-base; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab_size=100_352,
    n_experts=16, n_experts_per_tok=4, moe_d_ff=10752,
    moe_groups=16,
    rope_theta=500_000.0,
    fsdp=True,  # 264 GB of bf16 weights: replicated-over-data won't fit
    source="hf:databricks/dbrx-base; unverified",
)
