"""hymba-1.5b [hybrid] — parallel attention + mamba heads in every block,
128 meta tokens, sliding-window attention with 3 global layers
(first/middle/last).  [arXiv:2411.13676; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32_001,
    head_dim=64, ssm_state=16, ssm_proj_factor=2.0,
    meta_tokens=128,
    sliding_window=1024, global_attn_every=1,  # marker: 3 global layers
    rope_theta=10_000.0,
    source="arXiv:2411.13676; hf",
)
