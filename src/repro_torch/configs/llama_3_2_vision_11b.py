"""llama-3.2-vision-11b [vlm] — cross-attn image layers every 5th layer.
Vision frontend is a STUB: input_specs() provides precomputed patch
embeddings (assignment rule). [hf:meta-llama/Llama-3.2-11B-Vision;
unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=128_256,
    cross_attn_every=5,
    vision_tokens=1601, vision_dim=4096,
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
