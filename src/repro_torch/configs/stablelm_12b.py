"""stablelm-12b [dense] — GQA, partial rotary (25%).
[hf:stabilityai/stablelm-2-1_6b; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab_size=100_352,
    rope_fraction=0.25, rope_theta=10_000.0,
    source="hf:stabilityai/stablelm-2-1_6b; hf",
)
