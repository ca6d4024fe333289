"""whisper-tiny [audio] — encoder-decoder; conv frontend is a STUB:
input_specs() provides precomputed frame embeddings (1500 frames of 30 s
audio).  Sinusoidal positions allow the assigned decoder lengths.
[arXiv:2212.04356; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51_865,
    encoder_layers=4, encoder_seq=1500,
    activation="gelu", rope_fraction=0.0,  # learned-free sinusoidal pos
    source="arXiv:2212.04356; unverified",
)
