"""xlstm-350m [ssm] — sLSTM + mLSTM blocks (7:1), matrix-memory recurrence.
[arXiv:2405.04517; unverified]  d_ff=0: the mLSTM block's x2 up-projection
replaces the FFN (xLSTM block design)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50_304,
    slstm_every=8,           # xLSTM[7:1]: every 8th block is sLSTM
    ssm_proj_factor=2.0, ssm_state=0,
    source="arXiv:2405.04517; unverified",
)
