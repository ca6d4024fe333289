"""Architecture config schema + registry (``--arch <id>``).

A copy of ``repro/configs/base.py`` (pure Python); the port carries every
config of the reference.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple

ARCH_IDS = (
    "dbrx-132b", "qwen2-moe-a2.7b", "xlstm-350m", "llama-3.2-vision-11b",
    "granite-3-8b", "qwen2.5-32b", "qwen3-8b", "stablelm-12b",
    "hymba-1.5b", "whisper-tiny",
)

#: the families whose batches carry more than tokens (the VLM's vision
#: states, the audio family's frames)
EXTRAS_ARCH_IDS = ("llama-3.2-vision-11b", "whisper-tiny")

VOCAB_PAD = 128  # vocab padded to a multiple (model-axis sharding)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | vlm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # attention flavors
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_fraction: float = 1.0
    rope_theta: float = 500_000.0
    sliding_window: int = 0             # 0 = full attention
    global_attn_every: int = 0          # hymba: 1-in-N layers full attn

    # moe
    n_experts: int = 0
    n_experts_per_tok: int = 0
    moe_d_ff: int = 0
    shared_expert_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    moe_dispatch: str = "gather"        # "gather" | "dense" (§Perf)
    moe_groups: int = 1                 # == dp degree for local routing

    # ssm / hybrid
    ssm_state: int = 0
    ssm_proj_factor: float = 2.0
    slstm_every: int = 0                # xlstm: 1-in-N layers sLSTM
    meta_tokens: int = 0                # hymba

    # vlm
    cross_attn_every: int = 0           # 1-in-N layers cross-attn
    vision_tokens: int = 0
    vision_dim: int = 0

    # audio enc-dec
    encoder_layers: int = 0
    encoder_seq: int = 0

    # numerics / the paper's techniques as first-class switches
    dtype: str = "bfloat16"
    quantize_dense: bool = False        # LIN-HYB analogue (int8 linears)
    lut_activations: bool = False       # LOG-LUT analogue
    activation: str = "silu"

    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    remat: str = "full"                 # "full" | "none"
    fsdp: bool = False                  # weight sharding over data axes
    tp_dense: bool = True               # False: replicate backbone weights
    #                                     (pure DP+ZeRO; small ssm models)
    kv_cache_bits: int = 16             # 8: int8 KV cache (paper technique
    #                                     on the decode memory bound, §Perf)
    source: str = ""                    # provenance note

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab_size // VOCAB_PAD) * VOCAB_PAD

    def layer_pattern(self) -> Tuple[str, ...]:
        """Per-layer block types; the trainer scans over the repeating unit."""
        if self.family == "moe":
            return ("moe",) * self.n_layers
        if self.family == "ssm":
            if self.slstm_every:
                unit = ["mlstm"] * (self.slstm_every - 1) + ["slstm"]
                reps = self.n_layers // self.slstm_every
                assert reps * self.slstm_every == self.n_layers
                return tuple(unit) * reps
            return ("mlstm",) * self.n_layers
        if self.family == "vlm":
            e = self.cross_attn_every
            unit = ["attn"] * (e - 1) + ["cross"]
            reps = self.n_layers // e
            assert reps * e == self.n_layers
            return tuple(unit) * reps
        if self.family == "hybrid":
            return ("hymba",) * self.n_layers
        return ("attn",) * self.n_layers

    def layer_windows(self) -> Tuple[int, ...]:
        """Per-layer sliding window (0 = full)."""
        if not self.sliding_window:
            return (0,) * self.n_layers
        wins = []
        for i in range(self.n_layers):
            is_global = (self.global_attn_every and
                         (i == 0 or i == self.n_layers - 1
                          or i == self.n_layers // 2))
            wins.append(0 if is_global else self.sliding_window)
        return tuple(wins)

    def reduced(self, **overrides) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        base = dict(
            n_layers=self._reduced_layers(),
            d_model=128,
            n_heads=4, n_kv_heads=2,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            head_dim=32,
            dtype="float32",
            remat="none",
        )
        if self.n_experts:
            # dropless capacity so prefill/decode == teacher-forced forward
            # exactly (capacity drops are batch-composition-dependent in
            # the full configs — an accepted MoE property)
            base.update(n_experts=4, n_experts_per_tok=2, moe_d_ff=64,
                        shared_expert_d_ff=64 if self.shared_expert_d_ff
                        else 0, moe_capacity_factor=8.0)
        if self.family == "vlm":
            base.update(cross_attn_every=self.cross_attn_every,
                        vision_tokens=16, vision_dim=64)
        if self.family == "audio":
            base.update(encoder_layers=2, encoder_seq=32,
                        n_heads=4, n_kv_heads=4)
        if self.family == "hybrid":
            base.update(n_heads=5, n_kv_heads=1, meta_tokens=8,
                        sliding_window=self.sliding_window and 32,
                        ssm_state=8)
        if self.family == "ssm":
            base.update(ssm_state=min(self.ssm_state, 8) or 0,
                        n_heads=4, n_kv_heads=4)
        base.update(overrides)
        return dataclasses.replace(self, **base)

    def _reduced_layers(self) -> int:
        if self.family == "vlm":
            return self.cross_attn_every          # one unit
        if self.family == "ssm" and self.slstm_every:
            return self.slstm_every
        return 2


def get_config(arch_id: str) -> ArchConfig:
    """Load ``repro_torch/configs/<id>.py`` (dashes/dots -> underscores)."""
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod_name = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"{__package__}.{mod_name}")
    return mod.CONFIG
