"""Assigned input shapes (4 per architecture -> 40 dry-run cells).

``train_*``  lower ``train_step`` (forward+backward+update)
``prefill_*`` lower ``prefill`` (forward, KV-cache write)
``decode_*`` / ``long_*`` lower ``serve_step`` (1 new token, KV cache of
seq_len) — per the assignment, NOT train_step.

``long_500k`` requires sub-quadratic attention: runs for ssm/hybrid
(recurrent state / SWA+SSM), skipped for pure full-attention archs
(recorded in DESIGN.md §4 and in the dry-run output).

A copy of ``repro.configs.shapes`` over the port's ``configs/base.py``.
"""
from __future__ import annotations

import dataclasses

from .base import ArchConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"
    microbatches: int = 1      # grad-accum steps (train only)


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

#: per-(arch-family) default microbatch counts for train_4k so the
#: activations fit 16 GB/chip on the 256-chip mesh (validated by the
#: dry-run memory_analysis; revisited during §Perf).
TRAIN_MICROBATCHES = {
    "dbrx-132b": 16, "qwen2.5-32b": 8, "llama-3.2-vision-11b": 8,
    "granite-3-8b": 4, "qwen3-8b": 4, "stablelm-12b": 4,
    "qwen2-moe-a2.7b": 4, "xlstm-350m": 2, "hymba-1.5b": 2,
    "whisper-tiny": 1,
}


def shape_for(arch: ArchConfig, shape_name: str) -> InputShape:
    s = SHAPES[shape_name]
    if s.kind == "train":
        s = dataclasses.replace(
            s, microbatches=TRAIN_MICROBATCHES.get(arch.name, 4))
    return s


def supports(arch: ArchConfig, shape_name: str) -> tuple[bool, str]:
    """(runnable, reason-if-not) — the long_500k / decode skip rules."""
    if shape_name == "long_500k":
        if arch.family in ("ssm", "hybrid"):
            return True, ""
        return False, ("pure full-attention architecture: 512k-token "
                       "decode cache is quadratic-cost; skipped per "
                       "assignment (DESIGN.md §4)")
    return True, ""


def all_cells():
    """Every (arch_id, shape_name) cell, with skip annotations."""
    from .base import ARCH_IDS, get_config
    cells = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES:
            ok, reason = supports(cfg, s)
            cells.append((a, s, ok, reason))
    return cells
