"""Architecture configs (copies of ``repro/configs``; the decoder-only families)."""
from .base import ARCH_IDS, PORTED_ARCH_IDS, ArchConfig, get_config

__all__ = ["ARCH_IDS", "PORTED_ARCH_IDS", "ArchConfig", "get_config"]
