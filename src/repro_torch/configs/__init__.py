"""Architecture configs (copies of ``repro/configs``; dense family only)."""
from .base import ARCH_IDS, PORTED_ARCH_IDS, ArchConfig, get_config

__all__ = ["ARCH_IDS", "PORTED_ARCH_IDS", "ArchConfig", "get_config"]
