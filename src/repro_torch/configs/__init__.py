"""Architecture configs (copies of ``repro/configs``)."""
from .base import ARCH_IDS, EXTRAS_ARCH_IDS, ArchConfig, get_config

__all__ = ["ARCH_IDS", "EXTRAS_ARCH_IDS", "ArchConfig", "get_config"]
