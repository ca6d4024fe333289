"""Execution targets behind the System protocol.

  PimSystem    the paper's memory-centric PIM machine (systems/pim.py)
  HostSystem   the processor-centric baseline (systems/host.py)

``make_system("pim" | "host", n_cores=..., device=...)`` is the
construction path the launcher and the tests use.
"""
from __future__ import annotations

from .base import (ChunkBoundary, ChunkPipeline, ChunkTick, FabricReduce,
                   HierarchicalReduce, HostReduce, ReduceStrategy,
                   StepProgram, System, TransferStats, chunk_schedule,
                   host_array, resolve_reduce_strategy, run_steps)
from .compress import CompressedReduce
from .host import HostConfig, HostSystem
from .pim import PimConfig, PimSystem
from .topology import PimTopology, default_rank_size

#: CLI spelling -> (config class, system class)
SYSTEM_KINDS = {
    "pim": (PimConfig, PimSystem),
    "host": (HostConfig, HostSystem),
}


def make_system(kind: str = "pim", **config_kwargs) -> System:
    """Construct an execution target by name.  Keyword arguments are the
    fields of its config dataclass (``PimConfig`` / ``HostConfig``);
    ``device`` defaults to ``"cuda"`` and raises without a GPU."""
    try:
        cfg_cls, sys_cls = SYSTEM_KINDS[kind]
    except KeyError:
        raise ValueError(f"unknown system kind {kind!r}; known: "
                         f"{sorted(SYSTEM_KINDS)}") from None
    return sys_cls(cfg_cls(**config_kwargs))


__all__ = [
    "ChunkBoundary", "ChunkPipeline", "ChunkTick", "CompressedReduce",
    "FabricReduce", "HierarchicalReduce", "HostConfig", "HostReduce",
    "HostSystem", "PimConfig", "PimSystem", "PimTopology", "ReduceStrategy",
    "SYSTEM_KINDS", "StepProgram", "System", "TransferStats",
    "chunk_schedule", "default_rank_size", "host_array", "make_system",
    "resolve_reduce_strategy", "run_steps",
]
