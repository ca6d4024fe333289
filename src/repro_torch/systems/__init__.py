"""Execution targets behind the System protocol.

  PimSystem         the paper's memory-centric PIM machine (systems/pim.py)
  HostSystem        the processor-centric baseline (systems/host.py)
  ModeledGpuSystem  HostSystem numerics + A100 roofline time and energy
                    (systems/gpu_model.py)

``make_system("pim" | "host" | "gpu-model", n_cores=..., device=...)`` is
the construction path the launchers, the compare and the tests use.
"""
from __future__ import annotations

from .base import (ChunkBoundary, ChunkPipeline, ChunkTick, FabricReduce,
                   HierarchicalReduce, HostReduce, ReduceStrategy, ReduceVia,
                   StepProgram, System, TransferStats, chunk_schedule,
                   host_array, resolve_reduce_strategy, run_steps)
from .compress import CompressedReduce
from .gpu_model import (GpuModelConfig, GpuModelReport, GpuModelSlice,
                        ModeledGpuSystem)
from .host import HostConfig, HostSlice, HostSystem
from .pim import (DPU_FREQ_HZ, DPU_MRAM_BYTES_PER_CYCLE, DPU_OP_CYCLES,
                  DPU_PIPELINE_SATURATION_THREADS, WORKLOAD_STORAGE_DTYPE,
                  DpuCostModel, PimConfig, PimSystem,
                  workload_element_bytes)
from .topology import (DPU_DMA_SEGMENT_BYTES, DPU_DMA_SETUP_CYCLES,
                       DPU_MRAM_BYTES, DPU_WRAM_BYTES, ExtentFootprint,
                       HierarchicalCostModel, PimTopology, default_rank_size)

#: CLI spelling -> (config class, system class); "gpu_model" is the
#: identifier spelling of "gpu-model"
SYSTEM_KINDS = {
    "pim": (PimConfig, PimSystem),
    "host": (HostConfig, HostSystem),
    "gpu-model": (GpuModelConfig, ModeledGpuSystem),
    "gpu_model": (GpuModelConfig, ModeledGpuSystem),
}


def make_system(kind: str = "pim", **config_kwargs) -> System:
    """Construct an execution target by name.  Keyword arguments are the
    fields of its config dataclass (``PimConfig`` / ``HostConfig`` /
    ``GpuModelConfig``); ``device`` defaults to ``"cuda"`` and raises
    without a GPU."""
    try:
        cfg_cls, sys_cls = SYSTEM_KINDS[kind]
    except KeyError:
        raise ValueError(
            f"unknown system kind {kind!r}; known: "
            f"{sorted(set(SYSTEM_KINDS) - {'gpu_model'})}") from None
    return sys_cls(cfg_cls(**config_kwargs))


__all__ = [
    "ChunkBoundary", "ChunkPipeline", "ChunkTick", "CompressedReduce",
    "DPU_DMA_SEGMENT_BYTES", "DPU_DMA_SETUP_CYCLES", "DPU_FREQ_HZ",
    "DPU_MRAM_BYTES", "DPU_MRAM_BYTES_PER_CYCLE", "DPU_OP_CYCLES",
    "DPU_PIPELINE_SATURATION_THREADS", "DPU_WRAM_BYTES", "DpuCostModel",
    "ExtentFootprint", "FabricReduce", "GpuModelConfig", "GpuModelReport",
    "GpuModelSlice", "HierarchicalCostModel", "HierarchicalReduce",
    "HostConfig", "HostReduce", "HostSlice", "HostSystem",
    "ModeledGpuSystem", "PimConfig", "PimSystem", "PimTopology",
    "ReduceStrategy", "ReduceVia",
    "SYSTEM_KINDS", "StepProgram", "System", "TransferStats",
    "WORKLOAD_STORAGE_DTYPE", "chunk_schedule", "default_rank_size",
    "host_array", "make_system", "resolve_reduce_strategy", "run_steps",
    "workload_element_bytes",
]
