"""Compatibility shim: the PIM execution model lives in
``repro_torch.systems``.

Port of ``repro.core.pim``: every name the reference re-exports here
re-exports unchanged from the port's systems package, so ``from
repro_torch.core.pim import PimSystem`` works.  New code imports from
:mod:`repro_torch.systems`.
"""
from ..systems.base import (FabricReduce, HierarchicalReduce, HostReduce,
                            ReduceStrategy, ReduceVia, StepProgram,
                            StrategyLike, System, TransferStats,
                            chunk_schedule, resolve_reduce_strategy,
                            run_steps, _host_sum, _leaf_bytes, _tree_bytes)
from ..systems.pim import (DPU_FREQ_HZ, DPU_MRAM_BYTES_PER_CYCLE,
                           DPU_OP_CYCLES, DPU_PIPELINE_SATURATION_THREADS,
                           WORKLOAD_STORAGE_DTYPE, DpuCostModel, PimConfig,
                           PimSystem, workload_element_bytes)

__all__ = [
    "DPU_FREQ_HZ", "DPU_MRAM_BYTES_PER_CYCLE", "DPU_OP_CYCLES",
    "DPU_PIPELINE_SATURATION_THREADS", "DpuCostModel", "FabricReduce",
    "HierarchicalReduce", "HostReduce", "PimConfig", "PimSystem",
    "ReduceStrategy", "ReduceVia", "StepProgram", "StrategyLike",
    "System", "TransferStats", "WORKLOAD_STORAGE_DTYPE", "chunk_schedule",
    "resolve_reduce_strategy", "run_steps", "workload_element_bytes",
]
