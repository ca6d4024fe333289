"""The workload-session API — the port's public surface.

Training data is partitioned ONCE and stays resident across iterations
(paper §2.2, Fig. 3):

  System / make_system    execution targets: PimSystem (simulated PIM
                          cores on one device), HostSystem (the
                          processor-centric baseline) and
                          ModeledGpuSystem (host numerics priced on an
                          A100 roofline)
  HierarchicalCostModel   the PIM machine's launch pricing (DPU kernel
                          time + rank-serialized transfer legs)
  PimDataset              resident dataset handle (System.put); quantized
                          views are lazy and cached
  ShardedTable            row-sharded embedding table handle
                          (System.put_table) with the deferred-update
                          ledger
  Workload / registry     LIN, LOG, DTR, KME and EMB behind one
                          TrainerSpec -> FitResult
  make_estimator          sklearn-style facade over a registered workload
  ReduceStrategy          pluggable cross-core reduction, per call

Typical session::

    from repro_torch.api import make_estimator, make_system

    system = make_system("pim", n_cores=16)          # device="cuda"
    ds = system.put(X, y)                            # one partition
    for lr in (0.05, 0.1, 0.2):                      # sweep reuses it
        make_estimator("linreg", version="int32", lr=lr,
                       system=system).fit(ds)
"""
from ..systems import (DpuCostModel, FabricReduce, GpuModelConfig,
                       HierarchicalCostModel, HierarchicalReduce,
                       HostConfig, HostReduce, HostSystem, ModeledGpuSystem,
                       PimConfig, PimSystem, PimTopology, ReduceStrategy,
                       ReduceVia, System, TransferStats, make_system,
                       resolve_reduce_strategy)
from .dataset import PimDataset
from .estimator import PimEstimator, make_estimator
from .registry import (FitResult, TrainerSpec, Workload, get_workload,
                       list_workloads, register_workload)
from .table import ShardedTable
from . import workloads  # noqa: F401 — registers the workloads

__all__ = [
    "DpuCostModel", "FabricReduce", "FitResult", "GpuModelConfig",
    "HierarchicalCostModel", "HierarchicalReduce", "HostConfig",
    "HostReduce", "HostSystem", "ModeledGpuSystem", "PimConfig",
    "PimDataset", "PimEstimator", "PimSystem", "PimTopology",
    "ReduceStrategy", "ReduceVia", "ShardedTable", "System",
    "TrainerSpec", "TransferStats", "Workload", "get_workload",
    "list_workloads", "make_estimator", "make_system", "register_workload",
    "resolve_reduce_strategy",
]
