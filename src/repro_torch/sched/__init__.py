"""Multi-tenant PIM job scheduling, its base (port of ``repro.sched``).

:class:`BankAllocator` carves the cores axis into rank-aligned
:class:`PimSlice` views (the UPMEM rank-allocation model, paper §2.2), and
:mod:`~repro_torch.sched.gang` fuses eligible GD sweeps into one batched
kernel launch per step.  The scheduler and the manifest front end that
drive them are not ported yet.
"""
from .allocator import (DEFAULT_RANK_SIZE, PLACEMENT_POLICIES, BankAllocator,
                        BankLease, FragmentationStats, PimSlice,
                        default_rank_size)
from .gang import FUSABLE_WORKLOADS, FusedGdSweep, fuse_key, plan_fusion

__all__ = [
    "BankAllocator", "BankLease", "DEFAULT_RANK_SIZE",
    "FUSABLE_WORKLOADS", "FragmentationStats", "FusedGdSweep",
    "PLACEMENT_POLICIES", "PimSlice", "default_rank_size", "fuse_key",
    "plan_fusion",
]
