"""Multi-tenant PIM job scheduling (port of ``repro.sched``).

The subsystem that turns the workload-session API into a concurrent
training service: :class:`BankAllocator` carves the cores axis into
rank-aligned :class:`PimSlice` views (the UPMEM rank-allocation model,
paper §2.2); :class:`PimScheduler` queues jobs by priority, admits them
by capacity, gang-steps all running fits round-robin on one host
thread, and fuses eligible GD sweeps into one batched kernel launch per
step (:mod:`repro_torch.sched.gang`); :mod:`repro_torch.sched.manifest`
is the declarative front end the ``repro_torch.launch.pim_jobs`` CLI
drives.

Elastic job runtime (:mod:`repro_torch.elastic`): jobs checkpoint their
trainer carry at chunk boundaries, preempt and resume across
leases/schedulers/Systems, survive injected faults via supervised
retry, and a killed queue restarts from its durable ``queue.json`` +
per-job snapshots (``pim_jobs --resume``).  Snapshots, checkpoint
directories and queue records cross packages: one the reference wrote
resumes here and vice versa.
"""
from .allocator import (DEFAULT_RANK_SIZE, PLACEMENT_POLICIES, BankAllocator,
                        BankLease, FragmentationStats, PimSlice,
                        default_rank_size)
from .gang import FUSABLE_WORKLOADS, FusedGdSweep, fuse_key, plan_fusion
from .manifest import (dataset_shape, job_report, load_manifest,
                       run_manifest, serve_manifests, submit_manifest)
from .scheduler import JobHandle, JobState, PimScheduler, SloViolation

__all__ = [
    "BankAllocator", "BankLease", "DEFAULT_RANK_SIZE",
    "FUSABLE_WORKLOADS", "FragmentationStats", "FusedGdSweep",
    "JobHandle", "JobState", "PLACEMENT_POLICIES", "PimScheduler",
    "PimSlice", "SloViolation", "dataset_shape",
    "default_rank_size", "fuse_key", "job_report", "load_manifest",
    "plan_fusion", "run_manifest", "serve_manifests", "submit_manifest",
]
