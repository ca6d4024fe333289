"""Multi-tenant PIM training-job scheduler (DESIGN.md §7.2).

``PimScheduler`` layers job management on the unified workload API: it
owns a :class:`~repro_torch.sched.allocator.BankAllocator` per parent
:class:`~repro_torch.systems.base.System` (a single PimSystem, or a mixed
``{"pim": ..., "host": ...}`` machine — DESIGN.md §10.3), admits queued
jobs when rank-aligned capacity exists, runs each admitted job on its
own slice (``System.slice``: a
:class:`~repro_torch.sched.allocator.PimSlice` core extent on PIM, a
thread-pool lane scope on a host target), and gang-steps all running
jobs round-robin — one trainer iteration per job per turn — so K
concurrent fits interleave on a single host thread, exactly the way the
UPMEM host serially orchestrates many tenants' rank allocations
(paper §2.2).

Lifecycle: ``QUEUED -> RUNNING -> DONE | FAILED | CANCELLED`` plus the
non-terminal ``PREEMPTED`` detour (DESIGN.md §11): a running job can be
paused at a chunk boundary — its trainer carry snapshotted via the
``ChunkTick`` it last yielded, its lease released — and later resumed
on a fresh lease, a different scheduler, or a different execution
System (migration subject to the elastic compatibility matrix).
Preemption powers priority eviction (``preemptive=True``), allocator
defragmentation (:meth:`PimScheduler.defragment`), and explicit
:meth:`JobHandle.preempt` / :meth:`PimScheduler.resume`.  Failure
is isolated per job: an exception inside one job's step marks that job
FAILED (the exception object rides on the handle) and never unwinds the
drain loop or the other tenants — and jobs with a retry budget are
instead restored from their last in-memory snapshot and continue
(supervised retry, fault-injectable via ``REPRO_INJECT_FAULT`` —
repro_torch/elastic/fault.py).

Accounting: every job records the ``TransferStats`` delta of its slice
(attributable bytes even though jobs interleave — snapshot/delta, see
TransferStats), its step count, and modeled seconds from the
:class:`~repro_torch.systems.topology.HierarchicalCostModel` (steps x
per-iteration kernel + rank-serialized transfer legs — DESIGN.md §12).

Fused gangs: ``sweep(..., fused=True)`` routes same-``fuse_key`` GD jobs
through :class:`~repro_torch.sched.gang.FusedGdSweep` — one slice, one shared
dataset, one batched kernel launch per step for the whole gang.

Port of ``repro.sched.scheduler``: the same states, admission order,
leases, accounting and ``queue.json`` records.  Two things differ on a
card.  A turn on a CUDA slice ends with a synchronize of the slice's
current stream, inside the turn's ``perf_counter`` envelope: kernels are
enqueued asynchronously, so without it ``measured_seconds`` (and the
drift and straggler observations fed from it) would time the host's
enqueue, not the chunk; the waits are summed in ``sync_seconds``.  And a
runnable drops its slice, device dataset and trainer when it leaves the
running set, so a finished or preempted job holds no device memory (the
host arrays stay for a resume).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import json
import math
import os
import threading
import time
from typing import List, Mapping, Optional, Union

import torch

from ..api.dataset import PimDataset
from ..api.registry import FitResult, TrainerSpec, Workload, get_workload
from ..elastic import (InjectedFault, check_migration, injector_from_env,
                       job_fingerprint, snapshot_iters)
from ..elastic import checkpoint as elastic_ckpt
from ..obs.metrics import DRIFT_BUCKETS, Histogram, MetricsRegistry
from ..obs.trace import TRACER
from ..systems import (ChunkTick, HierarchicalCostModel, PimTopology,
                       System, TransferStats)
from ..train.fault_tolerance import StragglerMonitor
from .allocator import BankAllocator, BankLease, FragmentationStats, PimSlice
from .gang import FusedGdSweep, plan_fusion


class JobState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    #: paused at a chunk boundary, carry snapshotted, lease released;
    #: non-terminal — ``scheduler.resume(handle)`` continues the fit
    PREEMPTED = "preempted"
    DONE = "done"
    FAILED = "failed"
    CANCELLED = "cancelled"

    @property
    def terminal(self) -> bool:
        return self in (JobState.DONE, JobState.FAILED,
                        JobState.CANCELLED)


#: cost-model routing: workload registry name -> (model workload key,
#: version selector).  Unknown workloads simply skip cycle accounting.
_COST_KEYS = {"linreg": "lin", "logreg": "log", "dtree": "dtr",
              "kmeans": "kme", "emb": "emb"}
_COST_VERSIONS = {"dtree": "fp32", "kmeans": "int16"}


def _checkpoint_params(workload_name: str, params) -> dict:
    """The job's hyperparameters as the reference records them.  Its
    built-in workloads carry a ``kernel_backend`` knob (Pallas or jnp,
    None = auto) that the port has no use for, since the tensor's device
    picks the kernel; adding it back makes a fingerprint and a
    checkpoint's envelope the reference's, so either package resumes
    the other's checkpoint directory."""
    out = dict(params)
    if workload_name in _COST_KEYS:
        out.setdefault("kernel_backend", None)
    return out


def _cost_k(params: dict) -> int:
    """The cost model's free ``k`` knob: cluster count for KME,
    minibatch size for EMB, inert (16) elsewhere."""
    return params.get("n_clusters", params.get("batch", 16))


class SloViolation(RuntimeError):
    """A modeled-time SLO rejected work at admission (DESIGN.md §14.3):
    the cost model priced a job (or a whole manifest's makespan bound)
    above ``max_modeled_seconds``.  Admission control answers *before*
    anything runs, so the rejection is a first-class outcome — it rides
    on ``JobHandle.error`` / the manifest report, never a crash."""


class JobHandle:
    """Caller-facing view of one submitted training job.

    Fields filled in as the job progresses: ``state``, ``steps``
    (scheduling turns taken — with step fusion one turn drains a whole
    chunk, one CUDA graph replay on a card), ``iters`` (trainer
    iterations covered: the
    ``fit_steps`` generators yield how many iterations each turn
    advanced, 1 unfused, up to ``fuse_steps`` fused — DESIGN.md §9.3),
    ``result`` (FitResult on DONE), ``error`` (the exception on FAILED),
    ``transfer`` (the job's attributable TransferStats delta; for fused
    jobs this is the whole gang's delta — they share one slice),
    ``modeled_seconds`` (HierarchicalCostModel step pricing — per-DPU
    kernel plus rank-serialized transfer legs, DESIGN.md §12 — summed
    per iteration),
    and ``lease`` (the core extent while running).

    Elastic accounting (DESIGN.md §11): ``snapshot`` is the last
    materialized chunk-boundary state (the retry/resume source) and
    ``snapshot_kind`` the System kind it was taken on (the migration
    matrix validates against it); ``retry_budget``/``recoveries`` track
    supervised retry, ``preemptions`` counts preempt/resume cycles,
    ``straggler_flags`` the scheduler's per-chunk wall-time outliers,
    ``gpu`` the slice-scoped roofline delta on a gpu-model target, and
    ``restored`` marks a finished job replayed from a crash-surviving
    queue record without re-running.
    """

    def __init__(self, job_id: int, workload: Workload, spec: TrainerSpec,
                 priority: int, n_cores: int, name: Optional[str] = None):
        self.id = job_id
        self.workload = workload
        self.spec = spec
        self.priority = priority
        self.n_cores = n_cores
        self.name = name or f"job{job_id}:{workload.name}/{spec.version}"
        self.target = "pim"     # execution target on a mixed machine
        self.state = JobState.QUEUED
        self.steps = 0
        self.iters = 0
        self.result: Optional[FitResult] = None
        self.error: Optional[BaseException] = None
        self.transfer: Optional[TransferStats] = None
        self.modeled_seconds = 0.0
        #: wall seconds of the scheduling chunks this job was live in
        #: (gang members each see the full shared-chunk time); paired
        #: with ``modeled_seconds`` it yields the drift ratio
        self.measured_seconds = 0.0
        #: per-chunk measured/modeled wall-time ratios (DESIGN.md §13.5)
        self.drift = Histogram(DRIFT_BUCKETS)
        self.lease: Optional[BankLease] = None
        self.fused = False
        self.retry_budget = 0
        self.recoveries = 0
        self.preemptions = 0
        self.straggler_flags = 0
        self.snapshot: Optional[dict] = None
        self.snapshot_kind: Optional[str] = None
        self.fingerprint: Optional[str] = None
        self.gpu = None
        self.restored = False
        #: service-mode latency accounting (time.monotonic seconds,
        #: DESIGN.md §14.2): queue latency = started_at - submitted_at,
        #: completion latency = finished_at - submitted_at.  started_at
        #: is the *first* admission (preempt/resume cycles keep it);
        #: finished_at is stamped at the terminal transition.
        self.submitted_at = time.monotonic()
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        #: absolute monotonic deadline under the "deadline" policy
        #: (submit's ``deadline_seconds`` added to ``submitted_at``)
        self.deadline: Optional[float] = None
        self.deadline_missed = False
        self._cancel_requested = False
        self._preempt_requested = False

    @property
    def done(self) -> bool:
        return self.state.terminal

    def cancel(self) -> None:
        """Request cancellation: queued/preempted jobs cancel
        immediately, running jobs at their next gang-step boundary."""
        if not self.done:
            self._cancel_requested = True
            if self.state in (JobState.QUEUED, JobState.PREEMPTED):
                self.state = JobState.CANCELLED

    def preempt(self) -> None:
        """Request preemption at the next chunk boundary: the trainer
        carry is snapshotted, the lease released, and the handle parks
        in PREEMPTED until :meth:`PimScheduler.resume` — on the same
        scheduler, a fresh one, or a different execution target
        (migration per the elastic compatibility matrix, DESIGN.md
        §11.3).  Only meaningful on a RUNNING job; non-resumable
        workloads lose their progress and restart on resume."""
        if self.state is JobState.RUNNING:
            self._preempt_requested = True

    @property
    def queue_latency(self) -> Optional[float]:
        """Seconds from submission to first admission; None while
        queued (or when the job was rejected before ever running)."""
        if self.started_at is None:
            return None
        return self.started_at - self.submitted_at

    @property
    def completion_latency(self) -> Optional[float]:
        """Seconds from submission to the terminal transition; None
        until the job settles."""
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    @property
    def drift_ratio(self) -> Optional[float]:
        """Whole-job measured/modeled wall-time ratio — the PR 7
        calibration as a continuously monitored invariant (DESIGN.md
        §13.5).  None when the cost model never priced this job
        (non-PIM target, unknown workload): absence, not a guess."""
        if self.modeled_seconds <= 0.0:
            return None
        return self.measured_seconds / self.modeled_seconds

    def metrics(self) -> dict:
        """The job's telemetry as one JSON-serializable record: progress
        counters, drift accounting, elastic counters, and — when the
        lifecycle settled them — the attributable TransferStats /
        modeled-GPU deltas of its slice."""
        out = {
            "state": self.state.value,
            "target": self.target,
            "steps": self.steps,
            "iters": self.iters,
            "modeled_seconds": self.modeled_seconds,
            "measured_seconds": self.measured_seconds,
            "drift_ratio": self.drift_ratio,
            "drift": self.drift.to_dict(),
            "preemptions": self.preemptions,
            "recoveries": self.recoveries,
            "straggler_flags": self.straggler_flags,
            "queue_latency": self.queue_latency,
            "completion_latency": self.completion_latency,
            "deadline_missed": self.deadline_missed,
        }
        if self.transfer is not None:
            out["transfer"] = dataclasses.asdict(self.transfer)
        if self.gpu is not None:
            out["gpu_model"] = dataclasses.asdict(self.gpu)
        return out

    def __repr__(self) -> str:
        return (f"JobHandle({self.name!r}, {self.state.value}, "
                f"steps={self.steps}, cores={self.n_cores})")


def _modeled_step_seconds(handle: JobHandle, dataset: PimDataset,
                          slice_: System) -> float:
    """Modeled seconds for one training iteration of this job on its
    slice: per-DPU kernel time plus the rank-serialized broadcast/gather
    legs of the slice's own rank tree
    (:meth:`HierarchicalCostModel.step_seconds` — DESIGN.md §12).  0.0
    for workloads outside the paper's cost model, and for jobs running
    on a non-PIM target — DPU cycle accounting is meaningless there."""
    if getattr(slice_, "kind", None) != "pim":
        return 0.0
    wl_key = _COST_KEYS.get(handle.workload.name)
    if wl_key is None:
        return 0.0
    version = _COST_VERSIONS.get(handle.workload.name, handle.spec.version)
    model = HierarchicalCostModel(slice_.topology)
    return model.step_seconds(
        wl_key, version, dataset.n, dataset.n_features,
        n_cores=slice_.config.n_cores, n_threads=slice_.config.n_threads,
        k=_cost_k(handle.spec.params))


def _estimate_job_seconds(workload_name: str, spec: TrainerSpec, data,
                          n_cores: int, system: System) -> float:
    """Submission-time whole-job estimate (iters x step_seconds) from
    the host data shapes alone — the backfill ordering key and the
    ``capacity_estimate`` unit.  0.0 when the cost model cannot price
    the job (unknown workload/version, non-PIM target): such jobs keep
    their plain submission order."""
    if getattr(system, "kind", None) != "pim":
        return 0.0
    wl_key = _COST_KEYS.get(workload_name)
    if wl_key is None:
        return 0.0
    version = _COST_VERSIONS.get(workload_name, spec.version)
    X = data[0]
    n = int(X.shape[0])
    n_features = int(X.shape[1]) if getattr(X, "ndim", 1) > 1 else 1
    topo = getattr(system, "topology", None)
    if topo is None or n_cores > topo.n_cores:
        topo = PimTopology.for_cores(max(n_cores, 1))
    model = HierarchicalCostModel(topo)
    try:
        return model.job_seconds(
            wl_key, version, n, n_features,
            n_iters=int(spec.params.get("n_iters", 100)),
            n_cores=n_cores, n_threads=system.config.n_threads,
            k=_cost_k(spec.params))
    except (KeyError, ValueError):
        return 0.0


# ---------------------------------------------------------------------------
# Runnables: one admitted queue entry (a single job or a fused gang).
# ---------------------------------------------------------------------------

class _Runnable:
    """Base: owns a lease + slice + dataset and advances by one step."""

    def __init__(self, jobs: List[JobHandle], data, priority: int,
                 seq: int, n_cores: int, target: str = "pim"):
        self.jobs = jobs
        self.data = data
        self.priority = priority
        self.seq = seq
        self.n_cores = n_cores
        self.target = target
        #: trace/track label: the job name, or the gang spelled as one
        self.label = (jobs[0].name if len(jobs) == 1
                      else f"gang[{len(jobs)}]:{jobs[0].name}")
        self.lease: Optional[BankLease] = None
        self.slice: Optional[System] = None
        #: modeled whole-job seconds (backfill ordering key; 0.0 when
        #: the cost model cannot price the job)
        self.est_seconds = 0.0
        #: earliest member deadline (EDF admission key under the
        #: "deadline" policy; None sorts last)
        self.deadline: Optional[float] = None
        self._snapshot: Optional[TransferStats] = None
        self._gpu_snapshot = None

    @property
    def live_jobs(self) -> List[JobHandle]:
        return [j for j in self.jobs if not j.done]

    def release(self) -> None:
        """Drop the slice, its device dataset and the trainer once the
        runnable leaves the running set: a service that keeps every
        finished runnable must not keep its device memory (each slice
        also holds its own chunk-graph cache).  ``data``, the host
        arrays, stays for a resume."""
        self.slice = self.dataset = None

    def start(self, system: System, lease: BankLease) -> None:
        self.lease = lease
        # the system hands out its own slice type: PimSlice over a core
        # extent, HostSlice over thread-pool lanes (DESIGN.md §10.3)
        self.slice = system.slice(lease)
        self._snapshot = self.slice.stats.snapshot()
        gpu = getattr(self.slice, "gpu", None)
        self._gpu_snapshot = gpu.snapshot() if gpu is not None else None
        X, y = self.data
        self.dataset = self.slice.put(X, y)
        for job in self.jobs:
            if job.state in (JobState.QUEUED, JobState.PREEMPTED):
                job.state = JobState.RUNNING
                job.lease = lease
                job.n_cores = lease.n_cores
                if job.started_at is None:
                    job.started_at = time.monotonic()

    def _transfer_delta(self) -> TransferStats:
        return self.slice.stats.delta(self._snapshot)

    def _account(self, job: JobHandle) -> None:
        """Settle per-job accounting at a lifecycle boundary: the
        slice's TransferStats delta, and — on a gpu-model target — the
        slice-scoped roofline delta (satellite: per-job modeled-GPU
        attribution via GpuModelReport.delta)."""
        job.transfer = self._transfer_delta()
        if self._gpu_snapshot is not None:
            job.gpu = self.slice.gpu.delta(self._gpu_snapshot)

    def advance(self, sched: "Optional[PimScheduler]" = None) -> bool:
        """One gang step; True when the runnable is finished."""
        raise NotImplementedError


class _SingleRun(_Runnable):
    """One job advanced via its workload's ``fit_steps`` generator.

    The elastic unit of the scheduler (DESIGN.md §11): each yielded
    :class:`~repro_torch.systems.base.ChunkTick` carries a lazy snapshot of
    the trainer carry, so the run can be preempted at any chunk
    boundary, checkpointed on a cadence, retried after a fault from its
    last snapshot, or recreated on another scheduler/System from a
    ``resume_state``."""

    def __init__(self, *args, resume_state: Optional[dict] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self._resume_state = resume_state
        self._last_tick: Optional[ChunkTick] = None

    def _make_gen(self, job: JobHandle, state: Optional[dict]):
        # only pass state= when resuming: legacy/third-party workloads
        # predating the elastic API keep working un-resumed
        if state is None:
            return job.workload.fit_steps(self.dataset, job.spec)
        return job.workload.fit_steps(self.dataset, job.spec, state=state)

    def start(self, system: System, lease: BankLease) -> None:
        super().start(system, lease)
        job = self.jobs[0]
        self.gen = self._make_gen(job, self._resume_state)
        self._last_tick = None
        self._step_seconds = _modeled_step_seconds(job, self.dataset,
                                                   self.slice)

    def release(self) -> None:
        gen, self.gen = getattr(self, "gen", None), None
        if gen is not None:
            gen.close()      # a fused fit's ``finally`` drops its graphs
        self._last_tick = None
        super().release()

    def _materialize(self, job: JobHandle) -> bool:
        """Snapshot the last chunk boundary onto the handle; False when
        the workload never yielded a resumable tick."""
        tick = self._last_tick
        if tick is None or not tick.resumable:
            return False
        job.snapshot = tick.snapshot()
        job.snapshot_kind = getattr(self.slice, "kind", "pim")
        return True

    def _preempt(self, job: JobHandle,
                 sched: "Optional[PimScheduler]") -> bool:
        job._preempt_requested = False
        self._materialize(job)
        self.gen.close()
        job.state = JobState.PREEMPTED
        job.preemptions += 1
        self._account(job)
        if TRACER.enabled:
            TRACER.instant("preempt", track=f"job:{job.name}",
                           cat="elastic", steps=job.steps, iters=job.iters)
        if sched is not None:
            sched.metrics.counter("sched.preemptions").inc()
            sched._persist_job(job)
        return True

    def _fail_or_retry(self, job: JobHandle, err: BaseException,
                       sched: "Optional[PimScheduler]") -> bool:
        """Supervised retry (train.fault_tolerance semantics applied to
        the scheduler): restore from the job's last snapshot while the
        retry budget lasts; otherwise FAILED."""
        if (job.retry_budget - job.recoveries > 0
                and not job._cancel_requested):
            job.recoveries += 1
            job.error = err          # last fault survives for forensics
            self.gen.close()
            job.iters = snapshot_iters(job.snapshot)
            self.gen = self._make_gen(job, job.snapshot)
            self._last_tick = None
            if TRACER.enabled:
                TRACER.instant("retry", track=f"job:{job.name}",
                               cat="elastic", recoveries=job.recoveries,
                               error=type(err).__name__)
            if sched is not None:
                sched.metrics.counter("sched.retries").inc()
            return False
        job.error = err
        job.state = JobState.FAILED
        self._account(job)
        if TRACER.enabled:
            TRACER.instant("fail", track=f"job:{job.name}", cat="elastic",
                           error=type(err).__name__)
        return True

    def advance(self, sched: "Optional[PimScheduler]" = None) -> bool:
        job = self.jobs[0]
        if job._cancel_requested:
            self.gen.close()
            job.state = JobState.CANCELLED
            self._account(job)
            return True
        if job._preempt_requested:
            return self._preempt(job, sched)
        try:
            if (sched is not None and sched.injector is not None
                    and sched.injector(job.name, job.steps + 1)):
                raise InjectedFault(
                    f"injected fault: job {job.name!r} step "
                    f"{job.steps + 1}")
            advanced = next(self.gen)
        except StopIteration as stop:
            job.result = stop.value
            job.state = JobState.DONE
            self._account(job)
            return True
        except Exception as err:  # noqa: BLE001 — isolation by design
            return self._fail_or_retry(job, err, sched)
        # generators yield the iteration count each turn covered (a
        # fused chunk drains several); tolerate legacy generators that
        # yield something else by charging one iteration
        tick = advanced if isinstance(advanced, ChunkTick) else None
        advanced = advanced if isinstance(advanced, int) and advanced > 0 \
            else 1
        job.steps += 1
        job.iters += advanced
        job.modeled_seconds += advanced * self._step_seconds
        self._last_tick = tick
        if (sched is not None and sched.checkpoint_dir is not None
                and job.steps % max(1, sched.checkpoint_every) == 0
                and self._materialize(job)):
            sched._persist_job(job)
        return False


class _FusedRun(_Runnable):
    """A fused GD gang: one slice, one dataset, one launch per step."""

    def start(self, system: System, lease: BankLease) -> None:
        super().start(system, lease)
        workload = self.jobs[0].workload
        self.gang = FusedGdSweep(workload,
                                 [j.spec for j in self.jobs],
                                 self.dataset)
        self._step_seconds = [
            _modeled_step_seconds(j, self.dataset, self.slice)
            for j in self.jobs]
        for job in self.jobs:
            job.fused = True

    def release(self) -> None:
        gang, self.gang = getattr(self, "gang", None), None
        if gang is not None and gang._program is not None:
            gang._program.release()  # a gang cancelled whole keeps its graphs
        super().release()

    def _finish(self) -> None:
        delta = self._transfer_delta()
        for lane, job in enumerate(self.jobs):
            if job.done or job.state is JobState.PREEMPTED:
                continue
            job.transfer = delta
            result = self.gang.result(lane)
            if result is None:
                job.state = JobState.CANCELLED
            else:
                job.result = result
                job.state = JobState.DONE

    def advance(self, sched: "Optional[PimScheduler]" = None) -> bool:
        for lane, job in enumerate(self.jobs):
            if job._cancel_requested and self.gang.active[lane]:
                self.gang.deactivate(lane)
                job.state = JobState.CANCELLED
                job.transfer = self._transfer_delta()
            elif job._preempt_requested and self.gang.active[lane]:
                # a fused lane leaves its gang: carry synced out via
                # lane_state, lane deactivated; resume() re-enters as an
                # ordinary _SingleRun (gang membership is not restored)
                job._preempt_requested = False
                self.gang.deactivate(lane)
                job.snapshot = self.gang.lane_state(lane)
                job.snapshot_kind = getattr(self.slice, "kind", "pim")
                job.state = JobState.PREEMPTED
                job.preemptions += 1
                self._account(job)
                if TRACER.enabled:
                    TRACER.instant("preempt", track=f"job:{job.name}",
                                   cat="elastic", steps=job.steps,
                                   fused=True)
                if sched is not None:
                    sched.metrics.counter("sched.preemptions").inc()
                    sched._persist_job(job)
        it_before = self.gang.it
        try:
            finished = self.gang.step()
        except Exception as err:  # noqa: BLE001 — the gang shares a launch
            delta = self._transfer_delta()
            for job in self.live_jobs:
                if job.state is JobState.PREEMPTED:
                    continue     # already safely off the gang
                job.error = err
                job.state = JobState.FAILED
                job.transfer = delta
            return True
        advanced = self.gang.it - it_before
        if advanced:                     # a launch actually happened
            for lane, job in enumerate(self.jobs):
                if self.gang.active[lane]:
                    job.steps += 1       # one turn, maybe a whole chunk
                    job.iters += advanced
                    job.modeled_seconds += (advanced
                                            * self._step_seconds[lane])
        if finished:
            self._finish()
        return finished


# ---------------------------------------------------------------------------
# The scheduler.
# ---------------------------------------------------------------------------

class PimScheduler:
    """FIFO+priority scheduler of training jobs over one or more Systems.

    ``system`` is a single :class:`~repro_torch.systems.base.System` (the
    original surface) or a ``{target_name: System}`` mapping — a *mixed*
    machine, e.g. ``{"pim": PimSystem(...), "host": HostSystem(...)}``:
    one queue, one drain loop, per-target bank allocators, and
    ``submit(..., target="host")`` routes a job to the named target
    (default: the first/only one).  A HostSystem is schedulable too —
    its "cores" are thread-pool lanes and its slices are accounting
    scopes over the same single-image execution (DESIGN.md §10.3).

    ``rank_size=None`` auto-selects the largest divisor of each machine
    not exceeding UPMEM's 64-DPU rank (see ``default_rank_size``; an
    explicit ``rank_size`` applies to the default target only);
    ``backfill=True`` lets smaller jobs jump a queue head that doesn't
    fit (better utilization, admission no longer strictly ordered —
    off by default to keep head-of-line semantics, which with multiple
    targets is per target: a full PIM machine never stalls host-lane
    admissions).
    """

    def __init__(self,
                 system: Union[System, Mapping[str, System]],
                 rank_size: Optional[int] = None,
                 backfill: bool = False,
                 preemptive: bool = False,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1,
                 fault_injector=None,
                 default_retry_budget: int = 0,
                 placement: str = "first_fit",
                 policy: str = "fifo",
                 max_modeled_seconds: Optional[float] = None):
        if isinstance(system, Mapping):
            if not system:
                raise ValueError("need at least one system to schedule on")
            self.systems = dict(system)
        else:
            self.systems = {getattr(system, "kind", "pim"): system}
        self.default_target = next(iter(self.systems))
        # rank_size=None -> the allocator's auto rank (largest divisor
        # of the machine <= the 64-DPU UPMEM rank); each allocator
        # scores placements against its system's own rank tree when one
        # exists ("contention" policy, DESIGN.md §12.4)
        self.placement = placement
        #: scheduler-scoped control-plane metrics (admissions, chunks,
        #: evictions, drift histograms — repro_torch.obs.metrics)
        self.metrics = MetricsRegistry()
        self._allocators = {
            name: BankAllocator(
                sys_.config.n_cores,
                rank_size if name == self.default_target else None,
                topology=getattr(sys_, "topology", None),
                placement=placement,
                trace_track=f"channels:{name}")
            for name, sys_ in self.systems.items()}
        self.system = self.systems[self.default_target]
        self.allocator = self._allocators[self.default_target]
        #: a system whose cores are spread over ranks: every rank runs
        #: this scheduler, and the clock its decisions read is rank 0's
        #: (``_now``)
        self._ranked = next((s for s in self.systems.values()
                             if getattr(s, "ranks", None) is not None), None)
        self.backfill = backfill
        #: priority preemption in _admit: a high-priority submit may
        #: evict lower-priority resumable RUNNING jobs to claim cores
        self.preemptive = preemptive
        #: durable elastic checkpoints (None = in-memory snapshots only)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.default_retry_budget = default_retry_budget
        #: fault injection hook — explicit injector wins, else the
        #: REPRO_INJECT_FAULT environment plan (None when unset)
        self.injector = (fault_injector if fault_injector is not None
                         else injector_from_env())
        self._monitors: dict = {}   # job id -> StragglerMonitor
        if policy not in ("fifo", "deadline"):
            raise ValueError(f"unknown policy {policy!r}; "
                             "known: 'fifo', 'deadline'")
        #: admission-ordering policy: "fifo" = (priority desc,
        #: submission order); "deadline" = earliest absolute deadline
        #: first within a priority band (EDF — deadline-less jobs sort
        #: last).  Deadlines also extend preemptive eviction: an
        #: earlier-deadline submit may evict an equal-priority,
        #: later-deadline victim (``_outranks``, DESIGN.md §14.3).
        self.policy = policy
        #: default modeled-seconds admission SLO (None = unbounded);
        #: submit's per-job ``max_modeled_seconds`` overrides.  Jobs the
        #: cost model prices above the bound are rejected at submission:
        #: FAILED with an SloViolation on ``error``, never queued.
        self.max_modeled_seconds = max_modeled_seconds
        # service mode (DESIGN.md §14.2): one reentrant lock guards the
        # queue/running/finished structures; the Condition carries
        # "work arrived / state changed" wakeups between submitting
        # threads, the background drain loop, and wait()ers.  A
        # separate mutex serializes whole scheduling turns so two
        # threads can never co-advance one job's generator.
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._step_mutex = threading.Lock()
        self._serve_thread: Optional[threading.Thread] = None
        self._stop_serving = False
        self._drain_on_stop = True
        self._queue: List[_Runnable] = []
        self._running: List[_Runnable] = []
        self._finished: List[_Runnable] = []
        self._seq = itertools.count()
        self._next_job_id = itertools.count()
        self.handles: List[JobHandle] = []
        #: turn-end synchronizes on CUDA slices and the seconds they waited
        self.syncs = 0
        self.sync_seconds = 0.0

    # -- submission ----------------------------------------------------------

    def _resolve_target(self, target: Optional[str]) -> str:
        if target is None:
            return self.default_target
        if target not in self.systems:
            raise ValueError(f"unknown target {target!r}; known: "
                             f"{sorted(self.systems)}")
        return target

    def _sized(self, n_cores: Optional[int],
               target: Optional[str] = None) -> int:
        """Rank-align a request, rejecting unschedulable sizes at
        submission time (an over-machine job would livelock admission)."""
        alloc = self._allocators[self._resolve_target(target)]
        size = alloc.align(n_cores)
        if size > alloc.n_cores:
            raise ValueError(
                f"job needs {size} cores (rank-aligned) but the machine "
                f"has {alloc.n_cores}")
        return size

    @staticmethod
    def _resolve_workload(workload: Union[str, Workload]) -> Workload:
        if isinstance(workload, str):
            return get_workload(workload)
        return workload

    @staticmethod
    def _host_arrays(data) -> tuple:
        """Normalize submit() data to host (X, y).

        Accepted: (X, y) tuple, a bare X array, or a PimDataset — whose
        *host* arrays are re-sharded onto the job's slice (device shards
        are shaped by their owning system and cannot be re-scoped)."""
        if isinstance(data, PimDataset):
            return data.X, data.y
        if isinstance(data, tuple):
            if len(data) != 2:
                raise ValueError(f"data tuple must be (X, y), got "
                                 f"{len(data)} elements")
            return data
        return data, None

    def submit(self, workload: Union[str, Workload], data,
               spec: Optional[TrainerSpec] = None, *,
               version: Optional[str] = None, n_cores: Optional[int] = None,
               priority: int = 0, name: Optional[str] = None,
               target: Optional[str] = None,
               retry_budget: Optional[int] = None,
               resume_state: Optional[dict] = None,
               resume_from_kind: Optional[str] = None,
               deadline_seconds: Optional[float] = None,
               max_modeled_seconds: Optional[float] = None,
               **params) -> JobHandle:
        """Queue one training job; returns its :class:`JobHandle`.

        ``spec`` wins when given; otherwise one is built from
        ``version``/``**params`` exactly as ``make_estimator`` would.
        ``n_cores`` is rounded up to whole ranks at admission (None =
        one rank).  ``target`` picks the execution System on a mixed
        machine (None = the default target).  Jobs run when capacity
        exists, in (priority desc, submission order).

        Elastic knobs (DESIGN.md §11): ``retry_budget`` caps supervised
        retries from the last snapshot (None = the scheduler default);
        ``resume_state`` seeds the fit from a prior chunk-boundary
        snapshot — cross-System migration is validated when
        ``resume_from_kind`` names the System kind the snapshot was
        taken on (integer versions are bit-exact only between
        numerically-like kinds; fp32 migrates anywhere).

        Service/SLO knobs (DESIGN.md §14): ``deadline_seconds`` sets an
        absolute deadline (now + the given seconds) — the admission key
        under the "deadline" policy and the deadline-miss observable
        under any policy; ``max_modeled_seconds`` (per-job, overriding
        the scheduler default) rejects the job at submission when the
        cost model prices it above the bound — the handle comes back
        FAILED with an :class:`SloViolation` on ``error``, nothing is
        queued.  Thread-safe: may be called while a serve loop drains.
        """
        wl = self._resolve_workload(workload)
        if spec is None:
            spec = wl.spec(version, **params)
        elif version is not None or params:
            raise TypeError("pass either spec= or version=/params, "
                            "not both")
        with self._work:
            target = self._resolve_target(target)
            size = self._sized(n_cores, target)
            handle = JobHandle(next(self._next_job_id), wl, spec,
                               priority, size, name)
            handle.submitted_at = self._now()
            handle.target = target
            handle.retry_budget = (self.default_retry_budget
                                   if retry_budget is None
                                   else retry_budget)
            data = self._host_arrays(data)
            if self.checkpoint_dir is not None:
                handle.fingerprint = job_fingerprint(
                    wl.name, spec.version,
                    _checkpoint_params(wl.name, spec.params),
                    data[0], data[1])
            if resume_state is not None:
                if resume_from_kind is not None:
                    to_kind = getattr(self.systems[target], "kind", "pim")
                    check_migration(resume_from_kind, to_kind,
                                    spec.version)
                handle.snapshot = resume_state
                handle.iters = snapshot_iters(resume_state)
            run = _SingleRun([handle], data, priority,
                             next(self._seq), size, target,
                             resume_state=resume_state)
            run.est_seconds = _estimate_job_seconds(
                wl.name, spec, data, size, self.systems[target])
            bound = (max_modeled_seconds if max_modeled_seconds is not None
                     else self.max_modeled_seconds)
            if bound is not None and run.est_seconds > bound:
                handle.error = SloViolation(
                    f"job {handle.name!r}: modeled "
                    f"{run.est_seconds:.4g}s exceeds "
                    f"max_modeled_seconds={bound:.4g}")
                handle.state = JobState.FAILED
                handle.finished_at = time.monotonic()
                self.handles.append(handle)
                self.metrics.counter("sched.slo_rejections").inc()
                self._work.notify_all()
                return handle
            if deadline_seconds is not None:
                handle.deadline = (handle.submitted_at
                                   + float(deadline_seconds))
                run.deadline = handle.deadline
            self._queue.append(run)
            self.handles.append(handle)
            self._work.notify_all()
        return handle

    def sweep(self, workload: Union[str, Workload], data, grid: dict, *,
              version: Optional[str] = None, n_cores: Optional[int] = None,
              fused: bool = True, priority: int = 0,
              target: Optional[str] = None,
              **base_params) -> List[JobHandle]:
        """Submit the cartesian product of ``grid`` as one job per point.

        With ``fused=True`` (default), points whose ``fuse_key`` matches
        are gang-fused: one slice, one shared bank-resident dataset, one
        batched kernel launch per step for the whole gang (learning-rate
        sweeps collapse to a single dispatch).  Non-fusable points fall
        back to ordinary per-job scheduling.  Handles come back in grid
        order regardless of gang grouping.
        """
        wl = self._resolve_workload(workload)
        keys = sorted(grid)
        combos = [dict(zip(keys, values))
                  for values in itertools.product(*(grid[k] for k in keys))]
        specs = [wl.spec(version, **{**base_params, **combo})
                 for combo in combos]
        with self._work:
            target = self._resolve_target(target)
            size = self._sized(n_cores, target)
            data = self._host_arrays(data)

            groups = (plan_fusion(wl, specs) if fused
                      else [[i] for i in range(len(specs))])
            handles: List[Optional[JobHandle]] = [None] * len(specs)
            for group in groups:
                group_handles = []
                for i in group:
                    handle = JobHandle(next(self._next_job_id), wl,
                                       specs[i], priority, size)
                    handle.target = target
                    handles[i] = handle
                    group_handles.append(handle)
                    self.handles.append(handle)
                cls = _FusedRun if len(group) > 1 else _SingleRun
                run = cls(group_handles, data, priority,
                          next(self._seq), size, target)
                # a fused gang advances all lanes per launch, so its
                # duration is one member's, not the sum
                run.est_seconds = max(
                    (_estimate_job_seconds(wl.name, specs[i], data, size,
                                           self.systems[target])
                     for i in group), default=0.0)
                self._queue.append(run)
            self._work.notify_all()
        return handles

    # -- execution -----------------------------------------------------------

    def _preempt_running(self, run: _Runnable,
                         requeue: bool = True) -> Optional[JobHandle]:
        """Preempt a RUNNING _SingleRun at its current chunk boundary:
        snapshot the carry, release the lease, and (by default) requeue
        a fresh runnable seeded from the snapshot."""
        job = run.jobs[0]
        job._preempt_requested = True
        run.advance(self)
        self._allocators[run.target].release(run.lease)
        self._running.remove(run)
        self._finished.append(run)
        run.release()
        if job.state is not JobState.PREEMPTED:
            return None     # raced with completion/cancel — nothing lost
        if requeue:
            self._requeue(job)
        return job

    def _requeue(self, job: JobHandle) -> None:
        """PREEMPTED -> QUEUED on a fresh runnable seeded from the
        job's snapshot (None restarts non-resumable workloads)."""
        run = self._find_run(job)
        job.state = JobState.QUEUED
        job.lease = None
        job.iters = snapshot_iters(job.snapshot)
        new = _SingleRun([job], run.data, job.priority,
                         next(self._seq), job.n_cores, job.target,
                         resume_state=job.snapshot)
        self._queue.append(new)
        if TRACER.enabled:
            TRACER.instant("requeue", track=f"job:{job.name}",
                           cat="elastic", iters=job.iters)

    def _find_run(self, job: JobHandle) -> _Runnable:
        for pool in (self._running, self._finished, self._queue):
            for run in pool:
                if job in run.jobs:
                    return run
        raise ValueError(f"job {job.name!r} is not tracked by this "
                         "scheduler")

    def _outranks(self, run: _Runnable, victim: _Runnable) -> bool:
        """Eviction order: strictly higher priority always outranks;
        under the "deadline" policy an equal-priority run with a
        strictly earlier deadline also outranks a deadline-less or
        later-deadline victim (EDF eviction, DESIGN.md §14.3)."""
        if victim.priority < run.priority:
            return True
        if (self.policy == "deadline" and victim.priority == run.priority
                and run.deadline is not None):
            return victim.deadline is None or victim.deadline > run.deadline
        return False

    def _evict_for(self, run: _Runnable,
                   alloc: BankAllocator) -> Optional[BankLease]:
        """Priority preemption: free cores for ``run`` by preempting
        outranked resumable single jobs on its target (lowest priority
        first, latest deadline first under the "deadline" policy, LIFO
        within a band), retrying the allocation after each eviction.
        Returns the won lease, or None when even preempting every
        eligible victim cannot fit the request (then nobody is
        preempted)."""
        victims = [r for r in self._running
                   if r.target == run.target
                   and isinstance(r, _SingleRun)
                   and self._outranks(run, r)
                   and getattr(r.jobs[0].workload, "resumable", False)
                   and not r.jobs[0].done]
        if not victims:
            return None
        reclaimable = sum(r.lease.n_cores for r in victims)
        if alloc.free_cores + reclaimable < run.n_cores:
            return None
        victims.sort(key=lambda r: (
            r.priority,
            -(r.deadline if r.deadline is not None else math.inf),
            -r.seq))
        for victim in victims:
            self._preempt_running(victim, requeue=True)
            self.metrics.counter("sched.evictions").inc()
            if TRACER.enabled:
                TRACER.instant("evict", track="sched", cat="sched",
                               victim=victim.label, by=run.label)
            lease = alloc.allocate(run.n_cores)
            if lease is not None:
                return lease
        return None

    def defragment(self, target: Optional[str] = None) -> int:
        """Compact a target's allocator under churn: preempt every
        resumable running single job at its chunk boundary (releasing
        its lease), then re-admit — the allocator's first-fit over the
        coalesced free list packs the survivors contiguously.  Returns
        how many jobs were cycled.  Fused gangs are left in place
        (one gang = one lease; moving it buys nothing).  Serialized
        against scheduling turns: safe to call while a serve loop
        drains (the preempt lands at the next chunk boundary)."""
        with self._step_mutex, self._work:
            target = self._resolve_target(target)
            movable = [r for r in self._running
                       if r.target == target and isinstance(r, _SingleRun)
                       and getattr(r.jobs[0].workload, "resumable", False)
                       and not r.jobs[0].done]
            moved = 0
            for run in movable:
                if self._preempt_running(run, requeue=True) is not None:
                    moved += 1
            self._admit()
            self.metrics.counter("sched.defragments").inc()
            if TRACER.enabled:
                TRACER.instant("defragment", track="sched", cat="sched",
                               target=target, moved=moved)
            return moved

    def _admit(self) -> None:
        self._queue = [r for r in self._queue if r.live_jobs]
        # backfill mode additionally orders equal-priority candidates by
        # modeled job time (shortest-first — DESIGN.md §12.5): since
        # backfill already abandons strict submission order, the model's
        # estimate decides who jumps a blocked head.  Unpriceable jobs
        # (est 0.0) sort first and fall back to submission order.  The
        # "deadline" policy inserts EDF between priority and the
        # backfill/FIFO tie-breakers (DESIGN.md §14.3).
        if self.policy == "deadline":
            key = (lambda r: (-r.priority,
                              r.deadline if r.deadline is not None
                              else math.inf,
                              r.est_seconds if self.backfill else 0.0,
                              r.seq))
        elif self.backfill:
            key = (lambda r: (-r.priority, r.est_seconds, r.seq))
        else:
            key = (lambda r: (-r.priority, r.seq))
        pending = sorted(self._queue, key=key)
        blocked: set = set()    # head-of-line blocking is per target
        for run in pending:
            if run.target in blocked:
                continue
            alloc = self._allocators[run.target]
            lease = alloc.allocate(run.n_cores)
            if lease is None and self.preemptive:
                lease = self._evict_for(run, alloc)
            if lease is None:
                if not self.backfill:
                    blocked.add(run.target)
                continue
            self._queue.remove(run)
            try:
                run.start(self.systems[run.target], lease)
            except Exception as err:  # noqa: BLE001 — bad data/spec must
                # fail the job, not unwind the other tenants' drain
                alloc.release(lease)
                for job in run.live_jobs:
                    job.error = err
                    job.state = JobState.FAILED
                self._finished.append(run)
                run.release()
                continue
            self._running.append(run)
            self.metrics.counter("sched.admissions").inc()
            if TRACER.enabled:
                TRACER.instant("admit", track="sched", cat="sched",
                               job=run.label, target=run.target,
                               cores=lease.n_cores, start=lease.start)

    def _observe_stragglers(self, run: _Runnable, dt: float) -> None:
        """Feed each live job's per-chunk wall time into its
        StragglerMonitor (EWMA z-score over scheduling turns — the
        train.fault_tolerance detector wired into the drain loop)."""
        for job in run.jobs:
            if job.done:
                continue
            mon = self._monitors.get(job.id)
            if mon is None:
                mon = self._monitors[job.id] = StragglerMonitor()
            if mon.observe(dt):
                job.straggler_flags += 1

    def _account_drift(self, run: _Runnable, dt: float,
                       before: dict) -> None:
        """Per-chunk modeled-vs-measured settlement (DESIGN.md §13.5):
        every job live at the chunk start is charged the chunk's wall
        time, and — when the cost model priced any progress this chunk —
        one drift-ratio observation lands on the job's histogram and the
        scheduler-wide one.  Gang members share a launch, so each lane
        sees the full chunk wall time (the ratio then reads as
        wall-per-lane, comparable across fused/unfused runs of the same
        job, not as machine throughput)."""
        chunks = self.metrics.counter("sched.chunks")
        drift_hist = None   # materialized only when a ratio exists
        for job in run.jobs:
            if job.id not in before:
                continue    # finished before this chunk: not charged
            job.measured_seconds += dt
            chunks.inc()
            modeled = job.modeled_seconds - before[job.id]
            if modeled > 0.0 and dt > 0.0:
                ratio = dt / modeled
                job.drift.observe(ratio)
                if drift_hist is None:
                    drift_hist = self.metrics.histogram(
                        "sched.drift_ratio", DRIFT_BUCKETS)
                drift_hist.observe(ratio)

    def _now(self) -> float:
        """``time.monotonic()``; over ranks rank 0's, broadcast, so that
        the deadlines (the "deadline" policy's admission key) and the
        misses are the same on every rank, and the ranks take the same
        decisions in the same order.  Every rank calls it at the same
        points (submission, settling)."""
        if self._ranked is None:
            return time.monotonic()
        return self._ranked.ranks.broadcast_value(time.monotonic(),
                                                  self._ranked.device)

    def _settle(self, run: _Runnable) -> None:
        """Stamp completion latency on every job of ``run`` that just
        reached a terminal state, and count deadline misses — the SLO
        observable the "deadline" policy is judged by (DESIGN.md §14)."""
        now = self._now()
        for job in run.jobs:
            if job.done and job.finished_at is None:
                job.finished_at = now
                if (job.deadline is not None
                        and not job.deadline_missed
                        and now > job.deadline):
                    job.deadline_missed = True
                    self.metrics.counter("sched.deadline_misses").inc()

    def _sync(self, run: _Runnable) -> None:
        """End a turn on a CUDA slice when its chunk has run, not when its
        kernels are enqueued; the wait is summed in ``sync_seconds``."""
        device = getattr(run.slice, "device", None)
        if device is None or device.type != "cuda":
            return
        t0 = time.perf_counter()
        torch.cuda.current_stream(device).synchronize()
        self.sync_seconds += time.perf_counter() - t0
        self.syncs += 1

    def step(self) -> bool:
        """One scheduling turn: admit what fits, then advance every
        running job by one gang step (round-robin, admission order).
        Returns True while any job is queued or running.  Explicitly
        preempted jobs park in PREEMPTED (their lease released) until
        :meth:`resume`; parked jobs do not keep the drain loop alive.

        Thread-safe (serve mode, DESIGN.md §14.2): whole turns are
        serialized — two threads can never co-advance one job's
        generator — and the structure lock is dropped around each job's
        chunk so ``submit()``/``stats()``/``wait()`` stay responsive
        mid-chunk."""
        with self._step_mutex:
            return self._step_turn()

    def _step_turn(self) -> bool:
        with self._work:
            self._admit()
            runs = list(self._running)
        for run in runs:
            with self._work:
                if run not in self._running:
                    continue   # evicted mid-turn / finished elsewhere
                # drift accounting (DESIGN.md §13.5): modeled progress
                # this chunk is the delta each live job's _step_seconds
                # pricing adds during advance; wall time is the chunk's
                # perf_counter envelope.  Snapshot first, settle in
                # _account_drift.
                before = {j.id: j.modeled_seconds for j in run.jobs
                          if not j.done}
            t0 = time.perf_counter()
            if TRACER.enabled:
                with TRACER.span("chunk", f"target:{run.target}",
                                 "chunk", job=run.label):
                    with TRACER.span(run.label, f"job:{run.label}",
                                     "chunk"):
                        finished = run.advance(self)
            else:
                finished = run.advance(self)
            self._sync(run)
            dt = time.perf_counter() - t0
            with self._work:
                self._observe_stragglers(run, dt)
                self._account_drift(run, dt, before)
                if finished and run in self._running:
                    self._allocators[run.target].release(run.lease)
                    self._running.remove(run)
                    self._finished.append(run)
                    run.release()
                self._settle(run)
                self._work.notify_all()
        with self._work:
            if self.checkpoint_dir is not None:
                self._persist_queue()
            self._work.notify_all()
            return bool(self._running or self._queue)

    def drain(self) -> List[JobHandle]:
        """Run scheduling turns until every job reaches a terminal
        state; returns all handles.  One job's failure never stops the
        drain (failure isolation is per step, see _SingleRun.advance)."""
        while self.step():
            pass
        return self.handles

    # -- service mode: background drain loop (DESIGN.md §14.2) ---------------

    @property
    def serving(self) -> bool:
        """True while the background drain loop is alive."""
        thread = self._serve_thread
        return thread is not None and thread.is_alive()

    @property
    def idle(self) -> bool:
        """True when nothing is queued or running (parked PREEMPTED
        jobs don't count — only ``resume()`` revives those)."""
        with self._lock:
            return not (self._queue or self._running)

    def serve(self, poll_interval: float = 0.05) -> None:
        """Start the background drain loop: a daemon thread that runs
        scheduling turns whenever work exists and sleeps on the work
        Condition otherwise (``poll_interval`` bounds the sleep so
        externally-flipped state — e.g. ``handle.cancel()`` — is seen
        promptly).  ``submit()``/``sweep()``/``resume()`` return
        immediately while the loop drains; work submitted mid-flight is
        admitted at the loop's next turn.  One loop per scheduler —
        starting twice is an error."""
        with self._work:
            if self.serving:
                raise RuntimeError("scheduler is already serving")
            self._stop_serving = False
            self._drain_on_stop = True
            self._serve_thread = threading.Thread(
                target=self._serve_loop, args=(float(poll_interval),),
                name="pim-sched-serve", daemon=True)
            self._serve_thread.start()

    def _serve_loop(self, poll_interval: float) -> None:
        while True:
            with self._work:
                while (not self._stop_serving
                       and not (self._queue or self._running)):
                    self._work.wait(poll_interval)
                if self._stop_serving and (
                        not self._drain_on_stop
                        or not (self._queue or self._running)):
                    self._work.notify_all()
                    return
            try:
                self.step()
            except Exception:  # noqa: BLE001 — per-job failures are
                # already isolated inside step(); this backstop only
                # catches scheduler-level faults, counted so the loop
                # never dies silently
                self.metrics.counter("sched.serve_errors").inc()

    def shutdown(self, wait: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop the serve loop.  ``wait=True`` (default) first drains
        every queued/running job to a terminal state — no submitted
        work is lost; ``wait=False`` stops after the in-flight turn,
        leaving the queue intact (a later :meth:`serve` or
        :meth:`drain` picks it up).  No-op when not serving; raises
        when the loop fails to stop within ``timeout`` seconds."""
        with self._work:
            thread = self._serve_thread
            if thread is None:
                return
            self._drain_on_stop = wait
            self._stop_serving = True
            self._work.notify_all()
        thread.join(timeout)
        if thread.is_alive():
            raise RuntimeError(
                f"serve loop did not stop within {timeout}s")
        with self._work:
            self._serve_thread = None

    def wait(self, handles: Optional[List[JobHandle]] = None,
             timeout: Optional[float] = None) -> bool:
        """Block until every given handle (default: all) settles —
        terminal, or parked in PREEMPTED (only :meth:`resume` un-parks
        those; waiting on them would hang forever).  True when settled,
        False on timeout.  Progress needs a draining thread: serve
        mode, or another thread calling ``step()``/``drain()``."""
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        with self._work:
            while True:
                targets = (handles if handles is not None
                           else self.handles)
                if all(h.done or h.state is JobState.PREEMPTED
                       for h in targets):
                    return True
                remaining = 0.5
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                    remaining = min(remaining, 0.5)
                self._work.wait(remaining)

    def latency_summary(self) -> dict:
        """Queue/completion latency percentiles over every job that
        reached the corresponding lifecycle point — the service-level
        observables of DESIGN.md §14.2 (time.monotonic seconds): queue
        latency is first admission minus submission, completion latency
        is the terminal transition minus submission."""
        with self._lock:
            queued = [h.started_at - h.submitted_at
                      for h in self.handles if h.started_at is not None]
            completed = [h.finished_at - h.submitted_at
                         for h in self.handles
                         if h.finished_at is not None]
            misses = sum(1 for h in self.handles if h.deadline_missed)

        def _pcts(xs: List[float]) -> dict:
            if not xs:
                return {"count": 0, "mean": None, "p50": None,
                        "p99": None, "max": None}
            xs = sorted(xs)

            def pct(q: float) -> float:
                return xs[min(len(xs) - 1,
                              max(0, math.ceil(q * len(xs)) - 1))]

            return {"count": len(xs), "mean": sum(xs) / len(xs),
                    "p50": pct(0.50), "p99": pct(0.99), "max": xs[-1]}

        return {"queue": _pcts(queued), "completion": _pcts(completed),
                "deadline_misses": misses}

    # -- elastic: preempt / resume / migrate / persist -----------------------

    def resume(self, handle: JobHandle, *, data=None,
               target: Optional[str] = None) -> JobHandle:
        """Requeue a PREEMPTED job from its snapshot.

        ``target`` may name a *different* execution System (cross-System
        migration): the move is validated against the elastic
        compatibility matrix — integer versions only between
        numerically-like kinds, fp32 anywhere (tolerance-tested,
        DESIGN.md §11.3).  ``data`` re-supplies the host arrays when the
        handle comes from another scheduler (same-scheduler resumes find
        them on the parked runnable).  The handle itself is reused; on a
        foreign scheduler it is adopted into ``handles``.
        """
        with self._work:
            if handle.state is not JobState.PREEMPTED:
                raise ValueError(f"can only resume a PREEMPTED job, "
                                 f"{handle.name!r} is "
                                 f"{handle.state.value}")
            to_target = self._resolve_target(
                target if target is not None
                else (handle.target
                      if handle.target in self.systems else None))
            if (handle.snapshot is not None
                    and handle.snapshot_kind is not None):
                to_kind = getattr(self.systems[to_target], "kind", "pim")
                check_migration(handle.snapshot_kind, to_kind,
                                handle.spec.version)
            if data is None:
                data = self._find_data(handle)
            else:
                data = self._host_arrays(data)
            handle.target = to_target
            handle.n_cores = self._sized(handle.n_cores, to_target)
            handle.state = JobState.QUEUED
            handle.lease = None
            handle.iters = snapshot_iters(handle.snapshot)
            run = _SingleRun([handle], data, handle.priority,
                             next(self._seq), handle.n_cores, to_target,
                             resume_state=handle.snapshot)
            run.deadline = handle.deadline
            self._queue.append(run)
            if handle not in self.handles:
                self.handles.append(handle)
            self.metrics.counter("sched.resumes").inc()
            if TRACER.enabled:
                TRACER.instant("resume", track=f"job:{handle.name}",
                               cat="elastic", target=to_target,
                               iters=handle.iters)
            self._work.notify_all()
        return handle

    def _find_data(self, handle: JobHandle) -> tuple:
        try:
            return self._find_run(handle).data
        except ValueError:
            raise ValueError(
                f"job {handle.name!r} belongs to another scheduler; "
                "pass data= to resume it here") from None

    def attach_resume_state(self, handle: JobHandle, snapshot: dict,
                            envelope: Optional[dict] = None) -> None:
        """Seed a still-QUEUED job with a restored checkpoint (the
        crash-recovery path: run_manifest re-submits the manifest, then
        attaches each job's durable snapshot before draining).

        The envelope — when given — must carry a matching config+dataset
        ``fingerprint`` (refuse to resume someone else's weights) and
        its ``system_kind`` is migration-checked against the job's
        target."""
        with self._lock:
            self._attach_resume_state(handle, snapshot, envelope)

    def _attach_resume_state(self, handle: JobHandle, snapshot: dict,
                             envelope: Optional[dict]) -> None:
        if handle.state is not JobState.QUEUED:
            raise ValueError("attach_resume_state needs a QUEUED job, "
                             f"{handle.name!r} is {handle.state.value}")
        if envelope is not None:
            fp = envelope.get("fingerprint")
            if (fp and handle.fingerprint is not None
                    and fp != handle.fingerprint):
                raise ValueError(
                    f"checkpoint fingerprint mismatch for {handle.name!r}"
                    ": the saved config+dataset differ from the "
                    "submitted job")
            from_kind = envelope.get("system_kind")
            if from_kind:
                to_kind = getattr(self.systems[handle.target], "kind",
                                  "pim")
                check_migration(from_kind, to_kind, handle.spec.version)
                handle.snapshot_kind = from_kind
        run = self._find_run(handle)
        if not isinstance(run, _SingleRun):
            raise ValueError("cannot attach a resume state to a fused "
                             "gang member; submit it unfused")
        handle.snapshot = snapshot
        handle.iters = snapshot_iters(snapshot)
        run._resume_state = snapshot

    def mark_restored(self, handle: JobHandle, *, iters: int = 0,
                      steps: int = 0) -> None:
        """Mark a still-QUEUED job DONE-equivalent from a crash-surviving
        queue record: the fit already finished in the killed process, so
        ``--resume`` must not re-run it.  The handle lands in DONE with
        ``restored=True`` and no in-memory FitResult (the caller reloads
        artifacts from its own checkpoint if it needs them)."""
        with self._lock:
            if handle.state is not JobState.QUEUED:
                raise ValueError("mark_restored needs a QUEUED job, "
                                 f"{handle.name!r} is "
                                 f"{handle.state.value}")
            handle.state = JobState.DONE
            handle.restored = True
            handle.iters = iters
            handle.steps = steps

    def _persist_job(self, job: JobHandle) -> None:
        """Durably checkpoint one job's snapshot (atomic tmp+rename via
        train/checkpoint.py's format, see repro_torch/elastic)."""
        if self.checkpoint_dir is None or job.snapshot is None:
            return
        self.metrics.counter("sched.checkpoints").inc()
        if TRACER.enabled:
            TRACER.instant("checkpoint", track=f"job:{job.name}",
                           cat="elastic", steps=job.steps)
        elastic_ckpt.save_snapshot(
            elastic_ckpt.job_dir(self.checkpoint_dir, job.name),
            job.snapshot,
            envelope={
                "workload": job.workload.name,
                "version": job.spec.version,
                "params": _checkpoint_params(job.workload.name,
                                             job.spec.params),
                "fingerprint": job.fingerprint,
                "system_kind": job.snapshot_kind,
                "iters": snapshot_iters(job.snapshot),
                "steps": job.steps,
            })

    def _persist_queue(self) -> None:
        """Crash-survivable queue manifest: one atomic ``queue.json``
        naming every job and its state, so ``pim_jobs --resume`` can
        tell finished work from unfinished after a kill (-9 included:
        the rename is the commit point)."""
        rows = [{
            "name": h.name,
            "workload": h.workload.name,
            "version": h.spec.version,
            "state": h.state.value,
            "iters": h.iters,
            "steps": h.steps,
            "priority": h.priority,
            "n_cores": h.n_cores,
            "target": h.target,
            "fingerprint": h.fingerprint,
        } for h in self.handles]
        path = os.path.join(self.checkpoint_dir, "queue.json")
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"schema": 1, "jobs": rows}, fh, indent=1)
        os.replace(tmp, path)

    # -- introspection -------------------------------------------------------

    def counts(self) -> dict:
        by_state: dict = {s.value: 0 for s in JobState}
        for h in self.handles:
            by_state[h.state.value] += 1
        return by_state

    def fragmentation(self) -> FragmentationStats:
        return self.allocator.fragmentation()

    def stats(self) -> dict:
        """Operator snapshot: job counts, occupancy, queue depth.

        The top-level occupancy keys describe the default target (the
        original single-system surface); ``targets`` breaks occupancy
        out per execution System on a mixed machine."""
        with self._lock:
            return self._stats_locked()

    def _stats_locked(self) -> dict:
        frag = self.fragmentation()
        out = {
            "jobs": self.counts(),
            "policy": self.policy,
            "serving": self.serving,
            "queued_runnables": len(self._queue),
            "running_runnables": len(self._running),
            "cores_used": frag.used_cores,
            "cores_free": frag.free_cores,
            "external_fragmentation": frag.external_fragmentation,
            # topology occupancy (DESIGN.md §12.4): per-memory-channel
            # leased fraction and how many live leases straddle ranks —
            # the observables defragment()/placement decisions act on
            "per_channel_occupancy": list(frag.per_channel_occupancy),
            "rank_straddling_leases": frag.rank_straddling_leases,
            # elastic/fault-tolerance counters (DESIGN.md §11)
            "straggler_flags": sum(h.straggler_flags
                                   for h in self.handles),
            "preemptions": sum(h.preemptions for h in self.handles),
            "recoveries": sum(h.recoveries for h in self.handles),
        }
        out["targets"] = {
            name: {
                "kind": getattr(self.systems[name], "kind", "pim"),
                "cores_used": f.used_cores,
                "cores_free": f.free_cores,
                "external_fragmentation": f.external_fragmentation,
                "per_channel_occupancy": list(f.per_channel_occupancy),
                "rank_straddling_leases": f.rank_straddling_leases,
            }
            for name, f in ((n, a.fragmentation())
                            for n, a in self._allocators.items())}
        # unified telemetry (DESIGN.md §13): the scheduler's own
        # control-plane metrics, the parent Systems' transfer totals
        # (each job's attributable share lives on its handle), per-job
        # drift accounting, and the modeled-GPU roofline totals
        out["metrics"] = self.metrics.to_dict()
        out["transfer"] = {
            name: dataclasses.asdict(sys_.stats.snapshot())
            for name, sys_ in self.systems.items()}
        gpu = {name: dataclasses.asdict(sys_.gpu.snapshot())
               for name, sys_ in self.systems.items()
               if getattr(sys_, "gpu", None) is not None}
        if gpu:
            out["gpu_model"] = gpu
        out["drift"] = {
            h.name: {
                "modeled_seconds": h.modeled_seconds,
                "measured_seconds": h.measured_seconds,
                "ratio": h.drift_ratio,
                "chunks": h.drift.count,
                "mean_chunk_ratio": h.drift.mean,
            }
            for h in self.handles if h.measured_seconds > 0.0}
        out["latency"] = self.latency_summary()
        return out

    def capacity_estimate(self, doc: dict) -> dict:
        """Model-based capacity plan for a manifest — is this machine
        big enough, and what throughput can it promise? (DESIGN.md
        §12.5.)

        Prices every job/sweep point of the manifest through the
        :class:`HierarchicalCostModel` using only the declared dataset
        *shapes* (nothing is materialized, nothing runs) and returns

          ``jobs``                per-job rows (name, cores, modeled
                                  seconds),
          ``total_core_seconds``  the work integral,
          ``serial_seconds``      one-at-a-time makespan (sum),
          ``makespan_lower_bound``  max(longest job, work / machine) —
                                  no schedule can beat it,
          ``jobs_per_second``     job count over that bound: the
                                  capacity-planning claim ("N banks
                                  serve M jobs/s") as a measurable
                                  model output.

        Unpriceable jobs (workloads outside the paper's cost model)
        appear with ``modeled_seconds = 0.0`` and weaken the bound —
        they are counted, not guessed at.
        """
        from ..api.registry import get_workload as _get_wl
        from .manifest import dataset_shape

        shapes = {name: dataset_shape(spec)
                  for name, spec in (doc.get("datasets") or {}).items()}

        def _shape(entry: dict) -> tuple:
            name = entry.get("dataset")
            if name is None:
                if len(shapes) == 1:
                    return next(iter(shapes.values()))
                raise ValueError(f"job {entry} names no dataset and the "
                                 f"manifest defines {len(shapes)}")
            try:
                return shapes[name]
            except KeyError:
                raise ValueError(
                    f"job references unknown dataset {name!r}; "
                    f"known: {sorted(shapes)}") from None

        class _ShapeOnly:
            """Stands in for the host X array in the estimator."""
            def __init__(self, n, f):
                self.shape, self.ndim = (n, f), 2

        system = self.systems[self.default_target]
        alloc = self._allocators[self.default_target]
        rows = []

        def _price(entry: dict, spec, wl_name: str) -> None:
            n, f = _shape(entry)
            size = self._sized(entry.get("cores"))
            sec = _estimate_job_seconds(wl_name, spec,
                                        (_ShapeOnly(n, f), None),
                                        size, system)
            rows.append({
                "name": entry.get("name",
                                  f"{wl_name}/{spec.version}"),
                "workload": wl_name, "version": spec.version,
                "cores": size, "modeled_seconds": sec,
            })

        for entry in doc.get("jobs") or []:
            wl = _get_wl(entry["workload"])
            spec = wl.spec(entry.get("version"),
                           **(entry.get("params") or {}))
            _price(entry, spec, wl.name)
        for entry in doc.get("sweeps") or []:
            wl = _get_wl(entry["workload"])
            grid = entry["grid"]
            keys = sorted(grid)
            base = dict(entry.get("params") or {})
            for values in itertools.product(*(grid[k] for k in keys)):
                spec = wl.spec(entry.get("version"),
                               **{**base, **dict(zip(keys, values))})
                _price(entry, spec, wl.name)
        if not rows:
            raise ValueError("manifest defines no jobs or sweeps")

        total_core_seconds = sum(r["modeled_seconds"] * r["cores"]
                                 for r in rows)
        serial = sum(r["modeled_seconds"] for r in rows)
        longest = max((r["modeled_seconds"] for r in rows), default=0.0)
        bound = max(longest, total_core_seconds / alloc.n_cores)
        return {
            "machine_cores": alloc.n_cores,
            "placement": self.placement,
            "jobs": rows,
            "total_core_seconds": total_core_seconds,
            "serial_seconds": serial,
            "makespan_lower_bound": bound,
            "jobs_per_second": (len(rows) / bound) if bound > 0 else 0.0,
        }
