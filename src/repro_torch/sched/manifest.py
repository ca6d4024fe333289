"""Job manifests: declarative YAML/JSON input for the training service.

A manifest names one PIM system, a set of synthetic datasets, and the
jobs/sweeps to run over them; :func:`run_manifest` builds the
:class:`~repro_torch.sched.scheduler.PimScheduler`, submits everything, drains
the queue, and returns the handles.  This is the programmatic core of
the ``repro_torch.launch.pim_jobs`` CLI (DESIGN.md §7.4).

Schema (all sections optional except ``jobs``/``sweeps`` — at least one)::

    system:   {kind: pim|host|gpu-model, cores: 64, rank_size: 16,
               reduce: fabric, backfill: false,
               placement: first_fit|contention,
               policy: fifo|deadline}
    slo:      {max_modeled_seconds: X}   # admission control (§14.3)
    priority: N     # spool-lane priority in serve mode (§14.4): higher
                    # admits first within a scan; default 0
    datasets: {name: {kind: linear|classification|blobs|recsys,
                      samples: N, features: F, seed: S, ...}}
    jobs:     [{workload: linreg, version: int32, dataset: name,
                cores: 16, priority: 0, params: {lr: 0.1, ...},
                deadline_seconds: X, max_modeled_seconds: X}]
    sweeps:   [{workload: linreg, dataset: name, grid: {lr: [...]},
                fused: true, cores: 16, params: {...}}]

YAML input needs PyYAML; JSON always works (a ``.json`` manifest or any
file whose text parses as JSON).

Port of ``repro.sched.manifest``.  :func:`build_system` and
:func:`run_manifest` take the ``device`` every system of the port runs
on (``"cuda"`` unless the caller asks for ``"cpu"``).  The port's PIM
system has one execution path, the reference's ``backend: vmap`` (all
cores one leading tensor axis); ``backend: shard_map`` spreads the cores
over a device mesh, which waits for the distributed layer (ROADMAP queue
1 item 12) and raises ``NotImplementedError``.

Service mode (DESIGN.md §14.4): :func:`submit_manifest` admits one
manifest onto an existing — possibly serving — scheduler, so new
manifests land mid-flight while earlier ones still drain;
:func:`serve_manifests` is the long-running spool-directory watcher
behind ``pim_jobs --serve``.  Admission control happens *before*
anything is queued: a manifest whose modeled makespan lower bound
exceeds its ``slo.max_modeled_seconds`` (or the service default) is
rejected whole with :class:`~repro_torch.sched.scheduler.SloViolation` —
a first-class outcome the callers report, never a crash.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..data.synthetic import (make_blobs, make_classification,
                              make_linear_dataset, make_recsys)
from ..systems import System, make_system
from .scheduler import JobHandle, PimScheduler, SloViolation, _SingleRun


def load_manifest(path: str) -> dict:
    """Parse a YAML or JSON manifest file into a dict."""
    with open(path) as fh:
        text = fh.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        try:
            import yaml
        except ImportError:
            raise ValueError(
                f"{path} is not JSON and PyYAML is unavailable in this "
                f"environment; rewrite the manifest as JSON") from None
        doc = yaml.safe_load(text)
    if not isinstance(doc, dict):
        raise ValueError(f"manifest {path} must be a mapping, "
                         f"got {type(doc).__name__}")
    return doc


def dataset_shape(spec: dict) -> Tuple[int, int]:
    """(samples, features) a ``datasets:`` entry would materialize —
    the shape-only view :meth:`PimScheduler.capacity_estimate` prices
    manifests from without building any arrays."""
    return int(spec.get("samples", 4096)), int(spec.get("features", 16))


def build_dataset(spec: dict) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Materialize one ``datasets:`` entry as host (X, y) arrays."""
    spec = dict(spec)
    kind = spec.pop("kind", "linear")
    n = int(spec.pop("samples", 4096))
    f = int(spec.pop("features", 16))
    seed = int(spec.pop("seed", 0))
    if kind == "linear":
        X, y, _ = make_linear_dataset(n, f, seed=seed, **spec)
        return X, y
    if kind == "classification":
        X, y = make_classification(n, f, seed=seed, **spec)
        return X, y
    if kind == "blobs":
        X, _, _ = make_blobs(n, f, seed=seed, **spec)
        return X, None
    if kind == "recsys":
        # EMB input (DESIGN.md §15): Zipf-skewed (user, item, rating)
        # triples; `features` does not apply (the pair width is 2)
        return make_recsys(n, seed=seed, **spec)
    raise ValueError(f"unknown dataset kind {kind!r}; "
                     f"known: linear, classification, blobs, recsys")


def build_system(spec: Optional[dict], device: str = "cuda"
                 ) -> Tuple[System, dict]:
    """``system:`` entry -> (System, scheduler kwargs).

    ``kind: pim | host | gpu-model`` selects the execution target
    (default pim — DESIGN.md §10); the remaining keys fill its config.
    The system runs on ``device``."""
    spec = dict(spec or {})
    kind = str(spec.pop("kind", "pim"))
    kwargs = dict(n_cores=int(spec.pop("cores", 64)),
                  n_threads=int(spec.pop("threads", 16)),
                  reduce=spec.pop("reduce", "fabric"), device=device)
    backend = spec.pop("backend", None)
    if backend is not None:
        if kind != "pim":
            raise ValueError(
                f"system backend: {backend!r} only applies to kind: pim "
                f"(a {kind!r} target always runs single-image)")
        if backend == "shard_map":
            raise NotImplementedError(
                "system backend: 'shard_map' is not ported yet: the port "
                "runs every core on one device (backend: vmap; ROADMAP "
                "queue 1 item 12)")
    sched_kw = {}
    if "rank_size" in spec:
        sched_kw["rank_size"] = int(spec.pop("rank_size"))
    if "backfill" in spec:
        sched_kw["backfill"] = bool(spec.pop("backfill"))
    if "placement" in spec:
        sched_kw["placement"] = str(spec.pop("placement"))
    if "policy" in spec:
        sched_kw["policy"] = str(spec.pop("policy"))
    if spec:
        raise ValueError(f"unknown system keys {sorted(spec)}")
    return make_system(kind, **kwargs), sched_kw


def submit_manifest(scheduler: PimScheduler, doc: dict, *,
                    max_modeled_seconds: Optional[float] = None,
                    ) -> List[JobHandle]:
    """Admission-check one manifest and submit its jobs/sweeps onto an
    existing scheduler — the mid-flight entry point of serve mode
    (DESIGN.md §14.4): the scheduler may already be draining earlier
    manifests when this one lands.

    SLO admission control (§14.3) runs *first*: when the manifest's
    ``slo.max_modeled_seconds`` (or the ``max_modeled_seconds`` service
    default — the manifest's own knob wins) is set and the
    :meth:`~PimScheduler.capacity_estimate` makespan lower bound
    exceeds it, the whole manifest is rejected with
    :class:`SloViolation` and *nothing* is queued — no partial
    admission.  Per-job entries may additionally carry
    ``deadline_seconds`` / ``max_modeled_seconds``, forwarded to
    :meth:`~PimScheduler.submit` (a per-job SLO rejection comes back as
    a FAILED handle, not an exception).

    Returns the new handles in manifest order (jobs first, then sweep
    points in grid order).
    """
    slo = doc.get("slo") or {}
    bound = slo.get("max_modeled_seconds", max_modeled_seconds)
    if bound is not None:
        est = scheduler.capacity_estimate(doc)["makespan_lower_bound"]
        if est > float(bound):
            scheduler.metrics.counter(
                "sched.manifest_slo_rejections").inc()
            raise SloViolation(
                f"manifest: modeled makespan lower bound {est:.4g}s "
                f"exceeds max_modeled_seconds={float(bound):.4g}")

    datasets: Dict[str, tuple] = {
        name: build_dataset(spec)
        for name, spec in (doc.get("datasets") or {}).items()}

    def _data(entry: dict):
        name = entry.get("dataset")
        if name is None:
            if len(datasets) == 1:
                return next(iter(datasets.values()))
            raise ValueError(f"job {entry} names no dataset and the "
                             f"manifest defines {len(datasets)}")
        try:
            return datasets[name]
        except KeyError:
            raise ValueError(f"job references unknown dataset {name!r}; "
                             f"known: {sorted(datasets)}") from None

    handles: List[JobHandle] = []
    for entry in doc.get("jobs") or []:
        handles.append(scheduler.submit(
            entry["workload"], _data(entry),
            version=entry.get("version"),
            n_cores=entry.get("cores"),
            priority=int(entry.get("priority", 0)),
            name=entry.get("name"),
            deadline_seconds=entry.get("deadline_seconds"),
            max_modeled_seconds=entry.get("max_modeled_seconds"),
            **(entry.get("params") or {})))
    for entry in doc.get("sweeps") or []:
        handles.extend(scheduler.sweep(
            entry["workload"], _data(entry), entry["grid"],
            version=entry.get("version"),
            n_cores=entry.get("cores"),
            fused=bool(entry.get("fused", True)),
            priority=int(entry.get("priority", 0)),
            **(entry.get("params") or {})))
    if not handles:
        raise ValueError("manifest defines no jobs or sweeps")
    return handles


def run_manifest(doc: dict, drain: bool = True, *,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1,
                 resume: bool = False,
                 retry_budget: int = 0,
                 max_modeled_seconds: Optional[float] = None,
                 device: str = "cuda",
                 ) -> Tuple[PimScheduler, List[JobHandle]]:
    """Build the scheduler, submit every job and sweep, optionally drain.

    Returns the scheduler and the handles in manifest order (jobs first,
    then sweep points in grid order).

    Elastic knobs (DESIGN.md §11): ``checkpoint_dir`` makes the run
    crash-survivable — per-job chunk-boundary checkpoints every
    ``checkpoint_every`` scheduling steps plus an atomic ``queue.json``
    record of every job's state.  ``resume=True`` replays a previous
    (possibly killed) run from that directory: finished jobs are marked
    restored without re-running; unfinished jobs continue from their
    last durable snapshot (fingerprint-validated, migration-checked).
    ``retry_budget`` is the per-job supervised-retry default.

    ``max_modeled_seconds`` is the service-default admission SLO
    (§14.3, overridable by the manifest's own ``slo`` section); a
    rejected manifest raises :class:`SloViolation` before anything is
    built or queued.  Every job runs on ``device``.
    """
    system, sched_kw = build_system(doc.get("system"), device)
    scheduler = PimScheduler(system,
                             checkpoint_dir=checkpoint_dir,
                             checkpoint_every=checkpoint_every,
                             default_retry_budget=retry_budget,
                             **sched_kw)
    handles = submit_manifest(scheduler, doc,
                              max_modeled_seconds=max_modeled_seconds)
    if resume and checkpoint_dir is not None:
        _restore_jobs(scheduler, handles, checkpoint_dir)
    if drain:
        scheduler.drain()
    return scheduler, handles


#: manifest filename suffixes the spool watcher picks up
_SPOOL_SUFFIXES = (".json", ".yaml", ".yml")


def _write_status(path: str, record: dict) -> None:
    """Atomic ``<manifest>.status.json`` sidecar: the spool watcher's
    durable accepted/rejected verdict (also its already-processed
    marker across restarts — the manifest file itself is never
    touched)."""
    tmp = path + ".status.json.tmp"
    with open(tmp, "w") as fh:
        json.dump(record, fh, indent=1)
    os.replace(tmp, path + ".status.json")


def serve_manifests(scheduler: PimScheduler, spool_dir: str, *,
                    poll_interval: float = 0.2,
                    idle_timeout: Optional[float] = 10.0,
                    max_modeled_seconds: Optional[float] = None,
                    handles: Optional[List[JobHandle]] = None,
                    ) -> List[dict]:
    """Long-running service front end (DESIGN.md §14.4): watch
    ``spool_dir`` for manifest files and admit each onto the serving
    scheduler as it appears — new manifests land mid-flight while
    earlier ones drain in the background.

    Each manifest file (``.json``/``.yaml``/``.yml``) is processed once
    and answered with an atomic ``<name>.status.json`` sidecar:
    ``accepted`` with its job count, or ``rejected`` with the reason —
    an SLO violation or a malformed manifest fails *that manifest*,
    never the service.

    Ordering: within one scan, new manifests admit by ``(-priority,
    name)`` — a top-level ``priority:`` integer in the manifest jumps
    the FIFO name order (the spool-side priority lane; per-job
    ``priority:`` entries still order execution *inside* the
    scheduler).  Unmarked manifests default to priority 0.

    Restart resilience (DESIGN.md §11.5): the sidecar doubles as the
    durable processed marker, so a restarted watcher *replays* the
    recorded verdict of an already-answered manifest — the record
    returns (tagged ``"replayed": true``) without re-admitting or
    re-running anything, mirroring how ``--resume`` replays finished
    jobs from ``queue.json``.

    Returns when the spool has produced no new manifest and the
    scheduler has been idle (nothing queued or running) for
    ``idle_timeout`` seconds (None = watch forever), with one record
    per processed manifest.  ``handles`` — when given — collects every
    accepted manifest's handles in place.  Starts the serve loop if the
    scheduler is not already serving; the caller owns ``shutdown()``.
    """
    if not scheduler.serving:
        scheduler.serve()
    records: List[dict] = []
    seen: set = set()
    idle_since = time.monotonic()
    while True:
        progressed = False
        try:
            names = sorted(os.listdir(spool_dir))
        except FileNotFoundError:
            names = []
        fresh: list = []
        for name in names:
            if (not name.endswith(_SPOOL_SUFFIXES)
                    or name.endswith(".status.json")):
                continue   # not a manifest / our own answer sidecar
            path = os.path.join(spool_dir, name)
            if path in seen:
                continue
            seen.add(path)
            if os.path.exists(path + ".status.json"):
                # restarted watcher: replay the durable verdict instead
                # of re-running the manifest (§11.5 crash recovery)
                try:
                    with open(path + ".status.json") as fh:
                        old = json.load(fh)
                except (OSError, json.JSONDecodeError):
                    old = {"path": path, "state": "unknown"}
                old["replayed"] = True
                records.append(old)
                continue
            # peek the manifest-level priority; a load failure is a
            # per-manifest verdict, deferred to the admission step
            try:
                doc: object = load_manifest(path)
            except (ValueError, KeyError) as err:
                doc = err
            try:
                prio = int(doc.get("priority", 0)) if isinstance(
                    doc, dict) else 0
            except (TypeError, ValueError):
                prio = 0
            fresh.append((-prio, name, path, doc))
        # the priority lane: per scan, higher `priority:` manifests
        # admit first, name order breaking ties
        for nprio, _name, path, doc in sorted(fresh,
                                              key=lambda t: t[:2]):
            progressed = True
            try:
                if isinstance(doc, Exception):
                    raise doc
                new = submit_manifest(
                    scheduler, doc,
                    max_modeled_seconds=max_modeled_seconds)
                record = {"path": path, "state": "accepted",
                          "jobs": len(new), "priority": -nprio}
                if handles is not None:
                    handles.extend(new)
            except (SloViolation, ValueError, KeyError) as err:
                record = {"path": path, "state": "rejected",
                          "reason": f"{type(err).__name__}: {err}"}
            records.append(record)
            _write_status(path, record)
        if progressed or not scheduler.idle:
            idle_since = time.monotonic()
        elif (idle_timeout is not None
                and time.monotonic() - idle_since >= idle_timeout):
            return records
        time.sleep(poll_interval)


def _restore_jobs(scheduler: PimScheduler, handles: List[JobHandle],
                  checkpoint_dir: str) -> None:
    """Reconcile freshly-submitted manifest jobs against a killed run's
    ``queue.json`` + per-job checkpoints (crash recovery, DESIGN.md
    §11.5): finished records short-circuit via ``mark_restored`` (the
    manifest completes without redoing their work); everything else
    resumes from its last durable snapshot when one exists.  Jobs are
    matched by name — manifest names are stable across runs."""
    from .. import elastic

    queue_path = os.path.join(checkpoint_dir, "queue.json")
    records: Dict[str, dict] = {}
    if os.path.exists(queue_path):
        with open(queue_path) as fh:
            records = {r["name"]: r
                       for r in json.load(fh).get("jobs", [])}
    for h in handles:
        rec = records.get(h.name)
        if rec is not None and rec.get("state") == "done":
            scheduler.mark_restored(h, iters=int(rec.get("iters", 0)),
                                    steps=int(rec.get("steps", 0)))
            continue
        if not isinstance(scheduler._find_run(h), _SingleRun):
            continue    # fused gang members restart with their gang
        job_dir = elastic.job_dir(checkpoint_dir, h.name)
        if elastic.has_checkpoint(job_dir):
            snapshot, envelope = elastic.load_snapshot(job_dir)
            scheduler.attach_resume_state(h, snapshot, envelope)


def job_report(handles: List[JobHandle]) -> List[dict]:
    """JSON-serializable per-job rows for the CLI / bench output."""
    rows = []
    for h in handles:
        row = {
            "id": h.id,
            "name": h.name,
            "workload": h.workload.name,
            "version": h.spec.version,
            "state": h.state.value,
            "priority": h.priority,
            "cores": h.n_cores,
            "steps": h.steps,
            "iters": h.iters,
            "fused": h.fused,
            "modeled_dpu_seconds": h.modeled_seconds,
            # drift accounting (DESIGN.md §13.5): measured chunk wall
            # time next to the cost-model pricing; ratio None when the
            # model never priced this job (non-PIM target)
            "measured_seconds": h.measured_seconds,
            "drift_ratio": h.drift_ratio,
        }
        if h.recoveries:
            row["recoveries"] = h.recoveries
        if h.preemptions:
            row["preemptions"] = h.preemptions
        if h.straggler_flags:
            row["straggler_flags"] = h.straggler_flags
        if h.restored:
            row["restored"] = True
        if h.gpu is not None:
            row["modeled_gpu_seconds"] = h.gpu.modeled_seconds
        if h.transfer is not None:
            row["cpu_to_pim_bytes"] = h.transfer.cpu_to_pim
            row["pim_to_cpu_bytes"] = h.transfer.pim_to_cpu
            row["kernel_launches"] = h.transfer.kernel_launches
        if h.error is not None:
            row["error"] = f"{type(h.error).__name__}: {h.error}"
        rows.append(row)
    return rows
