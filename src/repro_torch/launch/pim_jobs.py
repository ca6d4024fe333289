"""Training-service launcher: drive the PIM job scheduler from a manifest.

The multi-tenant face of the reproduction (DESIGN.md §7): a YAML/JSON
manifest declares the PIM system, datasets, and a mix of jobs and
(optionally fused) hyperparameter sweeps; the scheduler carves the cores
axis into rank-aligned slices and gang-steps everything concurrently.

  PYTHONPATH=src python -m repro_torch.launch.pim_jobs \
      examples/jobs.yaml --device cpu
  PYTHONPATH=src python -m repro_torch.launch.pim_jobs jobs.json \
      --json out.json

Without a manifest, ``--demo`` runs a built-in mixed workload queue.

Crash survivability (DESIGN.md §11.5): ``--checkpoint-dir DIR`` writes
chunk-boundary job checkpoints plus an atomic queue record as the drain
progresses; after a kill, re-running the same manifest with
``--checkpoint-dir DIR --resume`` completes it — finished jobs are
restored without re-running, unfinished ones continue from their last
durable snapshot.  ``--retry-budget N`` survives injected or real
per-step faults via supervised retry.

Serve mode (DESIGN.md §14.4): ``--serve --spool DIR`` turns the one-shot
drain into a long-running service — the initial manifest's jobs drain on
a background thread while DIR is watched for further manifest files,
each admitted mid-flight (answered with a ``<name>.status.json``
sidecar: accepted, or rejected with the reason).  The service exits
after ``--idle-timeout`` seconds with no new work.
``--max-modeled-seconds X`` is cost-model admission control (§14.3):
manifests whose modeled makespan bound exceeds X are rejected whole —
reported, never queued, never a crash.

A manifest with ``system: {backend: shard_map}`` spreads the PIM cores
over ranks: run it under ``torchrun``, which every rank runs alike (the
default process group comes from torchrun's environment; rank 0 writes
the ``--json`` report):

  torchrun --nproc_per_node 2 -m repro_torch.launch.pim_jobs \
      ranked.json --device cpu

Port of ``repro.launch.pim_jobs``: the same flags, plus ``--device``
(``cuda`` unless the caller asks for ``cpu``).  The JSON report adds
``launch_counts``, the kernel launches each CUDA kernel made in this
process (empty on the CPU, where the plain versions run).  Without
PyYAML a manifest must be JSON.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch.distributed as dist

from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import init_from_env
from repro_torch.obs import (TRACER, Column, format_ratio, render_table,
                             write_chrome_trace)
from repro_torch.sched import (SloViolation, job_report, load_manifest,
                               run_manifest, serve_manifests)

#: the per-job report columns every metric row renders through
#: (repro_torch.obs.format — shared with pim_ml/compare so new metrics appear
#: in every CLI by adding one spec here)
JOB_COLUMNS = (
    Column("name", "job", width=28, align="<"),
    Column("state", width=10, align="<"),
    Column("cores", width=5, spec="d"),
    Column("steps", width=6, spec="d"),
    Column("kernel_launches", "launches", width=8, spec="d", default="0"),
    Column("modeled_dpu_seconds", "dpu_s", width=10, spec=".3e"),
    Column("drift_ratio", "drift", width=9, spec=".3g"),
)

#: the built-in demo manifest (also documents the schema)
DEMO_MANIFEST = {
    "system": {"cores": 32, "rank_size": 4, "reduce": "fabric"},
    "datasets": {
        "lin": {"kind": "linear", "samples": 2048, "features": 16,
                "seed": 0},
        "blobs": {"kind": "blobs", "samples": 4096, "features": 8,
                  "centers": 8, "seed": 1},
    },
    "jobs": [
        {"workload": "kmeans", "dataset": "blobs", "cores": 8,
         "priority": 1, "params": {"n_clusters": 8, "max_iter": 40}},
        {"workload": "logreg", "dataset": "lin", "cores": 4,
         "version": "int32_lut_wram", "params": {"n_iters": 150}},
    ],
    "sweeps": [
        {"workload": "linreg", "dataset": "lin", "cores": 8,
         "version": "hyb", "fused": True,
         "grid": {"lr": [0.05, 0.1, 0.2, 0.4]},
         "params": {"n_iters": 150}},
    ],
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("manifest", nargs="?", default=None,
                    help="YAML/JSON manifest path (see repro_torch.sched."
                         "manifest for the schema)")
    ap.add_argument("--demo", action="store_true",
                    help="run the built-in demo manifest")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the per-job report as JSON")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="write crash-survivable elastic checkpoints "
                         "(per-job snapshots + queue record) here")
    ap.add_argument("--checkpoint-every", type=int, default=1,
                    metavar="N",
                    help="checkpoint cadence in scheduling steps "
                         "(default 1 = every chunk boundary)")
    ap.add_argument("--resume", action="store_true",
                    help="resume a killed run from --checkpoint-dir: "
                         "finished jobs are not re-run, unfinished ones "
                         "continue from their last snapshot")
    ap.add_argument("--retry-budget", type=int, default=0, metavar="N",
                    help="per-job supervised retries from the last "
                         "snapshot before FAILED (default 0)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record a Chrome trace-event timeline of the "
                         "drain (load in Perfetto / chrome://tracing); "
                         "one track per target System, memory channel, "
                         "and job")
    ap.add_argument("--serve", action="store_true",
                    help="serve mode: drain on a background thread and "
                         "watch --spool for more manifests (DESIGN.md "
                         "§14.4)")
    ap.add_argument("--spool", default=None, metavar="DIR",
                    help="directory watched for additional manifest "
                         "files in --serve mode")
    ap.add_argument("--idle-timeout", type=float, default=10.0,
                    metavar="S",
                    help="serve mode exits after this many seconds "
                         "with no new manifests and an idle scheduler "
                         "(default 10)")
    ap.add_argument("--poll-interval", type=float, default=0.2,
                    metavar="S",
                    help="spool scan cadence in serve mode "
                         "(default 0.2)")
    ap.add_argument("--max-modeled-seconds", type=float, default=None,
                    metavar="X",
                    help="admission SLO: reject manifests whose "
                         "modeled makespan lower bound exceeds X "
                         "(the manifest's own slo section wins)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where every job runs (default cuda; cpu runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.manifest is None and not args.demo:
        ap.error("pass a manifest path or --demo")
    if args.resume and not args.checkpoint_dir:
        ap.error("--resume needs --checkpoint-dir")
    if args.serve and not args.spool:
        ap.error("--serve needs --spool")
    doc = DEMO_MANIFEST if args.manifest is None \
        else load_manifest(args.manifest)

    ranked = (doc.get("system") or {}).get("backend") == "shard_map"
    if ranked:
        init_from_env(args.device)
    if args.trace:
        TRACER.enable()
    t0 = time.perf_counter()
    try:
        scheduler, handles = run_manifest(
            doc,
            drain=not args.serve,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            resume=args.resume,
            retry_budget=args.retry_budget,
            max_modeled_seconds=args.max_modeled_seconds,
            device=args.device)
    except SloViolation as err:
        print(f"manifest rejected: {err}", file=sys.stderr)
        if args.json:
            with open(args.json, "w") as fh:
                json.dump({"rejected": True, "reason": str(err)}, fh,
                          indent=2)
        return 1
    manifest_records = []
    if args.serve:
        manifest_records = serve_manifests(
            scheduler, args.spool,
            poll_interval=args.poll_interval,
            idle_timeout=args.idle_timeout,
            max_modeled_seconds=args.max_modeled_seconds,
            handles=handles)
        scheduler.shutdown(wait=True)
    makespan = time.perf_counter() - t0
    if args.trace:
        write_chrome_trace(TRACER.events(), args.trace)
        print(f"trace written to {args.trace} "
              f"({len(TRACER)} events)")

    rows = job_report(handles)
    print(render_table(rows, JOB_COLUMNS,
                       extra=lambda row: row.get("error", "")))
    stats = scheduler.stats()
    if args.serve:
        accepted = sum(1 for r in manifest_records
                       if r["state"] == "accepted")
        print(f"\nserve: {len(manifest_records)} spooled manifest(s), "
              f"{accepted} accepted, "
              f"{len(manifest_records) - accepted} rejected")
        for rec in manifest_records:
            detail = (f"{rec['jobs']} job(s)"
                      if rec["state"] == "accepted"
                      else rec["reason"])
            print(f"  {rec['path']}: {rec['state']} ({detail})")
        lat = stats["latency"]
        if lat["completion"]["count"]:
            print(f"latency: queue p50 {lat['queue']['p50']:.3f}s "
                  f"p99 {lat['queue']['p99']:.3f}s; completion p50 "
                  f"{lat['completion']['p50']:.3f}s p99 "
                  f"{lat['completion']['p99']:.3f}s")
    n_done = stats["jobs"]["done"]
    print(f"\n{len(handles)} jobs, {n_done} done in {makespan:.2f}s "
          f"({n_done / max(makespan, 1e-9):.2f} jobs/s); "
          f"failed {stats['jobs']['failed']}, "
          f"cancelled {stats['jobs']['cancelled']}")
    s = scheduler.system.stats
    print(f"system transfers: cpu->pim {s.cpu_to_pim:,} B, "
          f"pim->cpu {s.pim_to_cpu:,} B, "
          f"kernel launches {s.kernel_launches}")
    ratios = [d["ratio"] for d in stats.get("drift", {}).values()
              if d.get("ratio")]
    if ratios:
        print(f"model drift (wall/modeled): mean "
              f"{format_ratio(sum(ratios) / len(ratios))} over "
              f"{len(ratios)} priced job(s)")
    n_restored = sum(1 for r in rows if r.get("restored"))
    n_recoveries = sum(r.get("recoveries", 0) for r in rows)
    if n_restored or n_recoveries:
        print(f"elastic: {n_restored} job(s) restored without re-running,"
              f" {n_recoveries} supervised retrie(s)")

    if args.json and (not ranked or dist.get_rank() == 0):
        report = {"makespan_seconds": makespan, "jobs": rows,
                  "scheduler": stats, "device": args.device,
                  "launch_counts": dict(dispatch.launch_counts)}
        if args.serve:
            report["manifests"] = manifest_records
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=2)
        print(f"report written to {args.json}")
    return 0 if stats["jobs"]["failed"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
