"""Job-queue walkthrough: the multi-tenant PIM training service.

Shows the scheduler's surface: rank-aligned bank allocation, a mixed
LIN/LOG/KME queue gang-stepped concurrently, failure isolation, per-job
transfer accounting, priorities, and a fused learning-rate sweep that
advances 4 jobs with one batched kernel launch per step.

  PYTHONPATH=src python -m repro_torch.examples.job_queue [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.api import PimConfig, PimSystem
from repro_torch.data.synthetic import make_blobs, make_linear_dataset
from repro_torch.examples import parse, parser
from repro_torch.sched import JobState, PimScheduler


def show(handles, title):
    print(f"\n{title}")
    for h in handles:
        extra = ""
        if h.error is not None:
            extra = f"  !! {type(h.error).__name__}: {h.error}"
        elif h.transfer is not None:
            extra = (f"  launches={h.transfer.kernel_launches}"
                     f" cpu->pim={h.transfer.cpu_to_pim:,}B"
                     f" dpu={h.modeled_seconds:.2e}s")
        print(f"  {h.name[:34]:34s} {h.state.value:10s} "
              f"cores={h.n_cores:<3d} steps={h.steps:<4d}{extra}")


def datasets(*, n_samples=2048, n_features=16, n_blobs=4096):
    """The GD jobs' ``(X, y)`` and K-Means' blobs ``Xb``."""
    X, y, _ = make_linear_dataset(n_samples, n_features, seed=0)
    Xb, _, _ = make_blobs(n_blobs, 8, centers=8, seed=1)
    return X, y, Xb


def mixed_queue(sched, X, y, Xb, *, n_iters=60, max_iter=30):
    """LIN + LOG + KME and one job designed to fail."""
    handles = [
        sched.submit("linreg", (X, y), version="int32", n_iters=n_iters,
                     n_cores=8),
        sched.submit("logreg", (X, y), version="int32_lut_wram",
                     n_iters=n_iters, n_cores=8, priority=2),
        sched.submit("kmeans", Xb, n_clusters=8, max_iter=max_iter,
                     n_cores=8),
        # more clusters than points: raises inside fit; the scheduler
        # isolates it and the rest of the queue drains normally
        sched.submit("kmeans", Xb[:4], n_clusters=8, name="poison"),
    ]
    sched.step()     # one scheduling turn: everything fits, all admitted
    frag = sched.fragmentation()
    print(f"\nafter one turn: {frag.used_cores}/{frag.total_cores} cores "
          f"leased in {frag.n_leases} slices "
          f"(frag={frag.external_fragmentation:.2f})")
    sched.drain()
    show(handles, "mixed queue (note the isolated failure):")


def fused_sweep(sched, X, y, *, n_iters=60):
    """4 learning rates, one kernel launch per step.  Returns the jobs."""
    system = sched.system
    snap = system.stats.snapshot()
    t0 = time.perf_counter()
    fused = sched.sweep("linreg", (X, y), {"lr": [0.05, 0.1, 0.2, 0.4]},
                        version="hyb", n_iters=n_iters, n_cores=8, fused=True)
    sched.drain()
    dt = time.perf_counter() - t0
    show(fused, f"fused 4-point lr sweep ({dt:.2f}s wall):")
    d = system.stats.delta(snap)
    print(f"  whole gang: {d.kernel_launches} kernel launches for "
          f"4 jobs x {n_iters} steps (1 batched launch/step), "
          f"{d.shard_transfers} shard transfers (one resident dataset)")
    return fused


def results(sched, fused, X, y):
    """The sweep's results are real fits."""
    best = max((h for h in fused if h.state is JobState.DONE),
               key=lambda h: -np.mean(
                   (X @ h.result.attributes["coef_"]
                    + h.result.attributes["intercept_"] - y) ** 2))
    print(f"\nbest sweep point: {best.name} "
          f"(lr={best.spec.params['lr']}), "
          f"w[:3]={np.round(best.result.attributes['coef_'][:3], 3)}")
    print(f"scheduler totals: {sched.stats()['jobs']}")


def main(argv=None):
    args = parse(parser(__doc__), argv)
    print("=== PIM job scheduler walkthrough (DESIGN.md §7) ===")
    # A 32-core machine carved into ranks of 4 (UPMEM hands out ranks
    # of 64 DPUs; the default rank_size=64 clamps to the machine).
    system = PimSystem(PimConfig(n_cores=32, device=args.device))
    sched = PimScheduler(system, rank_size=4)
    X, y, Xb = datasets()
    mixed_queue(sched, X, y, Xb)
    fused = fused_sweep(sched, X, y)
    results(sched, fused, X, y)


if __name__ == "__main__":
    main()
