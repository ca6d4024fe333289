"""Elastic job runtime walkthrough.

Five acts on a small PIM machine:

  1. preempt a running fit at a chunk boundary and resume it on a
     fresh scheduler: bit-identical to never stopping;
  2. priority eviction: a high-priority submit evicts a low-priority
     tenant, which requeues from its snapshot and still finishes;
  3. cross-System migration: an fp32 fit checkpointed on PIM finishes
     on the host baseline (integer fits are refused: the quantization
     contract differs);
  4. survive an injected fault via supervised retry;
  5. kill a checkpointed manifest run mid-queue and resume it.

  PYTHONPATH=src python -m repro_torch.examples.elastic_jobs [--device cpu]
"""
from __future__ import annotations

import os
import tempfile

import numpy as np

from repro_torch.elastic import FaultInjector
from repro_torch.examples import parse, parser
from repro_torch.sched import JobState, PimScheduler, run_manifest
from repro_torch.systems import HostConfig, HostSystem, PimConfig, PimSystem


def _pim(device, cores=16, **kw):
    return PimScheduler(PimSystem(PimConfig(n_cores=cores, device=device)),
                        rank_size=4, **kw)


def preempt_resume(device, X, y, *, n_iters=200):
    print("== 1. preempt at a chunk boundary, resume elsewhere ==")
    sched = _pim(device)
    job = sched.submit("linreg", (X, y), version="int32", n_iters=n_iters,
                       fuse_steps=16)
    for _ in range(5):
        sched.step()
    job.preempt()
    sched.step()
    print(f"   parked: {job.state.value} at iteration {job.iters}, "
          f"snapshot kind {job.snapshot_kind!r}")

    fresh = _pim(device)                # a brand new scheduler + System
    fresh.resume(job, data=(X, y))
    fresh.drain()

    ref_sched = _pim(device)
    ref = ref_sched.submit("linreg", (X, y), version="int32",
                           n_iters=n_iters, fuse_steps=16)
    ref_sched.drain()
    same = np.array_equal(np.asarray(job.result.model.w),
                          np.asarray(ref.result.model.w))
    print(f"   resumed -> {job.state.value} at {job.iters} iters; "
          f"bit-identical to uninterrupted: {same}")


def eviction(device, X, y, *, n_iters=120, urgent_iters=40):
    print("== 2. priority eviction (preemptive=True) ==")
    sched = _pim(device, cores=8, preemptive=True)
    tenants = [sched.submit("linreg", (X, y), version="int32",
                            n_iters=n_iters, name=f"tenant{i}")
               for i in range(2)]
    sched.step()                                   # machine is now full
    urgent = sched.submit("linreg", (X, y), version="int32",
                          n_iters=urgent_iters, priority=10, name="urgent")
    sched.step()
    evicted = next(t for t in tenants if t.preemptions)
    print(f"   urgent: {urgent.state.value}; evicted {evicted.name} "
          f"(requeued from its snapshot)")
    sched.drain()
    print(f"   all done: {[t.state.value for t in tenants + [urgent]]}")


def migration(device, X, y, *, n_iters=100, int_iters=20):
    print("== 3. fp32 PIM -> host migration ==")
    mixed = PimScheduler({"pim": PimSystem(PimConfig(n_cores=8,
                                                     device=device)),
                          "host": HostSystem(HostConfig(n_cores=4,
                                                        device=device))},
                         rank_size=4)
    mig = mixed.submit("linreg", (X, y), version="fp32", n_iters=n_iters,
                       fuse_steps=8, target="pim")
    mixed.step(); mixed.step()
    mig.preempt(); mixed.step()
    mixed.resume(mig, target="host")               # fp32: allowed
    mixed.drain()
    print(f"   finished on {mig.target!r}: {mig.state.value}")

    intjob = mixed.submit("linreg", (X, y), version="int32",
                          n_iters=int_iters, target="pim")
    mixed.step(); intjob.preempt(); mixed.step()
    try:
        mixed.resume(intjob, target="host")
    except ValueError as err:
        print(f"   int32 migration refused: {str(err)[:64]}...")
    mixed.resume(intjob, target="pim")
    mixed.drain()


def fault_retry(device, X, y, *, n_iters=100):
    print("== 4. fault injection + retry budget ==")
    injector = FaultInjector.parse("flaky:4")      # die at scheduling step 4
    sched = _pim(device, cores=8, fault_injector=injector)
    flaky = sched.submit("linreg", (X, y), version="int32", n_iters=n_iters,
                         fuse_steps=8, retry_budget=2, name="flaky")
    sched.drain()
    print(f"   {flaky.state.value} after {flaky.recoveries} recovery "
          f"(last fault on record: {type(flaky.error).__name__})")


def manifest_resume(device, *, n_samples=512, n_iters=200):
    print("== 5. kill a manifest run, then --resume ==")
    manifest = {
        "system": {"cores": 16, "rank_size": 4},
        "datasets": {"lin": {"kind": "linear", "samples": n_samples,
                             "features": 16, "seed": 0}},
        "jobs": [
            {"workload": "linreg", "dataset": "lin", "cores": 4,
             "name": "quick", "version": "int32",
             "params": {"n_iters": 8, "fuse_steps": 2}},
            {"workload": "linreg", "dataset": "lin", "cores": 4,
             "name": "long", "version": "int32",
             "params": {"n_iters": n_iters, "fuse_steps": 2}},
        ],
    }
    with tempfile.TemporaryDirectory(prefix="elastic_demo_") as ckpt:
        crashed, handles = run_manifest(manifest, drain=False,
                                        checkpoint_dir=ckpt, device=device)
        for _ in range(8):
            crashed.step()
        print(f"   'crash' with "
              f"{ {h.name: h.state.value for h in handles} }; "
              f"queue record: {os.path.join(ckpt, 'queue.json')}")
        del crashed

        sched2, handles2 = run_manifest(manifest, checkpoint_dir=ckpt,
                                        resume=True, device=device)
        for h in handles2:
            extra = " (restored, not re-run)" if h.restored else \
                f" (resumed, {h.iters} iters total)"
            print(f"   {h.name}: {h.state.value}{extra}")
        if not all(h.state is JobState.DONE for h in handles2):
            raise RuntimeError("a resumed manifest job did not finish")
    print("done.")


def main(argv=None):
    args = parse(parser(__doc__), argv)
    rng = np.random.RandomState(0)
    X = rng.randn(512, 16).astype(np.float32)
    y = (X @ rng.randn(16) + 0.1 * rng.randn(512)).astype(np.float32)
    preempt_resume(args.device, X, y)
    eviction(args.device, X, y)
    migration(args.device, X, y)
    fault_retry(args.device, X, y)
    manifest_resume(args.device)


if __name__ == "__main__":
    main()
