"""Quickstart: the paper's four ML workloads through the session API.

One PimSystem session, one bank-resident PimDataset per training set,
every version trained through the workload registry: the tour of the
port.  Every CPU baseline below is the same workload fitted on a
``HostSystem`` (the processor-centric ``System`` target), on the same
device as the PIM system.  The three-way PIM/host/modeled-GPU comparison
is ``python -m repro_torch.launch.compare --tiny``.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

from repro_torch.api import (PimConfig, PimSystem, get_workload,
                             make_estimator, make_system)
from repro_torch.core.metrics import (accuracy, adjusted_rand_index,
                                      training_error_rate)
from repro_torch.data.synthetic import (make_blobs, make_classification,
                                        make_linear_dataset)
from repro_torch.examples import parse, parser, sections
from repro_torch.sched import PimScheduler


def linear(pim, host, *, n_samples=8192, n_features=16, n_iters=500):
    """LIN (paper §3.1, Fig. 6): the four versions on one resident
    dataset.  Returns ``(X, y, ds, hds)`` for the sections after it."""
    # The dataset is partitioned across the banks ONCE; the four-version
    # sweep reuses the resident shards (one transfer per data precision).
    X, y, _ = make_linear_dataset(n_samples, n_features, decimals=4, seed=0)
    ds = pim.put(X, y)
    hds = host.put(X, y)
    print(f"LIN ({n_samples}x{n_features} synthetic, {n_iters} iters)")
    cpu = make_estimator("linreg", version="fp32", n_iters=n_iters,
                         system=host).fit(hds)
    print(f"  CPU float32      : {training_error_rate(cpu.predict(X), y):.2f}% err")
    for ver in get_workload("linreg").versions:
        est = make_estimator("linreg", version=ver, n_iters=n_iters,
                             system=pim).fit(ds)
        print(f"  PIM {ver:6s}       : "
              f"{training_error_rate(est.predict(X), y):.2f}% err")
    print(f"  shard transfers for all 4 versions: "
          f"{pim.stats.shard_transfers} (3 data precisions x (X, y) + mask"
          f" reuse)")
    return X, y, ds, hds


def logistic(pim, host, X, y, ds, hds, *, n_iters=500):
    """LOG (paper §3.2, Fig. 7) on LIN's resident dataset."""
    # LOG shares LIN's precision views, so no new CPU->PIM transfer
    # happens here at all.  On the host target, fp32 uses the exact
    # sigmoid, as the paper's MKL baseline does.
    print("\nLOG (same resident dataset; LUT sigmoid vs Taylor)")
    cpu = make_estimator("logreg", version="fp32", n_iters=n_iters,
                         system=host).fit(hds)
    print(f"  CPU float32      : "
          f"{training_error_rate(cpu.decision_function(X), y, 0.0):.2f}% err")
    for ver in ("int32", "int32_lut_wram", "bui_lut"):
        est = make_estimator("logreg", version=ver, n_iters=n_iters,
                             system=pim).fit(ds)
        print(f"  PIM {ver:15s}: "
              f"{training_error_rate(est.decision_function(X), y, 0.0):.2f}% err")


def decision_tree(pim, *, n_samples=60_000, n_features=16, max_depth=10):
    """DTR (paper §3.3) on PIM and on the host."""
    print(f"\nDTR ({n_samples // 1000}k x {n_features}, depth {max_depth}, "
          f"extremely randomized)")
    Xc, yc = make_classification(n_samples, n_features, seed=0,
                                 class_sep=1.4)
    tree = make_estimator("dtree", max_depth=max_depth, system=pim).fit(Xc, yc)
    tcpu = make_estimator("dtree", max_depth=max_depth, system=make_system(
        "host", device=pim.config.device)).fit(Xc, yc)
    print(f"  PIM accuracy     : {accuracy(tree.predict(Xc), yc):.4f} "
          f"({tree.n_nodes_} nodes)")
    print(f"  CPU accuracy     : {accuracy(tcpu.predict(Xc), yc):.4f}")


def kmeans(pim, *, n_samples=20_000, n_features=16, k=16):
    """KME (paper §3.4): int16-quantized PIM against float on the host."""
    # int16 = the paper's quantized PIM version; the float baseline is
    # version="fp32" on the host target: same trainer, no quantization.
    print(f"\nKME ({n_samples // 1000}k x {n_features}, k={k}, "
          f"int16-quantized PIM vs float CPU)")
    Xb, _, _ = make_blobs(n_samples, n_features, centers=k, seed=0)
    km = make_estimator("kmeans", n_clusters=k, seed=3, n_init=2,
                        system=pim).fit(Xb)
    rc = make_estimator("kmeans", version="fp32", n_clusters=k, seed=3,
                        n_init=2, system=make_system(
                            "host", device=pim.config.device)).fit(Xb)
    print(f"  adjusted Rand index(PIM, CPU) = "
          f"{adjusted_rand_index(km.labels_, rc.labels_):.4f} "
          f"(paper: 0.999)")


def host_reduce(device, X, y, *, n_iters=100):
    """The PIM execution model's host-orchestrated reduce."""
    print("\nHost-orchestrated reduce (the paper's DPU topology):")
    pim_host = PimSystem(PimConfig(n_cores=16, reduce="host", device=device))
    est = make_estimator("linreg", version="int32", n_iters=n_iters,
                         system=pim_host).fit(pim_host.put(X, y))
    print(f"  int32 via host round trip: "
          f"{training_error_rate(est.predict(X), y):.2f}% err;"
          f" bytes host->PIM {pim_host.stats.cpu_to_pim:,},"
          f" PIM->host {pim_host.stats.pim_to_cpu:,}")


def fused_sweep(device, X, y, *, n_iters=500):
    """The LIN lr sweep through the job scheduler, fused into one gang:
    one batched kernel launch advances every point one GD step."""
    print("\nScheduled fused sweep (1 batched launch/step for 3 jobs):")
    system = PimSystem(PimConfig(n_cores=16, device=device))
    sched = PimScheduler(system, rank_size=4)
    snap = system.stats.snapshot()
    handles = sched.sweep("linreg", (X, y), {"lr": (0.05, 0.1, 0.2)},
                          version="int32", n_iters=n_iters, n_cores=8,
                          fused=True)
    sched.drain()
    for h in handles:
        w, b = h.result.attributes["coef_"], h.result.attributes["intercept_"]
        print(f"  lr={h.spec.params['lr']:<5}: "
              f"{training_error_rate(X @ w + b, y):.2f}% err "
              f"({h.state.value}, {h.steps} steps)")
    d = system.stats.delta(snap)
    print(f"  gang total: {d.kernel_launches} launches for "
          f"{len(handles)} jobs x {n_iters} steps; "
          f"{d.shard_transfers} shard transfers (one resident dataset)")


def mixed_queue(device, X, y, *, n_iters=120):
    """PIM tenants and a host-lane baseline under one scheduler."""
    print("\nMixed-target queue (PIM tenants + a host-lane baseline):")
    mixed = PimScheduler({"pim": PimSystem(PimConfig(n_cores=16,
                                                     device=device)),
                          "host": make_system("host", n_cores=4,
                                              device=device)},
                         rank_size=8)
    h_pim = mixed.submit("linreg", (X, y), version="int32", n_iters=n_iters)
    h_cpu = mixed.submit("linreg", (X, y), version="fp32", n_iters=n_iters,
                         target="host")
    mixed.drain()
    for h in (h_pim, h_cpu):
        print(f"  {h.target:4s} {h.spec.version:6s}: {h.state.value}, "
              f"dram {h.transfer.dram_bytes:,} B, "
              f"cpu->pim {h.transfer.cpu_to_pim:,} B")


def run(device, **sizes):
    """The tour on ``device``; ``sizes`` maps a section's name to its
    keyword arguments (the reference's sizes where absent)."""
    lin, log, dtr, kme, red, gang, mixed = sections(
        sizes, "linear", "logistic", "decision_tree", "kmeans",
        "host_reduce", "fused_sweep", "mixed_queue")
    print("=== PIM-ML quickstart (paper: Gomez-Luna et al., 2022) ===\n")
    pim = PimSystem(PimConfig(n_cores=16, device=device))
    host = make_system("host", device=device)  # the CPU baseline
    X, y, ds, hds = linear(pim, host, **lin)
    logistic(pim, host, X, y, ds, hds, **log)
    decision_tree(pim, **dtr)
    kmeans(pim, **kme)
    host_reduce(device, X, y, **red)
    fused_sweep(device, X, y, **gang)
    mixed_queue(device, X, y, **mixed)


def main(argv=None):
    run(parse(parser(__doc__), argv).device)


if __name__ == "__main__":
    main()
