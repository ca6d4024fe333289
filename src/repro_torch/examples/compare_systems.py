"""Fig. 13-17 walkthrough: one workload, three machines.

The paper's headline result is a comparison: the same training workloads
ran on a real PIM system, a Xeon CPU and an A100-class GPU.  This
walkthrough makes that comparison one API call per target:

  1. build a Workload spec once,
  2. fit it on make_system("pim") / ("host") / ("gpu-model"),
  3. read each target's native report: DPU cost-model seconds and
     CPU<->PIM transfer bytes on PIM, measured wall and DRAM traffic on
     the host, A100-roofline time and energy on the modeled GPU.

Every target runs on the chosen device: ``host`` is fp32 there, and
``gpu-model`` runs the host's numerics and prices each launch on an
A100 roofline.  The full table (all five workloads) is ``python -m
repro_torch.launch.compare --tiny``.

  PYTHONPATH=src python -m repro_torch.examples.compare_systems [--device cpu]
"""
from __future__ import annotations

import time

from repro_torch.api import HierarchicalCostModel, get_workload, make_system
from repro_torch.data.synthetic import make_linear_dataset
from repro_torch.examples import parse, parser, sections


def _data(n_samples, n_features):
    X, y, _ = make_linear_dataset(n_samples, n_features, seed=0)
    return X, y, get_workload("linreg")


def pim(device, *, n_samples=8192, n_features=16, n_iters=200):
    """PIM: the paper's INT32 fixed-point version, DPU seconds modeled."""
    X, y, wl = _data(n_samples, n_features)
    system = make_system("pim", n_cores=16, device=device)
    spec = wl.spec("int32", n_iters=n_iters)
    result = wl.fit(system.put(X, y), spec)
    model = HierarchicalCostModel(system.topology)
    dpu_s = n_iters * model.step_seconds(
        "lin", "int32", n_samples, n_features,
        n_cores=system.config.n_cores, n_threads=system.config.n_threads)
    print(f"pim       int32  R^2={wl.score(result, X, y):.4f}  "
          f"modeled DPU {dpu_s * 1e3:.2f} ms (kernel + rank legs)  "
          f"cpu->pim {system.stats.cpu_to_pim:,} B, "
          f"pim->cpu {system.stats.pim_to_cpu:,} B "
          f"({system.stats.kernel_launches} launches)")


def host(device, *, n_samples=8192, n_features=16, n_iters=200):
    """The processor-centric fp32 baseline, measured on the device."""
    # No sharding, no quantization round-trip; TransferStats counts the
    # DRAM bytes the hot loop streams instead of CPU<->PIM transfers.
    X, y, wl = _data(n_samples, n_features)
    system = make_system("host", device=device)
    spec = wl.spec("fp32", n_iters=n_iters)
    ds = system.put(X, y)
    wl.fit(ds, spec)                       # warm
    t0 = time.perf_counter()
    result = wl.fit(ds, spec)
    wall = time.perf_counter() - t0
    print(f"host      fp32   R^2={wl.score(result, X, y):.4f}  "
          f"measured {wall * 1e3:.2f} ms  "
          f"DRAM {system.stats.dram_bytes:,} B "
          f"(cpu->pim stays {system.stats.cpu_to_pim})")


def gpu_model(device, *, n_samples=8192, n_features=16, n_iters=200):
    """The modeled GPU: the host's numerics, an A100 roofline report."""
    X, y, wl = _data(n_samples, n_features)
    system = make_system("gpu-model", device=device)
    result = wl.fit(system.put(X, y), wl.spec("fp32", n_iters=n_iters))
    g = system.gpu
    print(f"gpu-model fp32   R^2={wl.score(result, X, y):.4f}  "
          f"roofline {g.modeled_seconds * 1e3:.2f} ms / "
          f"{g.modeled_energy_j:.2f} J  "
          f"({g.flops:.2e} FLOPs, {g.launches} launches "
          f"x 5us launch overhead)")


def fused(device, *, n_samples=8192, n_features=16, n_iters=200,
          fuse_steps=32):
    """Step fusion on the GPU model: k steps a launch shrink the launch
    overhead term, on every target."""
    # Launch overhead dominates small iterative fits (why the paper's
    # GPU loses to PIM on LOG/KME).  The port counts a fused chunk's k
    # steps of work; the reference's XLA cost analysis counts a scanned
    # chunk's body once, so its line prints about 1/k of the work.
    X, y, wl = _data(n_samples, n_features)
    system = make_system("gpu-model", device=device)
    wl.fit(system.put(X, y), wl.spec("fp32", n_iters=n_iters,
                                     fuse_steps=fuse_steps))
    print(f"gpu-model fp32 fuse_steps={fuse_steps}: roofline "
          f"{system.gpu.modeled_seconds * 1e3:.2f} ms over "
          f"{system.gpu.launches} launches — the dispatch tax the paper "
          f"measures is gone")


def run(device, **sizes):
    """The three machines and the fused fit on ``device``; ``sizes`` maps
    a section's name to its keyword arguments (the reference's sizes
    where absent)."""
    on_pim, on_host, on_gpu, on_fused = sections(
        sizes, "pim", "host", "gpu_model", "fused")
    pim(device, **on_pim)
    host(device, **on_host)
    gpu_model(device, **on_gpu)
    fused(device, **on_fused)


def main(argv=None):
    run(parse(parser(__doc__), argv).device)


if __name__ == "__main__":
    main()
