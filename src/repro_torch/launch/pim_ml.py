"""Workload-session launcher: train LIN, LOG, DTR, KME or EMB on the port.

One System session on one device, one resident PimDataset, N fits over
it — version ladders and hyperparameter sweeps pay the data placement
once (paper §2.2).  The device picks the kernel implementation: CUDA
kernels on ``--device cuda`` (the default), their plain PyTorch versions
on ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.pim_ml --workload linreg \\
      --versions int32,hyb --samples 8192 --features 16 --iters 300 \\
      --sweep lr=0.05,0.1,0.2 --reduce fabric

  PYTHONPATH=src python -m repro_torch.launch.pim_ml --workload logreg \\
      --system host --device cpu --versions fp32

  PYTHONPATH=src python -m repro_torch.launch.pim_ml --workload linreg \\
      --system gpu-model --device cpu --versions fp32

  PYTHONPATH=src python -m repro_torch.launch.pim_ml --workload linreg \\
      --device cpu --versions int32 --iters 100 --fuse-steps 10

  PYTHONPATH=src python -m repro_torch.launch.pim_ml --workload kmeans \\
      --device cpu --samples 20000 --param n_clusters=16 --param n_init=2

  PYTHONPATH=src python -m repro_torch.launch.pim_ml --workload dtree \\
      --device cpu --samples 20000 --param max_depth=8

  PYTHONPATH=src python -m repro_torch.launch.pim_ml --workload emb \\
      --device cpu --samples 20000 --iters 100 --param flush_every=8
"""
from __future__ import annotations

import argparse
import time

from repro_torch.api import (get_workload, list_workloads, make_estimator,
                             make_system)
from repro_torch.data.synthetic import (make_blobs, make_classification,
                                        make_linear_dataset, make_recsys)


def _parse_value(text: str):
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            continue
    return text


def _make_data(workload: str, n: int, f: int, seed: int):
    if workload == "kmeans":
        X, _, _ = make_blobs(n, f, centers=16, seed=seed)
        return X, None
    if workload == "dtree":
        return make_classification(n, f, seed=seed, class_sep=1.4)
    if workload == "emb":
        # --features rides as the embedding dim; the pair width is 2
        return make_recsys(n, n_users=max(64, n // 16),
                           n_items=max(48, n // 24), dim=max(2, f),
                           seed=seed)
    X, y, _ = make_linear_dataset(n, f, seed=seed)
    return X, y


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="linreg",
                    choices=sorted(list_workloads()),
                    help="the workloads ported so far")
    ap.add_argument("--versions", default="",
                    help="comma list; default = all versions")
    ap.add_argument("--samples", type=int, default=8192)
    ap.add_argument("--features", type=int, default=16)
    ap.add_argument("--cores", type=int, default=16)
    ap.add_argument("--system", default="pim",
                    choices=("pim", "host", "gpu-model"),
                    help="execution target: the simulated PIM machine, "
                         "the processor-centric host baseline, or the host "
                         "numerics priced on an A100 roofline")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the system runs; cuda without a GPU fails")
    ap.add_argument("--iters", type=int, default=0,
                    help="override n_iters/max_iter when > 0")
    ap.add_argument("--reduce", default="fabric",
                    choices=("fabric", "host", "hierarchical"))
    ap.add_argument("--fuse-steps", type=int, default=1,
                    help="iterations per fused chunk (one CUDA graph "
                         "replay on a card); 1 = the per-step host loop")
    ap.add_argument("--sweep", default="",
                    help="hyper sweep, e.g. lr=0.05,0.1,0.2")
    ap.add_argument("--param", action="append", default=[],
                    help="extra hyperparameter, e.g. minibatch=64")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    wl = get_workload(args.workload)
    versions = ([v for v in args.versions.split(",") if v]
                or list(wl.versions))
    params = dict(p.split("=", 1) for p in args.param)
    params = {k: _parse_value(v) for k, v in params.items()}
    if args.fuse_steps > 1:
        if "fuse_steps" not in wl.defaults:
            ap.error(f"--fuse-steps does not apply to {wl.name} (no step "
                     f"fusion: not an iterative GD/Lloyd's workload)")
        params["fuse_steps"] = args.fuse_steps
    if args.iters > 0:
        iter_key = next((k for k in ("max_iter", "n_iters")
                         if k in wl.defaults), None)
        if iter_key is None:
            ap.error(f"--iters does not apply to {wl.name} (no iteration "
                     f"hyperparameter; try --param max_depth=N)")
        params[iter_key] = args.iters

    sweep = [("", None)]
    if args.sweep:
        key, _, vals = args.sweep.partition("=")
        sweep = [(key, _parse_value(v)) for v in vals.split(",")]

    system = make_system(args.system, n_cores=args.cores,
                         reduce=args.reduce, device=args.device)
    X, y = _make_data(wl.name, args.samples, args.features, args.seed)
    ds = system.put(X, y)
    print(f"session: {wl.name} on {args.system} ({args.cores} cores, "
          f"reduce={args.reduce}, device={system.device}), dataset "
          f"{args.samples}x{args.features} (resident)")
    print(f"  {'version':<16} {'sweep':<14} {'score':>9} {'fit_s':>7} "
          f"{'shards':>6}")
    for ver in versions:
        for skey, sval in sweep:
            p = dict(params)
            if skey:
                p[skey] = sval
            t0 = time.perf_counter()
            est = make_estimator(wl.name, version=ver, system=system,
                                 **p).fit(ds)
            dt = time.perf_counter() - t0
            label = f"{skey}={sval}" if skey else ""
            print(f"  {ver:<16} {label:<14} {est.score(X, y):>9.4f} "
                  f"{dt:>7.2f} {system.stats.shard_transfers:>6d}")

    s = system.stats
    if system.kind == "pim":
        print(f"transfers: cpu->pim {s.cpu_to_pim:,} B "
              f"(dataset shards {s.shard_bytes:,} B in {s.shard_transfers} "
              f"transfers), pim->cpu {s.pim_to_cpu:,} B, "
              f"inter-core via host {s.inter_core_via_host:,} B")
    else:
        print(f"traffic: DRAM {s.dram_bytes:,} B streamed over "
              f"{s.kernel_launches} launches "
              f"({s.shard_transfers} view materializations, "
              f"{s.shard_bytes:,} B resident)")
    if system.kind == "gpu-model":
        g = system.gpu
        print(f"modeled A100: {g.modeled_seconds * 1e3:.3f} ms, "
              f"{g.modeled_energy_j:.3f} J over {g.launches} launches "
              f"({g.flops:.3e} FLOPs, {g.hbm_bytes:.3e} HBM B)")


if __name__ == "__main__":
    main()
