"""Fig. 13-17 / Tables 5-7: the PIM vs processor vs GPU comparison,
driven end to end through the single ``System`` API.

Port of ``repro.launch.compare``.  For each of the paper's workloads
(and the EMB extension), the SAME ``Workload`` fits on three targets,
each on ``--device`` (``cuda`` unless the caller asks for ``cpu``):

  pim        the paper's best PIM version (INT32/BUI ladder for GD,
             int16 Lloyd's); DPU seconds MODELED by the hierarchical
             cost model (``HierarchicalCostModel``: the Fig. 8-12
             calibration with rank-serialized broadcast/gather legs)
  host       the processor-centric fp32 baseline, wall time MEASURED on
             the device that ran it: on ``cuda`` that is fp32 on the
             card (an H100 where the port is measured), not a CPU
  gpu-model  the host target's numerics priced on an A100 roofline
             (``launch/roofline.GpuRoofline``): seconds MODELED for an
             A100 from the counted FLOPs and bytes of every launch

The paper's reported speedups ride along as reference columns.  Output:
an aligned table on stdout, headed by the device that ran it, and a
JSON record (default ``benchmarks/out/compare.json``).

  PYTHONPATH=src python -m repro_torch.launch.compare --tiny --device cpu
  python -m repro_torch.launch.compare         # on the card (PYTHONPATH=src)
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.api import HierarchicalCostModel, get_workload, make_system
from repro_torch.data.synthetic import (make_blobs, make_classification,
                                        make_linear_dataset, make_recsys)
from repro_torch.obs import Column, render_table, write_json
from repro_torch.obs.runmeta import gpu_name_and_power_limit

SYSTEMS = ("pim", "host", "gpu-model")

#: the paper's reported cross-target ratios (reference columns only —
#: the gpu-model rows are computed, not echoed)
PAPER_REFERENCE = {
    "linreg": {"gpu_over_pim": 4.1},       # §5.4.1, GPU vs LIN-BUI
    "logreg": {"pim_over_cpu": 3.9},       # LOG-BUI-LUT vs CPU
    "dtree": {"pim_over_cpu": 27.0, "pim_over_gpu": 1.34},
    "kmeans": {"pim_over_cpu": 2.8, "pim_over_gpu": 3.2},
}

#: per-target workload versions: PIM runs the paper's quantized
#: versions, the processor-centric targets run fp32 (no quantization
#: round-trip, exact transcendentals)
PLAN = [
    {"workload": "linreg", "versions": {"pim": "int32", "host": "fp32",
                                        "gpu-model": "fp32"},
     "cost": ("lin", "int32")},
    {"workload": "logreg", "versions": {"pim": "int32_lut_wram",
                                        "host": "fp32",
                                        "gpu-model": "fp32"},
     "cost": ("log", "int32_lut_wram")},
    {"workload": "dtree", "versions": {k: "fp32" for k in SYSTEMS},
     "cost": ("dtr", "fp32")},
    {"workload": "kmeans", "versions": {"pim": "int16", "host": "fp32",
                                        "gpu-model": "fp32"},
     "cost": ("kme", "int16")},
    # the EMB extension (DESIGN.md §15): PIM runs the Q(frac_bits)
    # fixed-point tables with a deferred-update window, the
    # processor-centric targets the eager fp32 baseline
    {"workload": "emb", "versions": {"pim": "int32", "host": "fp32",
                                     "gpu-model": "fp32"},
     "cost": ("emb", "int32")},
]


def _make_data(workload: str, n: int, f: int, seed: int = 0):
    if workload == "kmeans":
        X, _, _ = make_blobs(n, f, centers=8, seed=seed)
        return X, None
    if workload == "dtree":
        return make_classification(n, f, seed=seed, class_sep=1.4)
    if workload == "emb":
        # f rides as the embedding dim elsewhere; the pair width is 2
        return make_recsys(n, n_users=max(64, n // 16),
                           n_items=max(48, n // 24), dim=f, seed=seed)
    X, y, _ = make_linear_dataset(n, f, seed=seed)
    return X, y


def _shapes(tiny: bool) -> dict:
    if tiny:
        return {"linreg": (1024, 8, {"n_iters": 30}),
                "logreg": (1024, 8, {"n_iters": 30}),
                "dtree": (2048, 8, {"max_depth": 4}),
                "kmeans": (1024, 8, {"n_clusters": 4, "max_iter": 15}),
                "emb": (1024, 4, {"n_iters": 30, "batch": 32, "dim": 4,
                                  "lr": 1.0, "frac_bits": 12,
                                  "flush_every": 4})}
    return {"linreg": (8192, 16, {"n_iters": 300}),
            "logreg": (8192, 16, {"n_iters": 300}),
            "dtree": (60_000, 16, {"max_depth": 10}),
            "kmeans": (20_000, 16, {"n_clusters": 16, "max_iter": 100}),
            "emb": (16_384, 8, {"n_iters": 300, "batch": 256, "dim": 8,
                                "lr": 1.0, "frac_bits": 12,
                                "flush_every": 8})}


def _iterations(workload: str, result, params: dict) -> int:
    """Training passes the fit performed (sizes the PIM cost model)."""
    if workload == "kmeans":
        return int(result.attributes["n_iter_"])
    if workload == "dtree":
        # one split-evaluate + one commit pass per grown node pair
        return 2 * int(result.attributes["n_nodes_"])
    return int(params["n_iters"])


def _sync(device: str) -> None:
    """Wait for the card, so a wall time covers the work it timed."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_compare(tiny: bool = False, cores: int = 16, seed: int = 0,
                device: str = "cuda") -> dict:
    """Fit every workload on all three systems, each on ``device``;
    return the record."""
    rows = []
    for plan in PLAN:
        name = plan["workload"]
        wl = get_workload(name)
        n, f, params = _shapes(tiny)[name]
        X, y = _make_data(name, n, f, seed)
        per_system: dict = {}
        for kind in SYSTEMS:
            system = make_system(kind, n_cores=cores, device=device)
            ds = system.put(X, y)
            spec = wl.spec(plan["versions"][kind], **params)
            # warm: build the kernels, materialize the views, count the
            # gpu-model's launches
            wl.fit(ds, spec)
            snap = system.stats.snapshot()
            gpu_snap = system.gpu.snapshot() if kind == "gpu-model" else None
            _sync(device)
            t0 = time.perf_counter()
            result = wl.fit(ds, spec)  # measured: the session steady state
            _sync(device)
            wall_s = time.perf_counter() - t0
            score = (wl.score(result, X) if wl.unsupervised
                     else wl.score(result, X, y))
            s = system.stats.delta(snap)
            row = {
                "workload": name,
                "system": kind,
                "version": spec.version,
                "samples": n,
                "features": f,
                "wall_s": wall_s,
                "score": score,
                "kernel_launches": s.kernel_launches,
                "dram_bytes": s.dram_bytes,
                "cpu_to_pim_bytes": s.cpu_to_pim,
                "pim_to_cpu_bytes": s.pim_to_cpu,
            }
            iters = _iterations(name, result, params)
            row["iterations"] = iters
            if kind == "pim":
                cost_wl, cost_ver = plan["cost"]
                model = HierarchicalCostModel(system.topology)
                # the model's free k knob: cluster count (KME) or
                # minibatch size (EMB); inert for the GD workloads
                kern = params.get("n_clusters", params.get("batch", 16))
                kernel_s = iters * model.workload_seconds(
                    cost_wl, cost_ver, n, f, cores,
                    system.config.n_threads, k=kern)
                row["modeled_s"] = iters * model.step_seconds(
                    cost_wl, cost_ver, n, f, n_cores=cores,
                    n_threads=system.config.n_threads, k=kern)
                # the topology split: per-DPU kernel vs the rank-
                # serialized host-link legs (DESIGN.md §12)
                row["modeled_kernel_s"] = kernel_s
                row["modeled_transfer_s"] = row["modeled_s"] - kernel_s
            elif kind == "gpu-model":
                gpu = system.gpu.delta(gpu_snap)
                row["modeled_s"] = gpu.modeled_seconds
                row["modeled_energy_j"] = gpu.modeled_energy_j
                row["modeled_flops"] = gpu.flops
                row["modeled_hbm_bytes"] = gpu.hbm_bytes
                row["modeled_launches"] = gpu.launches
            else:
                row["modeled_s"] = wall_s    # host: measured IS the model
            # drift: the wall time on ``device`` over the target's
            # model; 1.0 on host, where the measurement is the model
            row["drift_ratio"] = (wall_s / row["modeled_s"]
                                  if row["modeled_s"] > 0 else None)
            per_system[kind] = row
            rows.append(row)
        # cross-target ratios (the paper's headline numbers)
        pim_s = per_system["pim"]["modeled_s"]
        host_s = per_system["host"]["modeled_s"]
        gpu_s = per_system["gpu-model"]["modeled_s"]
        ratios = {
            "pim_over_host": host_s / max(pim_s, 1e-12),
            "pim_over_gpu_model": gpu_s / max(pim_s, 1e-12),
            "paper_reference": PAPER_REFERENCE.get(name, {}),
        }
        for row in per_system.values():
            row["ratios"] = ratios
    return {"meta": {"tiny": tiny, "cores": cores, "seed": seed,
                     "systems": list(SYSTEMS), "device": device,
                     "gpu": (gpu_name_and_power_limit()
                             if torch.device(device).type == "cuda"
                             else None)},
            "rows": rows}


#: the comparison table columns (repro_torch.obs.format)
COMPARE_COLUMNS = (
    Column("workload", width=9, align="<"),
    Column("system", width=10, align="<"),
    Column("version", width=15, align="<"),
    Column("wall_s", "wall s", width=9, spec=".3f"),
    Column("modeled_s", "model s", width=10, spec=".3e"),
    Column("drift_ratio", "drift", width=9, spec=".3g"),
    Column("score", width=11, spec=".4f"),
    Column("kernel_launches", "launches", width=9, spec="d"),
)


def _ratio_note(row: dict) -> str:
    r = row.get("ratios", {})
    if row["system"] == "host":
        return f"pim {r.get('pim_over_host', 0.0):.2f}x faster"
    if row["system"] == "gpu-model":
        return (f"pim {r.get('pim_over_gpu_model', 0.0):.2f}x; "
                f"paper {r.get('paper_reference', {})}")
    return ""


def compare_heading(meta: dict) -> str:
    """The line above the table: which device ran the fits, and what each
    target's seconds are."""
    where = meta["device"] + (f" ({meta['gpu']})" if meta.get("gpu") else "")
    return (f"compare on {where}, {meta['cores']} cores: host wall s "
            f"measured (fp32 on {meta['device']}); pim model s are modeled "
            f"UPMEM DPUs; gpu-model model s are a modeled A100")


def render_compare_table(record: dict) -> str:
    return (compare_heading(record["meta"]) + "\n"
            + render_table(record["rows"], COMPARE_COLUMNS,
                           extra=_ratio_note, rule=True))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true",
                    help="small shapes (seconds, CI-friendly)")
    ap.add_argument("--cores", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where every system runs; cuda without a GPU "
                         "fails")
    ap.add_argument("--out", default="benchmarks/out/compare.json",
                    help="JSON record path ('' disables)")
    args = ap.parse_args(argv)

    record = run_compare(tiny=args.tiny, cores=args.cores, seed=args.seed,
                         device=args.device)
    print(render_compare_table(record))
    if args.out:
        # the run-metadata envelope: git sha, timestamp, torch version,
        # the card's name and power limit
        record = write_json(args.out, record)
        print(f"\nrecorded -> {args.out}")
    return record


if __name__ == "__main__":
    main()
