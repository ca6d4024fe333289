"""Roofline models (port of ``repro.launch.roofline``).

Two of them:

* :class:`GpuRoofline` and its default calibration, :func:`a100`: the
  ``gpu-model`` target prices its launches on it.  The constants are an
  A100's (provenance in the class docstring), not the card the port runs
  on: a ``gpu-model`` row is a model of an A100.
* The dry-run table (:func:`terms`, :func:`build_table`,
  :func:`render_markdown`, :func:`main`) over ``launch/dryrun.py``'s
  results, per (arch x shape x mesh), in seconds a step of ONE rank's
  program::

      compute term    = flops per rank / peak FLOP/s
      memory term     = analytic HBM bytes per rank / HBM B/s
      collective term = collective bytes per rank / (links * link B/s)

  The dominant term is the bottleneck; the roofline fraction is
  ``useful / max(term)`` with ``useful = MODEL_FLOPS / (ranks * peak)``.
  The hardware is an argument: :data:`H100` by default (NVIDIA's H100
  SXM data sheet), :data:`TPU_V5E` the reference's constants.  A table
  is a model of such machines, not a measurement.

Usage::

    python -m repro_torch.launch.roofline [--results PATH] [--out PATH]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional

#: where launch/dryrun.py writes and this module reads
RESULTS_PATH = "build/dryrun/dryrun_results.json"
OUT_PATH = "build/dryrun/roofline.md"


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One accelerator's peaks for the dry-run roofline: dense bf16
    FLOP/s, HBM B/s, and the collective bandwidth charged (``links``
    links of ``link_bw`` B/s each way)."""

    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float
    links: int


#: NVIDIA H100 SXM5 data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3,
#: NVLink 4 at 450 GB/s each way a GPU (18 links, charged as one
#: aggregate), all at the 700 W power limit
H100 = Hardware("h100-sxm", peak_flops=989e12, hbm_bw=3.35e12,
                link_bw=450e9, links=1)
#: the reference's constants (TPU v5e class): 197 TFLOP/s bf16, 819 GB/s
#: HBM, 2 ICI links of 50 GB/s
TPU_V5E = Hardware("tpu-v5e", peak_flops=197e12, hbm_bw=819e9,
                   link_bw=50e9, links=2)


@dataclasses.dataclass(frozen=True)
class GpuRoofline:
    """Calibrated kernel-time/energy model of a discrete GPU.

    ``kernel_seconds(flops, bytes)`` prices one launch at
    ``launch_overhead + max(flops/peak, bytes/hbm_bw)`` — the classic
    roofline with a fixed dispatch cost.  The overhead term is what the
    paper's comparison turns on for the small iterative workloads: a GD
    step whose math takes microseconds still pays the full kernel-launch
    latency every iteration, which is exactly when PIM wins (Figs.
    13-17) and why the fused step engine matters on every target.

    Used by :class:`repro_torch.systems.gpu_model.ModeledGpuSystem` to
    price each launch from the FLOPs and bytes its ops were counted to
    do (``systems/gpu_model.py``).

    Calibration provenance (each constant against published numbers,
    not guesses):
      peak_flops   19.5 TFLOP/s — A100 datasheet fp32 peak (non-tensor-
                   core; the paper's ML kernels are fp32 BLAS-style
                   loops, not TF32 matmuls).
      hbm_bw       1555 GB/s — A100-SXM4-40G datasheet HBM2e peak.
      achievable_bw_fraction  0.85 — STREAM-class/bandwidthTest
                   microbenchmarks sustain ~1.3-1.4 TB/s of the 1555
                   peak on A100 (the familiar ~85% DRAM efficiency);
                   pricing memory-bound kernels at the full datasheet
                   rate flatters the GPU column of Figs. 13-17.
      launch_overhead_s  5 µs — measured empty-kernel CUDA launch
                   latency (cudaLaunchKernel down to the GPU) on PCIe/SXM
                   systems is ~3-7 µs; 5 µs is the conventional
                   midpoint.  This is the constant the PIM-vs-GPU
                   comparison actually turns on for tiny iterative
                   steps.
      tdp_w        400 W — A100-SXM4 board TDP.
    """

    name: str = "a100-sxm4-40g"
    peak_flops: float = 19.5e12      # fp32 (non-TC: the paper's ML
    #                                  kernels are fp32 BLAS-style loops)
    hbm_bw: float = 1.555e12         # B/s datasheet peak (40 GB HBM2e)
    #: fraction of datasheet HBM bandwidth real kernels sustain
    achievable_bw_fraction: float = 0.85
    launch_overhead_s: float = 5e-6  # CUDA kernel-launch latency
    tdp_w: float = 400.0             # board power for the energy model

    @property
    def achievable_bw(self) -> float:
        """Sustained HBM bandwidth the memory term is priced at."""
        return self.hbm_bw * self.achievable_bw_fraction

    def kernel_seconds(self, flops: float, bytes_: float) -> float:
        return self.launch_overhead_s + max(flops / self.peak_flops,
                                            bytes_ / self.achievable_bw)

    def kernel_energy_j(self, seconds: float) -> float:
        return seconds * self.tdp_w


def a100() -> GpuRoofline:
    """The default calibration: NVIDIA A100-SXM4 (the class of GPU the
    paper's Table 4 comparison machine carries)."""
    return GpuRoofline()


def terms(entry: dict, n_chips: int, arch: str = "",
          shape_name: str = "", hw: Hardware = H100) -> Optional[dict]:
    """The roofline terms of one dry-run result on ``n_chips`` ranks of
    ``hw``; the memory term is ``analytic.memory_bytes`` when the cell is
    named, else the traced traffic."""
    if entry.get("status") != "ok":
        return None
    corr = entry["corrected"]
    ana = entry["analytic"]
    t_compute = corr["flops"] / hw.peak_flops
    if arch and shape_name:
        from ..configs.base import get_config
        from ..configs.shapes import shape_for
        from .analytic import memory_bytes
        cfg = get_config(arch)
        mem = memory_bytes(cfg, shape_for(cfg, shape_name), n_chips)
        t_memory = mem["total"] / hw.hbm_bw
    else:
        t_memory = corr["traffic_bytes"] / hw.hbm_bw
    t_coll = corr["collective_bytes"] / (hw.links * hw.link_bw)
    bound = max(("compute", t_compute), ("memory", t_memory),
                ("collective", t_coll), key=lambda kv: kv[1])[0]
    useful = ana["model_flops"] / (n_chips * hw.peak_flops)
    step = max(t_compute, t_memory, t_coll)
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "bound": bound,
        "model_flops": ana["model_flops"],
        "hlo_flops_per_chip": corr["flops"],
        "useful_ratio": ana["model_flops"] / max(
            corr["flops"] * n_chips, 1e-9),
        "roofline_fraction": useful / max(step, 1e-30),
        "step_time_s": step,
    }


def _fmt(x: float) -> str:
    return f"{x:.3e}"


def build_table(results: dict, mesh: str = "1pod",
                hw: Hardware = H100) -> list:
    """One row per cell of ``mesh`` ("1pod" or "2pod"), sorted by key;
    cells that are not ``ok`` keep their status."""
    rows = []
    for key, entry in sorted(results.items()):
        parts = key.split("|")
        if len(parts) != 3:
            continue  # --mesh-shape experiment entries
        arch, shape, m = parts
        if m != mesh:
            continue
        status = entry.get("status")
        if status == "skipped":
            rows.append({"arch": arch, "shape": shape, "status": status,
                         "reason": entry.get("reason", "")[:60]})
            continue
        if status != "ok":
            rows.append({"arch": arch, "shape": shape, "status": "error"})
            continue
        n_chips = entry.get("n_devices", 256)
        t = terms(entry, n_chips, arch, shape, hw)
        rows.append({"arch": arch, "shape": shape, "status": "ok", **t})
    return rows


def render_markdown(rows: list, mesh: str, hw: Hardware = H100) -> str:
    out = [f"### Roofline — {mesh} mesh, a model of {hw.name} ranks", "",
           "| arch | shape | compute s | memory s | collective s | bound |"
           " MODEL/HLO | roofline frac |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                       f"{r['status']} | — | — |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {_fmt(r['t_compute_s'])} | "
            f"{_fmt(r['t_memory_s'])} | {_fmt(r['t_collective_s'])} | "
            f"{r['bound']} | {r['useful_ratio']:.3f} | "
            f"{r['roofline_fraction']:.3f} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=RESULTS_PATH)
    ap.add_argument("--out", default=OUT_PATH)
    args = ap.parse_args(argv)
    with open(args.results) as f:
        results = json.load(f)
    sections = []
    for mesh in ("1pod", "2pod"):
        rows = build_table(results, mesh)
        if rows:
            sections.append(render_markdown(rows, mesh))
    text = "\n\n".join(sections) + "\n"
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text)
    print(text)


if __name__ == "__main__":
    main()
