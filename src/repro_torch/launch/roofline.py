"""The GPU roofline the ``gpu-model`` target prices its launches on.

Port of the GPU half of ``repro.launch.roofline``: :class:`GpuRoofline`
and its default calibration, :func:`a100`.  The constants are an A100's
(NVIDIA's data sheet and published microbenchmarks, provenance in the
class docstring), not the card the port runs on: a ``gpu-model`` row is
a model of an A100, whatever device computed its numerics.

The reference's dry-run roofline table (``terms``, ``build_table``,
``render_markdown``, ``main``) reads ``launch/dryrun.py``'s results and
is not ported yet.
"""
from __future__ import annotations

import dataclasses


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
