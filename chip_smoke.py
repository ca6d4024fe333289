#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. device   require a CUDA device; print nvidia-smi's name and power
              limit
  2. build    compile every CUDA kernel from ``src/repro_torch/csrc`` with
              nvcc (one process per source, all at once)
  3. kernels  each kernel against its plain PyTorch version on the card,
              on the main path's shapes: they must be equal
  4. main     the paper's LIN/LOG training at full size: 6,291,456 x 16
              samples over 2048 simulated PIM cores, LIN int32/hyb/fp32
              and LOG int32_lut_wram/int32_lut_mram, through the public
              API.  The kernel launch counts, zeroed just before, must
              show every kernel ran; the same fits on the CPU must give
              bit-identical integer weights, fp32 weights within
              FP32_RTOL/FP32_ATOL, and equal TransferStats
  5. timing   each kernel and its plain version with CUDA events (median
              of TIMING_RUNS, L2 flushed between runs) beside its bound;
              each fit's seconds per iteration and samples/s

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Nothing of JAX or the JAX package is
imported.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
N_CORES = 2048
N_SAMPLES = 6_291_456          # the paper's strong-scaling LIN/LOG dataset
N_FEATURES = 16
ITERS = 10
TIMING_RUNS = 20
#: fp32 CPU-vs-card tolerance: cuBLAS and ATen's CPU kernels sum the
#: per-core products and the gradient rows in different orders
FP32_RTOL, FP32_ATOL = 1e-4, 1e-6
#: published peaks of the H100 SXM (NVIDIA data sheet): HBM3 bytes/s,
#: and float32 outside the tensor cores — the CUDA-core rate the integer
#: kernels' operations are held to
PEAK_BYTES_PER_S = 3.35e12
PEAK_CUDA_CORE_OPS_PER_S = 67e12

LIN_VERSIONS = ("int32", "hyb", "fp32")
LOG_VERSIONS = ("int32_lut_wram", "int32_lut_mram")


def say(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(torch, fn, flush) -> float:
    """Median CUDA-event time of ``fn()`` in ms over TIMING_RUNS runs,
    after two warm-up runs, with the L2 cache flushed before each."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(TIMING_RUNS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_CUDA_CORE_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    from repro_torch.api import make_estimator, make_system
    from repro_torch.core.lut import build_sigmoid_lut
    from repro_torch.data.synthetic import (make_classification,
                                            make_linear_dataset)
    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels.lut_activation import (lut_sigmoid_cuda,
                                                    lut_sigmoid_plain)
    from repro_torch.kernels.quant_matmul import (fx_matvec_cuda,
                                                  fx_matvec_plain)
    t_start = time.perf_counter()
    dev = torch.device("cuda")

    # -- 1. device -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    say(smi)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build()
    say(f"build: {len(logs)} of {len(build.SOURCES)} libraries compiled in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                say(f"  {name}: {line.strip()}")

    # -- 3. kernels against their plain versions, on the card ----------------
    rng = np.random.RandomState(SEED)
    n_pc = N_SAMPLES // N_CORES
    x = torch.from_numpy(rng.randint(-(16 << 10), 16 << 10,
                                     (N_CORES, n_pc, N_FEATURES))
                         .astype(np.int32)).to(dev)
    w = torch.from_numpy(rng.randint(-(4 << 10), 4 << 10, N_FEATURES)
                         .astype(np.int32)).to(dev)

    def full_range(shape):     # int32 values whose products wrap
        return torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31 - 1, shape,
                                            dtype=np.int64)
                                .astype(np.int32)).to(dev)
    wide, wide_w = full_range((1_000_003, 13)), full_range(13)
    err_fx = 0
    for xs, ws in ((x, w), (wide, wide_w)):    # main shape; ragged, wrapping
        out, ref = fx_matvec_cuda(xs, ws, 10), fx_matvec_plain(xs, ws, 10)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            fail(f"fx_matvec kernel != plain at {tuple(xs.shape)}")
        err_fx = max(err_fx, int((out.long() - ref.long()).abs().max()))
    say(f"kernels: fx_matvec == plain at {tuple(x.shape)} and "
        f"{tuple(wide.shape)} (max abs err {err_fx})")

    lut = build_sigmoid_lut(device=dev)
    n_table = lut.table.numel()
    edges = torch.tensor([0, 1, -1, n_table - 1, -(n_table - 1), n_table,
                          -n_table, 2 ** 31 - 1, -2 ** 31, -2 ** 31 + 1],
                         dtype=torch.int32)
    z = torch.from_numpy(rng.randint(-30000, 30000, (N_CORES, n_pc))
                         .astype(np.int32))
    z.view(-1)[:edges.numel()] = edges
    z = z.to(dev)
    err_lut = 0
    for placement in ("wram", "mram"):
        out = lut_sigmoid_cuda(z, lut, placement)
        ref = lut_sigmoid_plain(z, lut)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            fail(f"lut_sigmoid[{placement}] kernel != plain")
        err_lut = max(err_lut, int((out.long() - ref.long()).abs().max()))
    say(f"kernels: lut_sigmoid wram and mram == plain at {tuple(z.shape)} "
        f"with the edge values (max abs err {err_lut})")

    # -- 4. the main path at full size ---------------------------------------
    t0 = time.perf_counter()
    X, y, _ = make_linear_dataset(N_SAMPLES, N_FEATURES, seed=SEED)
    Xc, yc = make_classification(N_SAMPLES, N_FEATURES, seed=SEED)
    say(f"data: {N_SAMPLES}x{N_FEATURES} LIN and LOG datasets in "
        f"{time.perf_counter() - t0:.1f} s")
    plan = ([("linreg", v) for v in LIN_VERSIONS]
            + [("logreg", v) for v in LOG_VERSIONS])
    results = {}
    for device in ("cuda", "cpu"):
        system = make_system("pim", n_cores=N_CORES, reduce="fabric",
                             device=device)
        lin_ds, log_ds = system.put(X, y), system.put(Xc, yc)
        if device == "cuda":
            dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        for workload, version in plan:
            est = make_estimator(workload, version=version, n_iters=ITERS,
                                 system=system)
            est.fit(lin_ds if workload == "linreg" else log_ds)
            results[device, version] = (est.coef_, est.intercept_)
        if device == "cuda":
            torch.cuda.synchronize()
            counts = dict(dispatch.launch_counts)
        results[device, "stats"] = system.stats.snapshot()
        say(f"main path on {device}: {len(plan)} fits x {ITERS} iterations "
            f"in {time.perf_counter() - t0:.1f} s (views included)")

    expected = {"fx_matvec": 3 * ITERS, "lut_sigmoid": 2 * ITERS}
    say(f"launch counts on the main path: {counts} (expected {expected})")
    if counts != expected:
        fail(f"kernel launch counts {counts} != {expected}")
    for workload, version in plan:
        (wg, bg), (wc, bc) = results["cuda", version], results["cpu", version]
        if not (np.all(np.isfinite(wg)) and np.isfinite(bg)
                and wg.shape == (N_FEATURES,)):
            fail(f"{workload} {version}: non-finite or misshapen weights")
        if version == "fp32":
            ok = (np.allclose(wg, wc, rtol=FP32_RTOL, atol=FP32_ATOL)
                  and np.isclose(bg, bc, rtol=FP32_RTOL, atol=FP32_ATOL))
        else:
            ok = np.array_equal(wg, wc) and bg == bc
        diff = float(max(np.abs(wg - wc).max(), abs(bg - bc)))
        say(f"  {workload:<7} {version:<15} card == cpu: {ok} "
            f"(max |dw|,|db| {diff:.3g}; w[:3] {wg[:3]}, b {bg:.6f})")
        if not ok:
            fail(f"{workload} {version}: card and CPU fits disagree")
    if results["cuda", "stats"] != results["cpu", "stats"]:
        fail("TransferStats differ between the card and the CPU run")
    say(f"TransferStats equal on card and CPU: {results['cuda', 'stats']}")

    # -- 5. timing -----------------------------------------------------------
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    n = x.numel() // N_FEATURES
    fx = dict(ms=cuda_ms(torch, lambda: fx_matvec_cuda(x, w, 10), flush),
              plain_ms=cuda_ms(torch, lambda: fx_matvec_plain(x, w, 10),
                               flush))
    fx["bound_ms"], fx["bound_by"] = bound(n * N_FEATURES * 4
                                           + N_FEATURES * 4 + n * 4,
                                           n * N_FEATURES * 4)
    lu = dict(ms=cuda_ms(torch, lambda: lut_sigmoid_cuda(z, lut, "wram"),
                         flush),
              mram_ms=cuda_ms(torch, lambda: lut_sigmoid_cuda(z, lut, "mram"),
                              flush),
              plain_ms=cuda_ms(torch, lambda: lut_sigmoid_plain(z, lut),
                               flush))
    lu["bound_ms"], lu["bound_by"] = bound(z.numel() * 8 + n_table * 2,
                                           z.numel() * 5)
    for name, t in (("fx_matvec", fx), ("lut_sigmoid", lu)):
        say(f"timing: {name} {t['ms']:.4f} ms"
            + (f" (mram placement {t['mram_ms']:.4f} ms)"
               if "mram_ms" in t else "")
            + f", plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}; H100 SXM peaks {PEAK_BYTES_PER_S:.3g} B/s, "
            f"{PEAK_CUDA_CORE_OPS_PER_S:.3g} op/s) on {smi}")

    system = make_system("pim", n_cores=N_CORES, device="cuda")
    lin_ds, log_ds = system.put(X, y), system.put(Xc, yc)
    for workload, version in plan:
        ds = lin_ds if workload == "linreg" else log_ds
        make_estimator(workload, version=version, n_iters=1,
                       system=system).fit(ds)      # views and LUT resident
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        make_estimator(workload, version=version, n_iters=ITERS,
                       system=system).fit(ds)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / ITERS
        say(f"fit: {workload:<7} {version:<15} {dt * 1e3:.3f} ms/iteration, "
            f"{N_SAMPLES / dt:.4g} samples/s ({N_CORES} cores, on {smi})")

    kernels = [
        {"name": "fx_matvec", "route": "cuda",
         "source": "src/repro_torch/csrc/fx_matvec.cu",
         "replaces": "src/repro/kernels/quant_matmul/kernel.py:82",
         "launches": counts["fx_matvec"], "max_abs_err": err_fx,
         "ms": fx["ms"], "plain_ms": fx["plain_ms"],
         "bound_ms": fx["bound_ms"], "bound_by": fx["bound_by"],
         "library_ms": None},
        {"name": "lut_sigmoid", "route": "cuda",
         "source": "src/repro_torch/csrc/lut_sigmoid.cu",
         "replaces": "src/repro/kernels/lut_activation/kernel.py:37",
         "launches": counts["lut_sigmoid"], "max_abs_err": err_lut,
         "ms": lu["ms"], "mram_ms": lu["mram_ms"],
         "plain_ms": lu["plain_ms"], "bound_ms": lu["bound_ms"],
         "bound_by": lu["bound_by"], "library_ms": None},
    ]
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
