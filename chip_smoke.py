#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. device   require a CUDA device; print nvidia-smi's name and power
              limit
  2. build    compile every CUDA kernel from ``src/repro_torch/csrc`` with
              nvcc (one process per source, all at once)
  3. kernels  each kernel against its plain PyTorch version on the card,
              on the main paths' shapes and their edge cases (lut_sigmoid
              also on inputs 4-12 bytes past an alignment with ragged
              ends, under an odd table): they must
              be equal (flash_attention: within MHA_F32_ATOL /
              MHA_BF16_ATOL: float32 in another order; bf16 rounds P to
              bf16 for the tensor cores)
  4. main     the paper's training at full width (16 features) over 2048
              simulated PIM cores, through the public API, one path at a
              time with the kernel launch counts zeroed just before it
              and checked exactly just after it:
              - LIN int32/hyb/fp32 and LOG int32_lut_wram/int32_lut_mram
                at 6,291,456 samples; the same fits on the CPU must give
                bit-identical integer weights, fp32 weights within
                FP32_RTOL/FP32_ATOL, and equal TransferStats
              - KME int16 and fp32 at 25,600,000 samples, k=16, 10
                iterations; then whether the int32 reduce of the cluster
                sums across the cores left the int32 range (the same
                reduce in int64 beside it, on the card)
              - DTR at max_depth 10 on the largest of 153.6M / 76.8M /
                38.4M samples whose generation fits half the host's
                available memory
              - KME (100,000) and DTR (600,000) at the paper's quality
                sizes on the card and on the CPU: identical int16
                centroids, labels and iteration counts, fp32 centroids
                within KME_FP32_RTOL/KME_FP32_ATOL, identical trees, equal
                TransferStats
              - EMB at the Netflix Prize matrix's size (480,189 users x
                17,770 items, 100,480,507 ratings, cut when the host cannot
                generate them), dim 16, batch 64, 200 steps: int32 eager,
                int32 deferred D=8, int32 D=8 with compressed flushes and
                fp32 eager, each timed per step; then 20,000 ratings on 1
                and 16 cores under every reduce strategy on the card and
                on the CPU: identical int32 tables, history and
                TransferStats, fp32 tables within EMB_FP32_RTOL/ATOL
              - qwen3-8b served at full width and depth (36 layers, bf16,
                quantize_dense on, seeded random weights) through Model
                and ServeEngine: 8 requests over 4 slots, prompt lengths
                drawn from 128-1024, 32 new tokens each; launch counts
                exactly 3 int_matmul per layer per forward call and 1
                flash_attention per layer per prefill; the same load with
                quantize_dense off; the busy share over decode steps;
                prefill + decode against the forward's last position;
                then the reduced model in float32 on the card and the CPU
  5. timing   each kernel and its plain version with CUDA events (median
              of TIMING_RUNS, each run after L2Flush: a flush that reads
              a 256 MB buffer, then a device sleep that covers the host's
              enqueue; the method's floor, a one-element add_, first)
              beside its bound (lut_sigmoid in both placements, with
              their shares of it, also on the z a LOG fit hands it at its
              first and last iteration)
              and, for the EMB and LM kernels, the nearest PyTorch call
              (int_matmul at M = 1 and at the shortest and longest
              prompts, with the rate reached, its share of the bound and
              the host's time per wrapper call; flash_attention likewise);
              each fit's milliseconds per iteration (per round for DTR,
              per step for EMB) and samples/s; the serve runs' time to
              first token, ms per decode token and tokens/s
  6. fused    step fusion, each chunk one CUDA graph replay, on the
              datasets resident since phases 4-5, each fit with the
              launch counts zeroed just before it: LIN int32/hyb and LOG
              int32_lut_wram/int32_lut_mram at fuse_steps 5 and 10,
              pipeline depth 1 and 2 (weights bit-identical to the
              serial card fit, its launch counts, a replay a chunk); KME
              int16 at fuse_steps 5 (10 kmeans_assign launches, within
              the reference's fused-against-serial tolerances; card ==
              CPU at 100,000 samples); EMB int32 D=8 at fuse_steps 8
              (run at the end of its phase-4 fits: tables and history
              bit-identical to the serial deferred fit, 400 emb_gather
              launches through replays); fused against serial times,
              capture times, graph pool bytes and the card's busy share
              over a fused KME and EMB fit
  7. compare  the paper's three-way compare (launch/compare.py) on the
              card at its CLI defaults (16 features, 16 cores): LIN, LOG,
              DTR, KME and EMB each on pim (DPU seconds modeled), host
              (fp32 on the card, measured) and gpu-model (the host's
              numerics, seconds modeled for an A100), 15 rows, with the
              launch counts zeroed just before it: every host row's score
              equal to its gpu-model row's, every modeled time above 0,
              the six PIM-ML kernels launched; then the tiny compare over
              4 cores on the card and on the CPU: equal integer pim
              scores, iterations, transfer bytes and modeled seconds, and
              equal gpu-model launches, flops and bytes
  8. orchestration  fx_matvec with lane weights [K, F] against its plain
              version (K = 1, 2, 3, 8, 13) and timed; the 8-point LIN
              int32 learning-rate sweep (GANG_LIN_LRS) as one
              FusedGdSweep against its 8 serial fits (every lane
              bit-identical, 10 fx_matvec launches against 80), the LOG
              gang with a lane cancelled, the LIN gang at fuse_steps 5
              and traced (a valid Chrome trace); two 1,024-core slices
              each equal to a standalone system; LIN and KME int16
              resumed from disk snapshots equal to the uninterrupted fits
  9. service  the training service at the LIN/LOG, KME and DTR cells'
              full width over N_CORES cores in 64-core ranks: one
              PimScheduler (deadline policy, preemptive) drains LIN
              int32, LOG int32_lut_wram, KME int16, DTR and the fused
              8-lane LIN gang, and a priority LIN job at fuse_steps 5
              that evicts one at a chunk boundary, with the launch counts
              zeroed just before it: every job DONE without an error and
              bit-identical to its standalone card fit, the counts exact,
              the parent's TransferStats the jobs' sum, device memory back
              within SERVICE_MEMORY_SLACK; per-job queue and completion
              latency, measured and modeled seconds and drift, the
              scheduler's host time a turn and the card's busy share;
              then serve mode with 4 jobs submitted while the loop runs
              (a chunk graph captured on the serve thread); then
              ``python -m repro_torch.launch.pim_jobs`` on
              examples/jobs.yaml as JSON and again with --resume, which
              restores every job without a launch

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Nothing of JAX or the JAX package is
imported.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 0
N_CORES = 2048
N_SAMPLES = 6_291_456          # the paper's strong-scaling LIN/LOG dataset
N_FEATURES = 16
ITERS = 10
TIMING_RUNS = 20
#: the device sleep after a reading L2 flush: ~0.5 ms at the H100's boost
#: clock (1.98 GHz), longer than the host takes to enqueue a kernel
#: wrapper (29-83 us per call, PR 15)
FLUSH_SLEEP_CYCLES = 1_000_000
#: fp32 CPU-vs-card tolerance: cuBLAS and ATen's CPU kernels sum the
#: per-core products and the gradient rows in different orders
FP32_RTOL, FP32_ATOL = 1e-4, 1e-6
KME_SAMPLES = 25_600_000       # the paper's strong-scaling KME dataset
KME_QUALITY = 100_000          # ... and its quality dataset
KME_K = 16
#: KME fp32 CPU-vs-card tolerance on the centroids (blob coordinates are
#: ~10): the float32 distance and one-hot sum matmuls run in other orders
KME_FP32_RTOL, KME_FP32_ATOL = 1e-4, 1e-3
#: the paper's strong-scaling DTR dataset, then the cuts taken when the
#: host cannot generate it: make_classification peaks at ~450 B of host
#: memory per sample (float64 intermediates)
DTR_SIZES = (153_600_000, 76_800_000, 38_400_000)
DTR_HOST_BYTES_PER_SAMPLE = 450
DTR_QUALITY = 600_000
DTR_DEPTH = 10
#: the DTR main rows timed again over this many cores (the launcher's
#: default), fewer than the H100's 132 SMs: gini_counts then splits a
#: core's rows over blocks that add into its partial
FEW_CORES = 16
#: the Netflix Prize matrix (Bennett & Lanning, KDD Cup 2007): users and
#: items; then its 100,480,507 ratings and the cuts taken when the host
#: cannot generate them: make_recsys peaks at ~250 B of host memory per
#: rating at dim 16 (the gathered user and item rows and their product)
EMB_USERS, EMB_ITEMS = 480_189, 17_770
EMB_SIZES = (100_480_507, 50_240_254, 25_120_127)
EMB_HOST_BYTES_PER_SAMPLE = 250
EMB_DIM, EMB_BATCH, EMB_ITERS, EMB_FLUSH = 16, 64, 200, 8
#: the learning rate and Q format of the repo's EMB benchmark
#: (benchmarks/emb_bench.py); at the defaults (0.05, Q10) the int32
#: update lr/batch rounds to 1/1024 and most delta rows round to zero
EMB_LR, EMB_FRAC_BITS = 1.0, 12
#: the main path's EMB fits (name, hyperparameters)
EMB_FITS = (("int32 eager", {"version": "int32"}),
            ("int32 deferred D=8", {"version": "int32",
                                    "flush_every": EMB_FLUSH}),
            ("int32 D=8 compressed", {"version": "int32",
                                      "flush_every": EMB_FLUSH,
                                      "compress_flush": True}),
            ("fp32 eager", {"version": "fp32"}))
EMB_CHECK, EMB_CHECK_ITERS = 20_000, 40   # the card-vs-CPU EMB fits
#: the fused phase: GD and Lloyd's chunk lengths and pipeline depths, and
#: EMB's chunk length (one D=8 window a chunk)
FUSE_STEPS, FUSE_DEPTHS, KME_FUSE, EMB_FUSE = (5, 10), (1, 2), 5, 8
FUSED_GD = (("linreg", "int32"), ("linreg", "hyb"),
            ("logreg", "int32_lut_wram"), ("logreg", "int32_lut_mram"))
#: EMB fp32 CPU-vs-card tolerance on the tables: the prediction sums
#: u * i over the 16 columns in another order on the card
EMB_FP32_RTOL, EMB_FP32_ATOL = 1e-4, 1e-6
#: published peaks of the H100 SXM (NVIDIA data sheet): HBM3 bytes/s;
#: int32 operations on the CUDA cores (64 INT32 lanes per SM, half the
#: FP32 lanes; a multiply-add counts 2); float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 33.5e12
PEAK_FP32_OPS_PER_S = 67e12
#: ... and the dense tensor-core rates: int8 operations, bf16 flops
PEAK_INT8_OPS_PER_S = 1979e12
PEAK_BF16_FLOPS = 989e12
INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1
#: lut_sigmoid's misaligned and ragged cases: about this many elements,
#: and the length of the odd table beside the paper's
LUT_RAGGED, LUT_ODD = 100_000, 1_001

#: the LM serve load: the repo's serving model (launch/serve.py's default)
#: at full width and depth, 8 requests over 4 slots, prompt lengths drawn
#: by SEED from 128-1024, 32 new tokens each, greedy
LM_ARCH = "qwen3-8b"
LM_REQUESTS, LM_SLOTS, LM_NEW, LM_MAX_SEQ = 8, 4, 32, 2048
LM_PROMPT_MIN, LM_PROMPT_MAX = 128, 1024
LM_PROFILE_STEPS = 8
#: qwen3-8b's MLP linears as (K, N): up and gate, then down
LM_MLP_SHAPES = ((4096, 12288), (12288, 4096))
#: flash_attention against its plain version: both compute in float32 in
#: other orders (expf against ATen's exp), so float32 outputs agree to
#: ~1e-6 of their O(1) size; in bf16 the kernel also rounds the softmax
#: weights to bf16 (2**-9 relative) for the tensor cores' P @ V, and the
#: output may round to the neighbouring bf16 value (one ulp is 2**-6
#: below 4)
MHA_F32_ATOL, MHA_BF16_ATOL = 1e-5, 2e-2
#: prefill + decode against the forward at full width, on one prompt.
#: float32: the repo's float32 tolerance for that property
#: (tests/test_arch_smoke.py).  bf16 keeps 8 significant bits (2**-8 per
#: rounding); the decode step rounds the residual stream of its one token
#: through 36 layers in other orders than the prompt's batched path
#: (cuBLAS gemv against gemm) and casts the softmax weights to bf16
#: before p @ v (the reference's attention.py:184) where the prefill's
#: kernel keeps them float32: ~10 roundings a layer, a random walk of
#: ~2**-8 * sqrt(360) ~ 7% of a logit's scale (~1 here), whose largest of
#: 151,936 logits lies ~4 sigma out
LM_F32_PROPERTY_TOL, LM_BF16_TOL = 1e-3, 0.25
#: reduced qwen3-8b in float32, card against CPU: float32 in other orders
#: (tests/test_torch_lm.py's LOGIT_ATOL); with quantize_dense on, one int8
#: rounding step of one activation moves a logit by up to 0.145 there, so
#: two such steps (QUANT_LOGIT_ATOL)
LM_F32_ATOL, LM_QUANT_ATOL = 1e-4, 0.3

LIN_VERSIONS = ("int32", "hyb", "fp32")
LOG_VERSIONS = ("int32_lut_wram", "int32_lut_mram")

#: phase 8: fx_matvec's lane counts against the plain version, the gangs'
#: learning rates (an 8-point LIN sweep around the launcher's 0.1, a
#: 4-point LOG one around its 5.0), the LOG lane cancelled after
#: GANG_CANCEL_AT iterations, the chunked gang's fuse_steps, the slices'
#: rank and width, and the iteration of the snapshots
LANE_KS = (1, 2, 3, 8, 13)
GANG_LIN_LRS = (0.02, 0.05, 0.1, 0.15, 0.2, 0.3, 0.4, 0.5)
GANG_LOG_LRS = (1.0, 2.0, 5.0, 10.0)
GANG_CANCEL_AT, GANG_FUSE = 3, 5
#: the gang timed untraced (False) and traced (True) in these turns
TRACE_TURNS = (False, True, True, False) * 2
SLICE_RANK, SLICE_CORES = 64, 1024
SNAPSHOT_LIN_AT, SNAPSHOT_KME_AT = 5, 3

#: phase 9, the training service over N_CORES cores in UPMEM's 64-core
#: ranks: the priority job's arrival (after this many turns) and chunk
#: length, the drain's and the serve loop's time limits, the service's
#: device-memory allowance after a drain, and examples/jobs.yaml as JSON
#: (the card's machine has no PyYAML; tests/test_torch_service.py holds
#: this equal to the YAML file)
SERVICE_RANK, SERVICE_PRIORITY_AT, SERVICE_FUSE = 64, 3, 5
SERVICE_TIMEOUT = 300.0
SERVICE_MEMORY_SLACK = 64 << 20
TREE_FIELDS = ("feature", "threshold", "left", "right", "leaf_class",
               "depth")
JOBS_YAML_AS_JSON = {
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
        {"workload": "logreg", "dataset": "lin",
         "version": "int32_lut_wram", "cores": 4,
         "params": {"n_iters": 150}},
    ],
    "sweeps": [
        {"workload": "linreg", "dataset": "lin", "version": "hyb",
         "cores": 8, "fused": True, "grid": {"lr": [0.05, 0.1, 0.2, 0.4]},
         "params": {"n_iters": 150}},
    ],
}


def say(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


class L2Flush:
    """What runs before each timed call, so that the call finds L2 cold:
    sum a 256 MB buffer into a preallocated scalar, which leaves L2
    holding clean lines of the buffer (zeroing it would leave ~50 MB of
    dirty lines whose write-back the timed call pays), then a device sleep
    of FLUSH_SLEEP_CYCLES, so that the host has enqueued the timed call
    before its start event fires."""

    def __init__(self, torch):
        self.torch = torch
        self.buf = torch.zeros(32 << 20, dtype=torch.int64, device="cuda")
        self.sink = torch.zeros((), dtype=torch.int64, device="cuda")

    def __call__(self) -> None:
        self.torch.sum(self.buf, 0, out=self.sink)
        self.torch.cuda._sleep(FLUSH_SLEEP_CYCLES)


def cuda_ms(torch, fn, flush: L2Flush) -> float:
    """Median CUDA-event time of ``fn()`` in ms over TIMING_RUNS runs,
    after two warm-up runs, with ``flush()`` before each."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(TIMING_RUNS):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(torch, fn, n: int = 50) -> float:
    """Host microseconds per call of ``fn`` (enqueue only: the card runs
    behind), over ``n`` calls after a synchronised warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def bound(nbytes: float, ops: float,
          ops_per_s: float = PEAK_INT32_OPS_PER_S) -> tuple[float, str]:
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


#: the peak each declared cost's operations run at (KernelCost.rate)
PEAK_OPS_PER_S = {"int32": PEAK_INT32_OPS_PER_S, "fp32": PEAK_FP32_OPS_PER_S,
                  "int8": PEAK_INT8_OPS_PER_S, "bf16": PEAK_BF16_FLOPS}


def declared_bound(op: str, *args) -> tuple[float, str]:
    """The bound of one call of a PIM-ML kernel op from the cost it
    declares (kernels/dispatch.py), the same count the gpu-model target
    charges it."""
    from repro_torch.kernels import dispatch
    cost = dispatch.declared_cost(op, *args)
    return bound(cost.bytes, cost.ops, PEAK_OPS_PER_S[cost.rate])


def host_samples(sizes, bytes_per_sample: int) -> tuple[int, int]:
    """The largest of ``sizes`` whose generation fits half of
    MemAvailable, and MemAvailable in bytes."""
    with open("/proc/meminfo") as f:
        avail = next(int(line.split()[1]) * 1024 for line in f
                     if line.startswith("MemAvailable:"))
    for n in sizes:
        if n * bytes_per_sample <= avail / 2:
            return n, avail
    fail(f"MemAvailable {avail} B holds no size of {sizes}")


def same(torch, outs, refs) -> float:
    """Max abs difference of kernel outputs from their plain version's;
    fails unless they are equal (shape, dtype and values)."""
    torch.cuda.synchronize()
    if any(o.shape != r.shape or o.dtype != r.dtype
           for o, r in zip(outs, refs)):
        fail("kernel output and plain version differ in shape or dtype")
    err = max(float((o.double() - r.double()).abs().max()) if o.numel()
              else 0.0 for o, r in zip(outs, refs))
    if not all(torch.equal(o, r) for o, r in zip(outs, refs)):
        fail(f"kernel != plain (max abs err {err})")
    return err


def check_kmeans_assign(torch, dev, gen) -> tuple[int, dict]:
    """kmeans_assign against its plain version: the KME main shape with
    quantized and with full-range int16 (the products wrap), two chained
    calls there (one block per core stores a partial allocated empty), a
    ragged shape, K = 1, 9 and 33, F = 1 and 40, one row a core, rows that
    are not 16-byte aligned, and duplicated centroids (ties).  Returns the
    max abs error and the main-shape inputs."""
    from repro_torch.kernels.kmeans_assign import (kmeans_assign_cuda,
                                                   kmeans_assign_plain)

    def ints(shape, lo=-32768, hi=32768):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(torch.int16)
    n_pc = KME_SAMPLES // N_CORES
    main = (ints((N_CORES, n_pc, N_FEATURES), -2047, 2048),
            ints((KME_K, N_FEATURES), -2047, 2048))
    ties_c = ints((9, N_FEATURES), -1, 2)
    ties_c[4], ties_c[8] = ties_c[2], ties_c[0]
    flat = ints((5 * 999 * N_FEATURES + 1,))
    cases = {
        f"main {tuple(main[0].shape)} K={KME_K}": main,
        "main shape, full-range int16": (ints((N_CORES, n_pc, N_FEATURES)),
                                         ints((KME_K, N_FEATURES))),
        "main shape again, other values (chained)": (
            ints((N_CORES, n_pc, N_FEATURES), -3, 4),
            ints((KME_K, N_FEATURES), -3, 4)),
        "ragged (7, 100003, 13) K=5, full-range": (ints((7, 100_003, 13)),
                                                   ints((5, 13))),
        "(4, 3001, 16) K=1": (ints((4, 3001, 16)), ints((1, 16))),
        "(4, 3001, 16) K=9": (ints((4, 3001, 16)), ints((9, 16))),
        "(5, 2999, 16) K=33": (ints((5, 2999, 16)), ints((33, 16))),
        "(6, 3001, 1) K=7": (ints((6, 3001, 1)), ints((7, 1))),
        "(3, 4001, 40) K=33": (ints((3, 4001, 40)), ints((33, 40))),
        "(5, 1, 16) K=16, one row a core": (ints((5, 1, 16)),
                                            ints((16, 16))),
        "(5, 999, 16) K=16, rows not 16-byte aligned": (
            flat[1:].view(5, 999, N_FEATURES), ints((16, 16))),
        "ties (16, 4097, 16) K=9, duplicated centroids": (
            ints((16, 4097, N_FEATURES), -3, 4), ties_c),
    }
    err = 0
    for name, (x, c) in cases.items():
        out = kmeans_assign_cuda(x, c)
        err = max(err, same(torch, out, kmeans_assign_plain(x, c)))
        if name.startswith("ties") and torch.isin(
                out[0], torch.tensor([4, 8], device=dev)).any():
            fail("kmeans_assign: a duplicated centroid won a tie")
        say(f"kernels: kmeans_assign == plain, {name}")
        del out
    return err, {"x": main[0], "c": main[1]}


def check_gini_counts(torch, dev, gen, n_dtr: int) -> tuple[int, dict]:
    """gini_counts against its plain version at the DTR main shape with
    L = 4096: every row at the root, leaves spread over 2^10 values, over
    all 4,096 (wider than the window: rows past it add to global memory)
    and over a depth-10 frontier's ids 1023-2046, these calls chained on
    partials allocated empty; one block over more than 65,535 rows (three
    passes of 16-bit counters); the main rows over FEW_CORES cores and a
    3-core shape, whose cores split over blocks that add into zeros; 3
    classes at F = 13 and a ragged shape, with rows out of range.  Returns
    the max abs error and the main-shape inputs."""
    from repro_torch.kernels.gini_split import (gini_split_cuda,
                                                gini_split_plain)
    n_leaves = 2 ** (DTR_DEPTH + 2)
    n_pc = n_dtr // N_CORES
    x = torch.randn((N_CORES, n_pc, N_FEATURES), generator=gen, device=dev)
    y = torch.randint(0, 2, (N_CORES, n_pc), generator=gen, device=dev,
                      dtype=torch.int32)
    th = torch.randn((n_leaves, N_FEATURES), generator=gen, device=dev)

    def leaves(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)
    def few_cores(leaf):
        return (x.view(FEW_CORES, -1, N_FEATURES), y.view(FEW_CORES, -1),
                leaf.view(FEW_CORES, -1), th, 2)
    main = {"x": x, "y": y, "th": th, "few_cores": few_cores,
            "spread": leaves((N_CORES, n_pc), 0, 1024),
            "root": torch.zeros((N_CORES, n_pc), dtype=torch.int32,
                                device=dev),
            "frontier": leaves((N_CORES, n_pc), 1023, 2047)}

    def ragged(n_cores, n_pc, f, n_leaves, n_cls, hi):
        rx = torch.randn((n_cores, n_pc, f), generator=gen, device=dev)
        ry = torch.randint(0, n_cls, (n_cores, n_pc), generator=gen,
                           device=dev, dtype=torch.int32)
        rleaf = leaves((n_cores, n_pc), 0, hi)
        rleaf[0, :9], ry[1, :9], rleaf[2, :5] = n_leaves, n_cls, -1
        return (rx, ry, rleaf, torch.randn((n_leaves, f), generator=gen,
                                           device=dev), n_cls)
    cases = {
        f"main {tuple(x.shape)} L={n_leaves}, all rows at the root":
            lambda: (x, y, main["root"], th, 2),
        "main shape, leaves spread over 2^10": lambda: (x, y, main["spread"],
                                                        th, 2),
        "main shape, leaves spread over all 4096 (past the window)":
            lambda: (x, y, leaves((N_CORES, n_pc), 0, n_leaves), th, 2),
        "main shape, a depth-10 frontier's ids 1023-2046":
            lambda: (x, y, main["frontier"], th, 2),
        "(132, 150001, 16) L=4096, one block over more than 65,535 rows":
            lambda: (torch.randn((132, 150_001, N_FEATURES), generator=gen,
                                 device=dev), leaves((132, 150_001), 0, 2),
                     leaves((132, 150_001), 0, 1024), th, 2),
        f"the main rows as ({FEW_CORES}, {N_CORES * n_pc // FEW_CORES}, "
        f"16), leaves spread over 2^10 (several blocks a core add)":
            lambda: few_cores(main["spread"]),
        "(3, 200001, 16) L=4096, leaves over all 4096, several blocks a core":
            lambda: (torch.randn((3, 200_001, N_FEATURES), generator=gen,
                                 device=dev), leaves((3, 200_001), 0, 2),
                     leaves((3, 200_001), 0, n_leaves), th, 2),
        "(64, 20000, 13) L=4096, 3 classes, rows out of range":
            lambda: ragged(64, 20_000, 13, n_leaves, 3, 2047),
        "ragged (5, 100003, 13) L=37, 3 classes, rows out of range":
            lambda: ragged(5, 100_003, 13, 37, 3, 37),
    }
    err = 0
    for name, make in cases.items():
        args = make()
        out = gini_split_cuda(*args)
        err = max(err, same(torch, out, gini_split_plain(*args)))
        say(f"kernels: gini_counts == plain, {name}")
        del args, out
    return err, main


def zipf_ids(rng, n: int, vocab: int) -> np.ndarray:
    """``n`` ids from make_recsys's truncated Pareto popularity stream."""
    return np.minimum(rng.pareto(1.2, n).astype(np.int64),
                      vocab - 1).astype(np.int32)


def check_emb_kernels(torch, dev, make_system) -> tuple[int, int, dict]:
    """emb_gather and emb_scatter_add against their plain versions at the
    EMB main shapes: the Netflix-size tables placed over 2048 cores
    ([2048, 235, 16] users, [2048, 9, 16] items; both tails pad) with 64
    Zipf lookups; at both, a padded deferred flush (8 batches
    deduplicated, padded with IDX_PAD to a multiple of 64); 64 copies of
    one hot id; and a ragged shape with misses.  int32 tables and updates
    are full-range, so the sums wrap.  The gathers search each table's
    gather index, built once per placement.  Returns the max abs errors
    and the main inputs per table and dtype."""
    from repro_torch.kernels.sparse_gather import (
        IDX_PAD, emb_gather_cuda, emb_gather_plain, emb_scatter_add_cuda,
        emb_scatter_add_plain, gather_index)
    rng = np.random.RandomState(SEED)
    system = make_system("pim", n_cores=N_CORES, device="cuda")

    def table(vocab, dtype):
        t = system.put_table(np.zeros((vocab, 1), np.float32))
        shape = (N_CORES, t.rows_per_shard, EMB_DIM)
        if dtype == "int32":
            v = rng.randint(INT32_MIN, INT32_MAX, shape, np.int64)
            v = v.astype(np.int32)
        else:
            v = rng.uniform(0.5, 2.0, shape).astype(np.float32)
            v *= rng.choice([-1, 1], shape)           # finite, never 0
        return torch.from_numpy(v).to(dev), t

    def rows(n, dtype):
        if dtype == "int32":
            v = rng.randint(INT32_MIN, INT32_MAX, (n, EMB_DIM), np.int64)
            return torch.from_numpy(v.astype(np.int32)).to(dev)
        return torch.from_numpy(rng.randn(n, EMB_DIM)
                                .astype(np.float32)).to(dev)

    def ids_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def padded_flush(vocab):
        flush = np.unique(zipf_ids(rng, EMB_FLUSH * EMB_BATCH, vocab))
        pad = -len(flush) % EMB_BATCH
        return np.concatenate([flush, np.full(pad, IDX_PAD, np.int32)])

    vocabs = {"users": EMB_USERS, "items": EMB_ITEMS}
    eager = {k: zipf_ids(rng, EMB_BATCH, v) for k, v in vocabs.items()}
    flushes = {k: padded_flush(v) for k, v in vocabs.items()}
    err_g = err_s = 0
    main = {}
    for dtype in ("int32", "fp32"):
        tabs = {k: table(v, dtype) for k, v in vocabs.items()}
        rt = torch.from_numpy(rng.randint(-99, 99, (7, 13, 3))
                              .astype(np.int32)).to(dev)
        rt = rt if dtype == "int32" else rt.float() + 0.5
        rids = ids_dev(np.arange(7 * 13).reshape(13, 7).T)
        ragged = ids_dev([5, 90, IDX_PAD, 91, 5, 12, 300, 6, 5])
        gathers = {"ragged (7, 13, 3), misses and IDX_PAD": (
            rt, rids, ragged, gather_index(rids))}
        scatters = {"ragged (7, 13, 3), duplicates, misses and IDX_PAD": (
            rt, rids, ragged, rows(9, dtype)[:, :3].contiguous()
            .to(rt.dtype))}
        for name, (tab, t) in tabs.items():
            ids, index = t.ids_device(), t.gather_index()
            shape = tuple(tab.shape)
            gathers[f"{name} {shape}, 64 Zipf lookups"] = (
                tab, ids, ids_dev(eager[name]), index)
            scatters[f"{name} {shape}, one eager batch of 64 Zipf ids"] = (
                tab, ids, ids_dev(eager[name]), rows(EMB_BATCH, dtype))
            scatters[f"{name}, a padded D={EMB_FLUSH} flush of "
                     f"{len(flushes[name])} rows"] = (
                tab, ids, ids_dev(flushes[name]),
                rows(len(flushes[name]), dtype))
            main[name, dtype] = {
                "table": tab, "ids": ids, "index": index, "placement": t,
                "idx": ids_dev(eager[name]), "upd": rows(EMB_BATCH, dtype),
                "flush": ids_dev(flushes[name]),
                "flush_upd": rows(len(flushes[name]), dtype)}
        scatters["users, 64 copies of one hot id"] = (
            tabs["users"][0], tabs["users"][1].ids_device(),
            ids_dev(np.zeros(EMB_BATCH)), rows(EMB_BATCH, dtype))
        for name, args in gathers.items():
            err_g = max(err_g, same(torch, [emb_gather_cuda(*args)],
                                    [emb_gather_plain(*args)]))
            say(f"kernels: emb_gather == plain, {dtype} {name}")
        for name, args in scatters.items():
            before = args[0].clone()
            out = emb_scatter_add_cuda(*args)
            err_s = max(err_s, same(torch, [out],
                                    [emb_scatter_add_plain(*args)]))
            if not torch.equal(args[0], before):
                fail("emb_scatter_add wrote its input table")
            say(f"kernels: emb_scatter_add == plain, {dtype} {name}")
    return err_g, err_s, main


def emb_fits_on_card(torch, make_system, get_workload, dispatch, smi: str
                     ) -> tuple[dict, list, str]:
    """EMB's main path at the Netflix matrix's size: every fit of
    EMB_FITS through the workload's ``fit_steps`` with the launch counts
    zeroed just before it and checked just after; then the deferred D=8
    int32 fit fused (EMB_FUSE steps a chunk, one CUDA graph replay each),
    against the serial one.  Returns the summed launch counts (the
    serial fits'), a profiler summary of 50 eager int32 steps and one of
    a fused fit."""
    from repro_torch.data.synthetic import make_recsys
    n_emb, avail = host_samples(EMB_SIZES, EMB_HOST_BYTES_PER_SAMPLE)
    say(f"host MemAvailable {avail / 2 ** 30:.1f} GiB: EMB runs at {n_emb:,}"
        f" ratings (the Netflix matrix's {EMB_SIZES[0]:,} need "
        f"~{EMB_SIZES[0] * EMB_HOST_BYTES_PER_SAMPLE / 2 ** 30:.0f} GiB to "
        f"generate; taken when under half of MemAvailable)")
    t0 = time.perf_counter()
    X, y = make_recsys(n_emb, n_users=EMB_USERS, n_items=EMB_ITEMS,
                       dim=EMB_DIM, seed=SEED)
    say(f"data: {n_emb:,} EMB ratings ({EMB_USERS:,} users x "
        f"{EMB_ITEMS:,} items) in {time.perf_counter() - t0:.1f} s")
    system = make_system("pim", n_cores=N_CORES, device="cuda")
    ds = system.put(X, y)
    wl = get_workload("emb")
    base = dict(n_iters=EMB_ITERS, batch=EMB_BATCH, dim=EMB_DIM, lr=EMB_LR,
                frac_bits=EMB_FRAC_BITS, n_users=EMB_USERS, n_items=EMB_ITEMS,
                record_every=EMB_ITERS // 4, seed=SEED)
    totals: dict = {}
    serial = {}
    for name, params in EMB_FITS:
        spec = wl.spec(**base, **params)
        dispatch.reset_launch_counts()
        steps, res = step_times(wl.fit_steps(ds, spec))
        torch.cuda.synchronize()
        counts = dict(dispatch.launch_counts)
        m = serial[name] = res.model
        expected = {"emb_gather": 2 * EMB_ITERS,
                    "emb_scatter_add": 2 * m.n_flushes}
        windows = EMB_ITERS // params.get("flush_every", 1)
        if counts != expected or m.n_flushes != windows:
            fail(f"EMB {name}: launch counts {counts}, {m.n_flushes} "
                 f"flushes (expected {expected}, {windows} flushes)")
        if not (m.user_emb.shape == (EMB_USERS, EMB_DIM)
                and m.item_emb.shape == (EMB_ITEMS, EMB_DIM)
                and np.isfinite(m.user_emb).all()
                and np.isfinite(m.item_emb).all()
                and all(np.isfinite(h) for _, h in m.history)):
            fail(f"EMB {name}: misshapen or non-finite tables or loss")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        dt = statistics.median(steps[1:EMB_ITERS])
        mean = statistics.mean(steps[1:EMB_ITERS])
        say(f"fit: emb     {name:<21} {dt * 1e3:.3f} ms/step (median of "
            f"steps 2-{EMB_ITERS}; mean {mean * 1e3:.3f}), "
            f"{EMB_BATCH / dt:.4g} samples/s; setup and first step "
            f"{steps[0] * 1e3:.1f} ms; launch counts {counts}, "
            f"{m.n_flushes} flushes; batch MSE "
            + " ".join(f"{h:.4g}" for _, h in m.history)
            + f" ({N_CORES} cores, on {smi})")
    gen = wl.fit_steps(ds, wl.spec(**base, version="int32"))
    next(gen)                                # set-up and the first step
    profile = device_profile(torch, lambda: [next(gen) for _ in range(50)])
    gen.close()
    fused_profile = emb_fused_on_card(torch, wl, ds, base, dispatch,
                                      serial["int32 deferred D=8"], smi)
    del X, y, ds
    return totals, profile, fused_profile


def emb_fused_on_card(torch, wl, ds, base: dict, dispatch, serial, smi: str
                      ) -> str:
    """The deferred D=8 int32 fit with EMB_FUSE steps a chunk, twice, each
    with the launch counts zeroed just before it: tables and loss history
    equal the serial fit's, 2 emb_gather a step and 2 emb_scatter_add a
    flush, one graph replay a chunk.  A fit captures its own chunk graphs
    (they read its tables), one per chunk length.  Returns a profiler
    summary of a third fit after its first chunk."""
    spec = wl.spec(**base, version="int32", flush_every=EMB_FLUSH,
                   fuse_steps=EMB_FUSE)
    for run in (1, 2):
        syncs = ds.system.stats.host_syncs
        dispatch.reset_launch_counts()
        with GraphCaptures(torch) as graphs:
            chunks, res = chunk_times(torch, wl.fit_steps(ds, spec))
        m = res.model
        counts = dict(dispatch.launch_counts)
        replays = sum(dispatch.graph_replays.values())
        n_chunks = ds.system.stats.host_syncs - syncs  # a sync a chunk
        expected = {"emb_gather": 2 * EMB_ITERS,
                    "emb_scatter_add": 2 * m.n_flushes}
        if counts != expected or replays != n_chunks:
            fail(f"EMB fused: launch counts {counts}, {replays} replays "
                 f"for {n_chunks} chunks (expected {expected})")
        if not (np.array_equal(m.user_raw, serial.user_raw)
                and np.array_equal(m.item_raw, serial.item_raw)
                and m.history == serial.history
                and m.n_flushes == serial.n_flushes):
            fail("EMB fused: tables or history differ from the serial "
                 "deferred fit on the card")
        per_step = statistics.median(t / k for k, t in chunks[1:-1])
        say(f"fused: emb int32 D={EMB_FLUSH} fuse_steps {EMB_FUSE} (fit "
            f"{run}) {per_step * 1e3:.3f} ms/step (median over chunks "
            f"2-{len(chunks) - 1} of a chunk's time over its steps, "
            f"flushes included; the chunks that capture their graph "
            f"among them); set-up and first chunk "
            f"{chunks[0][1] * 1e3:.1f} ms; launch counts {counts}, "
            f"{replays} graph replays for {n_chunks} chunks; tables and "
            f"history == serial deferred fit ({N_CORES} cores, on {smi})")
        say(f"fused: emb chunk graphs of fit {run}: {graphs} (on {smi})")
    from repro_torch.systems import run_steps
    gen = wl.fit_steps(ds, spec)
    next(gen)
    return device_profile(torch, lambda: run_steps(gen))


def emb_card_equals_cpu(make_system, make_estimator) -> None:
    """The EMB fits at EMB_CHECK ratings on 1 and 16 cores under every
    reduce strategy, on the card and on the CPU."""
    from repro_torch.data.synthetic import make_recsys
    X, y = make_recsys(EMB_CHECK, n_users=max(64, EMB_CHECK // 16),
                       n_items=max(48, EMB_CHECK // 24), dim=EMB_DIM,
                       seed=SEED)
    t0 = time.perf_counter()
    n_int = n_fp = 0
    for cores in (1, 16):
        for reduce in ("fabric", "host", "hierarchical"):
            fits, stats = {}, {}
            for device in ("cuda", "cpu"):
                system = make_system("pim", n_cores=cores, reduce=reduce,
                                     device=device)
                ds = system.put(X, y)
                fits[device] = [make_estimator(
                    "emb", n_iters=EMB_CHECK_ITERS, batch=EMB_BATCH,
                    dim=EMB_DIM, lr=EMB_LR, frac_bits=EMB_FRAC_BITS,
                    record_every=10, seed=SEED, system=system,
                    **params).fit(ds).result_.model
                    for _, params in EMB_FITS]
                stats[device] = system.stats.snapshot()
            for (name, params), g, c in zip(EMB_FITS, fits["cuda"],
                                            fits["cpu"]):
                what = f"EMB {name}, {cores} cores, {reduce} reduce"
                if g.n_flushes != c.n_flushes:
                    fail(f"{what}: flush counts differ")
                if params["version"] == "int32":
                    n_int += 1
                    if not (np.array_equal(g.user_raw, c.user_raw)
                            and np.array_equal(g.item_raw, c.item_raw)
                            and g.history == c.history):
                        fail(f"{what}: card and CPU fits differ")
                    continue
                n_fp += 1
                if not all(np.allclose(a, b, rtol=EMB_FP32_RTOL,
                                       atol=EMB_FP32_ATOL)
                           for a, b in ((g.user_raw, c.user_raw),
                                        (g.item_raw, c.item_raw))):
                    fail(f"{what}: fp32 tables differ beyond tolerance")
            if stats["cuda"] != stats["cpu"]:
                fail(f"EMB TransferStats differ on {cores} cores, {reduce} "
                     f"reduce: {stats['cuda']} != {stats['cpu']}")
    say(f"  EMB at {EMB_CHECK:,} ratings, {EMB_CHECK_ITERS} steps, 1 and 16 "
        f"cores x fabric/host/hierarchical: {n_int} int32 fits card == cpu "
        f"(tables, history, flushes), {n_fp} fp32 fits within rtol "
        f"{EMB_FP32_RTOL} atol {EMB_FP32_ATOL}, TransferStats equal "
        f"({time.perf_counter() - t0:.1f} s)")


def emb_kernel_times(torch, emb: dict, flush) -> dict:
    """CUDA-event times of both EMB kernels at the main shapes (the user
    and the item table, int32 and float32, one eager batch; the scatter
    also on each table's padded flush), their plain versions, their
    bounds, and the nearest PyTorch call on the flat (C*R, D) table with
    the lookups' slots computed on the host.  Keys of the users table
    (int32) are bare; the other cases carry a prefix."""
    from repro_torch.kernels.sparse_gather import (
        emb_gather_cuda, emb_gather_plain, emb_scatter_add_cuda,
        emb_scatter_add_plain)

    def gather(d):
        return emb_gather_cuda(d["table"], d["ids"], d["idx"], d["index"])

    def scatter(d, key="idx", upd="upd"):
        return emb_scatter_add_cuda(d["table"], d["ids"], d[key], d[upd])

    g, s = {}, {}
    for name in ("users", "items"):
        e, f = emb[name, "int32"], emb[name, "fp32"]
        pre = "" if name == "users" else "items_"
        n_cores, n_rows, dim = e["table"].shape
        ids = e["placement"].ids
        slot_of = np.full(e["placement"].n_rows, -1, np.int64)
        slot_of[ids[ids >= 0]] = np.flatnonzero(ids >= 0)
        slot = torch.from_numpy(slot_of[e["idx"].cpu().numpy()]).to(
            e["table"].device)
        flat = e["table"].view(-1, dim)
        b = e["idx"].numel()
        g[pre + "ms"] = cuda_ms(torch, lambda: gather(e), flush)
        g[pre + "fp32_ms"] = cuda_ms(torch, lambda: gather(f), flush)
        g[pre + "library_ms"] = cuda_ms(torch, lambda: torch.index_select(
            flat, 0, slot), flush)
        # what the function moves: the [C, B, D] partials, the B rows it
        # looks up and idx; PR 13-15 counted every id and C*R*B compares
        g[pre + "bound_ms"], g[pre + "bound_by"] = declared_bound(
            "emb_gather", e["table"], e["ids"], e["idx"])
        g[pre + "old_bound_ms"], _ = bound(
            n_cores * n_rows * 4 + b * 4 + n_cores * b * dim * 4,
            n_cores * n_rows * b)
        s[pre + "ms"] = cuda_ms(torch, lambda: scatter(e), flush)
        s[pre + "fp32_ms"] = cuda_ms(torch, lambda: scatter(f), flush)
        s[pre + "flush_ms"] = cuda_ms(
            torch, lambda: scatter(e, "flush", "flush_upd"), flush)
        s[pre + "library_ms"] = cuda_ms(torch, lambda: torch.index_add(
            flat, 0, slot, e["upd"]), flush)
        s[pre + "bound_ms"], s[pre + "bound_by"] = declared_bound(
            "emb_scatter_add", e["table"], e["ids"], e["idx"], e["upd"])
    e = emb["users", "int32"]
    g["plain_ms"] = cuda_ms(torch, lambda: emb_gather_plain(
        e["table"], e["ids"], e["idx"]), flush)
    s["plain_ms"] = cuda_ms(torch, lambda: emb_scatter_add_plain(
        e["table"], e["ids"], e["idx"], e["upd"]), flush)
    g["library_call"], s["library_call"] = ("torch.index_select",
                                            "torch.index_add")
    return {"emb_gather": g, "emb_scatter_add": s}


def kme_fits(make_estimator, system, ds) -> dict:
    """The KME int16 and fp32 fits of the main path and of the card-CPU
    comparison: k=16, one restart, exactly ITERS iterations."""
    return {v: make_estimator("kmeans", version=v, n_clusters=KME_K,
                              n_init=1, max_iter=ITERS, tol=0.0,
                              system=system).fit(ds)
            for v in ("int16", "fp32")}


def check_kme(est: dict, n: int) -> None:
    for version, e in est.items():
        c = e.cluster_centers_
        if not (c.shape == (KME_K, N_FEATURES) and np.isfinite(c).all()
                and e.n_iter_ == ITERS and e.labels_.shape == (n,)
                and 0 <= e.labels_.min() and e.labels_.max() < KME_K
                and np.isfinite(e.inertia_)):
            fail(f"KME {version}: misshapen or non-finite result")


def chunk_times(torch, gen) -> tuple[list, object]:
    """``(iterations, wall seconds)`` of each chunk a ``fit_steps``
    generator yields, each ending in a synchronize (the last entry, with
    0 iterations, is the work after the last yield), and the result."""
    out, t = [], time.perf_counter()
    while True:
        try:
            k = int(next(gen))
        except StopIteration as stop:
            torch.cuda.synchronize()
            out.append((0, time.perf_counter() - t))
            return out, stop.value
        torch.cuda.synchronize()
        now = time.perf_counter()
        out.append((k, now - t))
        t = now


def step_times(gen) -> tuple[list, object]:
    """Wall seconds of each step of a ``fit_steps`` generator (the host
    reads the reduced partials, a sync, at every step; the last entry is
    the work after the last yield) and the fit's result."""
    times, t = [], time.perf_counter()
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            times.append(time.perf_counter() - t)
            return times, stop.value
        now = time.perf_counter()
        times.append(now - t)
        t = now


def timed(torch, fn) -> tuple[float, object]:
    """Wall seconds of ``fn()`` up to a synchronize, and its result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


class GraphCaptures:
    """Within the block, each chunk graph's capture, its warm-up step
    included, timed between two synchronizations, and the bytes of the
    memory pool it keeps (the segments the allocator lists under the
    graph's pool): ``taken`` holds (program, k, seconds, pool bytes)."""

    def __init__(self, torch):
        from repro_torch.systems import step_graph
        self.torch, self.cls = torch, step_graph.ChunkGraph
        self.taken: list = []

    def __enter__(self):
        torch, init, taken = self.torch, self.cls.__init__, self.taken
        self.init = init

        def timed_init(graph, program, carry, sharded, xs, k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            init(graph, program, carry, sharded, xs, k)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            pool = tuple(graph.graph.pool())
            taken.append((graph.name, k, dt, sum(
                seg["total_size"] for seg in torch.cuda.memory_snapshot()
                if tuple(seg["segment_pool_id"]) == pool)))
        self.cls.__init__ = timed_init
        return self

    def __exit__(self, *exc):
        self.cls.__init__ = self.init

    @property
    def seconds(self) -> float:
        return sum(t for _, _, t, _ in self.taken)

    def __str__(self) -> str:
        return ", ".join(f"k={k} capture {t * 1e3:.1f} ms pool {b:,} B"
                         for _, k, t, b in self.taken)


def fused_gd_fits(torch, dispatch, make_estimator, system, lin_ds, log_ds,
                  smi: str) -> None:
    """LIN int32 and hyb, LOG int32_lut_wram and int32_lut_mram at the main
    shape, serial and then fused at every FUSE_STEPS x FUSE_DEPTHS, each
    with the launch counts zeroed just before it: weights bit-identical
    to the serial card fit, the serial fit's launch counts, one graph
    replay and one host sync per chunk.  Each fused fit captures its
    chunk graphs and drops them when it ends; its time per iteration is
    given with the captures and without them."""
    for workload, version in FUSED_GD:
        ds = lin_ds if workload == "linreg" else log_ds

        def fit(**params):
            return make_estimator(workload, version=version, n_iters=ITERS,
                                  system=system, **params).fit(ds)
        dispatch.reset_launch_counts()
        dt, ref = timed(torch, fit)
        serial_counts = dict(dispatch.launch_counts)
        say(f"fused: {workload:<7} {version:<15} serial "
            f"{dt / ITERS * 1e3:.3f} ms/iteration over the fit; launch "
            f"counts {serial_counts} ({N_CORES} cores, on {smi})")
        for fuse in FUSE_STEPS:
            for depth in FUSE_DEPTHS:
                syncs = system.stats.host_syncs
                dispatch.reset_launch_counts()
                with GraphCaptures(torch) as graphs:
                    dt, est = timed(torch, lambda: fit(
                        fuse_steps=fuse, pipeline_depth=depth))
                counts = dict(dispatch.launch_counts)
                replays = sum(dispatch.graph_replays.values())
                chunks = system.stats.host_syncs - syncs
                if (counts != serial_counts or replays != chunks
                        or chunks != -(-ITERS // fuse)):
                    fail(f"{workload} {version} fuse_steps {fuse}: launch "
                         f"counts {counts}, {replays} replays, {chunks} "
                         f"chunks (serial: {serial_counts})")
                if not (np.array_equal(est.coef_, ref.coef_)
                        and est.intercept_ == ref.intercept_):
                    fail(f"{workload} {version} fuse_steps {fuse} depth "
                         f"{depth}: weights differ from the serial card fit")
                say(f"fused: {workload:<7} {version:<15} fuse_steps {fuse:>2}"
                    f" depth {depth} "
                    f"{(dt - graphs.seconds) / ITERS * 1e3:.3f} ms/iteration"
                    f" over the fit without its captures "
                    f"({dt / ITERS * 1e3:.3f} with them); {replays} "
                    f"replays; w, b == serial card fit; chunk graphs: "
                    f"{graphs} (on {smi})")
    torch.cuda.empty_cache()


def fused_kme(torch, dispatch, make_system, get_workload, kme_ds, serial,
              Xq, smi: str) -> str:
    """KME int16 at the main shape with KME_FUSE iterations a chunk, at
    depth 1 (to time a replayed chunk) and 2, each fit capturing its
    chunk graph and with the launch counts zeroed just before it: ITERS
    kmeans_assign launches, one replay a chunk, held to the serial fit
    within the reference's fused-against-serial tolerances
    (tests/test_step_fusion.py); then the card's fused fit against the
    CPU's at KME_QUALITY samples, bit for bit.  Returns a profiler
    summary of a fused fit."""
    wl = get_workload("kmeans")

    def spec(**extra):
        return wl.spec("int16", n_clusters=KME_K, n_init=1, max_iter=ITERS,
                       tol=0.0, **extra)
    steps, _ = step_times(wl.fit_steps(kme_ds, spec()))
    say(f"fused: kmeans  int16 serial "
        f"{statistics.median(steps[1:ITERS]) * 1e3:.3f} ms/iteration "
        f"(median of iterations 2-{ITERS}; {N_CORES} cores, "
        f"{KME_SAMPLES:,} samples, on {smi})")
    for depth in FUSE_DEPTHS:
        dispatch.reset_launch_counts()
        with GraphCaptures(torch) as graphs:
            chunks, res = chunk_times(torch, wl.fit_steps(
                kme_ds, spec(fuse_steps=KME_FUSE, pipeline_depth=depth)))
        m = res.model
        counts = dict(dispatch.launch_counts)
        replays = sum(dispatch.graph_replays.values())
        if counts != {"kmeans_assign": ITERS} or replays != ITERS // KME_FUSE:
            fail(f"KME fused: launch counts {counts}, {replays} replays")
        dc = float(np.abs(m.centroids - serial.cluster_centers_).max())
        rel = abs(m.inertia - serial.inertia_) / abs(serial.inertia_)
        say(f"fused: kmeans  int16 fuse_steps {KME_FUSE} depth {depth} "
            + (f"{chunks[1][1] / chunks[1][0] * 1e3:.3f} ms/iteration (the "
               f"second chunk over its {chunks[1][0]} iterations); "
               if depth == 1 else "")
            + f"first chunk with the init draw and the capture "
            f"{chunks[0][1] * 1e3:.1f} ms; chunk graph: {graphs}; launch "
            f"counts {counts}, {replays} replays; against the serial fit: "
            f"n_iter {m.n_iters}, inertia rel {rel:.3g}, max |dC| "
            f"{dc:.3g} (on {smi})")
        if not (m.n_iters == serial.n_iter_ and rel <= 1e-4
                and np.allclose(m.centroids, serial.cluster_centers_,
                                rtol=1e-4, atol=1e-3)):
            fail("KME fused: beyond the fused-against-serial tolerances")
    profile = device_profile(torch, lambda: wl.fit(
        kme_ds, spec(fuse_steps=KME_FUSE)))
    gen = wl.fit_steps(kme_ds, spec(fuse_steps=KME_FUSE, pipeline_depth=1))
    next(gen)                          # the init draw and the first chunk
    say(f"profile: KME int16 fused, its second chunk ({KME_FUSE} "
        f"iterations): " + device_profile(torch, lambda: next(gen), top=10))
    gen.close()
    quality = {}
    for device in ("cuda", "cpu"):
        qs = make_system("pim", n_cores=N_CORES, device=device)
        quality[device] = (wl.fit(qs.put(Xq), spec(fuse_steps=KME_FUSE)
                                  ).model, qs.stats.snapshot())
    (g, gs), (c, cs) = quality["cuda"], quality["cpu"]
    if not (np.array_equal(g.centroids, c.centroids)
            and np.array_equal(g.labels, c.labels)
            and g.n_iters == c.n_iters and gs == cs):
        fail("KME fused: card and CPU fits differ at the quality size")
    say(f"fused: kmeans int16 at {KME_QUALITY:,} samples: card == cpu "
        f"(centroids, labels, n_iter {g.n_iters}, TransferStats)")
    return profile


def gini_round_times(torch, dispatch, fit):
    """CUDA-event ms of each gini_split launch inside ``fit()`` (the
    rounds with L2 as the fit leaves it), and the fit's result."""
    op = dispatch.get_op("gini_split")
    events = []

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = op.cuda(*args)
        end.record()
        events.append((start, end))
        return out
    dispatch.register_op("gini_split", cuda=timed, plain=op.plain,
                         cost=op.cost)
    try:
        result = fit()
    finally:
        dispatch.register_op("gini_split", cuda=op.cuda, plain=op.plain,
                             cost=op.cost)
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events], result


def lut_edges(n_table: int) -> list:
    """The inputs where lut_sigmoid's index arithmetic turns: 0, +-1, the
    table's last entry and the first past it, and the int32 extremes
    (|INT32_MIN| wraps)."""
    return [0, 1, -1, n_table - 1, -(n_table - 1), n_table, -n_table,
            INT32_MAX, INT32_MIN, INT32_MIN + 1]


def check_lut_sigmoid(torch, rng, lut, z) -> tuple[int, int]:
    """lut_sigmoid against its plain version in both placements: on the
    main shape ``z`` (which holds the edge values); then on inputs 4, 8
    and 12 bytes past a 16-byte boundary whose lengths are 1, 2 and 3
    past a multiple of 4, with each edge value in turn in the scalar
    head, the first vector and the scalar tail, under the paper's table
    and an odd one of LUT_ODD entries.  Returns the max abs error and
    the number of those cases."""
    from repro_torch.core.lut import SigmoidLut
    from repro_torch.kernels.lut_activation import (lut_sigmoid_cuda,
                                                    lut_sigmoid_plain)
    odd = SigmoidLut(lut.table[:LUT_ODD].clone(), lut.frac_bits,
                     lut.boundary, lut.value_frac)
    base = torch.from_numpy(rng.randint(-30000, 30000, LUT_RAGGED + 16)
                            .astype(np.int32)).to(z.device)
    cases = [(lut, z)]
    for table in (lut, odd):
        for off in (1, 2, 3):
            for rem in (1, 2, 3):
                n = LUT_RAGGED + rem
                head = (4 - off) % 4
                tail = (n - head) % 4
                for e in lut_edges(table.table.numel()):
                    xs = base.clone()[off:off + n]
                    xs[:head + 4] = e
                    if tail:
                        xs[n - tail:] = e
                    cases.append((table, xs))
    err = 0
    for table, xs in cases:
        for placement in ("wram", "mram"):
            out = lut_sigmoid_cuda(xs, table, placement)
            ref = lut_sigmoid_plain(xs, table)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                fail(f"lut_sigmoid[{placement}] kernel != plain at "
                     f"{xs.numel()} elements, {xs.data_ptr() % 16} B past "
                     f"an alignment, a table of {table.table.numel()}")
            err = max(err, int((out.long() - ref.long()).abs().max()))
    return err, len(cases) - 1


def log_fit_z(dispatch, make_estimator, ds) -> dict:
    """The z that a LOG int32_lut_wram fit of ITERS iterations over ``ds``
    hands ``lut_sigmoid`` at its first iteration (w = 0 there, so z = 0
    everywhere) and at its last, copied on the card."""
    op = dispatch.get_op("lut_sigmoid")
    seen = []

    def capture(z, *args, **kwargs):
        seen.append(z.clone())
        return op.cuda(z, *args, **kwargs)
    dispatch.register_op("lut_sigmoid", cuda=capture, plain=op.plain,
                         cost=op.cost)
    try:
        make_estimator("logreg", version="int32_lut_wram", n_iters=ITERS,
                       system=ds.system).fit(ds)
    finally:
        dispatch.register_op("lut_sigmoid", cuda=op.cuda, plain=op.plain,
                             cost=op.cost)
    return {"first": seen[0], "last": seen[-1]}


def device_profile(torch, fn, top: int = 6, host: bool = True) -> str:
    """Run ``fn`` under torch.profiler: the device's busy share of the
    wall time ``fn`` took inside the profiler (its start-up and the trace's
    processing at exit excluded) and the kernels with the most device
    time.  ``host=False`` traces the device only, which leaves the
    host's timings of ``fn`` nearly as they are."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), reverse=True)
    busy_ms = sum(t for t, _, _ in kernels)
    if not kernels:
        return f"{wall_ms:.1f} ms wall, no device time traced"
    return (f"{wall_ms:.1f} ms wall under the profiler, device busy "
            f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%); top: "
            + "; ".join(f"{t:.1f} ms x{n} {k[:60]}"
                        for t, k, n in kernels[:top]))


# -- the LM serving path (qwen3-8b) -------------------------------------------

def lm_requests(vocab: int) -> list:
    """The serve load: LM_REQUESTS prompts whose lengths and tokens are
    drawn by SEED, LM_NEW tokens each."""
    rng = np.random.RandomState(SEED)
    lens = rng.randint(LM_PROMPT_MIN, LM_PROMPT_MAX + 1, LM_REQUESTS)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lens]


def check_lm_kernels(torch, dev, gen, prompt_lens) -> tuple[int, float]:
    """int_matmul (exact on full-range int8, -128 included) at the MLP
    shapes of qwen3-8b for M = 1, 7, 16 and 17 (the streaming and
    tensor-core paths' boundary), 513 and the shortest and longest
    prompts, plus ragged and unaligned shapes on both paths;
    flash_attention (within MHA_BF16_ATOL / MHA_F32_ATOL of its plain
    version) on bf16 [1, 32, S, 128] over 16 KV heads for every prompt
    length S, causal and not, one-token decode with q_offset, a window,
    D = 64 and 80, GQA groups 1 and 4, and float32.  Returns the max abs
    errors."""
    from repro_torch.kernels.flash_attention import mha_cuda, mha_plain
    from repro_torch.kernels.quant_matmul import (int_matmul_cuda,
                                                  int_matmul_plain,
                                                  int_matmul_plan)

    def int8(shape):
        t = torch.randint(-128, 128, shape, generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int8)
        t.view(-1)[:3] = -128
        return t
    err_mm = 0
    shapes = [(m, k, n) for m in (1, 7, 16, 17, 513, min(prompt_lens),
                                  max(prompt_lens))
              for k, n in LM_MLP_SHAPES] + [(33, 4099, 1000), (17, 61, 13),
                                            (5, 4099, 70)]
    for m, k, n in shapes:
        a, b = int8((m, k)), int8((k, n))
        err_mm = max(err_mm, same(torch, [int_matmul_cuda(a, b)],
                                  [int_matmul_plain(a, b)]))
    say(f"kernels: int_matmul == plain at (M, K, N) {shapes}")
    for m in (7, 40):                 # 1 byte past alignment: both paths
        flat = int8((1 + m * 64 + 64 * 36,))
        a, b = flat[1:1 + m * 64].view(m, 64), flat[1 + m * 64:].view(64, 36)
        err_mm = max(err_mm, same(torch, [int_matmul_cuda(a, b)],
                                  [int_matmul_plain(a, b)]))
        say(f"kernels: int_matmul == plain, unaligned ({m}, 64) @ (64, 36)"
            f" on the {int_matmul_plan(m, 36, 64).path} path")

    def qkv(b, hq, hkv, sq, skv, d, dtype):
        # [B, S, H, D] projections seen as [B, H, S, D], as _project_qkv does
        return [torch.randn((b, s, h, d), generator=gen, device=dev)
                .to(dtype).transpose(1, 2)
                for s, h in ((sq, hq), (skv, hkv), (skv, hkv))]
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(f"bf16 [1, 32, {s}, 128] over 16 KV heads, causal",
              qkv(1, 32, 16, s, s, 128, bf16), {}) for s in prompt_lens]
    s = int(prompt_lens[0])
    cases += [
        (f"bf16 [1, 32, {s}, 128], not causal",
         qkv(1, 32, 16, s, s, 128, bf16), {"causal": False}),
        (f"bf16 decode: 1 query at q_offset {s - 1} of {s} keys",
         qkv(1, 32, 16, 1, s, 128, bf16), {"q_offset": s - 1}),
        (f"bf16 [1, 32, {s}, 128], window 256",
         qkv(1, 32, 16, s, s, 128, bf16), {"window": 256}),
        ("bf16 [2, 8, 77, 64] over 2 KV heads (group 4), causal",
         qkv(2, 8, 2, 77, 77, 64, bf16), {}),
        ("bf16 [1, 8, 300, 80] over 8 KV heads (group 1), window 100",
         qkv(1, 8, 8, 300, 300, 80, bf16), {"window": 100}),
        ("f32 [2, 8, 300, 64] over 2 KV heads, causal",
         qkv(2, 8, 2, 300, 300, 64, f32), {}),
        ("f32 [1, 4, 5, 80], q_offset 255 of 260 keys, window 64",
         qkv(1, 4, 4, 5, 260, 80, f32), {"q_offset": 255, "window": 64}),
    ]
    err_fa = 0.0
    for name, (q, k, v), kw in cases:
        out, ref = mha_cuda(q, k, v, **kw), mha_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        if out.dtype != ref.dtype or out.shape != ref.shape:
            fail(f"flash_attention: {name}: dtype or shape differs")
        e = float((out.float() - ref.float()).abs().max())
        tol = MHA_BF16_ATOL if q.dtype == bf16 else MHA_F32_ATOL
        if not e <= tol:
            fail(f"flash_attention: {name}: max abs err {e} > {tol}")
        err_fa = max(err_fa, e)
        say(f"kernels: flash_attention ~ plain, {name} (max abs err {e:.3g}"
            f" <= {tol})")
    return err_mm, err_fa


class TimedModel:
    """A Model as the ServeEngine sees it, timing each synchronised
    prefill and decode call (host clock) and when each prefill ended."""

    def __init__(self, torch, model):
        self.torch, self.model, self.cfg = torch, model, model.cfg
        self.prefill_s, self.decode_s, self.prefill_end = [], [], []

    def prefill(self, params, batch, max_seq):
        t0 = time.perf_counter()
        out = self.model.prefill(params, batch, max_seq)
        self.torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.prefill_s.append(t1 - t0)
        self.prefill_end.append(t1)
        return out

    def decode_step(self, params, tokens, cache, extras=None):
        t0 = time.perf_counter()
        out = self.model.decode_step(params, tokens, cache)
        self.torch.cuda.synchronize()
        self.decode_s.append(time.perf_counter() - t0)
        return out


def serve_timed(torch, Model, Request, ServeEngine, cfg, params,
                prompts) -> dict:
    """Serve ``prompts`` through ServeEngine on the card: the outputs and
    time to first token, ms per decode call and tokens/s."""
    timed = TimedModel(torch, Model(cfg, device="cuda"))
    reqs = [Request(prompt=p, max_new_tokens=LM_NEW) for p in prompts]
    engine = ServeEngine(timed, params, n_slots=LM_SLOTS, max_seq=LM_MAX_SEQ)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run(reqs)
    wall = time.perf_counter() - t0
    n_tok = sum(len(r.output) for r in reqs)
    return {"outputs": [r.output for r in reqs], "wall_s": wall,
            "tokens": n_tok, "tokens_per_s": n_tok / wall,
            "ttft_ms": [(t - t0) * 1e3 for t in timed.prefill_end],
            "prefill_ms": [t * 1e3 for t in timed.prefill_s],
            "decode_ms": statistics.median(timed.decode_s) * 1e3,
            "decode_calls": len(timed.decode_s)}


def serve_line(name: str, r: dict, prompts, smi: str) -> str:
    return (f"serve: {name}: {len(prompts)} requests over {LM_SLOTS} slots, "
            f"prompts {[len(p) for p in prompts]}, {LM_NEW} new tokens each:"
            f" {r['tokens']} tokens in {r['wall_s']:.2f} s, "
            f"{r['tokens_per_s']:.2f} tokens/s; time to first token "
            f"{', '.join(f'{t:.0f}' for t in r['ttft_ms'])} ms (prefill "
            f"alone {', '.join(f'{t:.0f}' for t in r['prefill_ms'])} ms); "
            f"{r['decode_ms']:.2f} ms per decode token (median of "
            f"{r['decode_calls']} batch-1 decode calls) on {smi}")


def lm_serve_on_card(torch, dispatch, smi: str) -> dict:
    """qwen3-8b at full width and depth in bf16 with quantize_dense on,
    random weights from SEED, served through Model and ServeEngine with
    the launch counts zeroed just before and checked exactly after; then
    the same load with quantize_dense off (no int_matmul launches); the
    card's busy share over decode steps; and prefill + one decode step
    against the forward's last position (quantize_dense off, the repo's
    own property, tests/test_arch_smoke.py)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import Model
    from repro_torch.models.transformer import attn_spec
    from repro_torch.serve.engine import Request, ServeEngine
    base = get_config(LM_ARCH)
    cfg_q = dataclasses.replace(base, quantize_dense=True)
    t0 = time.perf_counter()
    model = Model(cfg_q, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = Model.param_count(params)
    plan = attn_spec(cfg_q).plan
    say(f"model: {LM_ARCH} at full width: {cfg_q.n_layers} layers, d_model "
        f"{cfg_q.d_model}, {cfg_q.n_heads} query / {cfg_q.n_kv_heads} KV "
        f"heads (padded to {plan.n_q} / {plan.n_kv}), d_ff {cfg_q.d_ff}, vocab "
        f"{cfg_q.vocab_size}, {cfg_q.dtype}, {n_params:,} parameters drawn "
        f"in {time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB")
    prompts = lm_requests(cfg_q.vocab_size)
    calls = LM_REQUESTS + LM_REQUESTS * (LM_NEW - 1)
    expected = {"int_matmul": 3 * cfg_q.n_layers * calls,
                "mha": cfg_q.n_layers * LM_REQUESTS}
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    on = serve_timed(torch, Model, Request, ServeEngine, cfg_q, params,
                     prompts)
    torch.cuda.synchronize()
    counts = dict(dispatch.launch_counts)
    say(f"launch counts on the main path (quantize_dense on): {counts} "
        f"(expected {expected}: 3 per layer per forward call over "
        f"{LM_REQUESTS} prefills + {calls - LM_REQUESTS} decode calls, 1 "
        f"per layer per prefill)")
    if counts != expected:
        fail(f"qwen3-8b serve launch counts {counts} != {expected}")
    if any(len(o) != LM_NEW or not all(0 <= t < cfg_q.vocab_size for t in o)
           for o in on["outputs"]):
        fail("qwen3-8b serve: an output has the wrong length or an id "
             "outside the vocabulary")
    say(serve_line("qwen3-8b quantize_dense on", on, prompts, smi)
        + f"; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")

    cfg_f = dataclasses.replace(base, quantize_dense=False)
    dispatch.reset_launch_counts()
    off = serve_timed(torch, Model, Request, ServeEngine, cfg_f, params,
                      prompts)
    torch.cuda.synchronize()
    if dict(dispatch.launch_counts) != {"mha": expected["mha"]}:
        fail(f"quantize_dense off: launch counts {dispatch.launch_counts}")
    say(serve_line("qwen3-8b quantize_dense off (same weights)", off,
                   prompts, smi))
    agree = sum(a == b for x, y in zip(on["outputs"], off["outputs"])
                for a, b in zip(x, y))
    say(f"  greedy tokens equal with quantize_dense on and off: {agree} of "
        f"{on['tokens']}")

    # the card's busy share over decode steps, quantize_dense on and off
    profiles = {}
    for name, cfg in (("on", cfg_q), ("off", cfg_f)):
        m = Model(cfg, device="cuda")
        _, cache = m.prefill(params, {"tokens": prompts[0][None]},
                             LM_MAX_SEQ)
        tok = np.zeros((1, 1), np.int32)
        profiles[name] = device_profile(torch, lambda: [
            m.decode_step(params, tok, cache) for _ in range(LM_PROFILE_STEPS)])
        say(f"profile: {LM_PROFILE_STEPS} decode steps, quantize_dense "
            f"{name}: {profiles[name]}")

    # prefill + one decode step == the forward's last position (the repo's
    # property, tests/test_arch_smoke.py), in bf16 and then, the same
    # weights cast exactly to float32, at the repo's float32 tolerance
    toks = prompts[0][None]
    for cfg, (atol, rtol) in ((cfg_f, (LM_BF16_TOL, 0.0)),
                              (dataclasses.replace(cfg_f, dtype="float32"),
                               (LM_F32_PROPERTY_TOL, LM_F32_PROPERTY_TOL))):
        if cfg.dtype == "float32":
            params.float()                    # in place: frees the bf16
        m = Model(cfg, device="cuda")
        _, cache = m.prefill(params, {"tokens": toks[:, :-1]}, LM_MAX_SEQ)
        dec, _ = m.decode_step(params, toks[:, -1:], cache)
        full = m.forward(params, {"tokens": toks})[:, -1]
        dec, full = dec[:, 0].float(), full.float()
        if not bool(torch.isfinite(full).all()):
            fail(f"qwen3-8b forward ({cfg.dtype}): non-finite logits")
        diff = (dec - full).abs()
        ok = bool((diff <= atol + rtol * full.abs()).all())
        say(f"  prefill({toks.shape[1] - 1}) + decode == forward's last "
            f"position at full width, {cfg.dtype}: {ok} (max |dlogit| "
            f"{float(diff.max()):.4g}, RMS logit "
            f"{float(full.square().mean().sqrt()):.4g}, max |logit| "
            f"{float(full.abs().max()):.4g}; atol {atol}, rtol {rtol}; argmax "
            f"{int(dec.argmax())} vs {int(full.argmax())})")
        if not ok:
            fail(f"qwen3-8b {cfg.dtype}: prefill + decode disagrees with "
                 f"the forward")
    del params, cache, full, dec
    torch.cuda.empty_cache()
    return {"on": on, "off": off, "counts": counts, "profiles": profiles,
            "prompts": prompts}


def lm_card_equals_cpu(torch) -> None:
    """qwen3-8b reduced, float32, the same weights on the card and the CPU:
    with quantize_dense off the greedy tokens are identical and the
    forward logits within LM_F32_ATOL; with it on the logits are within
    LM_QUANT_ATOL (one int8 rounding step, tests/test_torch_lm.py) and the
    token agreement is printed."""
    import copy
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import Model
    from repro_torch.serve.engine import Request, ServeEngine
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, 512, n).astype(np.int32) for n in (40, 9, 77,
                                                                 23)]
    toks = rng.randint(0, 512, (2, 48)).astype(np.int32)
    for quantize in (False, True):
        cfg = get_config(LM_ARCH).reduced(quantize_dense=quantize)
        weights = Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(SEED))
        res = {}
        for device in ("cuda", "cpu"):
            model = Model(cfg, device=device)
            params = copy.deepcopy(weights).to(device)
            reqs = [Request(prompt=p, max_new_tokens=12) for p in prompts]
            ServeEngine(model, params, n_slots=2, max_seq=128).run(reqs)
            logits = model.forward(params, {"tokens": toks}).cpu()
            res[device] = ([r.output for r in reqs], logits)
        (tg, lg), (tc, lc) = res["cuda"], res["cpu"]
        err = float((lg - lc).abs().max())
        agree = sum(a == b for x, y in zip(tg, tc) for a, b in zip(x, y))
        tol = LM_QUANT_ATOL if quantize else LM_F32_ATOL
        say(f"  {LM_ARCH} reduced f32, quantize_dense "
            f"{'on' if quantize else 'off'}: card vs CPU forward max "
            f"|dlogit| {err:.3g} (tolerance {tol}); greedy tokens equal "
            f"{agree} of {sum(len(t) for t in tg)}")
        if not err <= tol:
            fail(f"reduced {LM_ARCH}: card and CPU logits disagree")
        if not quantize and tg != tc:
            fail(f"reduced {LM_ARCH}: card and CPU greedy tokens differ")


def lm_kernel_times(torch, flush, prompt_lens) -> dict:
    """int_matmul at decode (M = 1) and at the shortest and longest
    prefills, both MLP shapes, and flash_attention at the longest prefill:
    kernel, plain, bound and the nearest PyTorch call (torch._int_mm where
    its shape rules allow; F.scaled_dot_product_attention with
    enable_gqa), with the achieved rate (TOP/s or TFLOP/s, the bound's
    operations over the kernel's time), its share of the bound, and the
    host's microseconds per wrapper call."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import mha_cuda, mha_plain
    from repro_torch.kernels.quant_matmul import (int_matmul_cuda,
                                                  int_matmul_plain)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for m in (1, min(prompt_lens), max(prompt_lens)):
        for k, n in LM_MLP_SHAPES:
            a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                              dtype=torch.int32).to(torch.int8)
            b = torch.randint(-128, 128, (k, n), generator=gen, device="cuda",
                              dtype=torch.int32).to(torch.int8)
            t = dict(ms=cuda_ms(torch, lambda: int_matmul_cuda(a, b), flush),
                     plain_ms=cuda_ms(torch, lambda: int_matmul_plain(a, b),
                                      flush))
            t["bound_ms"], t["bound_by"] = bound(
                m * k + k * n + 4 * m * n, 2 * m * k * n, PEAK_INT8_OPS_PER_S)
            # torch._int_mm: M > 16, K and N multiples of 8
            t["library_ms"] = (cuda_ms(torch, lambda: torch._int_mm(a, b),
                                       flush)
                               if m > 16 and k % 8 == 0 and n % 8 == 0
                               else None)
            t["tops"] = 2 * m * k * n / t["ms"] / 1e9
            t["bound_share"] = t["bound_ms"] / t["ms"]
            t["host_us"] = host_us(torch, lambda: int_matmul_cuda(a, b))
            out["int_matmul", m, k, n] = t
    s = max(prompt_lens)
    q, k, v = [torch.randn((1, s, h, 128), generator=gen, device="cuda")
               .to(torch.bfloat16).transpose(1, 2) for h in (32, 16, 16)]
    pairs = s * (s + 1) // 2 * 32                 # unmasked (query, key)
    t = dict(ms=cuda_ms(torch, lambda: mha_cuda(q, k, v), flush),
             plain_ms=cuda_ms(torch, lambda: mha_plain(q, k, v), flush),
             library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                 q, k, v, is_causal=True, enable_gqa=True), flush))
    t["bound_ms"], t["bound_by"] = bound(
        2 * (q.numel() * 2 + k.numel() * 2), 4 * 128 * pairs,
        PEAK_BF16_FLOPS)
    t["tflops"] = 4 * 128 * pairs / t["ms"] / 1e9
    t["bound_share"] = t["bound_ms"] / t["ms"]
    t["host_us"] = host_us(torch, lambda: mha_cuda(q, k, v))
    out["flash_attention",] = t
    return out


#: the compare's kernels: those its pim rows run (LIN/LOG int32, KME
#: int16, DTR, EMB int32), DTR's and EMB's also in the host and gpu-model
#: rows
COMPARE_KERNELS = ("fx_matvec", "lut_sigmoid", "kmeans_assign", "gini_split",
                   "emb_gather", "emb_scatter_add")


def compare_on_card(torch, dispatch, smi: str) -> dict:
    """Phase 7: the three-way compare at its CLI defaults on the card,
    then the tiny compare on the card against the CPU.  Returns the
    launch counts of the full run."""
    from repro_torch.launch.compare import render_compare_table, run_compare
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    record = run_compare(tiny=False, cores=16, device="cuda")
    torch.cuda.synchronize()
    counts = dict(dispatch.launch_counts)
    say(f"compare: the full run in {time.perf_counter() - t0:.1f} s; "
        f"launch counts {counts}")
    say(render_compare_table(record))
    rows = {(r["workload"], r["system"]): r for r in record["rows"]}
    if len(rows) != 15 or record["meta"]["gpu"] != smi:
        fail(f"compare: {len(rows)} rows on {record['meta']['gpu']}")
    for (workload, kind), row in rows.items():
        if not row["modeled_s"] > 0:
            fail(f"compare {workload} {kind}: modeled_s {row['modeled_s']}")
        if kind == "host" and row["score"] != rows[workload,
                                                  "gpu-model"]["score"]:
            fail(f"compare {workload}: host score {row['score']} != "
                 f"gpu-model {rows[workload, 'gpu-model']['score']}")
    missing = [k for k in COMPARE_KERNELS if not counts.get(k)]
    if missing:
        fail(f"compare: kernels not launched: {missing}")
    say("compare rows: " + json.dumps([
        {k: r.get(k) for k in ("workload", "system", "version", "wall_s",
                               "modeled_s", "drift_ratio", "score",
                               "kernel_launches", "iterations",
                               "modeled_kernel_s", "modeled_transfer_s",
                               "modeled_flops", "modeled_hbm_bytes")}
        for r in record["rows"]]))
    t0 = time.perf_counter()
    tiny = {dev: {(r["workload"], r["system"]): r for r in run_compare(
        tiny=True, cores=4, device=dev)["rows"]} for dev in ("cuda", "cpu")}
    fields = {"pim": ("iterations", "cpu_to_pim_bytes", "pim_to_cpu_bytes",
                      "modeled_s", "modeled_kernel_s", "modeled_transfer_s"),
              "gpu-model": ("modeled_launches", "modeled_flops",
                            "modeled_hbm_bytes")}
    for key, row in tiny["cuda"].items():
        other = tiny["cpu"][key]
        check = list(fields.get(key[1], ()))
        if key[1] == "pim" and key[0] != "dtree":      # the integer rows
            check.append("score")
        for field in check:
            if row[field] != other[field]:
                fail(f"tiny compare {key} {field}: card {row[field]} != "
                     f"cpu {other[field]}")
    say(f"compare: tiny (4 cores) card == cpu in "
        f"{time.perf_counter() - t0:.1f} s: integer pim scores, iterations, "
        f"transfer bytes and modeled seconds; gpu-model launches, flops "
        f"and bytes (" + ", ".join(
            f"{w} {tiny['cuda'][w, 'gpu-model']['modeled_launches']} / "
            f"{tiny['cuda'][w, 'gpu-model']['modeled_flops']:.6g} / "
            f"{tiny['cuda'][w, 'gpu-model']['modeled_hbm_bytes']:.6g}"
            for w in ("linreg", "logreg", "dtree", "kmeans", "emb")) + ")")
    return counts


def lane_kernel_on_card(torch, dispatch, rng, flush, smi: str) -> dict:
    """Phase 8a: fx_matvec with lanes against its plain version at the
    gang's shape for every LANE_KS and on full-range wrapping operands
    over F = 13 (the scalar path); K = 1 and K = 8 timed beside their
    declared bounds.  Returns the lane entries of the kernel table."""
    from repro_torch.kernels.quant_matmul import (fx_matvec_cuda,
                                                  fx_matvec_plain)

    def ints(shape, lo, hi):
        return torch.from_numpy(rng.randint(lo, hi, shape, dtype=np.int64)
                                .astype(np.int32)).to("cuda")
    n_pc = N_SAMPLES // N_CORES
    x = ints((N_CORES, n_pc, N_FEATURES), -(16 << 10), 16 << 10)
    wide = ints((1_000_003, 13), INT32_MIN, INT32_MAX)
    err = 0
    for k in LANE_KS:
        for xs, ws in ((x, ints((k, N_FEATURES), -(4 << 10), 4 << 10)),
                       (wide, ints((k, 13), INT32_MIN, INT32_MAX))):
            out = fx_matvec_cuda(xs, ws, 10)
            ref = fx_matvec_plain(xs, ws, 10)
            err = max(err, same(torch, [out], [ref]))
            del out, ref
    say(f"lanes: fx_matvec == plain for K in {LANE_KS} at "
        f"{tuple(x.shape)} and on full-range operands at "
        f"{tuple(wide.shape)} (max abs err {err})")
    out = {"lanes_max_abs_err": err}
    for k in (1, 8):
        w = ints((k, N_FEATURES), -(4 << 10), 4 << 10)
        t = dict(ms=cuda_ms(torch, lambda: fx_matvec_cuda(x, w, 10), flush),
                 plain_ms=cuda_ms(torch, lambda: fx_matvec_plain(x, w, 10),
                                  flush))
        t["bound_ms"], t["bound_by"] = declared_bound("fx_matvec", x, w, 10)
        cost = dispatch.declared_cost("fx_matvec", x, w, 10)
        say(f"timing: fx_matvec K={k} lanes at {tuple(x.shape)} "
            f"{t['ms']:.4f} ms ({100 * t['bound_ms'] / t['ms']:.1f}% of "
            f"the bound), plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {cost.bytes:.4g} B, "
            f"{cost.ops:.4g} int32 ops) on {smi}")
        out[f"k{k}"] = t
    return out


def run_gang(torch, gang, per_step: bool = False) -> list:
    """Step ``gang`` to its end; the wall seconds of each step (each
    ending in a synchronize when ``per_step``, else one for the run)."""
    times, t0 = [], time.perf_counter()
    while not gang.done:
        gang.step()
        if per_step:
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
    torch.cuda.synchronize()
    return times or [time.perf_counter() - t0]


def gang_on_card(torch, dispatch, make_estimator, get_workload, system,
                 lin_ds, log_ds, smi: str) -> dict:
    """Phase 8b, e and f: the 8-point LIN int32 sweep through
    FusedGdSweep (each lane bit-identical to a serial card fit; 10 map_*
    launches and 10 fx_matvec launches against 80 for the serial fits);
    the 4-point LOG int32_lut_wram sweep with lane 1 cancelled after
    GANG_CANCEL_AT iterations; the LIN sweep at fuse_steps GANG_FUSE (two
    chunk replays, equal to the unchunked gang); the LIN gang traced
    (a valid Chrome trace, one map_reduce span a step); the per-step
    seconds through StragglerMonitor."""
    import tempfile

    from repro_torch.obs import (TRACER, summarize, validate_chrome_trace,
                                 write_chrome_trace)
    from repro_torch.sched import FusedGdSweep
    from repro_torch.train.fault_tolerance import StragglerMonitor
    lin, log = get_workload("linreg"), get_workload("logreg")

    def gang(wl, version, lrs, ds, **params):
        return FusedGdSweep(wl, [wl.spec(version, lr=lr, n_iters=ITERS,
                                         **params) for lr in lrs], ds)

    def serial(workload, version, lrs, ds, n_iters=ITERS):
        return [make_estimator(workload, version=version, lr=lr,
                               n_iters=n_iters, system=system).fit(ds)
                for lr in lrs]

    run_gang(torch, gang(lin, "int32", GANG_LIN_LRS, lin_ds))   # warm-up
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    dispatch.reset_launch_counts()
    snap = system.stats.snapshot()
    g = gang(lin, "int32", GANG_LIN_LRS, lin_ds)
    dt = sum(run_gang(torch, g))
    counts = dict(dispatch.launch_counts)
    launches = system.stats.delta(snap).kernel_launches
    peak = torch.cuda.max_memory_allocated() - base
    dispatch.reset_launch_counts()
    dt_serial, fits = timed(torch, lambda: serial("linreg", "int32",
                                                  GANG_LIN_LRS, lin_ds))
    serial_counts = dict(dispatch.launch_counts)
    k = len(GANG_LIN_LRS)
    say(f"gang: LIN int32 {k} lanes {dt / ITERS * 1e3:.3f} ms/iteration, "
        f"the {k} serial fits {dt_serial / ITERS * 1e3:.3f} ms per "
        f"iteration of all {k} ({dt_serial / dt:.2f}x); launch counts "
        f"{counts} ({launches} map_* calls) against {serial_counts}; peak "
        f"{peak / 2 ** 30:.2f} GiB above the resident data "
        f"(torch.cuda.max_memory_allocated) at {N_SAMPLES}x{N_FEATURES} "
        f"over {N_CORES} cores on {smi}")
    if counts != {"fx_matvec": ITERS} or launches != ITERS \
            or serial_counts != {"fx_matvec": k * ITERS}:
        fail(f"gang: launch counts {counts}, {launches} launches, serial "
             f"{serial_counts}")
    for lane, est in enumerate(fits):
        r = g.result(lane).model
        if not (np.array_equal(r.w, est.coef_) and r.b == est.intercept_):
            fail(f"gang: LIN lane {lane} differs from its serial card fit")
    say(f"gang: every LIN lane == its serial card fit (lr {GANG_LIN_LRS})")

    dispatch.reset_launch_counts()
    lg = gang(log, "int32_lut_wram", GANG_LOG_LRS, log_ds)
    while not lg.done:
        lg.step()
        if lg.it == GANG_CANCEL_AT:
            lg.deactivate(1)
    torch.cuda.synchronize()
    log_counts = dict(dispatch.launch_counts)
    if log_counts != {"fx_matvec": ITERS, "lut_sigmoid": ITERS}:
        fail(f"gang: LOG launch counts {log_counts}")
    frozen = serial("logreg", "int32_lut_wram", [GANG_LOG_LRS[1]], log_ds,
                    n_iters=GANG_CANCEL_AT)[0]
    if lg.result(1) is not None or not np.array_equal(
            lg.lane_state(1)["arrays"]["w"], frozen.coef_):
        fail("gang: the cancelled LOG lane did not freeze")
    for lane, est in zip((0, 2, 3), serial(
            "logreg", "int32_lut_wram",
            [GANG_LOG_LRS[i] for i in (0, 2, 3)], log_ds)):
        r = lg.result(lane).model
        if not (np.array_equal(r.w, est.coef_) and r.b == est.intercept_):
            fail(f"gang: LOG lane {lane} differs from its serial card fit")
    say(f"gang: LOG int32_lut_wram {len(GANG_LOG_LRS)} lanes, lane 1 "
        f"cancelled after iteration {GANG_CANCEL_AT}: frozen there, lanes "
        f"0, 2, 3 == their serial card fits; launch counts {log_counts}")

    dispatch.reset_launch_counts()
    syncs = system.stats.host_syncs
    fg = gang(lin, "int32", GANG_LIN_LRS, lin_ds, fuse_steps=GANG_FUSE)
    dt_fused = sum(run_gang(torch, fg))
    fused_counts = dict(dispatch.launch_counts)
    replays = sum(dispatch.graph_replays.values())
    chunks = system.stats.host_syncs - syncs
    if fused_counts != counts or replays != chunks or chunks != -(
            -ITERS // GANG_FUSE):
        fail(f"gang fused: launch counts {fused_counts}, {replays} "
             f"replays, {chunks} chunks")
    for lane in range(k):
        a, b = fg.result(lane).model, g.result(lane).model
        if not (np.array_equal(a.w, b.w) and a.b == b.b):
            fail(f"gang fused: lane {lane} differs from the unchunked gang")
    say(f"gang: LIN at fuse_steps {GANG_FUSE}: {replays} chunk replays, "
        f"every lane == the unchunked gang; {dt_fused / ITERS * 1e3:.3f} "
        f"ms/iteration with its capture")

    # untraced and traced gangs in turns (off, on, on, off, ...); the
    # last traced gang's events are the trace
    per_it = {False: [], True: []}
    for traced in TRACE_TURNS:
        TRACER.clear()
        if traced:
            TRACER.enable()
        try:
            tg = gang(lin, "int32", GANG_LIN_LRS, lin_ds)
            per_it[traced].append(sum(run_gang(torch, tg)) / ITERS * 1e3)
            if traced:
                events = TRACER.events()
        finally:
            TRACER.disable()
            TRACER.clear()
    with tempfile.TemporaryDirectory() as tmp:
        doc = write_chrome_trace(events, str(Path(tmp) / "gang.json"))
    validate_chrome_trace(doc)
    name = f"map_reduce:{tg.kernel}"
    spans = sum(1 for e in events if e["name"] == name)
    if spans != ITERS:
        fail(f"trace: {spans} {name!r} spans for {ITERS} gang steps")
    say(f"trace: the LIN gang traced, a valid Chrome trace of "
        f"{len(events)} events; per track " + json.dumps(summarize(doc))
        + f"; {spans} {name!r} spans (one a step; a span times the "
        f"enqueue); ms/iteration in turns, traced "
        f"{' '.join(f'{t:.3f}' for t in per_it[True])}, untraced "
        f"{' '.join(f'{t:.3f}' for t in per_it[False])}")

    steps = run_gang(torch, gang(lin, "int32", GANG_LIN_LRS, lin_ds),
                     per_step=True)
    monitor = StragglerMonitor()
    flags = [monitor.observe(t) for t in steps]
    say(f"straggler: {monitor.flagged} of {len(steps)} gang steps flagged "
        f"(steps {' '.join(f'{t * 1e3:.2f}' for t in steps)} ms, each "
        f"ending in a synchronize; flags {flags})")
    return {"gang_ms_per_iteration": dt / ITERS * 1e3,
            "serial_ms_per_iteration": dt_serial / ITERS * 1e3,
            "gang_traced_ms_per_iteration": per_it[True],
            "gang_untraced_ms_per_iteration": per_it[False],
            "gang_launches": counts["fx_matvec"],
            "serial_launches": serial_counts["fx_matvec"],
            "gang_peak_bytes": peak}


def slices_on_card(torch, make_system, make_estimator, X, y, Xc, yc,
                   smi: str) -> None:
    """Phase 8c: two SLICE_CORES-core slices of an N_CORES-core machine
    leased through BankAllocator; LIN int32 on one, LOG int32_lut_wram on
    the other, each bit-identical to its fit on a standalone
    SLICE_CORES-core system; the parent's TransferStats the sum of the
    slices' deltas."""
    import dataclasses as dc

    from repro_torch.sched import BankAllocator
    parent = make_system("pim", n_cores=N_CORES, device="cuda")
    alloc = BankAllocator(N_CORES, rank_size=SLICE_RANK)
    leases = [alloc.allocate(SLICE_CORES) for _ in range(2)]
    deltas = []
    for lease, (workload, version, Xw, yw) in zip(leases, (
            ("linreg", "int32", X, y), ("logreg", "int32_lut_wram", Xc,
                                        yc))):
        sl = parent.slice(lease)
        snap = sl.stats.snapshot()
        t, got = timed(torch, lambda: make_estimator(
            workload, version=version, n_iters=ITERS, system=sl).fit(
                sl.put(Xw, yw)))
        deltas.append(sl.stats.delta(snap))
        alone = make_system("pim", n_cores=SLICE_CORES, device="cuda")
        want = make_estimator(workload, version=version, n_iters=ITERS,
                              system=alone).fit(alone.put(Xw, yw))
        if not (np.array_equal(got.coef_, want.coef_)
                and got.intercept_ == want.intercept_
                and sl.stats.snapshot() == alone.stats.snapshot()):
            fail(f"slices: {workload} {version} on cores [{lease.start}, "
                 f"{lease.stop}) differs from a standalone system")
        say(f"slices: {workload} {version} on cores [{lease.start}, "
            f"{lease.stop}) (ranks {lease.ranks[0]}-{lease.ranks[-1]}) == "
            f"a standalone {SLICE_CORES}-core system, weights and "
            f"TransferStats; {t:.2f} s with the put")
    for f in dc.fields(parent.stats):
        if getattr(parent.stats, f.name) != sum(getattr(d, f.name)
                                                 for d in deltas):
            fail(f"slices: parent {f.name} is not the slices' sum")
    say(f"slices: the parent's TransferStats == the sum of the slices' "
        f"deltas: {parent.stats}")
    say(f"slices: occupied {alloc.fragmentation()}")
    for lease in leases:
        alloc.release(lease)
    say(f"slices: released {alloc.fragmentation()} on {smi}")


def elastic_on_card(torch, dispatch, get_workload, system, lin_ds, kme_ds,
                    lin_ref, kme_ref, smi: str) -> None:
    """Phase 8d: LIN int32 snapshotted at iteration SNAPSHOT_LIN_AT and
    KME int16 after SNAPSHOT_KME_AT iterations (its MT19937 state in the
    snapshot) through elastic.save_snapshot, resumed through
    fit_steps(state=load_snapshot(...)[0]): each bit-identical to its
    uninterrupted phase-4 fit."""
    import tempfile

    from repro_torch.elastic import load_snapshot, save_snapshot
    cases = (("linreg", lin_ds, SNAPSHOT_LIN_AT,
              get_workload("linreg").spec("int32", n_iters=ITERS)),
             ("kmeans", kme_ds, SNAPSHOT_KME_AT,
              get_workload("kmeans").spec(
                  "int16", n_clusters=KME_K, n_init=1, max_iter=ITERS,
                  tol=0.0)))
    for workload, ds, at, spec in cases:
        wl = get_workload(workload)
        gen = wl.fit_steps(ds, spec)
        for _ in range(at):
            tick = next(gen)
        snap = tick.snapshot()
        gen.close()
        with tempfile.TemporaryDirectory() as tmp:
            path = save_snapshot(tmp, snap, envelope={
                "workload": workload, "version": spec.version,
                "system_kind": system.kind,
                "iters": snap["meta"]["iters"]})
            state, envelope = load_snapshot(tmp)
        dispatch.reset_launch_counts()
        gen = wl.fit_steps(ds, spec, state=state)
        while True:
            try:
                next(gen)
            except StopIteration as stop:
                res = stop.value
                break
        torch.cuda.synchronize()
        counts = dict(dispatch.launch_counts)
        if workload == "linreg":
            ok = (np.array_equal(res.attributes["coef_"], lin_ref[0])
                  and res.attributes["intercept_"] == lin_ref[1])
        else:
            ok = ("rng_mt_keys" in state["arrays"] and np.array_equal(
                res.attributes["cluster_centers_"],
                kme_ref.cluster_centers_)
                and np.array_equal(res.attributes["labels_"],
                                   kme_ref.labels_))
        if not ok:
            fail(f"elastic: the resumed {workload} fit differs from the "
                 f"uninterrupted one")
        say(f"elastic: {workload} {spec.version} snapshotted at iteration "
            f"{snap['meta']['iters']} ({Path(path).name}, "
            f"{len(state['arrays'])} arrays: {sorted(state['arrays'])}), "
            f"resumed == uninterrupted; launch counts of the resumed part "
            f"{counts} on {smi}")


# -- phase 9: the training service --------------------------------------------

def service_sizes(n_cores: int) -> dict:
    """Phase 9's leases: LIN and the fused gang half the machine each;
    LOG, KME, DTR and the priority job a quarter each."""
    half, quarter = n_cores // 2, n_cores // 4
    return {"lin": half, "log": quarter, "kme": quarter, "dtr": quarter,
            "gang": half, "priority": quarter}


def service_specs(data: dict, iters: int, depth: int,
                  fuse: int = SERVICE_FUSE) -> dict:
    """name -> (workload, (X, y), version, hyperparameters) of every
    phase-9 job but the gang's lanes."""
    lin, log = data["lin"], data["log"]
    return {
        "lin": ("linreg", lin, "int32", {"n_iters": iters}),
        "log": ("logreg", log, "int32_lut_wram", {"n_iters": iters}),
        "kme": ("kmeans", (data["kme"], None), "int16",
                {"n_clusters": KME_K, "max_iter": iters, "tol": 0.0}),
        "dtr": ("dtree", log, "fp32", {"max_depth": depth}),
        "priority": ("linreg", lin, "int32",
                     {"n_iters": iters, "fuse_steps": fuse}),
    }


def turn_states(sched) -> list:
    """Every job's state, turns, iterations and lease."""
    return [(h.name, h.state.value, h.steps, h.iters,
             None if h.lease is None else (h.lease.start, h.lease.n_cores))
            for h in sched.handles]


def service_drain(sched, data: dict, sizes: dict, iters: int, depth: int,
                  priority_at: int = SERVICE_PRIORITY_AT) -> dict:
    """Phase 9's queue, drained one turn at a time: LIN int32, LOG
    int32_lut_wram, KME int16 and DTR, the fused 8-point LIN int32 gang
    (GANG_LIN_LRS), then after ``priority_at`` turns a priority-1 LIN
    int32 job at fuse_steps SERVICE_FUSE, which evicts a priority-0 job.
    Returns the handles by name, each turn's states, wall seconds and
    the scheduler's own seconds (the turn's wall outside its jobs'
    chunks), and the TransferStats a preempted job settled before it
    resumed (its handle then keeps only the resumed run's delta)."""
    specs = service_specs(data, iters, depth)
    handles = {}
    for name in ("lin", "log", "kme", "dtr"):
        workload, d, version, params = specs[name]
        handles[name] = sched.submit(workload, d, version=version,
                                     n_cores=sizes[name], name=name,
                                     **params)
    lanes = sched.sweep("linreg", data["lin"], {"lr": list(GANG_LIN_LRS)},
                        version="int32", n_iters=iters,
                        n_cores=sizes["gang"], fused=True)
    handles.update((f"gang{i}", h) for i, h in enumerate(lanes))
    log, turns, own, segments = [], [], [], []
    preempted = {}

    def in_chunks():     # gang lanes each see their shared chunk's time
        return sum(h.measured_seconds for n, h in handles.items()
                   if not n.startswith("gang") or n == "gang0")

    more = True
    while more:
        if len(turns) == priority_at:
            workload, d, version, params = specs["priority"]
            handles["priority"] = sched.submit(
                workload, d, version=version, n_cores=sizes["priority"],
                priority=1, name="priority", **params)
        inside = in_chunks()
        t0 = time.perf_counter()
        more = sched.step()
        turns.append(time.perf_counter() - t0)
        own.append(turns[-1] - (in_chunks() - inside))
        log.append(turn_states(sched))
        for h in sched.handles:
            if h.preemptions > preempted.get(h.name, 0):
                preempted[h.name] = h.preemptions
                segments.append(h.transfer)
    return {"handles": handles, "log": log, "turns": turns, "own": own,
            "segments": segments}


def same_fit(got, want) -> bool:
    """Two FitResults: weights, centroids, labels and trees bit for bit
    (the int16 inertia, a float32 sum, to 1e-6)."""
    if got is None or sorted(got.attributes) != sorted(want.attributes):
        return False
    for key, w in want.attributes.items():
        g = got.attributes[key]
        if key == "tree_":
            ok = all(np.array_equal(getattr(g, f), getattr(w, f))
                     for f in TREE_FIELDS)
        elif key == "inertia_":
            ok = bool(np.isclose(g, w, rtol=1e-6, atol=0.0))
        else:
            ok = np.array_equal(np.asarray(g), np.asarray(w))
        if not ok:
            return False
    return True


def standalone_fits(torch, make_system, get_workload, data: dict,
                    sizes: dict, iters: int, depth: int) -> dict:
    """Each phase-9 job fitted alone on a card PimSystem of its lease's
    size (each gang lane as its serial fit), one after another, as one
    user would: one system a size, one dataset a (size, data) pair, so
    the first fit on a dataset builds its views.  name -> (FitResult,
    wall seconds)."""
    out, systems, datasets = {}, {}, {}
    specs = service_specs(data, iters, depth)
    specs.update((f"gang{i}", ("linreg", data["lin"], "int32",
                               {"n_iters": iters, "lr": lr}))
                 for i, lr in enumerate(GANG_LIN_LRS))
    for name, (workload, (X, y), version, params) in specs.items():
        size = sizes["gang" if name.startswith("gang") else name]
        if size not in systems:
            systems[size] = make_system("pim", n_cores=size, device="cuda")
        key = (size, id(X))
        if key not in datasets:
            datasets[key] = systems[size].put(X, y)
        wl = get_workload(workload)
        seconds, result = timed(torch, lambda: wl.fit(
            datasets[key], wl.spec(version, **params)))
        out[name] = (result, seconds)
    return out


def service_on_card(torch, dispatch, make_system, get_workload, data: dict,
                    smi: str) -> dict:
    """Phase 9: the training service on the card.

    (a) A drain: one PimScheduler over N_CORES cores (rank SERVICE_RANK,
    the deadline policy, preemptive) runs service_drain's queue with the
    launch counts zeroed just before it.  Every job DONE without an
    error, no retry and no serve error; each job and gang lane
    bit-identical to its standalone card fit; launch counts exactly what
    the iterations imply (the gang one fx_matvec launch a step for its 8
    lanes, the evicted job none again for an iteration done before its
    eviction); the parent's TransferStats the sum of the jobs' deltas;
    the allocator empty; device memory back within SERVICE_MEMORY_SLACK
    with the scheduler alive; the card's busy share over the drain
    (torch.profiler tracing the device only).
    (b) Serve mode: a fresh scheduler's serve loop takes 4 jobs submitted
    from this thread while it runs (one at fuse_steps SERVICE_FUSE, its
    chunk graph captured on the serve thread); shutdown(wait=True) loses
    none, each equals its standalone fit, the counts are exact.
    (c) The CLI: ``python -m repro_torch.launch.pim_jobs`` on
    examples/jobs.yaml as JSON with --checkpoint-dir, then again with
    --resume: every job restored without one kernel launch."""
    import gc
    import tempfile

    from repro_torch.sched import JobState, PimScheduler
    sizes = service_sizes(N_CORES)
    specs = service_specs(data, ITERS, DTR_DEPTH)
    alone = standalone_fits(torch, make_system, get_workload, data, sizes,
                            ITERS, DTR_DEPTH)
    alone_s = sum(t for _, t in alone.values())
    rounds = tree_rounds(alone["dtr"][0].model)

    def scheduler():
        return PimScheduler(make_system("pim", n_cores=N_CORES,
                                        device="cuda"),
                            rank_size=SERVICE_RANK, policy="deadline",
                            preemptive=True)

    def check_jobs(sched, handles: dict, what: str) -> None:
        bad = [h.name for h in handles.values()
               if h.state is not JobState.DONE or h.error is not None]
        if bad:
            fail(f"service {what}: jobs {bad} not DONE cleanly: " + "; ".join(
                f"{handles[n].state.value} {handles[n].error!r}"
                for n in bad))
        errors = {c: sched.metrics.counter(c).value
                  for c in ("sched.serve_errors", "sched.retries")}
        if any(errors.values()):
            fail(f"service {what}: {errors}")
        for name, h in handles.items():
            if not same_fit(h.result, alone[name][0]):
                fail(f"service {what}: job {name} differs from its "
                     f"standalone card fit")

    # (a) the drain
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    sched, run = scheduler(), {}

    def drain():
        t0 = time.perf_counter()
        run.update(service_drain(sched, data, sizes, ITERS, DTR_DEPTH))
        torch.cuda.synchronize()
        run["wall"] = time.perf_counter() - t0

    dispatch.reset_launch_counts()
    busy = device_profile(torch, drain, host=False)
    wall = run["wall"]
    counts = dict(dispatch.launch_counts)
    replays = sum(dispatch.graph_replays.values())
    handles = run["handles"]
    check_jobs(sched, handles, "drain")
    expected = {"fx_matvec": 4 * ITERS, "lut_sigmoid": ITERS,
                "kmeans_assign": ITERS, "gini_split": rounds}
    if counts != expected or replays != -(-ITERS // SERVICE_FUSE):
        fail(f"service drain: launch counts {counts} (expected "
             f"{expected}), {replays} graph replays")
    evicted = [h.name for h in handles.values() if h.preemptions]
    if len(evicted) != 1 or sched.metrics.counter(
            "sched.evictions").value != 1:
        fail(f"service drain: evicted {evicted}")
    parent = sched.system.stats.snapshot()
    deltas = [h.transfer for n, h in handles.items()
              if not n.startswith("gang") or n == "gang0"]
    deltas += run["segments"]
    for f in dataclasses.fields(parent):
        total = sum(getattr(d, f.name) for d in deltas)
        if getattr(parent, f.name) != total:
            fail(f"service drain: parent {f.name} {getattr(parent, f.name)}"
                 f" != the jobs' deltas {total}")
    frag = sched.fragmentation()
    if frag.used_cores or frag.n_leases:
        fail(f"service drain: the allocator is not empty: {frag}")
    gc.collect()
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - base
    if grown > SERVICE_MEMORY_SLACK:
        fail(f"service drain: {grown / 2 ** 20:.1f} MiB of device memory "
             f"still allocated after the drain")
    turns, own = run["turns"], run["own"]
    say(f"service: drain of {len(handles)} jobs over {N_CORES} cores "
        f"(rank {SERVICE_RANK}, deadline, preemptive) in {wall:.3f} s, "
        f"{len(turns)} turns; the {len(alone)} standalone card fits one "
        f"after another (one system a lease size, views shared) "
        f"{alone_s:.3f} s in all ({alone_s / wall:.2f}x); evicted "
        f"{evicted} at its chunk boundary and resumed; every job == its "
        f"standalone card fit; launch counts {counts} == expected, "
        f"{replays} graph replays; parent TransferStats == the jobs' "
        f"deltas ({len(run['segments'])} preempted segment); allocator "
        f"empty; device memory {grown / 2 ** 20:+.1f} MiB against the "
        f"phase's start (scheduler alive) on {smi}")
    say(f"service: per turn {statistics.median(turns) * 1e3:.3f} ms median"
        f" ({min(turns) * 1e3:.3f}-{max(turns) * 1e3:.3f}); the "
        f"scheduler's own host time (a turn's wall outside its jobs' "
        f"chunks) {statistics.median(own) * 1e6:.1f} us median a turn "
        f"({min(own) * 1e6:.1f}-{max(own) * 1e6:.1f}; admission builds a "
        f"gang's view), {sum(own):.3f} s in all; turn-end synchronizes "
        f"{sched.syncs}, waiting {sched.sync_seconds * 1e3:.3f} ms in all "
        f"({sched.sync_seconds / max(sched.syncs, 1) * 1e6:.1f} us each) "
        f"on {smi}")
    say(f"profile: service drain (device only traced): {busy}")
    for name, h in handles.items():
        fit_s = alone[name][1]
        say(f"service job {name:<8} {h.workload.name:<7} "
            f"{h.spec.version:<15} cores {h.n_cores:<5} turns {h.steps:<3}"
            f" queue {h.queue_latency:.4f} s, completion "
            f"{h.completion_latency:.4f} s, measured {h.measured_seconds:.4f}"
            f" s, modeled {h.modeled_seconds:.6g} s, drift "
            + (f"{h.drift_ratio:.4g}" if h.drift_ratio is not None
               else "none")
            + f"; standalone fit {fit_s:.4f} s, on {smi}")
    stats = sched.stats()
    say("service: stats " + json.dumps(
        {k: stats[k] for k in ("jobs", "preemptions", "recoveries",
                               "straggler_flags")})
        + f"; latency {json.dumps(sched.latency_summary())}")
    del sched, handles, run

    # (b) serve mode: submissions from this thread while the loop runs
    sched = scheduler()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    sched.serve(poll_interval=0.005)
    served = {}
    for name in ("lin", "log", "kme", "priority"):
        workload, d, version, params = specs[name]
        served[name] = sched.submit(workload, d, version=version,
                                    n_cores=sizes[name], name=name,
                                    **params)
        t_end = time.monotonic() + SERVICE_TIMEOUT
        while (served[name].state is JobState.QUEUED
               and time.monotonic() < t_end):
            time.sleep(0.001)          # mid-flight: the loop has taken it
    if not sched.wait(list(served.values()), timeout=SERVICE_TIMEOUT):
        fail("service serve: jobs unfinished after "
             f"{SERVICE_TIMEOUT} s")
    sched.shutdown(wait=True, timeout=SERVICE_TIMEOUT)
    serve_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    check_jobs(sched, served, "serve")
    serve_counts = dict(dispatch.launch_counts)
    serve_expected = {"fx_matvec": 3 * ITERS, "lut_sigmoid": ITERS,
                      "kmeans_assign": ITERS}
    serve_replays = sum(dispatch.graph_replays.values())
    if serve_counts != serve_expected or serve_replays != -(
            -ITERS // SERVICE_FUSE):
        fail(f"service serve: launch counts {serve_counts} (expected "
             f"{serve_expected}), {serve_replays} graph replays")
    say(f"service: serve loop took {len(served)} jobs submitted while it "
        f"ran (the fuse_steps {SERVICE_FUSE} job's chunk graph captured "
        f"on the serve thread), shutdown lost none, each == its "
        f"standalone card fit, launch counts {serve_counts}, "
        f"{serve_replays} replays, in {serve_s:.3f} s; latency "
        + json.dumps(sched.latency_summary()) + f" on {smi}")
    del sched, served
    gc.collect()
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - base
    if grown > SERVICE_MEMORY_SLACK:
        fail(f"service serve: {grown / 2 ** 20:.1f} MiB of device memory "
             f"still allocated")

    # (c) the CLI on examples/jobs.yaml as JSON, then resumed
    src = Path(__file__).resolve().parent / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    with tempfile.TemporaryDirectory() as tmp:
        manifest = Path(tmp) / "jobs.json"
        manifest.write_text(json.dumps(JOBS_YAML_AS_JSON))
        reports = []
        for resume in (False, True):
            out = Path(tmp) / f"report{int(resume)}.json"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.pim_jobs",
                 str(manifest), "--checkpoint-dir", str(Path(tmp) / "ck"),
                 "--json", str(out)] + (["--resume"] if resume else []),
                env=env, capture_output=True, text=True,
                timeout=SERVICE_TIMEOUT)
            if proc.returncode:
                fail(f"service cli: pim_jobs exited {proc.returncode}:\n"
                     f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
            reports.append((json.loads(out.read_text()),
                            time.perf_counter() - t0))
    (first, t_first), (again, t_again) = reports
    jobs_run = {r["name"]: r for r in first["jobs"]}
    if {r["state"] for r in first["jobs"]} != {"done"} or not {
            "fx_matvec", "lut_sigmoid", "kmeans_assign"} <= set(
                first["launch_counts"]) or first["device"] != "cuda":
        fail(f"service cli: first run {first['launch_counts']}, "
             f"{[(r['name'], r['state']) for r in first['jobs']]}")
    if not all(r.get("restored") and r["state"] == "done"
               for r in again["jobs"]) or again["launch_counts"] or \
            again["scheduler"]["transfer"]["pim"]["kernel_launches"]:
        fail(f"service cli: --resume re-ran work: "
             f"{again['launch_counts']}, {again['jobs']}")
    say(f"service: pim_jobs on examples/jobs.yaml as JSON "
        f"({len(jobs_run)} jobs, launch counts {first['launch_counts']}) "
        f"in {t_first:.1f} s with its start-up; --resume restored all "
        f"{len(again['jobs'])} without a launch in {t_again:.1f} s")
    return {"drain": counts, "serve": serve_counts}


def tree_rounds(tree) -> int:
    """Frontier rounds a fit ran: one per depth level, plus the last
    round, which evaluates the deepest leaves and splits none."""
    return int(tree.depth[:tree.n_nodes].max()) + 1


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.api import get_workload, make_estimator, make_system
    from repro_torch.configs.base import get_config
    from repro_torch.core.lut import build_sigmoid_lut
    from repro_torch.core.metrics import adjusted_rand_index
    from repro_torch.data.synthetic import (make_blobs, make_classification,
                                            make_linear_dataset)
    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels.gini_split import (gini_split_cuda,
                                                gini_split_plain)
    from repro_torch.kernels.kmeans_assign import (kmeans_assign_cuda,
                                                   kmeans_assign_plain)
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
    n_dtr, mem_avail = host_samples(DTR_SIZES, DTR_HOST_BYTES_PER_SAMPLE)
    say(f"host MemAvailable {mem_avail / 2 ** 30:.1f} GiB: DTR runs at "
        f"{n_dtr:,} samples (the paper's {DTR_SIZES[0]:,} needs "
        f"~{DTR_SIZES[0] * DTR_HOST_BYTES_PER_SAMPLE / 2 ** 30:.0f} GiB "
        f"to generate; taken when under half of MemAvailable)")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build()
    say(f"build: {len(logs)} of {len(build.SOURCES)} libraries compiled in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        kernel = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1][:90]
            elif "registers" in line or "spill" in line:
                say(f"  {name} {kernel}: {line.split(':', 1)[-1].strip()}")

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
    edges = torch.tensor(lut_edges(n_table), dtype=torch.int32)
    z = torch.from_numpy(rng.randint(-30000, 30000, (N_CORES, n_pc))
                         .astype(np.int32))
    z.view(-1)[:edges.numel()] = edges
    z = z.to(dev)
    err_lut, n_ragged = check_lut_sigmoid(torch, rng, lut, z)
    say(f"kernels: lut_sigmoid wram and mram == plain at {tuple(z.shape)} "
        f"with the edge values, and in {n_ragged} cases of ~{LUT_RAGGED} "
        f"elements 4-12 B past an alignment with ragged ends, the edge "
        f"values in the head, a vector and the tail, under tables of "
        f"{n_table} and {LUT_ODD} (max abs err {err_lut})")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    err_km, km = check_kmeans_assign(torch, dev, gen)
    err_gi, gi = check_gini_counts(torch, dev, gen, n_dtr)
    err_eg, err_es, emb = check_emb_kernels(torch, dev, make_system)
    lm_prompt_lens = sorted(len(p) for p in lm_requests(
        get_config(LM_ARCH).vocab_size))
    err_mm, err_fa = check_lm_kernels(torch, dev, gen, lm_prompt_lens)

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

    # KME at the paper's strong-scaling size, on the card
    t0 = time.perf_counter()
    Xk, _, _ = make_blobs(KME_SAMPLES, N_FEATURES, centers=KME_K, seed=SEED)
    say(f"data: {KME_SAMPLES}x{N_FEATURES} KME blobs in "
        f"{time.perf_counter() - t0:.1f} s")
    kme_system = make_system("pim", n_cores=N_CORES, device="cuda")
    kme_ds = kme_system.put(Xk)
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    kme = kme_fits(make_estimator, kme_system, kme_ds)
    torch.cuda.synchronize()
    kme_counts = dict(dispatch.launch_counts)
    say(f"main path KME: int16 + fp32 fits x {ITERS} iterations in "
        f"{time.perf_counter() - t0:.1f} s (views included); launch counts "
        f"{kme_counts} (expected {{'kmeans_assign': {ITERS}}})")
    if kme_counts != {"kmeans_assign": ITERS}:
        fail(f"KME launch counts {kme_counts}")
    check_kme(kme, KME_SAMPLES)
    for version, e in kme.items():
        say(f"  kmeans {version:<5} inertia {e.inertia_:.6g}, n_iter "
            f"{e.n_iter_}, centroid[0][:3] {e.cluster_centers_[0, :3]}")
    # the int32 range of the cross-core reduce of the cluster sums: the
    # reference's fabric sum keeps int32 and wraps; hold it against int64
    view = kme_ds.kmeans_view("int16")
    init = view.host_q[np.random.RandomState(SEED).choice(
        KME_SAMPLES, KME_K, replace=False)]
    fitted = np.round(kme["int16"].cluster_centers_ / view.scale)
    for name, cq in (("initial", init), ("fitted", fitted)):
        _, sums, _ = kmeans_assign_cuda(
            view.shards, torch.from_numpy(cq.astype(np.int16)).to(dev))
        wide = torch.sum(sums, dim=0, dtype=torch.int64)
        narrow = torch.sum(sums, dim=0, dtype=torch.int32)
        n_out = int(((wide < INT32_MIN) | (wide > INT32_MAX)).sum())
        say(f"int32 range: KME cluster sums over {N_CORES} cores with the "
            f"{name} centroids: {n_out} of {wide.numel()} entries leave "
            f"int32 (max |sum| {int(wide.abs().max()):,}; the int32 "
            f"reduce wraps them: {int((narrow.long() != wide).sum())} "
            f"differ)")
    del Xk, view, sums, wide, narrow

    # DTR at the largest size the host can generate, on the card
    t0 = time.perf_counter()
    Xd, yd = make_classification(n_dtr, N_FEATURES, seed=SEED,
                                 class_sep=1.4)
    say(f"data: {n_dtr}x{N_FEATURES} DTR classification in "
        f"{time.perf_counter() - t0:.1f} s")
    dtr_system = make_system("pim", n_cores=N_CORES, device="cuda")
    dtr_ds = dtr_system.put(Xd, yd)
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    dtr = make_estimator("dtree", max_depth=DTR_DEPTH,
                         system=dtr_system).fit(dtr_ds)
    torch.cuda.synchronize()
    dtr_counts = dict(dispatch.launch_counts)
    rounds = tree_rounds(dtr.tree_)
    say(f"main path DTR: max_depth {DTR_DEPTH}, {rounds} rounds, "
        f"{dtr.n_nodes_} nodes in {time.perf_counter() - t0:.1f} s (view "
        f"included); launch counts {dtr_counts} (expected "
        f"{{'gini_split': {rounds}}}); training accuracy on the first "
        f"1M samples {dtr.score(Xd[:1 << 20], yd[:1 << 20]):.4f}")
    if dtr_counts != {"gini_split": rounds}:
        fail(f"DTR launch counts {dtr_counts}")
    if dtr_system.stats.kernel_launches != 3 * rounds - 1:
        fail(f"DTR ran {dtr_system.stats.kernel_launches} map_* calls, "
             f"not 3 per round less the last commit")
    del Xd, yd

    # KME and DTR at the paper's quality sizes: the card against the CPU
    Xk, yk, _ = make_blobs(KME_QUALITY, N_FEATURES, centers=KME_K,
                           seed=SEED)
    Xd, yd = make_classification(DTR_QUALITY, N_FEATURES, seed=SEED,
                                 class_sep=1.4)
    quality = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        system = make_system("pim", n_cores=N_CORES, device=device)
        quality[device] = (
            kme_fits(make_estimator, system, system.put(Xk)),
            make_estimator("dtree", max_depth=DTR_DEPTH,
                           system=system).fit(Xd, yd).tree_,
            system.stats.snapshot())
        say(f"quality sizes on {device}: KME {KME_QUALITY} + DTR "
            f"{DTR_QUALITY} in {time.perf_counter() - t0:.1f} s")
    (gk, gt, gs), (ck, ct, cs) = quality["cuda"], quality["cpu"]
    check_kme(gk, KME_QUALITY)
    if not (np.array_equal(gk["int16"].cluster_centers_,
                           ck["int16"].cluster_centers_)
            and np.array_equal(gk["int16"].labels_, ck["int16"].labels_)
            and gk["int16"].n_iter_ == ck["int16"].n_iter_):
        fail("KME int16: card and CPU fits disagree")
    if not np.allclose(gk["fp32"].cluster_centers_,
                       ck["fp32"].cluster_centers_, rtol=KME_FP32_RTOL,
                       atol=KME_FP32_ATOL):
        fail("KME fp32: card and CPU centroids disagree")
    flips = int((gk["fp32"].labels_ != ck["fp32"].labels_).sum())
    dc = float(np.abs(gk["fp32"].cluster_centers_
                      - ck["fp32"].cluster_centers_).max())
    say(f"  KME int16 card == cpu (centroids, labels, n_iter {ITERS}); "
        f"fp32 max |dC| {dc:.3g}, {flips} labels differ; ARI vs the blobs' "
        f"truth: int16 {adjusted_rand_index(gk['int16'].labels_, yk):.4f}, "
        f"fp32 {adjusted_rand_index(gk['fp32'].labels_, yk):.4f}")
    fields = ("feature", "threshold", "left", "right", "leaf_class", "depth")
    if not (all(np.array_equal(getattr(gt, f), getattr(ct, f))
                for f in fields) and gt.n_nodes == ct.n_nodes):
        fail("DTR: card and CPU trees differ")
    say(f"  DTR tree card == cpu ({gt.n_nodes} nodes, {tree_rounds(gt)} "
        f"rounds; training accuracy {np.mean(gt.predict(Xd) == yd):.4f})")
    if gs != cs:
        fail("KME/DTR TransferStats differ between the card and the CPU")
    say(f"TransferStats equal on card and CPU: {gs}")

    # EMB at the Netflix matrix's size, on the card; then card == CPU
    emb_counts, emb_profile, emb_fused_profile = emb_fits_on_card(
        torch, make_system, get_workload, dispatch, smi)
    emb_card_equals_cpu(make_system, make_estimator)

    # qwen3-8b served at full width through Model and ServeEngine; then
    # the reduced model on the card against the CPU
    lm = lm_serve_on_card(torch, dispatch, smi)
    lm_card_equals_cpu(torch)

    # -- 5. timing -----------------------------------------------------------
    flush = L2Flush(torch)
    # the method's floor: no kernel reads below a one-element add_
    tiny = torch.zeros(1, dtype=torch.int32, device="cuda")
    say(f"timing: the method's floor, a one-element add_, "
        f"{cuda_ms(torch, lambda: tiny.add_(1), flush):.4f} ms on {smi}")
    fx = dict(ms=cuda_ms(torch, lambda: fx_matvec_cuda(x, w, 10), flush),
              plain_ms=cuda_ms(torch, lambda: fx_matvec_plain(x, w, 10),
                               flush))
    fx["bound_ms"], fx["bound_by"] = declared_bound("fx_matvec", x, w, 10)
    say(f"timing: fx_matvec {fx['ms']:.4f} ms, plain {fx['plain_ms']:.4f} "
        f"ms, bound {fx['bound_ms']:.4f} ms ({fx['bound_by']}; H100 SXM "
        f"peaks {PEAK_BYTES_PER_S:.3g} B/s, {PEAK_INT32_OPS_PER_S:.3g} "
        f"int32 op/s) on {smi}")
    # lut_sigmoid at the main shape, and on the z that the LOG fit itself
    # hands it (the system and datasets stay for the fits below)
    system = make_system("pim", n_cores=N_CORES, device="cuda")
    lin_ds, log_ds = system.put(X, y), system.put(Xc, yc)
    fit_z = log_fit_z(dispatch, make_estimator, log_ds)
    lu = dict(ms=cuda_ms(torch, lambda: lut_sigmoid_cuda(z, lut, "wram"),
                         flush),
              mram_ms=cuda_ms(torch, lambda: lut_sigmoid_cuda(
                  z, lut, "mram"), flush),
              plain_ms=cuda_ms(torch, lambda: lut_sigmoid_plain(z, lut),
                               flush))
    lu["bound_ms"], lu["bound_by"] = declared_bound("lut_sigmoid", z, lut)
    lu["fit_z_ms"] = {f"{it}_{placement}": cuda_ms(
        torch, lambda: lut_sigmoid_cuda(zi, lut, placement), flush)
        for it, zi in fit_z.items() for placement in ("wram", "mram")}
    fz = lu["fit_z_ms"]
    at_end = {name: float((zi.abs() >= n_table - 1).float().mean())
              for name, zi in (("main", z), ("last", fit_z["last"]))}
    say(f"timing: lut_sigmoid at {tuple(z.shape)} wram {lu['ms']:.4f} ms "
        f"({100 * lu['bound_ms'] / lu['ms']:.1f}% of the bound), mram "
        f"{lu['mram_ms']:.4f} ms "
        f"({100 * lu['bound_ms'] / lu['mram_ms']:.1f}%); "
        f"{100 * at_end['main']:.1f}% of z at the table's end; on the LOG "
        f"fit's own z, iteration 1 (all zero: "
        f"{not bool(fit_z['first'].any())}) wram {fz['first_wram']:.4f} / "
        f"mram {fz['first_mram']:.4f} ms, iteration {ITERS} (max |z| "
        f"{int(fit_z['last'].abs().max())}, {100 * at_end['last']:.2f}% "
        f"at the table's end) wram {fz['last_wram']:.4f} / mram "
        f"{fz['last_mram']:.4f} ms; plain {lu['plain_ms']:.4f} ms, bound "
        f"{lu['bound_ms']:.4f} ms ({lu['bound_by']}; H100 SXM peaks "
        f"{PEAK_BYTES_PER_S:.3g} B/s, {PEAK_INT32_OPS_PER_S:.3g} int32 "
        f"op/s) on {smi}")
    del fit_z

    kx, kc = km["x"], km["c"]
    n_km = kx.shape[0] * kx.shape[1]
    kt = dict(ms=cuda_ms(torch, lambda: kmeans_assign_cuda(kx, kc), flush),
              plain_ms=cuda_ms(torch, lambda: kmeans_assign_plain(kx, kc),
                               flush))
    # the products run on the tensor cores as four int8 products (the
    # byte split); on the CUDA cores they were 2 n K F int32 operations
    km_bytes = dispatch.declared_cost("kmeans_assign", kx, kc).bytes
    kt["bound_ms"], kt["bound_by"] = declared_bound("kmeans_assign", kx, kc)
    cuda_core_bound_ms = bound(km_bytes, 2 * n_km * KME_K * N_FEATURES)[0]
    n_leaves = gi["th"].shape[0]
    g_args = (gi["x"], gi["y"], gi["spread"], gi["th"], 2)
    g_root = (gi["x"], gi["y"], gi["root"], gi["th"], 2)
    g_front = (gi["x"], gi["y"], gi["frontier"], gi["th"], 2)
    gt = dict(ms=cuda_ms(torch, lambda: gini_split_cuda(*g_args), flush),
              root_ms=cuda_ms(torch, lambda: gini_split_cuda(*g_root),
                              flush),
              frontier_ms=cuda_ms(torch, lambda: gini_split_cuda(*g_front),
                                  flush),
              few_cores_ms=cuda_ms(torch, lambda: gini_split_cuda(
                  *gi["few_cores"](gi["spread"])), flush),
              few_cores_root_ms=cuda_ms(torch, lambda: gini_split_cuda(
                  *gi["few_cores"](gi["root"])), flush),
              plain_ms=cuda_ms(torch, lambda: gini_split_plain(*g_args),
                               flush))
    gt["bound_ms"], gt["bound_by"] = declared_bound("gini_split", *g_args)
    say(f"timing: kmeans_assign {kt['ms']:.4f} ms, plain "
        f"{kt['plain_ms']:.4f} ms, bound {kt['bound_ms']:.4f} ms "
        f"({kt['bound_by']}: {km_bytes:.4g} B at {PEAK_BYTES_PER_S:.3g} "
        f"B/s; four int8 products, {8 * n_km * KME_K * N_FEATURES:.4g} ops "
        f"at {PEAK_INT8_OPS_PER_S:.4g}/s; on the CUDA cores "
        f"{2 * n_km * KME_K * N_FEATURES:.4g} int32 ops at "
        f"{PEAK_INT32_OPS_PER_S:.3g}/s bound {cuda_core_bound_ms:.4f} "
        f"ms) at {tuple(kx.shape)} K={KME_K} on {smi}")
    say(f"timing: gini_counts {gt['ms']:.4f} ms (leaves spread over 2^10), "
        f"{gt['root_ms']:.4f} ms (all at the root), "
        f"{gt['frontier_ms']:.4f} ms (ids 1023-2046); the same rows over "
        f"{FEW_CORES} cores {gt['few_cores_ms']:.4f} ms spread, "
        f"{gt['few_cores_root_ms']:.4f} ms at the root; plain "
        f"{gt['plain_ms']:.4f} ms, bound {gt['bound_ms']:.4f} ms "
        f"({gt['bound_by']}) at {tuple(gi['x'].shape)} L={n_leaves} "
        f"on {smi}")
    et = emb_kernel_times(torch, emb, flush)
    for name in ("emb_gather", "emb_scatter_add"):
        t = et[name]
        for pre, table in (("", "users"), ("items_", "items")):
            shape = tuple(emb[table, "int32"]["table"].shape)
            say(f"timing: {name} {table} {shape} {t[pre + 'ms']:.4f} ms "
                f"int32, {t[pre + 'fp32_ms']:.4f} ms fp32"
                + (f", padded D={EMB_FLUSH} flush "
                   f"{t[pre + 'flush_ms']:.4f} ms" if "flush_ms" in t
                   else "")
                + f"; bound {t[pre + 'bound_ms']:.4f} ms "
                f"({t[pre + 'bound_by']}"
                + (f"; PR 13-15 counted every id and compare: "
                   f"{t[pre + 'old_bound_ms']:.4f} ms"
                   if "old_bound_ms" in t else "")
                + f"); {t['library_call']} {t[pre + 'library_ms']:.4f} ms "
                f"(it needs a slot map the kernel does not receive), "
                f"B={EMB_BATCH}, on {smi}")
        say(f"timing: {name} plain {t['plain_ms']:.4f} ms (users, int32)")

    lt = lm_kernel_times(torch, flush, lm_prompt_lens)
    for (name, *shape), t in lt.items():
        lib = ("none" if t["library_ms"] is None
               else f"{t['library_ms']:.4f} ms")
        rate = (f"{t['tops']:.1f} TOP/s" if shape
                else f"{t['tflops']:.1f} TFLOP/s")
        say(f"timing: {name} {t['ms']:.4f} ms ({rate}, "
            f"{100 * t['bound_share']:.1f}% of the bound), plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}), "
            + (f"torch._int_mm {lib} at (M, K, N) {tuple(shape)}"
               if shape else f"F.scaled_dot_product_attention {lib} at "
               f"bf16 [1, 32, {lm_prompt_lens[-1]}, 128] over 16 KV "
               f"heads, causal")
            + f"; host {t['host_us']:.1f} us per wrapper call"
            f" on {smi}")
    del flush, km, gi

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
    kme_wl, dtr_wl = get_workload("kmeans"), get_workload("dtree")
    kme_params = dict(n_clusters=KME_K, max_iter=ITERS, tol=0.0)
    for version in ("int16", "fp32"):          # views resident since phase 4
        steps, _ = step_times(kme_wl.fit_steps(
            kme_ds, kme_wl.spec(version, **kme_params)))
        dt = statistics.median(steps[1:ITERS])
        say(f"fit: kmeans  {version:<15} {dt * 1e3:.3f} ms/iteration "
            f"(median of iterations 2-{ITERS}), {KME_SAMPLES / dt:.4g} "
            f"samples/s; the first step with the init draw "
            f"{steps[0] * 1e3:.1f} ms, the end-of-fit inertia and labels "
            f"passes {steps[-1] * 1e3:.1f} ms ({N_CORES} cores, on {smi})")
    g_rounds, (steps, _) = gini_round_times(
        torch, dispatch, lambda: step_times(dtr_wl.fit_steps(
            dtr_ds, dtr_wl.spec(max_depth=DTR_DEPTH))))
    dt = sum(steps) / len(steps)
    say(f"fit: dtree   max_depth {DTR_DEPTH:<5} {dt * 1e3:.3f} ms/round "
        f"(mean of {len(steps)}), {n_dtr / dt:.4g} samples/s per round; "
        f"rounds {' '.join(f'{t * 1e3:.1f}' for t in steps)} ms "
        f"({N_CORES} cores, {n_dtr:,} samples, on {smi})")
    gt["fit_round_ms"] = g_rounds
    say(f"fit: dtree   gini_counts per round "
        f"{' '.join(f'{t:.4f}' for t in g_rounds)} ms, "
        f"{sum(g_rounds):.3f} ms over its {len(g_rounds)} launches (CUDA "
        f"events inside the fit, L2 as the fit leaves it; on {smi})")
    for name, fit in (
            ("KME int16 fit", lambda: kme_wl.fit(
                kme_ds, kme_wl.spec("int16", **kme_params))),
            ("DTR fit", lambda: dtr_wl.fit(
                dtr_ds, dtr_wl.spec(max_depth=DTR_DEPTH)))):
        say(f"profile: {name}: " + device_profile(torch, fit))
    say(f"profile: EMB int32 eager, 50 steps at the Netflix size: "
        f"{emb_profile}")

    # -- 6. step fusion: each fused chunk one CUDA graph replay --------------
    fused_gd_fits(torch, dispatch, make_estimator, system, lin_ds, log_ds,
                  smi)
    kme_fused_profile = fused_kme(torch, dispatch, make_system,
                                  get_workload, kme_ds, kme["int16"], Xk,
                                  smi)
    say(f"profile: KME int16 fused (fuse_steps {KME_FUSE}): "
        f"{kme_fused_profile}")
    say(f"profile: EMB int32 D={EMB_FLUSH} fused (fuse_steps {EMB_FUSE}), "
        f"{EMB_ITERS} steps at the Netflix size: {emb_fused_profile}")

    # -- 7. the paper's three-way compare on the card ------------------------
    t0 = time.perf_counter()
    compare_counts = compare_on_card(torch, dispatch, smi)
    say(f"compare: phase 7 in {time.perf_counter() - t0:.1f} s on {smi}")

    # -- 8. orchestration: lanes, the fused gang, slices, elastic, trace ----
    t0 = time.perf_counter()
    flush = L2Flush(torch)
    lanes = lane_kernel_on_card(torch, dispatch, rng, flush, smi)
    del flush
    lanes.update(gang_on_card(torch, dispatch, make_estimator, get_workload,
                              system, lin_ds, log_ds, smi))
    slices_on_card(torch, make_system, make_estimator, X, y, Xc, yc, smi)
    elastic_on_card(torch, dispatch, get_workload, system, lin_ds, kme_ds,
                    results["cuda", "int32"], kme["int16"], smi)
    say(f"orchestration: phase 8 in {time.perf_counter() - t0:.1f} s on "
        f"{smi}")

    # -- 9. the training service: scheduler, serve loop, CLI ----------------
    t0 = time.perf_counter()
    service = service_on_card(
        torch, dispatch, make_system, get_workload,
        {"lin": (X, y), "log": (Xc, yc), "kme": kme_ds.X}, smi)
    say(f"service: phase 9 in {time.perf_counter() - t0:.1f} s on {smi}")

    kernels = [
        {"name": "fx_matvec", "route": "cuda",
         "source": "src/repro_torch/csrc/fx_matvec.cu",
         "replaces": "src/repro/kernels/quant_matmul/kernel.py:82",
         "launches": counts["fx_matvec"], "max_abs_err": err_fx,
         "ms": fx["ms"], "plain_ms": fx["plain_ms"],
         "bound_ms": fx["bound_ms"], "bound_by": fx["bound_by"],
         "library_ms": None, "lanes": lanes},
        {"name": "lut_sigmoid", "route": "cuda",
         "source": "src/repro_torch/csrc/lut_sigmoid.cu",
         "replaces": "src/repro/kernels/lut_activation/kernel.py:37",
         "launches": counts["lut_sigmoid"], "max_abs_err": err_lut,
         "ms": lu["ms"], "mram_ms": lu["mram_ms"],
         "fit_z_ms": lu["fit_z_ms"], "plain_ms": lu["plain_ms"], "bound_ms": lu["bound_ms"],
         "bound_by": lu["bound_by"], "library_ms": None},
        {"name": "kmeans_assign", "route": "cuda",
         "source": "src/repro_torch/csrc/kmeans_assign.cu",
         "replaces": "src/repro/kernels/kmeans_assign/kernel.py:51",
         "launches": kme_counts["kmeans_assign"], "max_abs_err": err_km,
         "ms": kt["ms"], "plain_ms": kt["plain_ms"],
         "bound_ms": kt["bound_ms"], "bound_by": kt["bound_by"],
         "library_ms": None},
        {"name": "gini_counts", "route": "cuda",
         "source": "src/repro_torch/csrc/gini_counts.cu",
         "replaces": "src/repro/kernels/gini_split/kernel.py:58",
         "launches": dtr_counts["gini_split"], "max_abs_err": err_gi,
         "ms": gt["ms"], "root_ms": gt["root_ms"],
         "frontier_ms": gt["frontier_ms"],
         "few_cores_ms": gt["few_cores_ms"],
         "few_cores_root_ms": gt["few_cores_root_ms"],
         "fit_round_ms": gt["fit_round_ms"],
         "plain_ms": gt["plain_ms"], "bound_ms": gt["bound_ms"],
         "bound_by": gt["bound_by"], "library_ms": None},
        {"name": "emb_gather", "route": "cuda",
         "source": "src/repro_torch/csrc/emb_gather.cu",
         "replaces": "src/repro/kernels/sparse_gather/kernel.py:48",
         "launches": emb_counts["emb_gather"], "max_abs_err": err_eg,
         **et["emb_gather"]},
        {"name": "emb_scatter_add", "route": "cuda",
         "source": "src/repro_torch/csrc/emb_scatter_add.cu",
         "replaces": "src/repro/kernels/sparse_gather/kernel.py:81",
         "launches": emb_counts["emb_scatter_add"], "max_abs_err": err_es,
         **et["emb_scatter_add"]},
        {"name": "int_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/int_matmul.cu",
         "replaces": "src/repro/kernels/quant_matmul/kernel.py:43",
         "launches": lm["counts"]["int_matmul"], "max_abs_err": err_mm,
         "shape": [lm_prompt_lens[-1], *LM_MLP_SHAPES[0]],
         **lt["int_matmul", lm_prompt_lens[-1], *LM_MLP_SHAPES[0]],
         "decode": {f"{k}x{n}": lt["int_matmul", 1, k, n]
                    for k, n in LM_MLP_SHAPES},
         "prefill_down": lt["int_matmul", lm_prompt_lens[-1],
                            *LM_MLP_SHAPES[1]],
         "prefill_shortest": {f"{lm_prompt_lens[0]}x{k}x{n}":
                              lt["int_matmul", lm_prompt_lens[0], k, n]
                              for k, n in LM_MLP_SHAPES}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:81",
         "launches": lm["counts"]["mha"], "max_abs_err": err_fa,
         "shape": [1, 32, lm_prompt_lens[-1], 128], **lt["flash_attention",]},
    ]
    for k in kernels:
        op = "gini_split" if k["name"] == "gini_counts" else k["name"]
        if op in COMPARE_KERNELS:
            k["compare_launches"] = compare_counts[op]
        if op in service["drain"]:
            k["service_launches"] = service["drain"][op]
            k["serve_launches"] = service["serve"].get(op, 0)
    say("serve: " + json.dumps({
        name: {k: lm[name][k] for k in ("tokens_per_s", "ttft_ms",
                                        "prefill_ms", "decode_ms", "wall_s")}
        for name in ("on", "off")}))
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
