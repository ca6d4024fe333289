#!/usr/bin/env python3
"""Time ``gini_counts`` at two core counts, and the plain torch around
DTR's and KME's kernels, for the port in the source tree that ``--src``
names, so that two trees compare within one call on one card.

    python3 tools/time_gini_and_sites.py [--src DIR] [--sites]

``--src`` defaults to this checkout's ``src/``; the kernel is built from
that tree's ``csrc/``.  Each time is ``chip_smoke.py``'s: the median of
TIMING_RUNS CUDA-event timings, each after its reading L2 flush.

  gini_counts  the DTR main shape, x ``[2048, 37500, 16]`` f32, L = 4096,
               two classes, leaves spread over 2^10 and all at the root;
               then the same rows as 16 cores of 4,800,000
  --sites      DTR's split-evaluate around ``gini_counts``: invalid rows
               routed to a spill slot (x, y and leaf copied, the slot's
               total corrected) against invalid rows sent to leaf -1.
               KME's pad correction around ``kmeans_assign``: a scatter of
               the pad rows over their labels against their count put at
               the first argmin of the centroids' squared norms.  At the
               main shapes (x ``[2048, 37500, 16]``, labels ``[2048,
               12500]`` drawn uniformly from K = 16).

Prints the card's name and power limit, then one JSON line.  Nothing of
JAX or the JAX package is imported.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N_CORES, FEW_CORES, N_PC, N_FEATURES, N_LEAVES = 2048, 16, 37_500, 16, 4096
KME_PC, KME_K = 12_500, 16


def gini_times(torch, cs, gen) -> dict:
    from repro_torch.kernels.gini_split import gini_split_cuda
    dev = "cuda"
    x = torch.randn((N_CORES, N_PC, N_FEATURES), generator=gen, device=dev)
    y = torch.randint(0, 2, (N_CORES, N_PC), generator=gen, device=dev,
                      dtype=torch.int32)
    th = torch.randn((N_LEAVES, N_FEATURES), generator=gen, device=dev)
    leaves = {"spread": torch.randint(0, 1024, (N_CORES, N_PC),
                                      generator=gen, device=dev,
                                      dtype=torch.int32),
              "root": torch.zeros((N_CORES, N_PC), dtype=torch.int32,
                                  device=dev)}
    flush, out = cs.L2Flush(torch), {}
    for cores in (N_CORES, FEW_CORES):
        for name, leaf in leaves.items():
            args = (x.view(cores, -1, N_FEATURES), y.view(cores, -1),
                    leaf.view(cores, -1), th, 2)
            out[f"gini_counts_{cores}_cores_{name}_ms"] = cs.cuda_ms(
                torch, lambda: gini_split_cuda(*args), flush)
    return out


def site_times(torch, cs, gen) -> dict:
    dev = "cuda"
    x = torch.zeros((N_CORES, N_PC, N_FEATURES), device=dev)
    y = torch.zeros((N_CORES, N_PC), dtype=torch.int32, device=dev)
    leaf = torch.zeros_like(y)
    valid = torch.ones((N_CORES, N_PC), dtype=torch.bool, device=dev)
    max_nodes, n_cls = 2 ** 12, 2
    total = torch.zeros((N_CORES, max_nodes, n_cls), dtype=torch.int32,
                        device=dev)

    def dtr_spill_slot():
        torch.where(valid.unsqueeze(-1), x, 3.4e38)
        torch.where(valid, y, n_cls - 1)
        torch.where(valid, leaf, max_nodes - 1)
        total[:, max_nodes - 1, n_cls - 1] -= torch.sum(
            ~valid, dim=-1, dtype=torch.int32)

    labels = torch.randint(0, KME_K, (N_CORES, KME_PC), generator=gen,
                           device=dev, dtype=torch.int32)
    mask = torch.ones((N_CORES, KME_PC), dtype=torch.bool, device=dev)
    counts = torch.zeros((N_CORES, KME_K), dtype=torch.int32, device=dev)
    cq = torch.zeros((KME_K, N_FEATURES), dtype=torch.int16, device=dev)

    def kme_scatter():
        pads = torch.zeros_like(counts).scatter_add_(
            1, labels.long(), (~mask).to(torch.int32))
        return counts - pads

    def kme_closed_form():
        c = cq.to(torch.int32)
        n_pad = torch.sum(~mask, dim=-1, dtype=torch.int32)
        at_zero = torch.arange(KME_K, device=dev) == torch.argmin(
            torch.sum(c * c, dim=-1, dtype=torch.int32))
        return counts - n_pad.unsqueeze(-1) * at_zero

    flush = cs.L2Flush(torch)
    return {"dtr_spill_slot_ms": cs.cuda_ms(torch, dtr_spill_slot, flush),
            "dtr_leaf_minus_one_ms": cs.cuda_ms(
                torch, lambda: torch.where(valid, leaf, -1), flush),
            "kme_scatter_ms": cs.cuda_ms(torch, kme_scatter, flush),
            "kme_closed_form_ms": cs.cuda_ms(torch, kme_closed_form, flush)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the source tree whose repro_torch is timed")
    ap.add_argument("--sites", action="store_true",
                    help="also time the call sites' plain torch")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_gini_and_sites: no CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as cs
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"src": args.src, "card": smi, **gini_times(torch, cs, gen)}
    if args.sites:
        out.update(site_times(torch, cs, gen))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
