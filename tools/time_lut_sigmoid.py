#!/usr/bin/env python3
"""Time ``lut_sigmoid`` in both placements for the port in the source tree
that ``--src`` names, so that two trees compare within one call on one
card.

    python3 tools/time_lut_sigmoid.py [--src DIR]

``--src`` defaults to this checkout's ``src/``; the kernel is built from
that tree's ``csrc/``.  Each time is ``chip_smoke.py``'s: the median of
TIMING_RUNS CUDA-event timings, each after its reading L2 flush.

  main        z ``[2048, 3072]`` int32 drawn uniformly from [-30000, 30000),
              ``chip_smoke.py``'s distribution (a third of it clamps at
              the table's end)
  fit_first,  the z that a LOG int32_lut_wram fit of the paper's
  fit_last    6,291,456 x 16 over 2048 cores hands the kernel at its first
              iteration (w = 0 there: z is all zero) and at its tenth
  *_next      the kernel followed by the LOG step's next op, the rounding
              shift from Q(15) to Q(10) that reads its output

Prints the card's name and power limit, then one JSON line.  Nothing of
JAX or the JAX package is imported.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
N_CORES, N_SAMPLES, N_FEATURES = 2048, 6_291_456, 16
#: the LOG fit's Q format (LogRegConfig.frac_bits) and the table's
FRAC_BITS, VALUE_FRAC = 10, 15


def inputs(torch, cs) -> dict:
    from repro_torch.api import make_estimator, make_system
    from repro_torch.data.synthetic import make_classification
    from repro_torch.kernels import dispatch
    rng = np.random.RandomState(0)
    zs = {"main": torch.from_numpy(
        rng.randint(-30000, 30000, (N_CORES, N_SAMPLES // N_CORES))
        .astype(np.int32)).cuda()}
    X, y = make_classification(N_SAMPLES, N_FEATURES, seed=0)
    system = make_system("pim", n_cores=N_CORES, device="cuda")
    fit = cs.log_fit_z(dispatch, make_estimator, system.put(X, y))
    zs["fit_first"], zs["fit_last"] = fit["first"], fit["last"]
    return zs


def tree_times(torch, cs, zs, lut, flush) -> dict:
    from repro_torch.core.fixed_point import _shift_round
    from repro_torch.kernels.lut_activation import lut_sigmoid_cuda
    out = {}
    for name, z in zs.items():
        for pl in ("wram", "mram"):
            out[f"{name}_{pl}_ms"] = cs.cuda_ms(
                torch, lambda: lut_sigmoid_cuda(z, lut, pl), flush)
            out[f"{name}_{pl}_next_ms"] = cs.cuda_ms(
                torch, lambda: _shift_round(lut_sigmoid_cuda(z, lut, pl),
                                            VALUE_FRAC - FRAC_BITS), flush)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the source tree whose repro_torch is timed")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_lut_sigmoid: no CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as cs
    from repro_torch.core.lut import build_sigmoid_lut
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    lut = build_sigmoid_lut(device="cuda")
    zs = inputs(torch, cs)
    flush = cs.L2Flush(torch)
    out = {"src": args.src, "card": smi,
           **tree_times(torch, cs, zs, lut, flush)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
