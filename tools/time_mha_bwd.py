#!/usr/bin/env python3
"""Time the attention kernels of LM training and serving for the port in
the source tree that ``--src`` names, so that two trees compare within one
call on one card.

    python3 tools/time_mha_bwd.py [--src DIR]

``--src`` defaults to this checkout's ``src/``; the kernels are built from
that tree's ``csrc/``.  Each time is ``chip_smoke.py``'s: the median of
TIMING_RUNS CUDA-event timings, each after its reading L2 flush.

  bwd_ms        ``mha_bwd_cuda`` at phase 10's shape: bf16 q ``[8, 32,
                1024, 128]`` over 16 KV heads, causal, as ``_project_qkv``'s
                transposed views
  fwd_bwd_ms    ``mha`` forward + backward through autograd at that shape
  train_fwd_ms  ``mha_cuda`` with ``with_lse=True`` at that shape
  serve_fwd_ms  ``mha_cuda`` at the serve load's longest prompt: ``[1, 32,
                963, 128]`` over 16 KV heads

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


def qkvg(torch, b, hq, hkv, s, d=128):
    """q, k, v and dout drawn on the card, [B, S, H, D] seen as [B, H, S,
    D]."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    return [torch.randn((b, s, h, d), generator=gen, device="cuda")
            .to(torch.bfloat16).transpose(1, 2) for h in (hq, hkv, hkv, hq)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the source tree whose repro_torch is timed")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_mha_bwd: no CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import (mha, mha_bwd_cuda,
                                                     mha_cuda)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    flush = cs.L2Flush(torch)
    q, k, v, dout = qkvg(torch, cs.TRAIN_BATCH, 32, 16, cs.TRAIN_SEQ)
    out, lse = mha_cuda(q, k, v, with_lse=True)
    res = {"src": args.src,
           "bwd_ms": cs.cuda_ms(
               torch, lambda: mha_bwd_cuda(q, k, v, out, dout, lse), flush),
           "train_fwd_ms": cs.cuda_ms(
               torch, lambda: mha_cuda(q, k, v, with_lse=True), flush)}
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    res["fwd_bwd_ms"] = cs.cuda_ms(torch, lambda: torch.autograd.grad(
        mha(qg, kg, vg), (qg, kg, vg), dout), flush)
    del q, k, v, dout, out, lse, qg, kg, vg
    q, k, v, _ = qkvg(torch, 1, 32, 16, 963)
    res["serve_fwd_ms"] = cs.cuda_ms(torch, lambda: mha_cuda(q, k, v),
                                     flush)
    res["card"] = smi
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
