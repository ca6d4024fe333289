"""Serving launcher: batched generation with the slot engine (port of
``repro.launch.serve``).  It serves ``get_config(arch).reduced()`` from
random weights drawn with seed 0 on the device; ``--arch`` takes every
config whose batches are tokens only.  The VLM and audio ids are refused:
``ServeEngine`` prefills with ``{"tokens": prompt}`` alone, as the
reference's does, so it cannot hand over their vision states or frames
(serve those through ``Model.prefill`` and ``Model.decode_step``).

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

On ``--device cuda`` (the default) prefill attention, sliding windows
included, runs the ``flash_attention`` kernel; on ``--device cpu`` its
plain version.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, EXTRAS_ARCH_IDS, get_config
from repro_torch.models.api import Model
from repro_torch.serve.engine import Request, ServeEngine


#: the ids ServeEngine can serve: their batches are tokens only
TOKENS_ONLY_ARCH_IDS = tuple(a for a in ARCH_IDS if a not in EXTRAS_ARCH_IDS)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=TOKENS_ONLY_ARCH_IDS,
                    help="a config whose batches are tokens only: ServeEngine"
                         " prefills with the prompt alone, so the VLM's "
                         "vision states and the audio family's frames have "
                         "no way in")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    model = Model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    engine = ServeEngine(model, params, n_slots=args.slots,
                         max_seq=args.max_seq)
    rng = np.random.RandomState(0)
    reqs = [Request(prompt=rng.randint(0, cfg.vocab_size,
                                       args.prompt_len).astype(np.int32),
                    max_new_tokens=args.max_new)
            for _ in range(args.requests)]
    t0 = time.perf_counter()
    out = engine.run(reqs)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.output) for r in out)
    print(f"served {len(out)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens / dt:.1f} tok/s) on {model.device}")
    for i, r in enumerate(out[:3]):
        print(f"req{i}: prompt={r.prompt[:8].tolist()}... "
              f"output={r.output[:12]}...")


if __name__ == "__main__":
    main()
