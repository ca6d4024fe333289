"""Batched serving: slot-based continuous batching over a reduced LM.

The reduced qwen3-8b from random weights drawn with seed 0 on the
device (``Model.init``), 8 requests over 4 slots through
``ServeEngine``.  On ``cuda`` every prefill's attention runs the
``flash_attention`` kernel.

  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.examples import parse, parser
from repro_torch.models.api import Model
from repro_torch.serve.engine import Request, ServeEngine


def serve(model, params, *, n_slots=4, max_seq=96):
    """Serve the 8 seeded requests; returns the finished requests."""
    engine = ServeEngine(model, params, n_slots=n_slots, max_seq=max_seq)
    rng = np.random.RandomState(0)
    requests = [
        Request(prompt=rng.randint(0, model.cfg.vocab_size, 12)
                .astype(np.int32), max_new_tokens=16 + 4 * i)
        for i in range(8)
    ]
    t0 = time.perf_counter()
    done = engine.run(requests)
    dt = time.perf_counter() - t0
    total = sum(len(r.output) for r in done)
    print(f"served {len(done)} requests / {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s on {model.device.type.upper()})")
    for i, r in enumerate(done[:4]):
        print(f"  req{i}: {len(r.output)} tokens -> {r.output[:10]}...")
    if not all(r.done for r in done):
        raise RuntimeError("a request did not finish")
    return done


def main(argv=None):
    args = parse(parser(__doc__), argv)
    model = Model(get_config("qwen3-8b").reduced(), device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    return serve(model, params)


if __name__ == "__main__":
    main()
