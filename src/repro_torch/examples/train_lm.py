"""End-to-end driver: train a ~100M-parameter LM for a few hundred steps.

The granite family at a ~100M reduced width (12 layers x 768, GQA 12
over 4 heads, vocab 8192), float32, on a Markov corpus with a known
entropy floor, with checkpoints every 100 steps and straggler
monitoring: the whole training stack.  The quantized linears and LUT
activations stay off, as in the reference's driver.  On ``cuda``
attention forward and backward run the ``flash_attention`` kernels.

  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] \\
      [--device cpu] [--ckpt-dir DIR]

Without ``--ckpt-dir`` the checkpoints go to a fresh temporary directory,
removed at the end, so a run never resumes from another run's
checkpoints; with it, a second run resumes from the last checkpoint
there.
"""
from __future__ import annotations

import tempfile

import numpy as np

from repro_torch.examples import parse, parser
from repro_torch.launch.train import train

#: ~100M params: 12 layers x 768 wide on the granite (dense GQA) family
ARCH = "granite-3-8b"
WIDTH = dict(d_model=768, n_layers=12, d_ff=2048, vocab_size=8192,
             n_heads=12, n_kv_heads=4, head_dim=64)


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory, resumed from when it holds "
                         "one (default: a fresh temporary directory)")
    args = parse(ap, argv)
    with tempfile.TemporaryDirectory(prefix="repro_torch_lm_ckpt_") as tmp:
        params, losses, corpus = train(
            ARCH, steps=args.steps, batch=args.batch, seq=args.seq,
            reduced=True, ckpt_dir=args.ckpt_dir or tmp, ckpt_every=100,
            lr=3e-3, quantize_dense=False, lut_activations=False,
            microbatches=2, overrides=WIDTH, device=args.device)
    floor = corpus.entropy_bound()
    print(f"\nfinal loss {losses[-1]:.3f} "
          f"(corpus entropy floor {floor:.3f}, "
          f"uniform would be {np.log(corpus.vocab):.3f})")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss must decrease: {losses[0]:.4f} -> "
                           f"{losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
