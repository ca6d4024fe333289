"""EMB walkthrough: bank-sharded embedding tables and deferred updates.

A dot-product embedding model over Zipf-skewed (user, item, rating)
triples, with the embedding tables row-sharded across the PIM banks
(``System.put_table`` -> ShardedTable) and the LazyDP-style deferred
schedule: sparse gradients stage host-side and flush every D batches as
one deduplicated scatter-add.  The walkthrough shows:

  1. eager vs deferred training: the same quality, a fraction of the
     sparse-update traffic (``TransferStats.flush_bytes``);
  2. the D=1 identity: a one-batch window is bit-identical to eager;
  3. an int8 + error-feedback compressed flush (``compress_flush``);
  4. the int32 fixed-point version next to fp32 through the registry.

  PYTHONPATH=src python -m repro_torch.examples.emb_recsys [--device cpu]
"""
from __future__ import annotations

import numpy as np

from repro_torch.api import make_estimator, make_system
from repro_torch.data.synthetic import make_recsys
from repro_torch.emb import EmbConfig, fit
from repro_torch.examples import parse, parser, sections


def _pim(device):
    return make_system("pim", n_cores=16, device=device)


def _common(n_iters):
    return dict(n_iters=n_iters, batch=256, dim=8, lr=1.0, frac_bits=12,
                seed=1, record_every=n_iters)


def stream(*, n_samples=8192, n_users=256, n_items=192):
    """The Zipf-skewed ratings.  Returns ``(X, y)``."""
    X, y = make_recsys(n_samples, n_users=n_users, n_items=n_items, dim=8,
                       zipf_a=1.2, seed=0)
    print(f"recsys stream: {len(X)} (user, item, rating) triples, "
          f"vocab {n_users}x{n_items}, Zipf-skewed ids\n")
    return X, y


def eager_vs_deferred(device, X, y, *, n_iters=160):
    print("eager vs deferred (int32/Q12, 16 cores):")
    for label, D in (("eager (D=1)", 1), ("deferred D=8", 8)):
        pim = _pim(device)
        res = fit(pim.put(X, y), EmbConfig(version="int32", flush_every=D,
                                           **_common(n_iters)))
        print(f"  {label:14s}: final MSE {res.history[-1][1]:.5f}, "
              f"flush traffic {pim.stats.flush_bytes / 1024:.0f} KiB "
              f"({res.n_flushes} flushes)")


def identity(device, X, y, *, n_iters=160):
    print("\nthe D=1 identity (staged-and-flushed == eager, bitwise):")
    outs = []
    for deferred in (False, True):
        pim = _pim(device)
        outs.append(fit(pim.put(X, y),
                        EmbConfig(version="int32", flush_every=1,
                                  deferred=deferred, **_common(n_iters))))
    same = np.array_equal(outs[0].user_raw, outs[1].user_raw) \
        and np.array_equal(outs[0].item_raw, outs[1].item_raw)
    print(f"  tables bit-identical: {same}")


def compressed(device, X, y, *, n_iters=160):
    print("\ncompressed flush (int8 rows + error feedback):")
    pim = _pim(device)
    res = fit(pim.put(X, y), EmbConfig(version="int32", flush_every=8,
                                       compress_flush=True,
                                       **_common(n_iters)))
    print(f"  final MSE {res.history[-1][1]:.5f}, wire "
          f"{pim.stats.compressed_bytes / 1024:.0f} KiB vs logical "
          f"{pim.stats.flush_bytes / 1024:.0f} KiB")


def registry(device, X, y, *, n_iters=160):
    print("\nthe registry surface (same estimator API as LIN/LOG/KME):")
    for ver in ("fp32", "int32"):
        pim = _pim(device)
        est = make_estimator("emb", version=ver, flush_every=8, system=pim,
                             **_common(n_iters))
        est.fit(pim.put(X, y))
        print(f"  emb/{ver:5s}: R^2 = {est.score(X, y):.4f}")


def run(device, **sizes):
    """The walkthrough on ``device``; ``sizes`` maps a section's name to
    its keyword arguments (the reference's sizes where absent)."""
    data, *fits = sections(sizes, "stream", "eager_vs_deferred", "identity",
                           "compressed", "registry")
    print("=== EMB: embedding training on bank-sharded tables ===\n")
    X, y = stream(**data)
    for section, kw in zip((eager_vs_deferred, identity, compressed,
                            registry), fits):
        section(device, X, y, **kw)


def main(argv=None):
    run(parse(parser(__doc__), argv).device)


if __name__ == "__main__":
    main()
