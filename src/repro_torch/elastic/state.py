"""Serializable trainer state: the rng half of the snapshot schema.

A snapshot is what a resumable trainer's ``fit_steps`` materializes at a
chunk boundary (``ChunkTick.snapshot()``): ``{"arrays": {name:
np.ndarray}, "meta": {json-able scalars}}`` — the same dict the
reference's trainers produce, so a snapshot taken from a ``repro`` fit
resumes here.  This module packs the MT19937 stream the minibatch draws
come from: the key vector travels in ``arrays``, the stream position in
``meta``, so a resumed minibatch SGD draws exactly the offsets an
uninterrupted fit would.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

_RNG_KEY = "rng_mt_keys"          # uint32[624] in arrays


def pack_rng(rng: np.random.RandomState) -> tuple[dict, dict]:
    """``(arrays, meta)`` fragments capturing the full MT19937 state."""
    kind, keys, pos, has_gauss, cached = rng.get_state()
    if kind != "MT19937":
        raise ValueError(f"expected an MT19937 RandomState, got {kind}")
    return ({_RNG_KEY: np.asarray(keys, np.uint32)},
            {"rng_pos": int(pos), "rng_has_gauss": int(has_gauss),
             "rng_cached_gaussian": float(cached)})


def unpack_rng(arrays: Mapping, meta: Mapping
               ) -> Optional[np.random.RandomState]:
    """Rebuild the RandomState a snapshot packed; None if it holds no
    rng (full-batch GD never draws, so its snapshots may omit it)."""
    keys = arrays.get(_RNG_KEY)
    if keys is None:
        return None
    rng = np.random.RandomState()
    rng.set_state(("MT19937", np.asarray(keys, np.uint32),
                   int(meta["rng_pos"]), int(meta["rng_has_gauss"]),
                   float(meta["rng_cached_gaussian"])))
    return rng
