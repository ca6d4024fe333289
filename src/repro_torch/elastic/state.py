"""Serializable trainer state: the rng half of the snapshot schema.

A snapshot is what a resumable trainer's ``fit_steps`` materializes at a
chunk boundary (``ChunkTick.snapshot()``): ``{"arrays": {name:
np.ndarray}, "meta": {json-able scalars}}`` — the same dict the
reference's trainers produce, so a snapshot taken from a ``repro`` fit
resumes here.  This module packs the MT19937 stream the minibatch draws
come from: the key vector travels in ``arrays``, the stream position in
``meta``, so a resumed minibatch SGD draws exactly the offsets an
uninterrupted fit would.

It also holds the snapshot schema's version and the cross-System
migration rule: which execution targets a checkpoint taken on one
System kind may resume on.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

#: snapshot schema version; bumped on incompatible layout changes and
#: validated on restore (the reference's, so snapshots cross packages)
SCHEMA_VERSION = 1

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


# ---------------------------------------------------------------------------
# Migration compatibility.
# ---------------------------------------------------------------------------

#: fp32 versions per workload: float carries migrate across System kinds
#: (to a tolerance: reduction order and sigmoid flavour differ between
#: PIM and a processor-centric target); every other version is fixed
#: point and resumes bit-exactly only on a numerically-like target
_FLOAT_VERSIONS = ("fp32",)

#: System kinds whose execution is numerically identical: the modeled GPU
#: is HostSystem execution with a roofline price, so checkpoints move
#: freely between them
_LIKE_KINDS = {
    "host": {"host", "gpu-model"},
    "gpu-model": {"host", "gpu-model"},
    "pim": {"pim"},
}


def migration_ok(from_kind: str, to_kind: str, version: str) -> bool:
    """May a ``version`` checkpoint taken on ``from_kind`` resume on
    ``to_kind``?  Same kind always; float carries anywhere (tolerance,
    not bit-identity); integer carries only between numerically-like
    kinds."""
    if from_kind == to_kind:
        return True
    if version in _FLOAT_VERSIONS:
        return True
    return to_kind in _LIKE_KINDS.get(from_kind, {from_kind})


def check_migration(from_kind: str, to_kind: str, version: str) -> None:
    if not migration_ok(from_kind, to_kind, version):
        raise ValueError(
            f"cannot resume a {version!r} checkpoint taken on "
            f"{from_kind!r} on a {to_kind!r} target: fixed-point "
            f"carries are only bit-valid on numerically-like systems; "
            f"fp32 jobs may migrate freely")


def snapshot_iters(state: Optional[Mapping]) -> int:
    """Trainer iterations a snapshot covers (0 for None: a restart)."""
    if not state:
        return 0
    return int(state.get("meta", {}).get("iters", 0))
