"""Activation sharding constraints (port of
``repro.distributed.act_sharding``).

The reference's model calls ``constrain(x, kind)`` at well-known cut
points as hints to XLA's SPMD partitioner, and the launcher opts in by
setting the mesh via ``use_mesh`` (tests and single-device runs leave it
unset -> no-op).  In the port an eager tensor is local to its rank and no
partitioner reads a hint, so :func:`constrain` leaves a plain tensor as it
is and redistributes a DTensor to the cut point's spec.  The model's call
sites wait for tensor-parallel execution (ROADMAP queue 1 item 12d).
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional

from .sharding import P, placements, validate_divisibility

_STATE = threading.local()


def _dp(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


@contextlib.contextmanager
def use_mesh(mesh):
    prev = getattr(_STATE, "mesh", None)
    _STATE.mesh = mesh
    try:
        yield
    finally:
        _STATE.mesh = prev


def current_mesh():
    return getattr(_STATE, "mesh", None)


#: sequence parallelism (Korthikanti et al.): shard the residual stream's
#: sequence dim over "model" between blocks — norms/elementwise compute
#: shard 16x and the per-layer activation all-reduce splits into
#: reduce-scatter + all-gather (overlappable).  §Perf experiment knob.
SEQ_PARALLEL = os.environ.get("REPRO_SEQ_PARALLEL", "0") == "1"


#: cut-point -> spec builder (ndim-aware)
def _spec_for(kind: str, ndim: int, mesh) -> Optional[tuple]:
    dp = _dp(mesh)
    if kind == "btd":        # [B, S, d] residual stream
        if ndim == 3:
            return P(dp, "model", None) if SEQ_PARALLEL else \
                P(dp, None, None)
    if kind == "bhsd":       # [B, H, S, hd] attention heads
        if ndim == 4:
            return P(dp, "model", None, None)
    if kind == "btf":        # [B, S, ffn] mlp hidden
        if ndim == 3:
            return P(dp, None, "model")
    if kind == "ecd":        # [E, cap, d] moe expert inputs/outputs
        if ndim == 3:
            return P("model", None, None)
    if kind == "gecd":       # [G, E, cap, d] group-local moe buffers
        if ndim == 4:
            return P(dp, "model", None, None)
    if kind == "btv":        # [B, S, vocab] logits
        if ndim == 3:
            return P(dp, None, "model")
    if kind == "bdp":        # batch -> dp, everything else replicated
        return P(*((dp,) + (None,) * (ndim - 1)))
    return None


def constrain(x, kind: str):
    """``x`` unchanged when no mesh is set, the kind has no spec at its
    rank, or ``x`` is a plain tensor; a DTensor redistributed to the spec
    (axes that do not divide dropped)."""
    from torch.distributed.tensor import DTensor
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = _spec_for(kind, x.ndim, mesh)
    if spec is None:
        return x
    spec = validate_divisibility(spec, x.shape, mesh)
    return x.redistribute(mesh, placements(spec, mesh))
