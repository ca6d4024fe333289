"""Activation sharding constraints (port of
``repro.distributed.act_sharding``).

The reference's model calls ``constrain(x, kind)`` at well-known cut
points as hints to XLA's SPMD partitioner, and the launcher opts in by
setting the mesh via ``use_mesh`` (tests and single-device runs leave it
unset -> no-op).  In the port an eager tensor is local to its rank and no
partitioner reads a hint, so :func:`constrain` leaves a plain tensor as it
is and redistributes a DTensor to the cut point's spec.  The dense LM
calls it at the reference's cut points (``models/layers.py``,
``models/attention.py``, ``models/transformer.py``), so with its
parameters placed (``sharding.place_params``) it runs tensor-parallel.
The MoE's expert buffers take the "egcd" spec, the reference's "gecd" in
the port's ``[E, G * cap, d]`` layout (``models/moe.py``).
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional

import torch

from .sharding import P, placements, validate_divisibility

_STATE = threading.local()


def _dp(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


@contextlib.contextmanager
def use_mesh(mesh):
    """Set the mesh the model's cut points constrain to.  Inside, a plain
    tensor meeting a DTensor counts as replicated (positions, masks, the
    optimizer's step; DTensor's ``implicit_replication``, kept on for the
    backward too and restored on exit, so the contexts nest)."""
    from torch.distributed.tensor import DTensor
    prev = getattr(_STATE, "mesh", None)
    dispatcher = DTensor._op_dispatcher
    prev_implicit = dispatcher._allow_implicit_replication
    _STATE.mesh = mesh
    dispatcher._allow_implicit_replication = (mesh is not None
                                              or prev_implicit)
    try:
        yield
    finally:
        _STATE.mesh = prev
        dispatcher._allow_implicit_replication = prev_implicit


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
    if kind == "egcd":       # [E, G * cap, d]: the port's "gecd" buffers
        if ndim == 3:        # (models/moe.py), the experts leading
            return P("model", dp, None)
    if kind == "btv":        # [B, S, vocab] logits
        if ndim == 3:
            return P(dp, None, "model")
    if kind == "bdp":        # batch -> dp, everything else replicated
        return P(*((dp,) + (None,) * (ndim - 1)))
    return None


def constrain(x, kind: str):
    """``x`` unchanged when no mesh is set, the kind has no spec at its
    rank, or ``x`` is a plain tensor; a DTensor redistributed to the spec
    (axes that do not divide dropped), and its gradient too, as XLA
    constrains the cotangent of ``with_sharding_constraint``."""
    from torch.distributed.tensor import DTensor
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = _spec_for(kind, x.ndim, mesh)
    if spec is None:
        return x
    spec = validate_divisibility(spec, x.shape, mesh)
    return _Constrain.apply(x, tuple(placements(spec, mesh)))


class _Constrain(torch.autograd.Function):
    """Redistribute to ``pl`` in the forward and the gradient to ``pl``
    in the backward (``DTensor.redistribute``'s own backward returns the
    gradient to the input's placements)."""

    @staticmethod
    def forward(ctx, x, pl):
        ctx.pl = pl
        return x.redistribute(placements=pl)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(placements=ctx.pl), None
