"""AdamW and SGD (port of ``repro.optim.adam``).

Parameters are a :class:`~repro_torch.models.layers.Params` tree, updated
in place under ``torch.no_grad()`` on their device (the reference returns
new arrays; in place saves a copy of the model).  Gradients are a dict from
the tree's ``named_parameters()`` names to tensors.  Moments are float32
whatever the parameter dtype, and the update casts back to it.

On sharded parameters each leaf's update is computed where its moments
lie (ZeRO-1: the parameter's split plus the data axes) and gathered back
through ``tp.redistribute``.

The global-norm clip sums the squared gradients in the reference's leaf
order (``jax.tree_util.tree_leaves``: dict keys sorted, the scanned layers
stacked into one leaf per name), layer by layer within a leaf.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


class AdamState(NamedTuple):
    step: torch.Tensor   # int32 scalar on the parameters' device
    m: dict              # name -> float32 first moment
    v: dict              # name -> float32 second moment


def _stacked_key(name: str) -> tuple:
    """A port leaf name as the path of the reference's stacked leaf and the
    layer it holds: ``layers.3.attn.wq`` -> ``(("unit", "attn", "wq"),
    3)``; a leaf outside the layers is its own path."""
    parts = name.split(".")
    if parts[0] == "layers":
        return ("unit",) + tuple(parts[2:]), int(parts[1])
    return tuple(parts), 0


def leaf_order(names) -> list:
    """``names`` in the reference's ``tree_leaves`` order, layers of one
    stacked leaf in layer order."""
    return sorted(names, key=_stacked_key)


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt(sum of every squared gradient element + 1e-12), float32, the
    squares summed leaf by leaf in :func:`leaf_order`.  A sharded leaf's
    sum is reduced over its shards (one all-reduce a leaf), so every rank
    sums the same leaf totals in the same order."""
    from ..distributed.tp import full_tensor
    total = None
    for name in leaf_order(grads):
        sq = full_tensor(torch.sum(torch.square(
            grads[name].to(torch.float32))))
        total = sq if total is None else total + sq
    return torch.sqrt(total + 1e-12)


def _laid_out(t, like):
    """``t`` laid out as the DTensor ``like`` (``tp.redistribute``: ZeRO-1
    moments split over the data axes where the parameter is not take a
    local slice of it, and the update gathers back through the port's
    collectives); as it is otherwise."""
    from ..distributed.tp import redistribute
    from ..kernels.dispatch import is_dtensor
    if is_dtensor(t) and is_dtensor(like) and t.placements != like.placements:
        return redistribute(t, like.placements)
    return t


def _step_tensor(params) -> torch.Tensor:
    """The int32 step, a plain tensor on the parameters' device."""
    p = next(params.parameters())
    return torch.zeros((), dtype=torch.int32,
                       device=getattr(p, "_local_tensor", p).device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0

    def init(self, params) -> AdamState:
        """Zero moments laid out as the parameters (``zeros_like``: a
        DTensor leaf's moments are DTensors of its placements)."""
        m = {n: torch.zeros_like(p, dtype=torch.float32,
                                 requires_grad=False)
             for n, p in params.named_parameters()}
        return AdamState(step=_step_tensor(params), m=m,
                         v={n: t.clone() for n, t in m.items()})

    def init_shapes(self, param_shapes: dict) -> AdamState:
        """The state's shapes as meta tensors, from ``param_shapes``
        (``Model.param_shapes``)."""
        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")
        m = {n: meta(p.shape, torch.float32) for n, p in param_shapes.items()}
        return AdamState(step=meta((), torch.int32), m=m, v=dict(m))

    def update(self, grads: dict, state: AdamState, params):
        """One step: ``(params, state, grad_norm)``; params, m and v are
        updated in place.  ``b1 ** t`` and ``b2 ** t`` are float32 with
        ``t`` a float32 tensor, as JAX computes them."""
        with torch.no_grad():
            step = state.step + 1
            scale = None
            if self.grad_clip:
                gnorm = global_norm(grads)
                # a tensor numerator: float / tensor would multiply by the
                # reciprocal
                scale = torch.clamp(gnorm.new_tensor(self.grad_clip) / gnorm,
                                    max=1.0)
            else:
                gnorm = torch.zeros((), dtype=torch.float32,
                                    device=step.device)
            t = step.to(torch.float32)
            bc1 = 1 - self.b1 ** t
            bc2 = 1 - self.b2 ** t
            # one leaf at a time: float32 copies of every gradient at once
            # would hold twice the moments' memory
            for name, p in params.named_parameters():
                m, v = state.m[name], state.v[name]
                g = _laid_out(grads[name], m).to(torch.float32)
                if scale is not None:
                    g = g * scale
                m.mul_(self.b1).add_((1 - self.b1) * g)
                v.mul_(self.b2).add_((1 - self.b2) * g * g)
                u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
                w = _laid_out(p.detach(), m).to(torch.float32)
                if self.weight_decay:
                    u = u + self.weight_decay * w
                p.copy_(_laid_out((w - self.lr * u).to(p.dtype), p))
        return params, AdamState(step=step, m=state.m, v=state.v), gnorm


@dataclasses.dataclass(frozen=True)
class SGD:
    """Plain SGD (the paper's host-side update rule for LIN/LOG)."""
    lr: float = 0.1

    def init(self, params) -> AdamState:
        return AdamState(step=_step_tensor(params), m={}, v={})

    def update(self, grads: dict, state: AdamState, params):
        with torch.no_grad():
            for name, p in params.named_parameters():
                p.copy_((p.to(torch.float32) - self.lr
                         * grads[name].to(torch.float32)).to(p.dtype))
            gnorm = torch.zeros((), dtype=torch.float32,
                                device=state.step.device)
        return params, AdamState(step=state.step + 1, m={}, v={}), gnorm
