"""Pipeline parallelism (GPipe-style) over a mesh "stage" axis (port of
``repro.distributed.pipeline``).

The layer stack is split into contiguous stages, one a rank of the stage
axis; microbatches flow from stage to stage by ``send``/``recv``.  Each
hop is a ``torch.autograd.Function`` whose backward sends the gradient
the other way, so ``backward()`` through :func:`pipeline_apply` runs
GPipe's backward schedule with no hand-written backward pass (the
reference gets the same from ``ppermute``'s transpose).

Scope: the embedding and LM head stay outside the pipelined region; the
pipeline carries the residual stream [B_mb, S, d] (``block_fn`` keeps its
shape).  Bubble fraction is the standard (n_stages - 1) / (n_micro +
n_stages - 1).  The reference's tick loop computes and masks the bubble
slots; here a stage simply waits for its next microbatch, with the same
outputs.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from . import collectives


def split_stages(stacked_params, n_stages: int):
    """(reps, ...) leaves -> (n_stages, reps//n_stages, ...), over a dict
    (nested dicts too) of tensors."""
    if isinstance(stacked_params, dict):
        return {k: split_stages(v, n_stages) for k, v in
                stacked_params.items()}
    reps = stacked_params.shape[0]
    if reps % n_stages:
        raise ValueError(f"{reps} layers do not split into {n_stages} "
                         f"stages")
    return stacked_params.reshape(n_stages, reps // n_stages,
                                  *stacked_params.shape[1:])


class _Send(torch.autograd.Function):
    """Forward: send ``h`` to ``dst``, return a scalar token that carries
    the graph.  Backward: receive ``h``'s gradient from ``dst``."""

    @staticmethod
    def forward(ctx, h, dst, group):
        ctx.dst, ctx.group = dst, group
        ctx.like = (h.shape, h.dtype, h.device)
        collectives.send(h, dst, group)
        return h.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device = ctx.like
        like = torch.empty(shape, dtype=dtype, device=device)
        return collectives.recv(like, ctx.dst, ctx.group), None, None


class _Recv(torch.autograd.Function):
    """Forward: receive an activation like ``like`` from ``src``.
    Backward: send its gradient back to ``src``."""

    @staticmethod
    def forward(ctx, anchor, like, src, group):
        ctx.src, ctx.group = src, group
        return collectives.recv(like, src, group)

    @staticmethod
    def backward(ctx, grad):
        collectives.send(grad, ctx.src, ctx.group)
        return None, None, None, None


class _HandOut(torch.autograd.Function):
    """Forward: the last stage's ``outs`` broadcast to every rank of the
    stage group (elsewhere ``outs`` gives the shape only).  Backward: the
    last stage keeps its own gradient only; every rank computed the same
    loss on the same outputs, so summing the ranks' gradients would count
    it W times.  Elsewhere the gradient is dropped, and ``carry`` (the
    rank's send tokens) gets zero, which runs the sends' backward."""

    @staticmethod
    def forward(ctx, carry, outs, src, group, is_last):
        ctx.is_last = is_last
        ctx.carry_shape = carry.shape
        out = outs.clone() if is_last else torch.empty_like(outs)
        return collectives.broadcast(out, src, group)

    @staticmethod
    def backward(ctx, grad):
        zero = grad.new_zeros(ctx.carry_shape)
        return zero, (grad if ctx.is_last else None), None, None, None


def pipeline_apply(mesh, stage_axis: str, block_fn: Callable,
                   stage_params, x_micro: torch.Tensor) -> torch.Tensor:
    """Run ``block_fn(stage_params, x) -> x`` over all stages.

    stage_params: this rank's stage (leaves (layers_per_stage, ...); the
                  slice ``[stage]`` of :func:`split_stages`' output).
    x_micro:      (n_micro, B_mb, S, d) microbatches, the same on every
                  rank (stage 0 reads them).
    Returns (n_micro, B_mb, S, d), the last stage's outputs, on every rank.
    """
    group = mesh.get_group(stage_axis)
    n_stages, stage = dist.get_world_size(group), dist.get_rank(group)
    last = n_stages - 1

    def peer(s: int) -> int:
        return dist.get_global_rank(group, s)
    anchor = x_micro.new_zeros((), requires_grad=torch.is_grad_enabled())
    outs, tokens = [], []
    for m in range(x_micro.shape[0]):
        h = x_micro[m] if stage == 0 else _Recv.apply(
            anchor, x_micro[m], peer(stage - 1), group)
        h = block_fn(stage_params, h)
        if stage < last:
            tokens.append(_Send.apply(h, peer(stage + 1), group))
        else:
            outs.append(h)
    if stage == last:
        y, carry = torch.stack(outs), anchor
    else:
        y, carry = x_micro, torch.stack(tokens).sum()
    return _HandOut.apply(carry, y, peer(last), group, stage == last)


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
