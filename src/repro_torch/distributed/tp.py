"""Tensor-parallel products of the LM stack: ``x @ w`` with a DTensor
weight, computed shard by shard with fixed placements (Megatron's
column- and row-parallel linears), forward and backward.

DTensor's own ``mm`` rule picks placements by a cost model and may gather
a weight to keep an activation split (it did, in the backward of every
projection, in the dry-run's first traces).  :class:`ShardedMatmul` never
moves ``w``: on each mesh dim

  =================  ==============  ===============  =============
  w                  x is moved to   out              grad of w
  =================  ==============  ===============  =============
  ``Shard(1)``       ``Replicate``   ``Shard(-1)``    ``Shard(1)``
  ``Shard(0)``       ``Shard(-1)``   ``Partial``      ``Shard(0)``
  ``Replicate``      rows split or   as x             ``Partial`` /
                     replicated                       ``Replicate``
  =================  ==============  ===============  =============

so the only collectives are the activations' (and the gradients'
reductions, which ``train/loop.py::to_param_layout`` makes).
:class:`VocabParallelNll` is the loss on vocab-split logits, likewise
shard by shard.
"""
from __future__ import annotations

import math

import torch

from .collectives import reduce_over


def _x_placements(x, w) -> list:
    from torch.distributed.tensor import Replicate, Shard
    last = x.ndim - 1
    out = []
    for px, pw in zip(x.placements, w.placements):
        if pw.is_shard(0):
            out.append(Shard(last))
        elif pw.is_shard(1) or px.is_partial() or px.is_shard(last):
            out.append(Replicate())
        else:
            out.append(px)
    return out


def _out_placements(xp: list, w, ndim: int) -> list:
    from torch.distributed.tensor import Partial, Shard
    return [Shard(ndim - 1) if pw.is_shard(1) else Partial()
            if pw.is_shard(0) else px for px, pw in zip(xp, w.placements)]


class ShardedMatmul(torch.autograd.Function):
    """``x @ w.to(x.dtype)`` of DTensors, shard by shard (module
    docstring)."""

    @staticmethod
    def forward(ctx, x, w):
        from torch.distributed.tensor import DTensor
        xp = _x_placements(x, w)
        if list(x.placements) != xp:
            x = x.redistribute(placements=xp)
        outp = _out_placements(xp, w, x.ndim)
        xl, wl = x.to_local(), w.to_local()
        ctx.save_for_backward(xl, wl)
        ctx.meta = (x.device_mesh, xp, outp, list(w.placements), w.dtype)
        return DTensor.from_local(xl @ wl.to(xl.dtype), x.device_mesh, outp,
                                  run_check=False)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        xl, wl = ctx.saved_tensors
        mesh, xp, outp, wp, w_dtype = ctx.meta
        gp = [Replicate() if p.is_partial() else p for p in outp]
        if list(grad.placements) != gp:
            grad = grad.redistribute(placements=gp)
        gl = grad.to_local()
        gx = gl @ wl.to(gl.dtype).t()
        gw = xl.reshape(-1, xl.shape[-1]).t() @ gl.reshape(-1, gl.shape[-1])
        gxp = [Partial() if pw.is_shard(1) else px
               for px, pw in zip(xp, wp)]
        gwp = [pw if not pw.is_replicate() else
               Partial() if px.is_shard() else Replicate()
               for px, pw in zip(xp, wp)]
        return (DTensor.from_local(gx, mesh, gxp, run_check=False),
                DTensor.from_local(gw.to(w_dtype), mesh, gwp,
                                   run_check=False))


def matmul(x, w):
    """``x @ w`` in x's dtype; with a DTensor weight, shard by shard
    (:class:`ShardedMatmul`)."""
    from ..kernels.dispatch import is_dtensor
    if is_dtensor(w):
        return ShardedMatmul.apply(x, w)
    return x @ w.to(x.dtype)


def mesh_groups(dt, dim_of) -> list:
    """The process groups of ``dt``'s mesh dims whose placement
    ``dim_of`` picks."""
    mesh = dt.device_mesh
    return [mesh.get_group(i) for i, p in enumerate(dt.placements)
            if dim_of(p)]


class VocabParallelNll(torch.autograd.Function):
    """Mean next-token cross-entropy of vocab-split logits (a DTensor
    ``[B, S, Vpad]``, the vocab over "model", the rows over the data
    axes), computed on each rank's columns: max, sum of exponentials and
    the gold logit reduced over the vocab ranks, the sum over the data
    ranks (Megatron's parallel cross-entropy; the logits are never
    gathered).  Padded columns (``>= vocab``) count as -1e30.  Returns a
    plain float32 scalar, the same on every rank.  PyTorch's
    ``loss_parallel`` computes the same loss but, in torch 2.11, takes a
    one-dimensional mesh only, and the LM's is ("data", "model")."""

    @staticmethod
    def forward(ctx, logits, targets, vocab: int):
        last = logits.ndim - 1
        splits = [i for i, p in enumerate(logits.placements)
                  if p.is_shard(last)]
        if len(splits) > 1:
            raise ValueError(f"vocab split over {len(splits)} mesh dims")
        vgroups = mesh_groups(logits, lambda p: p.is_shard(last))
        bgroups = mesh_groups(logits, lambda p: p.is_shard(0))
        x = logits.to_local().to(torch.float32)
        t = getattr(targets, "_local_tensor", targets).long()
        width = x.shape[-1]
        off = (logits.device_mesh.get_coordinate()[splits[0]] * width
               if splits else 0)
        cols = off + torch.arange(width, device=x.device)
        x = x.masked_fill(cols >= vocab, -1e30)
        m = reduce_over(torch.amax(x, dim=-1), "max", vgroups)
        se = reduce_over(torch.sum(torch.exp(x - m[..., None]), dim=-1),
                         "sum", vgroups)
        logz = m + torch.log(se)
        inside = (t >= off) & (t < off + width)
        idx = (t - off).clamp(0, width - 1)
        gold = torch.gather(x, -1, idx[..., None])[..., 0] * inside
        gold = reduce_over(gold, "sum", vgroups)
        n = t.numel() * math.prod(logits.device_mesh.size(i) for i, p in
                                  enumerate(logits.placements)
                                  if p.is_shard(0))
        total = reduce_over(torch.sum(logz - gold), "sum", bgroups)
        ctx.save_for_backward(x, logz, idx, inside)
        ctx.meta = (logits.device_mesh, logits.placements, logits.dtype, n)
        return total / n

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor
        x, logz, idx, inside = ctx.saved_tensors
        mesh, placements, dtype, n = ctx.meta
        p = torch.exp(x - logz[..., None])
        p.scatter_add_(-1, idx[..., None], -inside[..., None].to(p.dtype))
        g = getattr(grad, "_local_tensor", grad)
        return (DTensor.from_local((p * (g / n)).to(dtype), mesh,
                                   placements, run_check=False),
                None, None)


def full_tensor(t):
    """A DTensor's whole value on every rank, a plain tensor outside
    autograd (a plain tensor as it is): each split mesh dim gathered (innermost first),
    each partial one reduced, through ``collectives.all_gather`` and
    :func:`reduce_over`, which copy a CUDA tensor through host memory
    under gloo (DTensor's own ``full_tensor`` gathers on the device, and
    torch 2.11's gloo killed the process gathering bf16 CUDA tensors)."""
    from ..kernels.dispatch import is_dtensor
    from .collectives import all_gather
    if not is_dtensor(t):
        return t
    mesh, local = t.device_mesh, t.to_local().detach()
    for i in reversed(range(mesh.ndim)):
        p, group = t.placements[i], mesh.get_group(i)
        if p.is_shard():
            local = all_gather(local.movedim(p.dim, 0), group) \
                .movedim(0, p.dim)
        elif p.is_partial():
            local = reduce_over(local, p.reduce_op, [group])
    return local.contiguous()
