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

The MoE adds :class:`ExpertMatmul` (each rank multiplies its own
experts' buffers), :class:`GatherSame` and :class:`SumGrad` (a
replicated computation's gather and a local one's gradient sum), and
FSDP (:func:`gathered`, :class:`FsdpGather`: a weight split over the
data axes gathered for its use, its gradient reduced and scattered
back).  :func:`redistribute` moves a DTensor between layouts through
``collectives``' functional collectives (staged through host memory
where gloo needs it), in place of DTensor's own ``redistribute``.
The recurrent mixers (``models/ssm.py``) run on local shards between
:class:`Gather`, :class:`Scatter` and :class:`Reduce`: the same
collectives, differentiable, for work of which each rank does its own
share.
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
    autograd (a plain tensor as it is), through :func:`redistribute`,
    which copies a CUDA tensor through host memory under gloo (DTensor's
    own ``full_tensor`` gathers on the device, and torch 2.11's gloo
    killed the process gathering bf16 CUDA tensors)."""
    from torch.distributed.tensor import Replicate
    from ..kernels.dispatch import is_dtensor
    if not is_dtensor(t):
        return t
    t = t.detach()
    return redistribute(t, [Replicate()] * t.device_mesh.ndim) \
        .to_local().contiguous()


def redistribute(t, placements):
    """The DTensor ``t`` laid out by ``placements``, through
    ``collectives``' functional collectives, each staged through host
    memory where the backend needs it (DTensor's own ``redistribute``
    calls gloo's reduce-scatter and all-gather on CUDA tensors, which
    its backend table does not list).  On each mesh dim: a split
    gathered (innermost mesh dim first), a partial sum reduced, or
    reduced and scattered, to a split (outermost first), a replicated
    dim sliced to its split.  Not differentiable: the autograd functions
    below call it.  Replicate to Partial is refused."""
    from torch.distributed.tensor import DTensor, Replicate
    from .collectives import gather_over, reduce_scatter_over
    mesh, want = t.device_mesh, list(placements)
    cur, local = list(t.placements), t.to_local()
    if cur == want:
        return t
    coord = mesh.get_coordinate()
    for i in reversed(range(mesh.ndim)):
        if cur[i].is_shard() and cur[i] != want[i]:
            local = gather_over(local, cur[i].dim, [mesh.get_group(i)])
            cur[i] = Replicate()
    for i in range(mesh.ndim):
        if cur[i] == want[i]:
            continue
        group = mesh.get_group(i)
        if cur[i].is_partial() and want[i].is_shard():
            local = reduce_scatter_over(local, want[i].dim, [group])
        elif cur[i].is_partial() and want[i].is_replicate():
            local = reduce_over(local, cur[i].reduce_op, [group])
        elif cur[i].is_replicate() and want[i].is_shard():
            local = local.chunk(mesh.size(i), dim=want[i].dim)[coord[i]] \
                .clone()
        else:
            raise ValueError(f"cannot lay {t.placements} out as {want}")
    return DTensor.from_local(local, mesh, want, run_check=False,
                              shape=t.shape, stride=t.stride())


def data_split(w) -> list:
    """The mesh dims of the data axes ("pod", "data") that the DTensor
    ``w`` is split over: FSDP's."""
    names = w.device_mesh.mesh_dim_names
    return [i for i, p in enumerate(w.placements)
            if p.is_shard() and names[i] in ("pod", "data")]


class FsdpGather(torch.autograd.Function):
    """A weight split over the data axes (FSDP, ``param_shardings_fsdp``)
    gathered over them for its use, its other placements kept; the
    gradient reduced and scattered back to the weight's own layout
    (ZeRO-3)."""

    @staticmethod
    def forward(ctx, w):
        from torch.distributed.tensor import Replicate
        ctx.placements = list(w.placements)
        split = data_split(w)
        return redistribute(w, [Replicate() if i in split else p
                                for i, p in enumerate(w.placements)])

    @staticmethod
    def backward(ctx, grad):
        return redistribute(grad, ctx.placements)


class _Gathered:
    """A read view of a :class:`~repro_torch.models.layers.Params` group
    whose leaves split over the data axes are gathered (:class:`FsdpGather`)
    when first read, once for the view; sub-groups are views too, layer
    lists are returned as they are."""

    __slots__ = ("_group", "_memo")

    def __init__(self, group):
        self._group, self._memo = group, {}

    def __getitem__(self, name: str):
        if name not in self._memo:
            from ..kernels.dispatch import is_dtensor
            value = self._group[name]
            if isinstance(value, torch.nn.Module) and \
                    not isinstance(value, torch.nn.ModuleList):
                value = _Gathered(value)
            elif is_dtensor(value) and data_split(value):
                value = FsdpGather.apply(value)
            self._memo[name] = value
        return self._memo[name]

    def __contains__(self, name: str) -> bool:
        return name in self._group


def gathered(group):
    """``group`` to read inside ``use_mesh`` on a mesh with data axes: a
    view that gathers each FSDP leaf as it is first read (one layer's
    weights at a time, when a block takes its own group), the
    gradients reduce-scattered back; ``group`` itself otherwise."""
    from .act_sharding import current_mesh
    mesh = current_mesh()
    if mesh is None or not ({"pod", "data"} & set(mesh.mesh_dim_names)):
        return group
    return _Gathered(group)


class ExpertMatmul(torch.autograd.Function):
    """The experts' batched product ``x @ w`` of DTensors, shard by shard:
    ``x [E, T, d_in]`` each expert's buffer rows, ``w [E, d_in, d_out]``
    the stacked expert weights.  On each mesh dim ``w`` is split on its
    experts (expert parallel: x must be split alike, a rank multiplies its
    own experts' buffers) or replicated (x's rows split, as over the data
    axes, or replicated); ``w`` never moves.  The output keeps x's
    placements; the weight's gradient is partial where x's rows are
    split."""

    @staticmethod
    def forward(ctx, x, w):
        from torch.distributed.tensor import DTensor
        for px, pw in zip(x.placements, w.placements):
            if (pw.is_shard(0) and not px.is_shard(0)) or (
                    pw.is_replicate() and not (px.is_replicate()
                                               or px.is_shard(1))) or (
                    not pw.is_shard(0) and not pw.is_replicate()):
                raise ValueError(f"expert product of x {x.placements} and "
                                 f"w {w.placements}")
        xl, wl = x.to_local(), w.to_local()
        ctx.save_for_backward(xl, wl)
        ctx.meta = (x.device_mesh, list(x.placements), list(w.placements),
                    w.dtype)
        return DTensor.from_local(torch.matmul(xl, wl.to(xl.dtype)),
                                  x.device_mesh, x.placements,
                                  run_check=False)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        xl, wl = ctx.saved_tensors
        mesh, xp, wp, w_dtype = ctx.meta
        gl = redistribute(grad, xp).to_local()
        gx = torch.matmul(gl, wl.to(gl.dtype).transpose(1, 2))
        gw = torch.matmul(xl.transpose(1, 2), gl)
        gwp = [pw if pw.is_shard() else Partial() if px.is_shard()
               else Replicate() for px, pw in zip(xp, wp)]
        return (DTensor.from_local(gx, mesh, xp, run_check=False),
                DTensor.from_local(gw.to(w_dtype), mesh, gwp,
                                   run_check=False))


class SumGrad(torch.autograd.Function):
    """Identity forward; the gradient summed over ``groups`` (Megatron's
    ``f``): for a replicated tensor each rank uses in a computation of its
    own shards, whose gradient is then a partial sum."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return reduce_over(grad.contiguous(), "sum", ctx.groups), None


class GatherSame(torch.autograd.Function):
    """Every rank's ``x`` of ``group`` concatenated along ``dim``, for a
    computation every rank of the group then runs alike: the gradient,
    the same on each of them, is cut back to this rank's block."""

    @staticmethod
    def forward(ctx, x, dim: int, group):
        import torch.distributed as dist
        from .collectives import gather_over
        ctx.meta = (dim, dist.get_world_size(group), dist.get_rank(group))
        return gather_over(x, dim, [group])

    @staticmethod
    def backward(ctx, grad):
        dim, n, rank = ctx.meta
        return grad.chunk(n, dim)[rank].contiguous(), None, None


class Gather(torch.autograd.Function):
    """Every rank's ``x`` of ``groups`` concatenated along ``dim`` (the
    innermost mesh dim's group first), for work of which each rank then
    does its own share (its heads, its channels, its rows of a
    row-parallel product): the gradient, a partial sum on each rank, is
    summed and scattered back to this rank's block (reduce-scatter).
    :class:`GatherSame` is the form for work every rank repeats alike."""

    @staticmethod
    def forward(ctx, x, dim: int, groups: list):
        from .collectives import gather_over
        ctx.meta = (dim, groups)
        return gather_over(x, dim, groups)

    @staticmethod
    def backward(ctx, grad):
        from .collectives import reduce_scatter_over
        dim, groups = ctx.meta
        return reduce_scatter_over(grad, dim, groups[::-1]), None, None


class Scatter(torch.autograd.Function):
    """``x``, a partial sum over ``groups``, summed and cut to this rank's
    block along ``dim`` (reduce-scatter; the outermost mesh dim's group
    first); the gradient gathered (:class:`Gather`'s mirror)."""

    @staticmethod
    def forward(ctx, x, dim: int, groups: list):
        from .collectives import reduce_scatter_over
        ctx.meta = (dim, groups)
        return reduce_scatter_over(x, dim, groups)

    @staticmethod
    def backward(ctx, grad):
        from .collectives import gather_over
        dim, groups = ctx.meta
        return gather_over(grad, dim, groups[::-1]), None, None


class Reduce(torch.autograd.Function):
    """``x``, a partial sum over ``groups``, summed on every rank, for work
    of which each rank then does its own share: the gradient, a partial
    sum too, is summed the same way (an all-reduce each way)."""

    @staticmethod
    def forward(ctx, x, groups: list):
        from . import collectives
        ctx.groups = groups
        return collectives.reduce_over(x.contiguous(), "sum", groups)

    @staticmethod
    def backward(ctx, grad):
        from . import collectives
        return collectives.reduce_over(grad.contiguous(), "sum",
                                       ctx.groups), None
