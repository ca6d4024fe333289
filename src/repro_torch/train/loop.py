"""Training-step builders (port of ``repro.train.loop``): one device, and
the explicit data-parallel step over ``torch.distributed`` ranks.

``make_train_step(model, optimizer, microbatches)`` returns
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``:
with ``microbatches`` k > 1 the batch is cut into k slices of B/k along its
first dim, their gradients summed in float32 and divided by k, the loss
averaged, then one optimizer update.  Gradients are taken functionally
(``torch.autograd.grad``) with respect to the tree's floating-point leaves,
which must require them (``Params.trainable_()``); a leaf the loss does not
reach (every MLP ``gate`` under ``lut_activations``) gets a zero gradient,
as ``jax.grad`` gives it.

``make_dp_train_step(model, optimizer, mesh, compress)`` is the
reference's explicit-DP trainer (the paper's PIM schedule applied to LM
training): every rank of a ``("data",)`` or ``("pod", "data")`` mesh holds
a whole replica, takes its rows of the global batch and makes ONE gradient
reduction a step: int8 with error feedback (``compress``), two-level on a
mesh with "pod", else the mean over "data".

On a mesh with a "model" axis the model runs on sharded parameters
instead: ``Model.place`` lays them out (tensor-parallel), the step runs
inside ``act_sharding.use_mesh``, and ``make_train_step`` itself trains
them, each gradient reduced to its parameter's layout
(:func:`to_param_layout`) before the update.  That covers every family:
dense, moe (the experts over "model", dbrx's FSDP leaves over the data
axes), ssm and hybrid (the recurrent mixers on their channels and heads),
vlm (the gated cross blocks on their heads) and audio (the
encoder-decoder's layers as a decoder LM's).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..distributed.collectives import (all_reduce, divide, group_over,
                                       hierarchical_psum)
from ..distributed.sharding import axis_sizes, dp_axes
from ..models.api import stacked_groups
from ..optim.grad_compression import ef_compress_psum_stacked


def value_and_grad(model, params, batch: dict):
    """``(loss, grads)``: the loss of ``batch`` (detached) and its gradient
    for every floating-point leaf, a dict by ``named_parameters()`` name."""
    named = {n: p for n, p in params.named_parameters()
             if p.is_floating_point()}
    frozen = [n for n, p in named.items() if not p.requires_grad]
    if frozen:
        raise ValueError(f"{len(frozen)} leaves (first {frozen[0]!r}) do not "
                         f"require a gradient: call params.trainable_()")
    with torch.enable_grad():
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
    return loss.detach(), {
        n: g if g is not None else torch.zeros_like(p)
        for (n, p), g in zip(named.items(), grads)}


def _split(x, k: int, i: int):
    """Microbatch ``i`` of ``k``: a slice of the rows; a DTensor's local
    rows sliced on each rank (its rows over the data axes stay there)."""
    from ..kernels.dispatch import is_dtensor
    if is_dtensor(x):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(_split(x.to_local(), k, i), x.device_mesh,
                                  x.placements, run_check=False)
    b = x.shape[0]
    if b % k:
        raise ValueError(f"batch {b} does not split into {k} microbatches")
    return x[i * (b // k):(i + 1) * (b // k)]


def _microbatches(batch: dict, k: int) -> int:
    """``k``; or, where a DTensor batch holds fewer rows a rank than ``k``
    and they divide it (dbrx's 16 microbatches of train_4k's 8 rows a rank
    on the 512-rank mesh), one microbatch a local row: microbatches of
    equal size, whose mean gradient is the batch's, as ``k``'s is (the
    MoE's routing groups and capacity then follow the larger
    microbatch)."""
    from ..kernels.dispatch import is_dtensor
    rows = [v.to_local().shape[0] for v in batch.values() if is_dtensor(v)]
    if rows and rows[0] % k and k % rows[0] == 0:
        return rows[0]
    return k


def make_train_step(model, optimizer, microbatches: int = 1):
    """Returns ``train_step(params, opt_state, batch)``; metrics hold the
    float32 ``loss`` and ``grad_norm`` (0-d tensors on the device)."""

    def train_step(params, opt_state, batch: dict):
        k_mb = _microbatches(batch, microbatches)
        if k_mb == 1:
            loss, grads = value_and_grad(model, params, batch)
        else:
            grads, loss_sum = None, None
            for i in range(k_mb):
                mb = {k: _split(v, k_mb, i) for k, v in batch.items()}
                loss, g = value_and_grad(model, params, mb)
                if grads is None:
                    grads = {n: gg.to(torch.float32) for n, gg in g.items()}
                    loss_sum = loss.to(torch.float32)
                else:
                    for n, gg in g.items():
                        grads[n].add_(gg.to(torch.float32))
                    loss_sum = loss_sum + loss
            grads = {n: g / k_mb for n, g in grads.items()}
            loss = loss_sum / k_mb
        grads = to_param_layout(grads, params)
        params, opt_state, gnorm = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss.to(torch.float32),
                                   "grad_norm": gnorm}

    return train_step


def to_param_layout(grads: dict, params) -> dict:
    """Each DTensor gradient laid out as its parameter (partial sums over
    the data axes reduced: the data-parallel all-reduce, or reduced and
    scattered onto an FSDP split), through ``tp.redistribute``'s
    collectives; plain gradients as they are."""
    from ..distributed.tp import redistribute
    from ..kernels.dispatch import is_dtensor
    named = dict(params.named_parameters())
    return {n: redistribute(g, named[n].placements) if is_dtensor(g) else g
            for n, g in grads.items()}


def make_eval_step(model):
    def eval_step(params, batch: dict) -> torch.Tensor:
        with torch.no_grad():
            return model.loss(params, batch).to(torch.float32)
    return eval_step


# ---------------------------------------------------------------------------
# Explicit-DP trainer: replicated params, each rank on its rows of the batch,
# ONE gradient reduction per step — optionally int8-compressed with error
# feedback (optim/grad_compression.py).
# ---------------------------------------------------------------------------

def make_dp_train_step(model, optimizer, mesh, *, compress: bool = False):
    """Returns ``step(params, opt_state, err, batch) -> (params, opt_state,
    err, metrics)``.  Every rank passes the same global ``batch`` and keeps
    its own error buffers ``err`` (``init_error_buffers(params)``; returned
    unchanged without ``compress``); parameters stay bit-identical across
    ranks."""
    extra = set(mesh.mesh_dim_names) - {"pod", "data"}
    if "data" not in mesh.mesh_dim_names or extra:
        raise ValueError(f"the data-parallel trainer runs on a ('data',) or "
                         f"('pod', 'data') mesh, not {mesh.mesh_dim_names}"
                         f": with a 'model' axis, place the parameters "
                         f"(Model.place) and use make_train_step")

    def step(params, opt_state, err, batch):
        (loss, grads), new_err = _dp_call(mesh, model, params, err, batch,
                                          compress)
        params, opt_state, gnorm = optimizer.update(grads, opt_state, params)
        return params, opt_state, new_err, {"loss": loss.to(torch.float32),
                                            "grad_norm": gnorm}

    return step


def local_rows(batch: dict, mesh) -> dict:
    """This rank's rows of every batch leaf with a leading dim, as
    ``P(("pod", "data"))`` lays them out: pod-major over the data axes."""
    axes, sizes = dp_axes(mesh), axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    world, index = math.prod(sizes[a] for a in axes), 0
    for a in axes:
        index = index * sizes[a] + coord[a]
    out = {}
    for key, value in batch.items():
        if getattr(value, "ndim", 0) == 0:
            out[key] = value
            continue
        rows = value.shape[0]
        if rows % world:
            raise ValueError(f"batch leaf {key!r} has {rows} rows, not a "
                             f"multiple of the {world} data-parallel ranks")
        n = rows // world
        out[key] = value[index * n:(index + 1) * n]
    return out


def dp_reduce(cfg, grads: dict, err: dict, mesh, compress: bool
              ) -> tuple[dict, dict]:
    """The step's one gradient reduction: (mean gradients, new error
    buffers).  ``compress``: ``ef_compress_psum`` over every rank, one
    scale for each of the reference's leaves (:func:`stacked_groups` of
    ``cfg``); on a mesh with "pod": the hierarchical sum over the world;
    else the mean over "data".  Exact reductions reduce ``grads`` in
    place."""
    axes = dp_axes(mesh)
    world = math.prod(axis_sizes(mesh)[a] for a in axes)
    if compress:
        group = group_over(mesh, axes)
        means, new_err = {}, {}
        for names in stacked_groups(cfg, grads):
            ms, es = ef_compress_psum_stacked(
                [grads[n] for n in names], [err[n] for n in names], group,
                world)
            means.update(zip(names, ms))
            new_err.update(zip(names, es))
        return means, new_err
    if "pod" in axes:
        return {n: divide(hierarchical_psum(g, mesh), world)
                for n, g in grads.items()}, err
    group = mesh.get_group("data")
    return {n: divide(all_reduce(g, group=group), world)
            for n, g in grads.items()}, err


def _dp_call(mesh, model, params, err, batch, compress):
    """The gradient step on this rank's rows: ((mean loss, reduced
    gradients), new error buffers)."""
    loss, grads = value_and_grad(model, params, local_rows(batch, mesh))
    grads, new_err = dp_reduce(model.cfg, grads, err, mesh, compress)
    group = group_over(mesh, dp_axes(mesh))
    loss = divide(all_reduce(loss.clone(), group=group),
                  dist.get_world_size(group))
    return (loss, grads), new_err
