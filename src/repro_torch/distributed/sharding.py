"""Sharding rules: parameter/optimizer/data partition specs over the
production mesh axes ("pod", "data", "model") (port of
``repro.distributed.sharding``).

Philosophy (DESIGN.md §5): batch -> (pod, data); heads / FFN hidden /
experts / vocab -> model.  A spec is a tuple over a tensor's dims, each
entry ``None``, an axis name or a tuple of axis names, as the reference's
``PartitionSpec``; :func:`placements` turns it into DTensor placements and
:func:`place` puts a tensor on a ``DeviceMesh`` with it (the reference's
``NamedSharding``).  A mesh here is anything with ``mesh_dim_names`` and
``shape`` (a ``DeviceMesh``).  :func:`P` builds a spec as the reference's
``PartitionSpec`` does: a one-axis tuple entry becomes the axis name and
an empty one ``None``.

Rules are name-based over the port's leaf names (``named_parameters()``:
``layers.3.attn.wq``).  The reference stacks a layer group's leaves into
``[reps, ...]``; the port keeps one group a layer (``layers``, and the
encoder-decoder's ``enc`` and ``dec``), so a per-layer leaf's spec is the
reference's spec of the stacked leaf with its leading ``None`` dropped.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

#: trailing-dims spec per canonical weight name (leading dims -> None)
_RULES: dict[str, tuple] = {
    # embeddings / heads: vocab over model
    "tok_emb": ("model", None),
    "lm_head": (None, "model"),
    # attention
    "wq": (None, "model"), "wk": (None, "model"), "wv": (None, "model"),
    "wo": ("model", None),
    "bq": ("model",), "bk": ("model",), "bv": ("model",),
    # mlp
    "up": (None, "model"), "gate": (None, "model"), "down": ("model", None),
    # moe (leading expert axis over model = EP)
    "router": (None, "model"),
    "w_gate": ("model", None, None), "w_up": ("model", None, None),
    "w_down": ("model", None, None),
    # mlstm / ssm
    "w_in": (None, "model"),
    "w_up_m": (None, "model"),
    "conv_w": (None, "model"),
    "w_bc": ("model", None), "w_dt": ("model", None),
    "a_log": ("model", None), "d_skip": ("model",),
    "w_x": (None, "model"), "w_out": ("model", None),
    # misc
    "meta": (), "final_norm": (), "enc_ln": (), "dec_ln": (),
}

#: weight names that stay replicated regardless of shape
_REPLICATED = {"norm", "norm1", "norm2", "attn_norm", "ssm_norm",
               "q_norm", "k_norm", "b", "w", "b_if", "w_if", "r",
               "dt_bias", "gate_attn", "gate_mlp", "ln1", "ln2", "ln3"}

#: the groups that hold one layer each (the reference's stacked leaves)
_LAYER_GROUPS = ("layers", "enc", "dec")

#: only embeddings keep model-axis sharding when TP is disabled for the
#: backbone (small recurrent models: replicate weights, pure DP + ZeRO)
_EMB_NAMES = {"tok_emb", "lm_head"}


def P(*parts) -> tuple:
    """A spec from its entries, normalised as ``PartitionSpec`` does."""
    def one(p):
        if isinstance(p, (tuple, list)):
            return None if not p else p[0] if len(p) == 1 else tuple(p)
        return p
    return tuple(one(p) for p in parts)


def axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _per_layer(names: list) -> bool:
    return len(names) > 1 and names[0] in _LAYER_GROUPS


def _stacked_spec(name: str, ndim: int) -> tuple:
    """The reference's ``spec_for_param`` of a leaf named ``name`` of rank
    ``ndim`` (stacked leaves with their layer axis)."""
    # mlstm's w_up/w_gate collide with moe names; disambiguate by rank:
    # moe expert weights are (reps, E, d, f) = rank 4.
    if name in ("w_gate", "w_up", "w_down") and ndim < 4:
        rule = {"w_gate": (None, "model"), "w_up": (None, "model"),
                "w_down": ("model", None)}[name]
    elif name in _REPLICATED or name not in _RULES:
        return ()
    else:
        rule = _RULES[name]
    if len(rule) > ndim:
        return ()
    return P(*((None,) * (ndim - len(rule)) + tuple(rule)))


def spec_for_param(name: str, shape) -> tuple:
    """The spec of the port's leaf ``name`` (a ``named_parameters()``
    name) of ``shape``."""
    names = name.split(".")
    if not _per_layer(names):
        return _stacked_spec(names[-1], len(shape))
    spec = _stacked_spec(names[-1], len(shape) + 1)
    if spec and spec[0] is not None:
        raise ValueError(f"{name}: the reference's spec {spec} shards the "
                         f"stacked layer axis")
    return spec[1:]


def validate_divisibility(spec: tuple, shape, mesh) -> tuple:
    """Drop sharding on axes whose size doesn't divide the mesh axis."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, s in enumerate(spec):
        if s is None:
            out.append(None)
            continue
        axes = (s,) if isinstance(s, str) else tuple(s)
        total = math.prod(sizes[a] for a in axes)
        out.append(s if shape[dim] % total == 0 else None)
    return P(*out)


def _named_shapes(tree) -> dict:
    """name -> shape of a Params tree or a dict of tensors or shapes."""
    items = (tree.named_parameters() if hasattr(tree, "named_parameters")
             else tree.items())
    return {n: tuple(getattr(v, "shape", v)) for n, v in items}


def param_shardings(mesh, param_tree, tp_dense: bool = True) -> dict:
    """Specs for a param tree, by name.

    tp_dense=False: backbone weights replicated (vocab tensors still shard
    over "model") — the §Perf fix for xlstm-class models where TP
    all-gathers of tiny weights dominated the collective term.
    """
    out = {}
    for name, shape in _named_shapes(param_tree).items():
        if not tp_dense and not (_EMB_NAMES & set(name.split("."))):
            out[name] = ()
            continue
        out[name] = validate_divisibility(spec_for_param(name, shape), shape,
                                          mesh)
    return out


def dp_axes(mesh) -> tuple:
    """Data-parallel mesh axes: ("pod","data") if pod axis present."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def extend_with_dp(spec: tuple, shape, mesh) -> tuple:
    """ZeRO/FSDP extension: additionally shard the largest still-unsharded
    dim over the data axes (weights: FSDP; adam moments: ZeRO-1)."""
    dp = dp_axes(mesh)
    if not dp:
        return P(*spec)
    sizes = axis_sizes(mesh)
    total = math.prod(sizes[a] for a in dp)
    spec_t = tuple(spec) + (None,) * (len(shape) - len(spec))
    best, best_size = None, 0
    for dim, s in enumerate(spec_t):
        if s is None and shape[dim] % total == 0 and shape[dim] > best_size:
            best, best_size = dim, shape[dim]
    if best is None:
        return P(*spec_t)
    out = list(spec_t)
    out[best] = dp if len(dp) > 1 else dp[0]
    return P(*out)


def param_shardings_fsdp(mesh, param_tree) -> dict:
    """FSDP variant of param_shardings (dbrx-class models whose replicated
    weights would not fit per-chip HBM)."""
    out = {}
    for name, shape in _named_shapes(param_tree).items():
        spec = validate_divisibility(spec_for_param(name, shape), shape,
                                     mesh)
        out[name] = extend_with_dp(spec, shape, mesh)
    return out


def opt_state_shardings(mesh, param_tree) -> dict:
    """ZeRO-1: adam moments sharded over data axes on top of the param
    spec (f32 moments are 4x the bf16 weights — always worth sharding)."""
    return param_shardings_fsdp(mesh, param_tree)


def batch_shardings(mesh, batch: dict) -> dict:
    """Leading axis -> data parallel; everything else replicated."""
    dp = dp_axes(mesh)
    sizes = axis_sizes(mesh)
    total = math.prod(sizes[a] for a in dp)
    out = {}
    for name, shape in _named_shapes(batch).items():
        if not shape:
            out[name] = ()
            continue
        out[name] = P(dp if shape[0] % total == 0 else None,
                      *(None,) * (len(shape) - 1))
    return out


def _cache_spec(name: str, shape, mesh, stacked: bool) -> tuple:
    """The reference's cache spec of a leaf: KV caches (reps, B, H, S, D)
    -> (None, dp, model, None, None), states (reps, B, ...) -> (None, dp,
    ...); the port's per-layer leaves drop the leading entry."""
    full = (1, *shape) if stacked else tuple(shape)
    if len(full) <= 1:
        return ()
    spec: list = [None] * len(full)
    spec[1] = dp_axes(mesh)
    if len(full) >= 4 and name in ("k", "v", "ck", "cv"):
        spec[2] = "model"
    spec = validate_divisibility(tuple(spec), full, mesh)
    return spec[1:] if stacked else spec


#: the port's layout of the recurrent decode states, after their batch
#: dim (over the data axes), by (block group, state field): each laid out
#: as the mixer that reads it (``models/ssm.py``), the conv states and the
#: SSM's ``h`` split over their channels, the mLSTM's ``c``, ``n`` and
#: ``m`` over its heads (whole where "model" does not divide them, as the
#: heads then run), the sLSTM's whole.  The reference lays every state out
#: ``(dp, ...)``, whole over "model" (a difference by design: ROADMAP
#: queue 3).
_STATE_RULES: dict[tuple, tuple] = {
    ("mlstm", "c"): ("model", None, None), ("mlstm", "n"): ("model", None),
    ("mlstm", "m"): ("model",), ("mlstm", "conv"): (None, "model"),
    ("ssm", "h"): ("model", None), ("ssm", "conv"): (None, "model"),
}


def state_spec(group: str, field: str, shape, mesh) -> tuple:
    """The port's spec of a recurrent state ``group.field`` ``[B, ...]``
    (:data:`_STATE_RULES`; the sLSTM's states and unknown fields: rows
    over the data axes alone), axes that do not divide dropped."""
    rule = _STATE_RULES.get((group, field), ())
    spec = (dp_axes(mesh), *rule, *(None,) * (len(shape) - 1 - len(rule)))
    return validate_divisibility(P(*spec), tuple(shape), mesh)


def cache_shardings(mesh, caches):
    """Specs for the port's decode caches, in their structure: a decoder
    LM's list of per-layer dicts, or the encoder-decoder's dict of
    per-layer lists (``k``, ``v``, ``ck``, ``cv``) beside its ``length``
    and ``pos`` table.  A layer's ``KVCache`` or recurrent state (a named
    tuple under its block group's name: ``kv``, ``mlstm``, ``slstm``,
    ``ssm``) gets a dict of its fields' specs, the states' by
    :func:`state_spec`.  Falls back to replication when sizes don't
    divide."""
    def leaf(name: str, value, stacked: bool):
        shape = tuple(getattr(value, "shape", ()))
        return _cache_spec(name, shape, mesh, stacked)

    def entry(name: str, value):
        if not hasattr(value, "_fields"):
            return leaf(name, value, True)
        if name == "kv":
            return {f: leaf(f, v, True) for f, v in zip(value._fields, value)}
        return {f: state_spec(name, f, tuple(v.shape), mesh)
                for f, v in zip(value._fields, value)}
    if isinstance(caches, dict):
        return {name: ([leaf(name, v, True) for v in value]
                       if isinstance(value, list) else leaf(name, value,
                                                            False))
                for name, value in caches.items()}
    return [{name: entry(name, v) for name, v in layer.items()}
            for layer in caches]


def placements(spec: tuple, mesh) -> list:
    """DTensor placements for ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that tensor dim ``d`` is split over, ``Replicate()`` on the
    rest and on mesh dims of size 1 (a split in one is no split, and a
    reduction over a one-rank group is no reduction).  A dim split over
    several mesh axes takes them in mesh order (pod-major, as
    ``P(("pod", "data"))`` lays rows out)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    out: list = [Replicate()] * len(names)
    for dim, s in enumerate(spec):
        if s is None:
            continue
        idx = [names.index(a) for a in ((s,) if isinstance(s, str) else s)]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {s} out of the mesh's order "
                             f"{tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} uses axis {names[i]} twice")
            if sizes[names[i]] > 1:
                out[i] = Shard(dim)
    return out


def place(tensor, mesh, spec: Optional[tuple]):
    """``tensor`` (the same on every rank) as a DTensor on ``mesh`` laid
    out by ``spec`` (axes that do not divide its shape stay replicated),
    made from this rank's slice of it with no communication.  A split
    tensor's local shard is a copy, so the whole tensor can be freed."""
    spec = validate_divisibility(tuple(spec or ()), tensor.shape, mesh)
    return _from_slice(tensor, mesh, placements(spec, mesh))


def _from_slice(tensor, mesh, pl: list):
    from torch.distributed.tensor import DTensor
    coord = mesh.get_coordinate()
    local = tensor
    for i, p in enumerate(pl):     # mesh dims in order: pod-major rows
        if p.is_shard():
            local = local.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    if local is not tensor:
        local = local.clone()
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=tensor.shape, stride=tensor.stride())


def local_like(tensor, like):
    """``tensor`` (whole, the same on every rank) as a DTensor laid out as
    the DTensor ``like``: this rank's slice, no communication."""
    if any(p.is_partial() for p in like.placements):
        raise ValueError(f"cannot lay a whole tensor out as {like.placements}")
    return _from_slice(tensor.to(like.dtype), like.device_mesh,
                       list(like.placements))


def place_params(params, mesh, specs: dict):
    """Replace every leaf of the :class:`Params` tree ``params`` (the same
    on every rank) by its DTensor on ``mesh`` laid out by ``specs[name]``
    (:func:`param_shardings`' names), in place; returns ``params``.  A
    leaf keeps whether it requires a gradient; a leaf already placed stays
    as it is."""
    from torch import nn

    from ..kernels.dispatch import is_dtensor
    for prefix, module in params.named_modules():
        for name, p in list(module._parameters.items()):
            if is_dtensor(p):
                continue
            full = f"{prefix}.{name}" if prefix else name
            module._parameters[name] = nn.Parameter(
                place(p.detach(), mesh, specs[full]),
                requires_grad=p.requires_grad)
    return params


def redistribute_to(x, mesh, spec: tuple):
    """``x`` laid out by ``spec``: a DTensor redistributed (a split of a
    replicated dim is a local slice), a plain tensor placed."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return place(x, mesh, spec)
    spec = validate_divisibility(tuple(spec), x.shape, mesh)
    return x.redistribute(mesh, placements(spec, mesh))


def place_opt_state(state, mesh, specs: dict):
    """An ``AdamState`` with its moments laid out by ``specs``
    (:func:`opt_state_shardings`: ZeRO-1, the parameter's spec plus the
    data axes); the step stays a replicated scalar."""
    return state._replace(
        m={n: redistribute_to(t, mesh, specs[n]) for n, t in state.m.items()},
        v={n: redistribute_to(t, mesh, specs[n]) for n, t in state.v.items()})


def place_batch(batch: dict, mesh) -> dict:
    """Every tensor of ``batch`` (the global batch, the same on every rank)
    as a DTensor with its rows over the data axes
    (:func:`batch_shardings`)."""
    specs = batch_shardings(mesh, batch)
    return {k: place(v, mesh, specs[k]) for k, v in batch.items()}


def cache_tensor(shape: tuple, fill: float, dtype, device, mesh=None):
    """A decode-cache tensor ``[B, Hkv, ...]`` filled with ``fill`` (a KV
    cache's ``k`` and ``v`` and their scales, a cross block's ``ck`` and
    ``cv``): plain on ``device``, or on ``mesh`` a DTensor over (data
    axes, "model") by :func:`cache_shardings`' rule for these names, of
    which each rank allocates its shard alone."""
    if mesh is None:
        return torch.full(shape, fill, dtype=dtype, device=device)
    from torch.distributed.tensor import full
    spec = _cache_spec("k", tuple(shape), mesh, True)
    return full(shape, fill, dtype=dtype, device_mesh=mesh,
                placements=placements(spec, mesh))


def state_tensor(group: str, field: str, shape: tuple, fill: float, dtype,
                 device, mesh=None):
    """A recurrent state ``group.field`` filled with ``fill``: plain on
    ``device``, or on ``mesh`` a DTensor laid out by :func:`state_spec`, of
    which each rank allocates its shard alone."""
    if mesh is None:
        return torch.full(shape, fill, dtype=dtype, device=device)
    from torch.distributed.tensor import full
    return full(shape, fill, dtype=dtype, device_mesh=mesh,
                placements=placements(state_spec(group, field, shape, mesh),
                                      mesh))
