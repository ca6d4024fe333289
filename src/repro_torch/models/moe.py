"""Mixture-of-Experts layer (port of ``repro.models.moe``; dbrx,
qwen2-moe).

Routing is the reference's: top-k of the float32 router logits (padding
experts masked to -1e30, so never chosen), softmax gates over the k picks,
the load-balancing aux loss, and each (token, slot)'s position in its
expert's capacity buffer from a cumsum over the tokens' slots in top-k's
descending order; positions past the capacity are dropped.

Two dispatch modes, as the reference's:

* ``gather`` (default): group-local routing over ``spec.groups`` groups
  (one group when they do not divide the tokens), kept tokens gathered
  into each expert's capacity buffers, cap rows a group (a dropped slot
  goes to a spill row that is cut off), the expert products as batched
  matmuls over ``[E, G * cap, d]``, each token's k results gathered back
  and summed by their gates;
* ``dense``: the GShard one-hot einsums, the reference's baseline.

The expert products are plain batched matmuls (no Pallas kernel computes
them in the reference).  At decode a token sees capacity 1 in every
expert, so each step computes all E experts' buffers, as the reference's.

On sharded parameters (a DTensor input inside ``use_mesh``) the gather
mode runs expert parallel over "model" (:func:`_moe_sharded`): each rank
multiplies only its own experts' buffers, and the dense mode raises.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..distributed import tp
from ..distributed.act_sharding import _spec_for, constrain
from ..distributed.sharding import placements
from ..distributed.tp import GatherSame, SumGrad, matmul
from ..kernels.dispatch import is_dtensor
from .layers import Params, activation, dense_init, normal_init


@dataclasses.dataclass(frozen=True)
class MoeSpec:
    d_model: int
    n_experts: int          # padded count (divisible by EP)
    n_experts_real: int
    top_k: int
    d_ff: int               # per-expert hidden
    capacity_factor: float = 1.25
    activation: str = "silu"
    dispatch: str = "gather"  # "gather" | "dense"
    groups: int = 1           # group-local routing


def pad_experts(n_experts: int, ep: int = 16) -> int:
    return -(-n_experts // ep) * ep


def init_moe(gen: torch.Generator, spec: MoeSpec,
             dtype: torch.dtype) -> Params:
    e, d, f = spec.n_experts, spec.d_model, spec.d_ff
    return Params(
        router=dense_init(gen, d, e, torch.float32),
        # stacked expert weights, E leading
        w_gate=normal_init(gen, (e, d, f), 1.0 / math.sqrt(d), dtype),
        w_up=normal_init(gen, (e, d, f), 1.0 / math.sqrt(d), dtype),
        w_down=normal_init(gen, (e, f, d), 1.0 / math.sqrt(f), dtype))


def _route(params, spec: MoeSpec, xt: torch.Tensor):
    """Router over xt ``[..., t, d]`` (each leading index a routing group):
    ``(gates [..., t, k], gidx [..., t, k], pos [..., t, k], aux [...])``."""
    t = xt.shape[-2]
    e, k = spec.n_experts, spec.top_k
    logits = xt.to(torch.float32) @ params["router"]
    if spec.n_experts_real < e:                 # mask padding experts
        pad = torch.arange(e, device=xt.device) >= spec.n_experts_real
        logits = logits.masked_fill(pad, -1e30)
    gval, gidx = torch.topk(logits, k, dim=-1)   # descending, as lax.top_k
    gates = torch.softmax(gval, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    me = torch.mean(probs, dim=-2)
    onehot = F.one_hot(gidx, e)                  # [..., t, k, e] int64
    ce = torch.mean(onehot.sum(dim=-2).to(torch.float32), dim=-2)
    aux = torch.sum(me * ce, dim=-1) * (e / k)
    # position of each (token, slot) in its expert's buffer: the running
    # count of that expert over the (token, slot) pairs in order
    flat = onehot.reshape(*onehot.shape[:-3], t * k, e)
    pos = torch.gather(torch.cumsum(flat, dim=-2), -1,
                       gidx.reshape(*gidx.shape[:-2], t * k, 1)) - 1
    return gates, gidx, pos.reshape(gidx.shape), aux


def _experts(params, spec: MoeSpec, xe: torch.Tensor, lut: bool
             ) -> torch.Tensor:
    """The gated expert MLPs on buffers ``[E, T, d]``: one batched matmul
    a weight, expert e's rows against its own ``[d, f]`` slice."""
    dt = xe.dtype
    g = activation(torch.matmul(xe, params["w_gate"].to(dt)),
                   spec.activation, lut)
    u = torch.matmul(xe, params["w_up"].to(dt))
    return torch.matmul(g * u, params["w_down"].to(dt))


def _capacity(spec: MoeSpec, t: int) -> tuple[int, int, int]:
    """(routing groups, tokens a group, capacity an expert a group) of
    ``t`` tokens: one group when ``spec.groups`` does not divide them."""
    groups = spec.groups if t % max(spec.groups, 1) == 0 else 1
    tg = t // groups
    cap = int(max(spec.top_k * tg / spec.n_experts * spec.capacity_factor,
                  1))
    return groups, tg, min(cap, spec.top_k * tg)   # <= the assignments


def moe_apply(params, spec: MoeSpec, x: torch.Tensor, lut: bool = False
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x ``[B, S, d]`` -> ``(out [B, S, d], aux_loss)``, aux a float32
    0-d tensor."""
    if is_dtensor(x):
        return _moe_sharded(params, spec, x, lut)
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    e, k = spec.n_experts, spec.top_k
    groups, tg, cap = _capacity(spec, t)

    if spec.dispatch == "dense":
        gates, gidx, pos, aux = _route(params, spec, xt)
        keep = (pos >= 0) & (pos < cap)
        pos_oh = (F.one_hot(pos.clamp(0, cap - 1), cap).to(torch.float32)
                  * keep[..., None].to(torch.float32))       # [t, k, cap]
        eh = F.one_hot(gidx, e).to(torch.float32)            # [t, k, e]
        dispatch = torch.einsum("tke,tkc->tec", eh, pos_oh)
        combine = torch.einsum("tk,tke,tkc->tec", gates, eh, pos_oh)
        xe = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), xt)
        ye = _experts(params, spec, xe, lut)
        out = torch.einsum("tec,ecd->td", combine.to(x.dtype), ye)
        return out.reshape(b, s, d), aux

    # -- gather dispatch, group-local routing -------------------------------
    xg = xt.reshape(groups, tg, d)
    gates, gidx, pos, aux = _route(params, spec, xg)          # [G, tg, k]
    aux = torch.mean(aux)
    keep = (pos >= 0) & (pos < cap)
    slot = gidx * cap + pos.clamp(0, cap - 1)                 # [G, tg, k]
    spilled = torch.where(keep, slot, e * cap).reshape(groups, tg * k)
    tok = torch.arange(tg, device=x.device).repeat_interleave(k)
    token_src = torch.zeros((groups, e * cap + 1), dtype=torch.int64,
                            device=x.device)
    token_src.scatter_(1, spilled, tok.expand(groups, -1))
    filled = torch.zeros((groups, e * cap + 1), dtype=torch.bool,
                         device=x.device)
    filled.scatter_(1, spilled, True)
    token_src, filled = token_src[:, :e * cap], filled[:, :e * cap]
    xe = torch.gather(xg, 1, token_src[..., None].expand(-1, -1, d))
    xe = xe * filled[..., None].to(xe.dtype)
    # [G, E*cap, d] -> [E, G*cap, d]: every group's rows of an expert in
    # one batch entry (a [G, E, ...] @ [E, ...] broadcast would copy each
    # expert's weights G times)
    xe = xe.reshape(groups, e, cap, d).transpose(0, 1).reshape(e, -1, d)
    ye = _experts(params, spec, xe, lut).reshape(e, groups, cap, d)
    ye = ye.transpose(0, 1).reshape(groups, e * cap, d)
    yk = torch.gather(ye, 1, slot.reshape(groups, tg * k, 1)
                      .expand(-1, -1, d))
    yk = yk.reshape(groups, tg, k, d) * keep[..., None].to(x.dtype)
    out = torch.einsum("gtk,gtkd->gtd", gates.to(x.dtype), yk)
    return out.reshape(b, s, d), aux


# -- expert parallel, on sharded parameters -----------------------------------

def _pieces(groups: int, n: int) -> tuple[int, int]:
    """(groups a data rank holds whole, data ranks a group spans): the
    routing groups split along the ``n`` data ranks' rows, or each group
    over consecutive ranks."""
    if groups % n == 0:
        return groups // n, 1
    if n % groups == 0:
        return 1, n // groups
    raise ValueError(f"{groups} routing groups over {n} data ranks: neither "
                     f"divides the other")


class _Split(NamedTuple):
    """Where a rank's tokens lie: ``ddims`` the data mesh dims the rows are
    split over (``n`` ranks, this one ``r``, pod-major); the global
    routing ``groups``, tokens a group ``tg`` and capacity ``cap``; the
    rank's ``gl`` pieces of ``tl`` tokens, each a whole group or, where a
    group spans ``span`` data ranks, its rank's part."""

    ddims: list
    n: int
    r: int
    groups: int
    tg: int
    cap: int
    gl: int
    tl: int
    span: int


def _route_sharded(params, spec: MoeSpec, x, sp: _Split):
    """The router on this rank's tokens, alike on every "model" rank:
    ``(gates, gidx, pos [gl, tl, k], aux)``, ``pos`` each (token, slot)'s
    position in its expert's buffer of its whole group (after the
    group's earlier data ranks' counts of that expert), ``aux`` the
    load-balancing loss over every group, the same on every rank.  The
    logits are column-parallel over "model" and gathered before top-k;
    the per-expert statistics are gathered over the data ranks."""
    mesh = x.device_mesh
    e, k = spec.n_experts, spec.top_k
    logits = matmul(x.to(torch.float32), params["router"])
    ll = logits.to_local()
    for i in reversed(range(mesh.ndim)):
        if logits.placements[i].is_shard(2):
            ll = GatherSame.apply(ll, 2, mesh.get_group(i))
    ll = ll.reshape(sp.gl, sp.tl, e)
    if spec.n_experts_real < e:
        pad = torch.arange(e, device=ll.device) >= spec.n_experts_real
        ll = ll.masked_fill(pad, -1e30)
    gval, gidx = torch.topk(ll, k, dim=-1)
    onehot = F.one_hot(gidx, e)                       # [gl, tl, k, e]
    stats = torch.cat([torch.softmax(ll, dim=-1).sum(dim=-2),
                       onehot.sum(dim=(-3, -2)).to(torch.float32)], dim=-1)
    for i in reversed(sp.ddims):                      # [n * gl, 2e]
        stats = GatherSame.apply(stats, 0, mesh.get_group(i))
    per_group = stats.reshape(sp.groups, -1, 2 * e).sum(dim=1) / sp.tg
    aux = torch.mean(torch.sum(per_group[:, :e] * per_group[:, e:],
                               dim=-1) * (e / k))
    pos = torch.gather(torch.cumsum(onehot.reshape(sp.gl, sp.tl * k, e),
                                    dim=-2), -1,
                       gidx.reshape(sp.gl, sp.tl * k, 1)) - 1
    pos = pos.reshape(sp.gl, sp.tl, k)
    if sp.span > 1:
        counts = stats.detach()[:, e:].round().long()
        first = sp.r - sp.r % sp.span
        pos = pos + counts[first:sp.r].sum(dim=0)[gidx]
    return torch.softmax(gval, dim=-1), gidx, pos, aux


def _moe_sharded(params, spec: MoeSpec, x, lut: bool):
    """:func:`moe_apply` inside ``use_mesh`` on a DTensor ``x [B, S, d]``
    (rows over the data axes, whole over "model") with the expert weights
    split over "model" (expert parallel; FSDP's data split gathered by the
    block's :func:`~repro_torch.distributed.tp.gathered` view).

    Every rank routes its data rank's tokens alike
    (:func:`_route_sharded`); groups, tokens a group and capacity come
    from the global token count, so the drop set is one process's.  A rank
    fills only its own experts' capacity buffers (a local slice of the
    dispatch: the tokens are already on every "model" rank), multiplies
    them (``tp.ExpertMatmul``) and combines its experts' contributions
    into a partial ``[B, S, d]``; one sum over "model" completes it.  No
    all-to-all.  Where a group spans data ranks (one group at decode),
    each rank's buffers hold its own tokens' rows alone and zeros in the
    others' (an expert maps a zero row to zero)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if spec.dispatch != "gather":
        raise NotImplementedError(f"moe dispatch {spec.dispatch!r} on "
                                  f"sharded parameters (gather only)")
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    rows = [Shard(0) if p.is_shard(0) and names[i] in ("pod", "data")
            else Replicate() for i, p in enumerate(x.placements)]
    if list(x.placements) != rows:
        x = x.redistribute(placements=rows)
    coord = mesh.get_coordinate()
    ddims = [i for i, p in enumerate(rows) if p.is_shard()]
    n, r = 1, 0
    for i in ddims:                       # pod-major, as the rows lie
        n, r = n * mesh.size(i), r * mesh.size(i) + coord[i]
    b, s, d = x.shape
    e, k = spec.n_experts, spec.top_k
    groups, tg, cap = _capacity(spec, b * s)
    gl, span = _pieces(groups, n)
    sp = _Split(ddims, n, r, groups, tg, cap, gl, (b * s) // n // gl, span)
    tl = sp.tl
    edims = [i for i, p in enumerate(params["w_gate"].placements)
             if p.is_shard(0)]
    el, e0 = e, 0
    for i in edims:
        el //= mesh.size(i)
        e0 = e0 * mesh.size(i) + coord[i]
    e0 *= el

    gates, gidx, pos, aux = _route_sharded(params, spec, x, sp)
    mine = (pos >= 0) & (pos < cap) & (gidx >= e0) & (gidx < e0 + el)

    # -- this rank's experts' buffers of its tokens -------------------------
    slot = (gidx - e0).clamp(0, el - 1) * cap + pos.clamp(0, cap - 1)
    spilled = torch.where(mine, slot, el * cap).reshape(gl, tl * k)
    tok = torch.arange(tl, device=x.device).repeat_interleave(k)
    token_src = torch.zeros((gl, el * cap + 1), dtype=torch.int64,
                            device=x.device)
    token_src.scatter_(1, spilled, tok.expand(gl, -1))
    filled = torch.zeros((gl, el * cap + 1), dtype=torch.bool,
                         device=x.device)
    filled.scatter_(1, spilled, True)
    token_src, filled = token_src[:, :el * cap], filled[:, :el * cap]
    # the tokens' gradient from this rank's experts is a partial sum
    xl = x.to_local(grad_placements=[Partial() if i in edims else p
                                     for i, p in enumerate(rows)])
    xl = xl.reshape(gl, tl, d)
    xe = torch.gather(xl, 1, token_src[..., None].expand(-1, -1, d))
    xe = xe * filled[..., None].to(xe.dtype)
    xe = xe.reshape(gl, el, cap, d).transpose(0, 1).reshape(el, -1, d)
    # the reference's "gecd" cut point in the port's layout ("egcd"), on
    # the mesh dims this run splits
    lay = placements(_spec_for("egcd", 3, mesh), mesh)
    lay = [p if (i in edims or i in ddims) else Replicate()
           for i, p in enumerate(lay)]
    xe = DTensor.from_local(xe, mesh, lay, run_check=False)
    g = tp.ExpertMatmul.apply(xe, params["w_gate"])
    u = tp.ExpertMatmul.apply(xe, params["w_up"])
    h = DTensor.from_local(activation(g.to_local(), spec.activation, lut)
                           * u.to_local(), mesh, lay, run_check=False)
    ye = tp.ExpertMatmul.apply(h, params["w_down"]).to_local()
    ye = ye.reshape(el, gl, cap, d).transpose(0, 1).reshape(gl, el * cap, d)
    yk = torch.gather(ye, 1, slot.reshape(gl, tl * k, 1).expand(-1, -1, d))
    yk = yk.reshape(gl, tl, k, d) * mine[..., None].to(x.dtype)
    gates = SumGrad.apply(gates, [mesh.get_group(i) for i in edims])
    out = torch.einsum("gtk,gtkd->gtd", gates.to(x.dtype), yk)
    out = DTensor.from_local(out.reshape(-1, s, d), mesh,
                             [Partial() if i in edims else p
                              for i, p in enumerate(rows)],
                             run_check=False, shape=x.shape,
                             stride=x.stride())
    return constrain(out, "btd"), aux
