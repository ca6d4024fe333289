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
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

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


def moe_apply(params, spec: MoeSpec, x: torch.Tensor, lut: bool = False
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x ``[B, S, d]`` -> ``(out [B, S, d], aux_loss)``, aux a float32
    0-d tensor."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    e, k = spec.n_experts, spec.top_k
    groups = spec.groups if t % max(spec.groups, 1) == 0 else 1
    tg = t // groups
    cap = int(max(k * tg / e * spec.capacity_factor, 1))
    cap = min(cap, k * tg)             # never above the assignment count

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
