"""Attention layers: GQA, KV cache, sliding window, cross-attention (port
of ``repro.models.attention``).

``plan_heads`` pads the query and KV heads to multiples of the reference's
model-parallel degree (16), so the parameter shapes equal the reference's
(qwen3-8b's 8 KV heads become 16, each drawn at init).

``_sdpa`` sends attention without a ``kv_len`` to the ``mha`` op, the
``flash_attention`` kernel on a CUDA tensor, sliding windows included:
that is prefill and the training-style forward, and every
cross-attention (no mask, ``Skv`` the vision or encoder states).  Decode's
self-attention attends over the static cache with a ``kv_len`` mask and
keeps the plain masked path, as the reference does; on DTensors it runs
on each rank's batch rows and heads.  The projections are constrained to
heads over "model" (``"bhsd"``), the reference's cut point.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..core.quantization import true_divide
from ..distributed.act_sharding import constrain, current_mesh
from ..distributed.sharding import cache_tensor
from ..distributed.tp import matmul
from ..kernels.dispatch import is_dtensor
from ..kernels.flash_attention import gqa_repeat, mha, on_head_shards
from .layers import Params, apply_rope, dense_init, rms_norm


class HeadPlan(NamedTuple):
    n_q: int          # padded query heads
    n_kv: int         # padded kv heads
    group: int        # q heads per kv head (after padding)
    n_q_real: int
    n_kv_real: int


def plan_heads(n_q: int, n_kv: int, tp: int = 16) -> HeadPlan:
    """Pad (n_q, n_kv) to multiples of ``tp`` with integral GQA groups."""
    n_kv_p = _next_multiple(n_kv, tp)
    n_q_p = _next_multiple(n_q, tp)
    while n_q_p % n_kv_p != 0:
        n_q_p += tp
    return HeadPlan(n_q_p, n_kv_p, n_q_p // n_kv_p, n_q, n_kv)


def _next_multiple(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    plan: HeadPlan
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_fraction: float = 1.0
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    kv_dim: int = 0    # cross-attn source dim (0 -> d_model)


def init_attention(gen: torch.Generator, spec: AttnSpec, dtype: torch.dtype,
                   cross: bool = False) -> Params:
    """Projections of self-attention, or with ``cross`` of cross-attention,
    whose keys and values project ``spec.kv_dim``-wide states."""
    q_dim = spec.plan.n_q * spec.head_dim
    kv_dim = spec.plan.n_kv * spec.head_dim
    kv_in = (spec.kv_dim or spec.d_model) if cross else spec.d_model
    p = {"wq": dense_init(gen, spec.d_model, q_dim, dtype),
         "wk": dense_init(gen, kv_in, kv_dim, dtype),
         "wv": dense_init(gen, kv_in, kv_dim, dtype),
         "wo": dense_init(gen, q_dim, spec.d_model, dtype)}
    dev = gen.device
    if spec.qkv_bias:
        p["bq"] = torch.zeros((q_dim,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((kv_dim,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((kv_dim,), dtype=dtype, device=dev)
    if spec.qk_norm:
        p["q_norm"] = torch.ones((spec.head_dim,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((spec.head_dim,), dtype=dtype, device=dev)
    return Params(**p)


class KVCache(NamedTuple):
    """Static-shape cache; ``length`` (a Python int) is the filled prefix.

    int8 mode: k/v stored int8 with per-(batch, head, position) f32
    scales.  ``k_scale is None`` <=> unquantized storage.
    """
    k: torch.Tensor          # [B, Hkv, S_max, D] (dtype or int8)
    v: torch.Tensor
    length: int
    k_scale: Optional[torch.Tensor] = None   # [B, Hkv, S_max] f32
    v_scale: Optional[torch.Tensor] = None


def init_kv_cache(batch: int, plan: HeadPlan, head_dim: int, max_seq: int,
                  dtype: torch.dtype, bits: int = 16,
                  device="cuda") -> KVCache:
    """An empty cache; inside ``use_mesh`` its tensors are DTensors over
    (data axes, "model") (``sharding.cache_tensor``)."""
    shape = (batch, plan.n_kv, max_seq, head_dim)
    mesh = current_mesh()

    def make(shp, fill, dt):
        return cache_tensor(shp, fill, dt, device, mesh)
    if bits == 8:
        return KVCache(make(shape, 0, torch.int8), make(shape, 0, torch.int8),
                       0, make(shape[:-1], 1.0, torch.float32),
                       make(shape[:-1], 1.0, torch.float32))
    return KVCache(make(shape, 0, dtype), make(shape, 0, dtype), 0)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., D] -> (int8 [..., D], f32 scale [...]) per-vector symmetric."""
    xf = x.to(torch.float32)
    scale = true_divide(torch.clamp_min(torch.amax(torch.abs(xf), dim=-1),
                                        1e-12), 127.0)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def _project_qkv(params, spec: AttnSpec, x: torch.Tensor,
                 positions: Optional[torch.Tensor]):
    """-> q [B, Hq, S, D], k and v [B, Hkv, S, D]: transposed views of the
    projections (the attention kernel reads them through their strides).
    Rotary embeddings apply unless ``positions`` is None."""
    b, s, _ = x.shape
    hd = spec.head_dim
    q = matmul(x, params["wq"])
    k = matmul(x, params["wk"])
    v = matmul(x, params["wv"])
    if spec.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = q.reshape(b, s, spec.plan.n_q, hd).transpose(1, 2)
    k = k.reshape(b, s, spec.plan.n_kv, hd).transpose(1, 2)
    v = v.reshape(b, s, spec.plan.n_kv, hd).transpose(1, 2)
    if spec.qk_norm:
        q = rms_norm(q, params["q_norm"], spec.norm_eps)
        k = rms_norm(k, params["k_norm"], spec.norm_eps)
    if positions is not None and spec.rope_fraction > 0:
        q = apply_rope(q, positions, spec.rope_fraction, spec.rope_theta)
        k = apply_rope(k, positions, spec.rope_fraction, spec.rope_theta)
    return constrain(q, "bhsd"), constrain(k, "bhsd"), constrain(v, "bhsd")


def _sdpa(q, k, v, *, causal: bool, q_offset: int = 0,
          window: Optional[int] = None,
          kv_len: Optional[int] = None) -> torch.Tensor:
    """Scaled dot-product attention with GQA, an optional sliding window
    and valid-kv-length masking (for static-shape caches).

    Without a kv length it is the ``mha`` op (the kernel on the card),
    with its window; a window no query can reach past (``FULL_WINDOW``
    among them) is no window.  The masked path is the reference's: float32
    scores of the (upcast) operands, ``-1e30`` where masked, softmax,
    ``p`` cast to v's dtype before the float32 ``p @ v``, the result in
    q's dtype.
    """
    if kv_len is None:
        # query row i sits at q_offset + i, keys at 0..: no key is ever
        # window or more behind a query when window >= q_offset + Sq
        reach = q_offset + q.shape[2]
        w = 0 if window is None or window >= reach else window
        return mha(q, k, v, causal=causal, q_offset=q_offset, window=w)
    if is_dtensor(q):        # each rank over its own rows and heads
        return on_head_shards(_sdpa, q, k, v, causal=causal,
                              q_offset=q_offset, window=window,
                              kv_len=kv_len)
    d = q.shape[-1]
    sq, skv = q.shape[2], k.shape[2]
    k, v = gqa_repeat(q, k, v)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) / (d ** 0.5)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    if kv_len is not None:
        mask &= kpos < kv_len
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.to(q.dtype)


def attend(params, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           **mask) -> torch.Tensor:
    """``_sdpa`` of q [B, Hq, S, D] over k and v with ``mask``'s keywords,
    its heads merged and projected through ``params["wo"]``: [B, S, d]."""
    out = _sdpa(q, k, v, **mask)
    b, _, s, _ = q.shape
    # the row-parallel product's partial sums reduced here, where XLA
    # puts the all-reduce, so the residual add sees the whole stream
    return constrain(matmul(out.transpose(1, 2).reshape(b, s, -1),
                            params["wo"]), "btd")


def attention(params, spec: AttnSpec, x: torch.Tensor,
              positions: torch.Tensor, *,
              window: Optional[int] = None) -> torch.Tensor:
    """Training / prefill path (full sequence, causal)."""
    q, k, v = _project_qkv(params, spec, x, positions)
    return attend(params, q, k, v, causal=True, window=window)


def attention_decode(params, spec: AttnSpec, x: torch.Tensor,
                     cache: KVCache, *, window: Optional[int] = None
                     ) -> tuple[torch.Tensor, KVCache]:
    """Single-token decode: append to the cache, attend to the prefix.

    The new key and value are written into ``cache``'s tensors in place
    (the reference returns updated copies); the returned cache shares them
    and has ``length`` advanced."""
    s = x.shape[1]  # 1
    pos = cache.length
    if pos + s > cache.k.shape[2]:
        raise ValueError(f"KV cache full: {pos} + {s} > {cache.k.shape[2]}")
    positions = torch.arange(pos, pos + s, device=x.device,
                             dtype=torch.int32)[None]
    q, k, v = _project_qkv(params, spec, x, positions)
    if cache.k_scale is not None:           # int8 cache
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        cache.k[:, :, pos:pos + s] = kq
        cache.v[:, :, pos:pos + s] = vq
        cache.k_scale[:, :, pos:pos + s] = ks
        cache.v_scale[:, :, pos:pos + s] = vs
        k_full = dequantize_kv(cache.k, cache.k_scale, x.dtype)
        v_full = dequantize_kv(cache.v, cache.v_scale, x.dtype)
    else:
        cache.k[:, :, pos:pos + s] = k.to(cache.k.dtype)
        cache.v[:, :, pos:pos + s] = v.to(cache.v.dtype)
        k_full, v_full = cache.k, cache.v
    out = attend(params, q, k_full, v_full, causal=True, q_offset=pos,
                 window=window, kv_len=pos + s)
    return out, cache._replace(length=pos + s)


def cross_queries(params, spec: AttnSpec, x: torch.Tensor) -> torch.Tensor:
    """Cross-attention's queries of ``x`` [B, S, d]: [B, Hq, S, D], with
    the bias and the query norm where the spec has them; on sharded
    parameters each rank's heads (``"bhsd"``)."""
    b, s, _ = x.shape
    q = matmul(x, params["wq"])
    if spec.qkv_bias:
        q = q + params["bq"].to(x.dtype)
    q = q.reshape(b, s, spec.plan.n_q, spec.head_dim).transpose(1, 2)
    if spec.qk_norm:
        q = rms_norm(q, params["q_norm"], spec.norm_eps)
    return constrain(q, "bhsd")


def cross_kv(params, spec: AttnSpec, kv_states: torch.Tensor,
             dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention's keys and values of ``kv_states`` [B, Skv, kv_dim]
    in ``dtype``: [B, Hkv, Skv, D] each, contiguous, as a decode step's
    attention reads them from the cache (no key norm: the reference's
    cache has none).  On sharded parameters each rank projects the whole
    states (rows over the data axes) onto its own heads: no collective."""
    b, sk, _ = kv_states.shape
    kv = kv_states.to(dtype)
    k = matmul(kv, params["wk"])
    v = matmul(kv, params["wv"])
    if spec.qkv_bias:
        k = k + params["bk"].to(dtype)
        v = v + params["bv"].to(dtype)
    shape = (b, sk, spec.plan.n_kv, spec.head_dim)
    return tuple(constrain(t.reshape(shape).transpose(1, 2), "bhsd")
                 .contiguous() for t in (k, v))


def cross_attention(params, spec: AttnSpec, x: torch.Tensor,
                    kv_states: torch.Tensor) -> torch.Tensor:
    """Encoder-decoder / vision cross-attention: queries from ``x``, keys
    and values from ``kv_states`` [B, Skv, kv_dim] (cast to x's dtype);
    no mask, no rope."""
    q = cross_queries(params, spec, x)
    k, v = cross_kv(params, spec, kv_states, x.dtype)
    if spec.qk_norm:
        k = rms_norm(k, params["k_norm"], spec.norm_eps)
    return attend(params, q, k, v, causal=False)
