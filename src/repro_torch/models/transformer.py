"""Decoder LM of every decoder family (port of
``repro.models.transformer``): ``attn`` (dense), ``moe``, ``mlstm`` and
``slstm`` (xLSTM), ``hymba`` and ``cross`` (the VLM's gated
cross-attention over vision states) blocks.  The audio family's
encoder-decoder is ``models/encdec.py``.

The reference scans a stacked repeating unit with ``lax.scan``; the port
keeps one parameter group per layer (``params["layers"][i]``) and loops
over them in Python.  Modes: the training forward and ``lm_loss`` (the
blocks' aux loss, MoE load balancing, summed in), prefill (writes each
block's cache: KV, SSM or xLSTM state) and single-token decode.  With
``cfg.remat == "full"`` the training forward checkpoints each layer (the
reference checkpoints each scanned unit): its activations are recomputed
in the backward.  Hymba's meta tokens are prepended to the prompt (and
its cache holds them), then stripped after the stack.

On sharded parameters (inside ``use_mesh``) each block reads its group
through ``tp.gathered``: a leaf split over the data axes (FSDP) is
gathered when first read, one layer at a time.

``extras`` carries the inputs beside the tokens: ``cross_states``, the
VLM's vision states [B, vision_tokens, vision_dim].  A ``cross`` block's
cache holds their keys and values, computed once at prefill and stored
contiguous, so a decode step reads them as the attention kernel takes
them and needs no extras.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.utils.checkpoint
from torch import nn

from ..configs.base import ArchConfig
from ..distributed.act_sharding import constrain, current_mesh
from ..distributed.sharding import cache_tensor
from ..distributed.tp import VocabParallelNll, gathered, matmul
from ..kernels.dispatch import is_dtensor
from . import ssm as ssm_mod
from .attention import (AttnSpec, _project_qkv, attend, attention,
                        attention_decode, cross_attention, cross_kv,
                        cross_queries, init_attention, init_kv_cache,
                        plan_heads, quantize_kv)
from .layers import (Params, dense_init, embed_init, init_mlp, leaf_shapes,
                     mlp, normal_init, rms_norm)
from .moe import MoeSpec, init_moe, moe_apply, pad_experts

FULL_WINDOW = 1 << 30


# ---------------------------------------------------------------------------
# Specs derived from the config.
# ---------------------------------------------------------------------------

def attn_spec(cfg: ArchConfig, tp: int = 16) -> AttnSpec:
    return AttnSpec(
        d_model=cfg.d_model,
        plan=plan_heads(cfg.n_heads, cfg.n_kv_heads, tp),
        head_dim=cfg.resolved_head_dim,
        qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
        rope_fraction=cfg.rope_fraction, rope_theta=cfg.rope_theta,
        norm_eps=cfg.norm_eps,
        kv_dim=cfg.vision_dim or 0)


def moe_spec(cfg: ArchConfig, ep: int = 16) -> MoeSpec:
    return MoeSpec(
        d_model=cfg.d_model,
        n_experts=pad_experts(cfg.n_experts, ep),
        n_experts_real=cfg.n_experts,
        top_k=cfg.n_experts_per_tok, d_ff=cfg.moe_d_ff,
        capacity_factor=cfg.moe_capacity_factor,
        activation=cfg.activation, dispatch=cfg.moe_dispatch,
        groups=cfg.moe_groups)


def mlstm_spec(cfg: ArchConfig) -> ssm_mod.MlstmSpec:
    return ssm_mod.MlstmSpec(d_model=cfg.d_model, n_heads=cfg.n_heads,
                             proj_factor=cfg.ssm_proj_factor)


def slstm_spec(cfg: ArchConfig) -> ssm_mod.SlstmSpec:
    return ssm_mod.SlstmSpec(d_model=cfg.d_model, n_heads=cfg.n_heads)


def ssm_spec(cfg: ArchConfig) -> ssm_mod.SsmSpec:
    return ssm_mod.SsmSpec(
        d_model=cfg.d_model,
        d_inner=int(cfg.d_model * cfg.ssm_proj_factor),
        d_state=cfg.ssm_state or 16)


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Blocks.
# ---------------------------------------------------------------------------

def init_block(gen: torch.Generator, cfg: ArchConfig, bt: str) -> Params:
    dt, d = _dtype(cfg), cfg.d_model

    def norm():
        return torch.ones((d,), dtype=dt, device=gen.device)
    if bt == "mlstm":
        return Params(norm1=norm(),
                      mlstm=ssm_mod.init_mlstm(gen, mlstm_spec(cfg), dt))
    if bt == "slstm":
        return Params(norm1=norm(),
                      slstm=ssm_mod.init_slstm(gen, slstm_spec(cfg), dt))
    if bt == "cross":        # the gates start at 0: tanh(0) shuts them
        zero = torch.zeros((), dtype=torch.float32, device=gen.device)
        return Params(norm1=norm(),
                      cross=init_attention(gen, attn_spec(cfg), dt,
                                           cross=True),
                      norm2=norm(), mlp=init_mlp(gen, d, cfg.d_ff, dt),
                      gate_attn=zero, gate_mlp=zero.clone())
    p = {"norm1": norm(), "attn": init_attention(gen, attn_spec(cfg), dt)}
    if bt == "hymba":
        p.update(ssm=ssm_mod.init_ssm(gen, ssm_spec(cfg), dt),
                 attn_norm=norm(), ssm_norm=norm())
    p["norm2"] = norm()
    if bt == "moe":
        p["moe"] = init_moe(gen, moe_spec(cfg), dt)
        if cfg.shared_expert_d_ff:
            p["shared"] = init_mlp(gen, d, cfg.shared_expert_d_ff, dt)
    else:
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, dt)
    return Params(**p)


def _ffn(p, cfg: ArchConfig, bt: str, x: torch.Tensor):
    """The block's second half on the residual stream: ``(x, aux)``, the
    MLP, or the routed experts beside the shared one (aux their
    load-balancing loss)."""
    y = rms_norm(x, p["norm2"])
    lut, q = cfg.lut_activations, cfg.quantize_dense
    if bt != "moe":
        return x + mlp(p["mlp"], y, cfg.activation, lut, q), 0.0
    mo, aux = moe_apply(p["moe"], moe_spec(cfg), y, lut)
    if "shared" in p:
        mo = mo + mlp(p["shared"], y, cfg.activation, lut, q)
    return x + mo, aux


def _hymba_mix(p, ha: torch.Tensor, hs: torch.Tensor) -> torch.Tensor:
    """Hymba's parallel heads: the mean of the normed attention and SSM
    outputs."""
    return 0.5 * (rms_norm(ha, p["attn_norm"]) + rms_norm(hs, p["ssm_norm"]))


def _gated(p, x: torch.Tensor, h: torch.Tensor, cfg: ArchConfig
           ) -> torch.Tensor:
    """A ``cross`` block's second half: ``x + tanh(gate_attn) h``, then its
    MLP through ``tanh(gate_mlp)``."""
    x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * h
    h2 = mlp(p["mlp"], rms_norm(x, p["norm2"]), cfg.activation,
             cfg.lut_activations, cfg.quantize_dense)
    return x + torch.tanh(p["gate_mlp"]).to(x.dtype) * h2


def apply_block_train(p, cfg: ArchConfig, bt: str, x: torch.Tensor,
                      positions: torch.Tensor, window: Optional[int],
                      extras: dict):
    """-> (x, aux_loss)."""
    p = gathered(p)
    if bt == "cross":
        h = cross_attention(p["cross"], attn_spec(cfg),
                            rms_norm(x, p["norm1"]), extras["cross_states"])
        return _gated(p, x, h, cfg), 0.0
    if bt == "mlstm":
        return x + ssm_mod.mlstm_chunkwise(
            p["mlstm"], mlstm_spec(cfg), rms_norm(x, p["norm1"])), 0.0
    if bt == "slstm":
        return x + ssm_mod.slstm_apply(
            p["slstm"], slstm_spec(cfg), rms_norm(x, p["norm1"])), 0.0
    y = rms_norm(x, p["norm1"])
    h = attention(p["attn"], attn_spec(cfg), y, positions, window=window)
    if bt == "hymba":
        h = _hymba_mix(p, h, ssm_mod.ssm_apply(p["ssm"], ssm_spec(cfg), y))
    return _ffn(p, cfg, bt, x + h)


def init_block_cache(cfg: ArchConfig, bt: str, batch: int, max_seq: int,
                     device="cuda") -> dict:
    """A block's empty decode cache; inside ``use_mesh`` its KV caches and
    recurrent states are DTensors (``sharding.cache_shardings``)."""
    dt, mesh = _dtype(cfg), current_mesh()
    if bt == "mlstm":
        return {"mlstm": ssm_mod.mlstm_state_init(batch, mlstm_spec(cfg), dt,
                                                  device, mesh)}
    if bt == "slstm":
        return {"slstm": ssm_mod.slstm_state_init(batch, slstm_spec(cfg),
                                                  device, mesh)}
    spec = attn_spec(cfg)
    if bt == "cross":        # filled once at prefill from the states
        sk = cfg.vision_tokens or cfg.encoder_seq
        shape = (batch, spec.plan.n_kv, sk, spec.head_dim)
        return {name: cache_tensor(shape, 0, dt, device, mesh)
                for name in ("ck", "cv")}
    c = {"kv": init_kv_cache(batch, spec.plan, spec.head_dim, max_seq, dt,
                             bits=cfg.kv_cache_bits, device=device)}
    if bt == "hymba":
        c["ssm"] = ssm_mod.ssm_state_init(batch, ssm_spec(cfg), dt, device,
                                          mesh)
    return c


def apply_block_decode(p, cfg: ArchConfig, bt: str, x: torch.Tensor,
                       cache: dict, window: Optional[int]
                       ) -> tuple[torch.Tensor, dict]:
    """Single-token step.  -> (x, new_cache)."""
    p = gathered(p)
    if bt == "cross":        # attends to the cached keys and values
        q = cross_queries(p["cross"], attn_spec(cfg),
                          rms_norm(x, p["norm1"]))
        h = attend(p["cross"], q, cache["ck"], cache["cv"], causal=False)
        return _gated(p, x, h, cfg), dict(cache)
    if bt == "mlstm":
        h, st = ssm_mod.mlstm_decode_step(
            p["mlstm"], mlstm_spec(cfg), rms_norm(x, p["norm1"]),
            cache["mlstm"])
        return x + h, {"mlstm": st}
    if bt == "slstm":
        h, st = ssm_mod.slstm_decode_step(
            p["slstm"], slstm_spec(cfg), rms_norm(x, p["norm1"]),
            cache["slstm"])
        return x + h, {"slstm": st}
    y = rms_norm(x, p["norm1"])
    h, kv = attention_decode(p["attn"], attn_spec(cfg), y, cache["kv"],
                             window=window)
    new = {"kv": kv}
    if bt == "hymba":
        hs, new["ssm"] = ssm_mod.ssm_decode_step(p["ssm"], ssm_spec(cfg), y,
                                                 cache["ssm"])
        h = _hymba_mix(p, h, hs)
    x, _ = _ffn(p, cfg, bt, x + h)
    return x, new


# ---------------------------------------------------------------------------
# The whole model.
# ---------------------------------------------------------------------------

def unit_pattern(cfg: ArchConfig) -> tuple[tuple[str, ...], int]:
    """(repeating unit, reps)."""
    pattern = cfg.layer_pattern()
    n = len(pattern)
    for p in range(1, n + 1):
        if n % p == 0 and pattern == pattern[:p] * (n // p):
            return pattern[:p], n // p
    return pattern, 1


def init_lm(cfg: ArchConfig, gen: torch.Generator,
            place_layer=None) -> Params:
    """Random weights drawn from ``gen`` on its device; each layer's group,
    once drawn, handed to ``place_layer(i, group)`` (``Model.init_placed``
    keeps a rank's shards of it) before the next is drawn."""
    dt = _dtype(cfg)
    p = {"tok_emb": embed_init(gen, cfg.padded_vocab, cfg.d_model, dt),
         "final_norm": torch.ones((cfg.d_model,), dtype=dt,
                                  device=gen.device),
         "lm_head": dense_init(gen, cfg.d_model, cfg.padded_vocab, dt)}
    if cfg.meta_tokens:
        p["meta"] = normal_init(gen, (cfg.meta_tokens, cfg.d_model), 0.02,
                                dt)
    place_layer = place_layer or (lambda i, group: group)
    return Params(**p, layers=nn.ModuleList(
        place_layer(i, init_block(gen, cfg, bt))
        for i, bt in enumerate(cfg.layer_pattern())))


def _windows_stacked(cfg: ArchConfig, unit_len: int,
                     reps: int) -> list[list[int]]:
    """Per-layer windows as [reps][unit_len] (FULL_WINDOW = unbounded)."""
    wins = [w if w else FULL_WINDOW for w in cfg.layer_windows()]
    return [wins[r * unit_len:(r + 1) * unit_len] for r in range(reps)]


def _layer_windows(cfg: ArchConfig) -> list[Optional[int]]:
    """Each layer's window argument: None unless the config slides."""
    unit, reps = unit_pattern(cfg)
    if not cfg.sliding_window:
        return [None] * cfg.n_layers
    return [w for row in _windows_stacked(cfg, len(unit), reps) for w in row]


def _lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows ``tokens`` of ``table``; a DTensor table split over its vocab
    rows looks up each rank's rows (``F.embedding``'s sharded rule) and
    sums them."""
    if is_dtensor(table):
        return torch.nn.functional.embedding(tokens.long(), table)
    return table[tokens.long()]


def _embed(cfg: ArchConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings ``[B, S, d]``, after the meta tokens where the
    config has them (``[B, meta + S, d]``)."""
    params = gathered(params)
    x = _lookup(params["tok_emb"], tokens)
    if cfg.meta_tokens:
        x = constrain(x, "btd")    # a vocab-split lookup summed first
        meta = params["meta"].to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([meta, x], dim=1)
    return x


def _unembed(cfg: ArchConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Logits of the stack's output."""
    params = gathered(params)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return matmul(x, params["lm_head"])


def lm_forward(cfg: ArchConfig, params, tokens: torch.Tensor,
               extras: Optional[dict] = None):
    """Training-style forward: tokens [B, S] -> (logits [B, S, Vpad],
    aux), aux the blocks' summed aux loss (0.0 without MoE blocks, else a
    float32 0-d tensor)."""
    extras = extras or {}
    x = constrain(_embed(cfg, params, tokens), "btd")
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None]
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    aux = 0.0
    for p, bt, win in zip(params["layers"], cfg.layer_pattern(),
                          _layer_windows(cfg)):
        x = constrain(x, "btd")
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                apply_block_train, p, cfg, bt, x, positions, win, extras,
                use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = apply_block_train(p, cfg, bt, x, positions, win, extras)
        aux = aux + a
    logits = _unembed(cfg, params, x[:, cfg.meta_tokens:])
    return constrain(logits, "btv"), aux


def lm_loss(cfg: ArchConfig, params, tokens: torch.Tensor,
            targets: torch.Tensor, extras: Optional[dict] = None,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Mean next-token cross-entropy in float32 over the real vocab (the
    padded columns at -1e30), plus ``aux_weight`` times the blocks' aux
    loss."""
    logits, aux = lm_forward(cfg, params, tokens, extras)
    return token_nll(cfg, logits, targets) + aux_weight * aux


def token_nll(cfg: ArchConfig, logits: torch.Tensor,
              targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of ``logits`` [B, S, Vpad] against ``targets`` in
    float32, the padded vocab columns at -1e30."""
    if is_dtensor(logits):       # each rank over its vocab columns
        return VocabParallelNll.apply(logits, targets, cfg.vocab_size)
    logits = logits.to(torch.float32)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=logits.device) \
            >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device="cuda") -> list[dict]:
    """One cache per layer, room for the meta tokens added."""
    max_seq += cfg.meta_tokens
    return [init_block_cache(cfg, bt, batch, max_seq, device)
            for bt in cfg.layer_pattern()]


def lm_prefill(cfg: ArchConfig, params, tokens: torch.Tensor, max_seq: int,
               extras: Optional[dict] = None
               ) -> tuple[torch.Tensor, list[dict]]:
    """Run the full prompt: (last-token logits [B, 1, Vpad], the filled
    per-layer caches)."""
    extras = extras or {}
    x = _embed(cfg, params, tokens)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None]
    caches = []
    for p, bt, win in zip(params["layers"], cfg.layer_pattern(),
                          _layer_windows(cfg)):
        x, c = _prefill_block(p, cfg, bt, constrain(x, "btd"), positions,
                              win, extras, max_seq + cfg.meta_tokens)
        caches.append(c)
    return _unembed(cfg, params, x[:, -1:]), caches


def _prefill_block(p, cfg: ArchConfig, bt: str, x: torch.Tensor,
                   positions: torch.Tensor, window: Optional[int],
                   extras: dict, cache_max: int) -> tuple[torch.Tensor, dict]:
    """Forward one block while materializing its decode cache."""
    p = gathered(p)
    if bt == "cross":        # the cache keeps the keys without their norm
        spec = attn_spec(cfg)
        ck, cv = cross_kv(p["cross"], spec, extras["cross_states"], x.dtype)
        k = (rms_norm(ck, p["cross"]["k_norm"], spec.norm_eps)
             if spec.qk_norm else ck)
        q = cross_queries(p["cross"], spec, rms_norm(x, p["norm1"]))
        h = attend(p["cross"], q, k, cv, causal=False)
        return _gated(p, x, h, cfg), {"ck": ck, "cv": cv}
    if bt == "mlstm":
        h, st = ssm_mod._mlstm_forward(p["mlstm"], mlstm_spec(cfg),
                                       rms_norm(x, p["norm1"]))
        return x + h, {"mlstm": st}
    if bt == "slstm":
        h, st = ssm_mod._slstm_forward(p["slstm"], slstm_spec(cfg),
                                       rms_norm(x, p["norm1"]))
        return x + h, {"slstm": st}
    b, s_total, _ = x.shape
    spec = attn_spec(cfg)
    y = rms_norm(x, p["norm1"])
    qh, kh, vh = _project_qkv(p["attn"], spec, y, positions)
    kv = init_kv_cache(b, spec.plan, spec.head_dim, cache_max, _dtype(cfg),
                       bits=cfg.kv_cache_bits, device=x.device)
    if cfg.kv_cache_bits == 8:
        kq, ks = quantize_kv(kh)
        vq, vs = quantize_kv(vh)
        kv.k[:, :, :s_total] = kq
        kv.v[:, :, :s_total] = vq
        kv.k_scale[:, :, :s_total] = ks
        kv.v_scale[:, :, :s_total] = vs
    else:
        kv.k[:, :, :s_total] = kh
        kv.v[:, :, :s_total] = vh
    h = attend(p["attn"], qh, kh, vh, causal=True, window=window)
    cache = {"kv": kv._replace(length=s_total)}
    if bt == "hymba":
        hs, cache["ssm"] = ssm_mod._ssm_forward(p["ssm"], ssm_spec(cfg), y)
        h = _hymba_mix(p, h, hs)
    x, _ = _ffn(p, cfg, bt, x + h)
    return x, cache


def lm_decode_step(cfg: ArchConfig, params, tokens: torch.Tensor,
                   caches: list[dict]) -> tuple[torch.Tensor, list[dict]]:
    """tokens [B, 1] -> (logits [B, 1, Vpad], new caches).  The caches'
    tensors are written in place (``attention_decode``); the recurrent
    states are new tensors.  No meta tokens: the cache holds them."""
    x = _lookup(gathered(params)["tok_emb"], tokens)
    new_caches = []
    for p, bt, c, win in zip(params["layers"], cfg.layer_pattern(), caches,
                             _layer_windows(cfg)):
        x, c = apply_block_decode(p, cfg, bt, constrain(x, "btd"), c, win)
        new_caches.append(c)
    return _unembed(cfg, params, x), new_caches


def param_shapes(cfg: ArchConfig) -> dict:
    """``init_lm``'s leaves as meta tensors, without allocating (the
    reference counts every family's parameters through ``init_lm``)."""
    return leaf_shapes(init_lm, cfg)


@functools.cache
def count_params(cfg: ArchConfig) -> int:
    return sum(t.numel() for t in param_shapes(cfg).values())
