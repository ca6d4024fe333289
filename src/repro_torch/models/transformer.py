"""Decoder LM of the dense family (port of ``repro.models.transformer``,
``"attn"`` blocks only).

The reference scans a stacked repeating unit with ``lax.scan``; the port
keeps one parameter group per layer (``params["layers"][i]``) and loops
over them in Python.  Modes: the training forward and ``lm_loss``,
prefill (writes the KV caches) and single-token decode.  With
``cfg.remat == "full"`` the training forward checkpoints each layer (the
reference checkpoints each scanned unit): its activations are recomputed
in the backward.

Only the dense family is ported: any other block type (moe, mlstm, slstm,
hymba, cross) raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint
from torch import nn

from ..configs.base import ArchConfig
from .attention import (AttnSpec, KVCache, _project_qkv, _sdpa, attention,
                        attention_decode, init_attention, init_kv_cache,
                        plan_heads, quantize_kv)
from .layers import Params, dense_init, embed_init, init_mlp, mlp, rms_norm

FULL_WINDOW = 1 << 30
#: ROADMAP item that ports the other block types
BLOCKS_TODO = ("only the dense family's 'attn' blocks are ported; {bt!r} "
               "blocks (moe, ssm, vlm, hybrid, audio) wait for ROADMAP "
               "queue 1 item 12")


def check_ported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what the port cannot run yet."""
    if cfg.family != "dense":
        raise NotImplementedError(BLOCKS_TODO.format(bt=cfg.family))


def attn_spec(cfg: ArchConfig, tp: int = 16) -> AttnSpec:
    return AttnSpec(
        d_model=cfg.d_model,
        plan=plan_heads(cfg.n_heads, cfg.n_kv_heads, tp),
        head_dim=cfg.resolved_head_dim,
        qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
        rope_fraction=cfg.rope_fraction, rope_theta=cfg.rope_theta,
        norm_eps=cfg.norm_eps)


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _require_attn(bt: str) -> None:
    if bt != "attn":
        raise NotImplementedError(BLOCKS_TODO.format(bt=bt))


# ---------------------------------------------------------------------------
# Blocks.
# ---------------------------------------------------------------------------

def init_block(gen: torch.Generator, cfg: ArchConfig, bt: str) -> Params:
    _require_attn(bt)
    dt, d = _dtype(cfg), cfg.d_model
    return Params(
        norm1=torch.ones((d,), dtype=dt, device=gen.device),
        attn=init_attention(gen, attn_spec(cfg), dt),
        norm2=torch.ones((d,), dtype=dt, device=gen.device),
        mlp=init_mlp(gen, d, cfg.d_ff, dt))


def apply_block_train(p, cfg: ArchConfig, bt: str, x: torch.Tensor,
                      positions: torch.Tensor, window: Optional[int]
                      ) -> tuple[torch.Tensor, float]:
    """-> (x, aux_loss)."""
    _require_attn(bt)
    x = x + attention(p["attn"], attn_spec(cfg), rms_norm(x, p["norm1"]),
                      positions, window=window)
    x = x + mlp(p["mlp"], rms_norm(x, p["norm2"]), cfg.activation,
                cfg.lut_activations, cfg.quantize_dense)
    return x, 0.0


def init_block_cache(cfg: ArchConfig, bt: str, batch: int, max_seq: int,
                     device="cuda") -> dict:
    _require_attn(bt)
    spec = attn_spec(cfg)
    return {"kv": init_kv_cache(batch, spec.plan, spec.head_dim, max_seq,
                                _dtype(cfg), bits=cfg.kv_cache_bits,
                                device=device)}


def apply_block_decode(p, cfg: ArchConfig, bt: str, x: torch.Tensor,
                       cache: dict, window: Optional[int]
                       ) -> tuple[torch.Tensor, dict]:
    """Single-token step.  -> (x, new_cache)."""
    _require_attn(bt)
    h, kv = attention_decode(p["attn"], attn_spec(cfg),
                             rms_norm(x, p["norm1"]), cache["kv"],
                             window=window)
    x = x + h
    x = x + mlp(p["mlp"], rms_norm(x, p["norm2"]), cfg.activation,
                cfg.lut_activations, cfg.quantize_dense)
    return x, {"kv": kv}


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


def init_lm(cfg: ArchConfig, gen: torch.Generator) -> Params:
    """Random weights drawn from ``gen`` on its device."""
    check_ported(cfg)
    dt = _dtype(cfg)
    return Params(
        tok_emb=embed_init(gen, cfg.padded_vocab, cfg.d_model, dt),
        final_norm=torch.ones((cfg.d_model,), dtype=dt, device=gen.device),
        lm_head=dense_init(gen, cfg.d_model, cfg.padded_vocab, dt),
        layers=nn.ModuleList(init_block(gen, cfg, bt)
                             for bt in cfg.layer_pattern()))


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


def _embed(cfg: ArchConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok_emb"][tokens.long()]


def lm_forward(cfg: ArchConfig, params, tokens: torch.Tensor
               ) -> tuple[torch.Tensor, float]:
    """Training-style forward: tokens [B, S] -> (logits [B, S, Vpad],
    aux)."""
    x = _embed(cfg, params, tokens)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None]
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    aux = 0.0
    for p, bt, win in zip(params["layers"], cfg.layer_pattern(),
                          _layer_windows(cfg)):
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                apply_block_train, p, cfg, bt, x, positions, win,
                use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = apply_block_train(p, cfg, bt, x, positions, win)
        aux += a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"].to(x.dtype), aux


def lm_loss(cfg: ArchConfig, params, tokens: torch.Tensor,
            targets: torch.Tensor, aux_weight: float = 0.01
            ) -> torch.Tensor:
    """Mean next-token cross-entropy in float32 over the real vocab (the
    padded columns at -1e30), plus ``aux_weight`` times the blocks' aux
    loss."""
    logits, aux = lm_forward(cfg, params, tokens)
    logits = logits.to(torch.float32)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=logits.device) \
            >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = torch.mean(logz - gold)
    return nll + aux_weight * aux


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device="cuda") -> list[dict]:
    """One cache per layer."""
    return [init_block_cache(cfg, bt, batch, max_seq, device)
            for bt in cfg.layer_pattern()]


def lm_prefill(cfg: ArchConfig, params, tokens: torch.Tensor, max_seq: int
               ) -> tuple[torch.Tensor, list[dict]]:
    """Run the full prompt: (last-token logits [B, 1, Vpad], the filled
    per-layer caches)."""
    x = _embed(cfg, params, tokens)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None]
    caches = []
    for p, bt, win in zip(params["layers"], cfg.layer_pattern(),
                          _layer_windows(cfg)):
        x, c = _prefill_block(p, cfg, bt, x, positions, win, max_seq)
        caches.append(c)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x[:, -1:] @ params["lm_head"].to(x.dtype), caches


def _prefill_block(p, cfg: ArchConfig, bt: str, x: torch.Tensor,
                   positions: torch.Tensor, window: Optional[int],
                   cache_max: int) -> tuple[torch.Tensor, dict]:
    """Forward one block while materializing its decode cache."""
    _require_attn(bt)
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
    att = _sdpa(qh, kh, vh, causal=True, window=window)
    att = att.transpose(1, 2).reshape(b, s_total, -1)
    x = x + att @ p["attn"]["wo"].to(x.dtype)
    x = x + mlp(p["mlp"], rms_norm(x, p["norm2"]), cfg.activation,
                cfg.lut_activations, cfg.quantize_dense)
    return x, {"kv": kv._replace(length=s_total)}


def lm_decode_step(cfg: ArchConfig, params, tokens: torch.Tensor,
                   caches: list[dict]) -> tuple[torch.Tensor, list[dict]]:
    """tokens [B, 1] -> (logits [B, 1, Vpad], new caches).  The caches'
    tensors are written in place (``attention_decode``)."""
    x = _embed(cfg, params, tokens)
    new_caches = []
    for p, bt, c, win in zip(params["layers"], cfg.layer_pattern(), caches,
                             _layer_windows(cfg)):
        x, c = apply_block_decode(p, cfg, bt, x, c, win)
        new_caches.append(c)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"].to(x.dtype), new_caches
