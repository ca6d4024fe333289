"""Whisper-style encoder-decoder backbone, whisper-tiny (port of
``repro.models.encdec``).

The conv/mel frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings ``frames`` [B, encoder_seq, d_model].
Encoder blocks: bidirectional self-attention and a GELU MLP; decoder
blocks: causal self-attention, cross-attention over the encoder's output
and the MLP; pre-LayerNorm, sinusoidal positions on both sides.

The reference scans stacked layers with ``lax.scan``; the port keeps one
parameter group per layer (``params["enc"][i]``, ``params["dec"][i]``)
and loops over them in Python.  With ``cfg.remat == "full"`` the
training forward checkpoints each decoder layer, as the reference does.
The encoder computes in the frames' dtype (float32 frames keep a bf16
model's encoder in float32, as in the reference).

The decode cache is a dict of per-layer lists, ``k`` and ``v`` [B, Hkv,
max_seq, D] (self-attention, written in place by a decode step), ``ck``
and ``cv`` [B, Hkv, encoder_seq, D] (the encoder's keys and values,
computed once at prefill and stored contiguous), the filled ``length``
and ``pos``, the sinusoidal table of the cache's ``max_seq`` positions,
built once per cache (the reference rebuilds it on every step).  Prefill
and decode project the cross queries as the forward does, with the bias
and the norm a spec may have; the reference's prefill and decode skip
both, which whisper-tiny does not have.

On sharded parameters (inside ``use_mesh``) the layout is the decoder
LM's: heads, the MLP's hidden units and the vocab over "model", the
batch over the data axes.  The stream is constrained whole over "model"
(``"btd"``) after the embedding and before every layer, as ``lm_forward``
does, the vocab-split token lookup summed there (``transformer._lookup``:
the table never moves), and the logits stay split over the vocab
(``"btv"``), so the loss takes ``VocabParallelNll``.  The frames' rows
lie over the data axes, whole over "model": each rank projects the
encoder's states onto its own cross heads.  The decode cache's tensors
are laid out by ``sharding.cache_tensor`` and written shard by shard.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from ..configs.base import ArchConfig
from ..distributed.act_sharding import constrain, current_mesh
from ..distributed.sharding import cache_tensor
from ..distributed.tp import matmul
from .attention import (AttnSpec, _project_qkv, attend, cross_attention,
                        cross_kv, cross_queries, init_attention)
from .layers import (Params, dense_init, embed_init, init_mlp, layer_norm,
                     mlp, sinusoidal_positions)
from .transformer import _dtype, _lookup, attn_spec, token_nll


def _ln_params(d: int, dt: torch.dtype, device) -> Params:
    return Params(w=torch.ones((d,), dtype=dt, device=device),
                  b=torch.zeros((d,), dtype=dt, device=device))


def _ln(x: torch.Tensor, p, eps: float) -> torch.Tensor:
    return layer_norm(x, p["w"], p["b"], eps)


def _mlp(p, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    return mlp(p["mlp"], x, cfg.activation, cfg.lut_activations,
               cfg.quantize_dense)


def _positions(n: int, d: int, device) -> torch.Tensor:
    return torch.from_numpy(sinusoidal_positions(n, d)).to(device)


def init_enc_block(gen: torch.Generator, cfg: ArchConfig) -> Params:
    dt, d, dev = _dtype(cfg), cfg.d_model, gen.device
    return Params(ln1=_ln_params(d, dt, dev),
                  attn=init_attention(gen, attn_spec(cfg), dt),
                  ln2=_ln_params(d, dt, dev),
                  mlp=init_mlp(gen, d, cfg.d_ff, dt, gated=False))


def init_dec_block(gen: torch.Generator, cfg: ArchConfig) -> Params:
    dt, d, dev = _dtype(cfg), cfg.d_model, gen.device
    return Params(ln1=_ln_params(d, dt, dev),
                  self=init_attention(gen, attn_spec(cfg), dt),
                  ln2=_ln_params(d, dt, dev),
                  cross=init_attention(gen, attn_spec(cfg), dt, cross=True),
                  ln3=_ln_params(d, dt, dev),
                  mlp=init_mlp(gen, d, cfg.d_ff, dt, gated=False))


def init_encdec(cfg: ArchConfig, gen: torch.Generator) -> Params:
    """Random weights drawn from ``gen`` on its device."""
    dt, d, dev = _dtype(cfg), cfg.d_model, gen.device
    return Params(
        tok_emb=embed_init(gen, cfg.padded_vocab, d, dt),
        enc=nn.ModuleList(init_enc_block(gen, cfg)
                          for _ in range(cfg.encoder_layers)),
        dec=nn.ModuleList(init_dec_block(gen, cfg)
                          for _ in range(cfg.n_layers)),
        enc_ln=_ln_params(d, dt, dev), dec_ln=_ln_params(d, dt, dev),
        lm_head=dense_init(gen, d, cfg.padded_vocab, dt))


def _enc_layer(p, cfg: ArchConfig, spec: AttnSpec,
               x: torch.Tensor) -> torch.Tensor:
    y = _ln(x, p["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(p["attn"], spec, y, None)
    x = x + attend(p["attn"], q, k, v, causal=False)
    return x + _mlp(p, cfg, _ln(x, p["ln2"], cfg.norm_eps))


def encode(cfg: ArchConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """frames [B, S_enc, d] (the frontend's stub embeddings) -> the
    encoder's states [B, S_enc, d] in the frames' dtype."""
    pos = _positions(frames.shape[1], cfg.d_model, frames.device)
    x = frames + pos[None].to(frames.dtype)
    spec = attn_spec(cfg)
    for p in params["enc"]:
        x = _enc_layer(p, cfg, spec, constrain(x, "btd"))
    return _ln(x, params["enc_ln"], cfg.norm_eps)


def _dec_embed(cfg: ArchConfig, params, tokens: torch.Tensor,
               offset: int = 0) -> torch.Tensor:
    x = constrain(_lookup(params["tok_emb"], tokens), "btd")
    s = tokens.shape[1]
    pos = _positions(offset + s, cfg.d_model, x.device)[offset:]
    return x + pos[None].to(x.dtype)


def _dec_layer(p, cfg: ArchConfig, x: torch.Tensor,
               enc_states: torch.Tensor) -> torch.Tensor:
    spec, eps = attn_spec(cfg), cfg.norm_eps
    q, k, v = _project_qkv(p["self"], spec, _ln(x, p["ln1"], eps), None)
    x = x + attend(p["self"], q, k, v, causal=True)
    x = x + cross_attention(p["cross"], spec, _ln(x, p["ln2"], eps),
                            enc_states)
    return x + _mlp(p, cfg, _ln(x, p["ln3"], eps))


def _unembed(cfg: ArchConfig, params, x: torch.Tensor) -> torch.Tensor:
    x = _ln(x, params["dec_ln"], cfg.norm_eps)
    return constrain(matmul(x, params["lm_head"]), "btv")


def decoder_forward(cfg: ArchConfig, params, tokens: torch.Tensor,
                    enc_states: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder: tokens [B, S] -> logits [B, S, Vpad]."""
    x = _dec_embed(cfg, params, tokens)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    for p in params["dec"]:
        x = constrain(x, "btd")
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _dec_layer, p, cfg, x, enc_states, use_reentrant=False,
                preserve_rng_state=False)
        else:
            x = _dec_layer(p, cfg, x, enc_states)
    return _unembed(cfg, params, x)


def encdec_loss(cfg: ArchConfig, params, frames: torch.Tensor,
                tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy of the decoder in float32 over the
    real vocab."""
    enc = encode(cfg, params, frames)
    return token_nll(cfg, decoder_forward(cfg, params, tokens, enc), targets)


# -- serving -------------------------------------------------------------------

def init_dec_cache(cfg: ArchConfig, batch: int, max_seq: int,
                   device="cuda") -> dict:
    """An empty decode cache; inside ``use_mesh`` its tensors are DTensors
    over (data axes, "model") (``sharding.cache_tensor``)."""
    spec, mesh = attn_spec(cfg), current_mesh()

    def zeros(seq: int) -> list:        # one tensor a decoder layer
        return [cache_tensor((batch, spec.plan.n_kv, seq, spec.head_dim), 0,
                             _dtype(cfg), device, mesh)
                for _ in range(cfg.n_layers)]
    return {"k": zeros(max_seq), "v": zeros(max_seq),
            "ck": zeros(cfg.encoder_seq), "cv": zeros(cfg.encoder_seq),
            "length": 0, "pos": _positions(max_seq, cfg.d_model, device)}


def encdec_prefill(cfg: ArchConfig, params, frames: torch.Tensor,
                   tokens: torch.Tensor, max_seq: int):
    """Encode, then a teacher-forced decoder pass that fills the decode
    cache: (last-token logits [B, 1, Vpad], cache)."""
    enc = encode(cfg, params, frames)
    spec, eps, dt = attn_spec(cfg), cfg.norm_eps, _dtype(cfg)
    b, s = tokens.shape
    cache = {**init_dec_cache(cfg, b, max_seq, tokens.device), "length": s}
    x = _dec_embed(cfg, params, tokens)
    for i, p in enumerate(params["dec"]):
        x = constrain(x, "btd")
        q, k, v = _project_qkv(p["self"], spec, _ln(x, p["ln1"], eps), None)
        cache["k"][i][:, :, :s] = k
        cache["v"][i][:, :, :s] = v
        x = x + attend(p["self"], q, k, v, causal=True)
        ck, cv = cross_kv(p["cross"], spec, enc, dt)
        cache["ck"][i], cache["cv"][i] = ck, cv
        x = x + attend(p["cross"], cross_queries(
            p["cross"], spec, _ln(x, p["ln2"], eps)), ck, cv, causal=False)
        x = x + _mlp(p, cfg, _ln(x, p["ln3"], eps))
    return _unembed(cfg, params, x[:, -1:]), cache


def encdec_decode_step(cfg: ArchConfig, params, tokens: torch.Tensor,
                       cache: dict):
    """tokens [B, 1] -> (logits [B, 1, Vpad], cache): one decoder step.  The
    new keys and values are written into the cache's tensors in place; the
    returned cache shares them and has ``length`` advanced."""
    spec, eps = attn_spec(cfg), cfg.norm_eps
    length = cache["length"]
    if length >= cache["pos"].shape[0]:
        raise ValueError(f"decode cache full: {length} of "
                         f"{cache['pos'].shape[0]} positions")
    x = constrain(_lookup(params["tok_emb"], tokens), "btd")
    x = x + cache["pos"][length:length + 1][None].to(x.dtype)
    for i, p in enumerate(params["dec"]):
        x = constrain(x, "btd")
        k_l, v_l = cache["k"][i], cache["v"][i]
        q, k, v = _project_qkv(p["self"], spec, _ln(x, p["ln1"], eps), None)
        k_l[:, :, length:length + 1] = k.to(k_l.dtype)
        v_l[:, :, length:length + 1] = v.to(v_l.dtype)
        x = x + attend(p["self"], q, k_l, v_l, causal=True, q_offset=length,
                       kv_len=length + 1)
        x = x + attend(p["cross"], cross_queries(
            p["cross"], spec, _ln(x, p["ln2"], eps)), cache["ck"][i],
            cache["cv"][i], causal=False)
        x = x + _mlp(p, cfg, _ln(x, p["ln3"], eps))
    return _unembed(cfg, params, x), {**cache, "length": length + 1}
