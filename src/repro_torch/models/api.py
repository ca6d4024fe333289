"""Model facade of the LM stack (port of ``repro.models.api``): every
family, the decoder LMs through ``models/transformer.py`` and the audio
family's encoder-decoder through ``models/encdec.py``.

``Model(cfg, device)`` exposes init / loss / forward / prefill /
decode_step / init_cache.  A batch holds ``tokens`` (and ``targets`` for
the loss); the VLM's also ``vision`` [B, vision_tokens, vision_dim], the
audio family's ``frames`` [B, encoder_seq, d_model], numpy arrays or
tensors, moved to the model's device as they are.  Parameters are a
:class:`~repro_torch.models.layers.Params` tree whose names are the
reference's dict keys (nested ``moe``/``mlstm``/``slstm``/``ssm``/
``cross`` groups included), one group per layer under ``layers`` (``enc``
and ``dec`` for the encoder-decoder), and hymba's ``meta`` tokens at the
top.
:func:`params_from_jax` builds that tree from the reference's parameters
(as numpy arrays), so both packages can compute the same function from the
same weights; given the reference's gradient tree (``jax.grad``'s output,
the same structure) it returns the gradients under the port's names.

Init draws from a ``torch.Generator`` on the target device: the
reference's threefry stream cannot be reproduced, and LM parity goes
through :func:`params_from_jax` instead.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from ..configs.base import ArchConfig
from ..configs.shapes import InputShape
from ..distributed.act_sharding import current_mesh
from ..distributed.sharding import (batch_shardings, param_shardings,
                                    param_shardings_fsdp, place,
                                    place_params)
from ..kernels.dispatch import is_dtensor
from ..systems.base import resolve_device
from . import encdec, transformer
from .layers import Params, leaf_shapes

class Model:
    """The LM of ``cfg`` on ``device`` (``"cuda"`` unless the caller asks
    for ``"cpu"``; ``"cuda"`` without a GPU raises)."""

    def __init__(self, cfg: ArchConfig,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.is_encdec = cfg.family == "audio"

    # -- init -----------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None) -> Params:
        """Random weights from ``generator`` (seed 0 on the model's device
        when None)."""
        gen = generator or torch.Generator(device=self.device).manual_seed(0)
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")
        if self.is_encdec:
            return encdec.init_encdec(self.cfg, gen)
        return transformer.init_lm(self.cfg, gen)

    def param_shapes(self) -> dict:
        """Every leaf's shape and dtype as a meta tensor, by
        ``named_parameters()`` name: the weights ``init`` draws, drawn
        from nothing (``FakeTensorMode``)."""
        return leaf_shapes(encdec.init_encdec if self.is_encdec
                           else transformer.init_lm, self.cfg)

    @staticmethod
    def param_count(params: Params) -> int:
        return sum(p.numel() for p in params.parameters())

    # -- sharded parameters -----------------------------------------------------
    def param_specs(self, mesh, tree) -> dict:
        """The reference's specs of ``tree``'s leaves on ``mesh``, every
        family's: FSDP for a config that asks for it, else tensor-parallel
        (the backbone replicated where ``tp_dense`` is off; the MoE's
        experts over "model"; the recurrent mixers on their channels and
        heads; the cross blocks and the encoder-decoder's ``enc`` and
        ``dec`` layers as a decoder LM's attention and MLP)."""
        if self.cfg.fsdp:
            return param_shardings_fsdp(mesh, tree)
        return param_shardings(mesh, tree, tp_dense=self.cfg.tp_dense)

    def place(self, params: Params, mesh) -> Params:
        """``params`` (the same on every rank: ``init`` from one seed, or
        ``params_from_jax``) laid out on ``mesh`` by :meth:`param_specs`,
        in place, each rank keeping its shards."""
        return place_params(params, mesh, self.param_specs(mesh, params))

    def init_placed(self, mesh,
                    generator: Optional[torch.Generator] = None) -> Params:
        """``place(init(generator), mesh)``, each layer laid out as soon as
        it is drawn: a rank holds the whole of one layer at a time beside
        its shards (dbrx-132b's 264 GB never whole), and the values are
        ``init``'s.  The encoder-decoder is drawn whole, then placed:
        whisper-tiny's 68M parameters (its heads and vocab padded) fit
        beside any rank's shards."""
        if self.is_encdec:
            return self.place(self.init(generator), mesh)
        gen = generator or torch.Generator(device=self.device).manual_seed(0)
        specs = self.param_specs(mesh, self.param_shapes())

        def place_layer(i: int, group: Params) -> Params:
            pre = f"layers.{i}."
            return place_params(group, mesh, {
                n[len(pre):]: s for n, s in specs.items()
                if n.startswith(pre)})
        return place_params(transformer.init_lm(self.cfg, gen, place_layer),
                            mesh, specs)

    def _on_device(self, a) -> torch.Tensor:
        """``a`` on the model's device; inside ``use_mesh`` a DTensor with
        its rows over the data axes (the global batch, the same on every
        rank)."""
        t = torch.as_tensor(a, device=self.device)
        mesh = current_mesh()
        if mesh is None or is_dtensor(t):
            return t
        return place(t, mesh, batch_shardings(mesh, {"x": t})["x"])

    def _extras(self, batch: dict) -> dict:
        """The decoder's inputs beside the tokens: the VLM's vision states
        as ``cross_states``."""
        if self.cfg.family == "vlm":
            return {"cross_states": self._on_device(batch["vision"])}
        return {}

    # -- training -----------------------------------------------------------------
    def loss(self, params: Params, batch: dict) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch["tokens"]`` against
        ``batch["targets"]`` plus 0.01 times the MoE aux loss (float32
        scalar)."""
        tokens = self._on_device(batch["tokens"])
        targets = self._on_device(batch["targets"])
        if self.is_encdec:
            return encdec.encdec_loss(self.cfg, params,
                                      self._on_device(batch["frames"]),
                                      tokens, targets)
        return transformer.lm_loss(self.cfg, params, tokens, targets,
                                   self._extras(batch))

    def forward(self, params: Params, batch: dict) -> torch.Tensor:
        tokens = self._on_device(batch["tokens"])
        if self.is_encdec:
            enc = encdec.encode(self.cfg, params,
                                self._on_device(batch["frames"]))
            return encdec.decoder_forward(self.cfg, params, tokens, enc)
        logits, _ = transformer.lm_forward(self.cfg, params, tokens,
                                           self._extras(batch))
        return logits

    # -- serving ----------------------------------------------------------------
    def prefill(self, params: Params, batch: dict, max_seq: int):
        tokens = self._on_device(batch["tokens"])
        if self.is_encdec:
            return encdec.encdec_prefill(self.cfg, params,
                                         self._on_device(batch["frames"]),
                                         tokens, max_seq)
        return transformer.lm_prefill(self.cfg, params, tokens, max_seq,
                                      self._extras(batch))

    def decode_step(self, params: Params, tokens, cache, extras=None):
        """One token a sequence: (logits [B, 1, Vpad], cache).  ``extras``
        is the reference's argument and is not read: the cross blocks
        attend to the keys and values their cache holds since prefill."""
        tokens = self._on_device(tokens)
        if self.is_encdec:
            return encdec.encdec_decode_step(self.cfg, params, tokens, cache)
        return transformer.lm_decode_step(self.cfg, params, tokens, cache)

    def init_cache(self, batch: int, max_seq: int):
        """Empty decode caches on the model's device; inside ``use_mesh``
        laid out by ``cache_shardings`` (the recurrent states by
        ``state_spec``)."""
        if self.is_encdec:
            return encdec.init_dec_cache(self.cfg, batch, max_seq,
                                         self.device)
        return transformer.init_cache(self.cfg, batch, max_seq, self.device)


def input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """Meta-tensor stand-ins for a step's data inputs (the reference's
    ``ShapeDtypeStruct``s).

    train   : {tokens, targets (+vision/frames)}
    prefill : {tokens (+vision/frames)}
    decode  : {tokens [B, 1], cache}
    """
    b, s = shape.global_batch, shape.seq_len

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")
    dt, tok = getattr(torch, cfg.dtype), torch.int32
    if shape.kind == "decode":
        cache = (encdec.init_dec_cache(cfg, b, s, "meta")
                 if cfg.family == "audio"
                 else transformer.init_cache(cfg, b, s, "meta"))
        return {"tokens": meta((b, 1), tok), "cache": cache}
    spec = {"tokens": meta((b, s), tok)}
    if shape.kind == "train":
        spec["targets"] = meta((b, s), tok)
    if cfg.family == "vlm":
        spec["vision"] = meta((b, cfg.vision_tokens, cfg.vision_dim), dt)
    if cfg.family == "audio":
        spec["frames"] = meta((b, cfg.encoder_seq, cfg.d_model), dt)
    return spec


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bf16: exact via f32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def _params(tree: dict, index: Optional[int], device) -> Params:
    """A Params group from a dict of arrays, taking ``[index]`` of each
    leaf when the tree is stacked."""
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out[name] = _params(value, index, device)
        else:
            out[name] = _tensor(value if index is None else value[index],
                                device)
    return Params(**out)


def params_from_jax(cfg: ArchConfig, tree: dict,
                    device: Union[str, torch.device] = "cuda") -> Params:
    """The reference's parameter tree (``init_lm``'s or ``init_encdec``'s
    dict, leaves as numpy arrays) as the port's.  A decoder LM's scanned
    ``unit`` axis ``[reps, ...]`` is unstacked into one group per layer,
    layer ``r * len(unit) + u`` from rep ``r`` of unit slot ``u`` (xLSTM's
    unit is 7 mLSTM blocks and an sLSTM one, the VLM's 4 attention blocks
    and a cross one); the encoder-decoder's ``enc`` and ``dec`` stacks
    into one group per layer each.  A gradient tree of the same structure
    converts the same way (``named_parameters()`` then pairs each
    gradient with the port's leaf of that name)."""
    dev = resolve_device(device)
    if cfg.family == "audio":
        return Params(
            **{name: _tensor(tree[name], dev)
               for name in ("tok_emb", "lm_head")},
            **{name: _params(tree[name], None, dev)
               for name in ("enc_ln", "dec_ln")},
            enc=nn.ModuleList(_params(tree["enc"], i, dev)
                              for i in range(cfg.encoder_layers)),
            dec=nn.ModuleList(_params(tree["dec"], i, dev)
                              for i in range(cfg.n_layers)))
    unit, reps = transformer.unit_pattern(cfg)
    layers = [_params(tree["unit"][u], r, dev)
              for r in range(reps) for u in range(len(unit))]
    top = {name: _tensor(tree[name], dev)
           for name in ("tok_emb", "final_norm", "lm_head", "meta")
           if name in tree}
    return Params(**top, layers=nn.ModuleList(layers))


def stacked_groups(cfg: ArchConfig, names) -> list[list[str]]:
    """The port's leaf ``names`` grouped by the reference leaf that holds
    them, in ``names``' order of first appearance, layers in order within a
    group: a decoder LM's ``layers.{r * len(unit) + u}.<rest>`` over the
    reps ``r`` of unit slot ``u`` (the reference's ``unit[u]`` leaf
    ``[reps, ...]``), the encoder-decoder's ``enc.{i}.<rest>`` and
    ``dec.{i}.<rest>`` over ``i``; every other leaf alone."""
    slots = (len(transformer.unit_pattern(cfg)[0])
             if cfg.family != "audio" else None)
    groups: dict = {}
    for name in names:
        parts = name.split(".")
        if parts[0] == "layers":
            key = ("layers", int(parts[1]) % slots, *parts[2:])
        elif parts[0] in ("enc", "dec") and len(parts) > 2:
            key = (parts[0], *parts[2:])
        else:
            key = (name,)
        groups.setdefault(key, []).append(name)
    return [sorted(g, key=lambda n: int(n.split(".")[1])) if len(g) > 1
            else g for g in groups.values()]
