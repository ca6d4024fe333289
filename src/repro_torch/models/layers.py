"""Shared layers of the LM stack (port of ``repro.models.layers``).

Conventions, as in the reference:
  - a layer's parameters live in a :class:`Params` module whose names are
    the reference's dict keys, read as ``params["wq"]``;
  - matmuls run in the config dtype (bf16 by default) with float32
    normalization statistics;
  - ``quantize_dense`` routes every MLP linear through the int8 path
    (``models/quantized.py``), the paper's LIN-HYB analogue, and
    ``lut_activations`` runs SiLU/GELU as table lookups (``core/lut.py``),
    the LOG-LUT analogue.

:class:`Params` leaves never require a gradient until a trainer asks for
them with :meth:`Params.trainable_`, so serving builds no graph.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.lut import ActivationLut, gelu_lut, silu_lut

# Module-level LUTs, built once (16 KB each), as the reference's.
_ACT_LUTS: dict[str, ActivationLut] = {}


def _get_act_lut(name: str) -> ActivationLut:
    if name not in _ACT_LUTS:
        _ACT_LUTS[name] = {"silu": silu_lut, "gelu": gelu_lut}[name]()
    return _ACT_LUTS[name]


class Params(nn.Module):
    """A group of named parameters and sub-groups, read like the reference's
    parameter dicts: ``p["wq"]``, ``"gate" in p``."""

    def __init__(self, /, **entries):   # "self" may name an entry
        super().__init__()
        for name, value in entries.items():
            if isinstance(value, nn.Module):
                self.add_module(name, value)
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def load_(self, named: dict) -> "Params":
        """Copy ``named[name]`` (a restored checkpoint's tensors, DTensors
        laid out as the leaves) into every leaf in place; returns self."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                p.copy_(named[name])
        return self

    def trainable_(self) -> "Params":
        """Let every floating-point leaf require a gradient, in place;
        returns self."""
        for p in self.parameters():
            if p.is_floating_point():
                p.requires_grad_(True)
        return self


def leaf_shapes(init, cfg) -> dict:
    """``init(cfg, generator)``'s leaves as meta tensors by
    ``named_parameters()`` name: their shapes and dtypes, drawn from
    nothing (``FakeTensorMode``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        params = init(cfg, torch.Generator(device="cpu"))
        return {n: torch.empty(p.shape, dtype=p.dtype, device="meta")
                for n, p in params.named_parameters()}


def activation(x: torch.Tensor, name: str, lut: bool = False
               ) -> torch.Tensor:
    if lut:
        return _get_act_lut(name)(x)
    if name == "silu":
        return F.silu(x)
    if name == "gelu":                 # jax.nn.gelu's default: the tanh form
        return F.gelu(x, approximate="tanh")
    raise ValueError(name)


# -- initializers -----------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype) -> torch.Tensor:
    """N(0, 1/d_in) in float32, cast to ``dtype``, on ``gen``'s device."""
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(1.0 / math.sqrt(d_in)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype) -> torch.Tensor:
    return normal_init(gen, (vocab, d), 0.02, dtype)


def normal_init(gen: torch.Generator, shape, scale: float,
                dtype: torch.dtype) -> torch.Tensor:
    """N(0, scale^2) of ``shape`` in float32, cast to ``dtype``, on
    ``gen``'s device."""
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(scale).to(dtype)


# -- norms -------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.to(torch.float32)).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with float32 statistics (the population variance, as
    ``jnp.var``)."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


# -- rotary embeddings --------------------------------------------------------

def rope_frequencies(head_dim: int, fraction: float, theta: float
                     ) -> np.ndarray:
    """Inverse frequencies for the rotary fraction of the head dim."""
    rot = int(head_dim * fraction) // 2 * 2
    return 1.0 / (theta ** (np.arange(0, rot, 2, dtype=np.float64) / rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, fraction: float,
               theta: float) -> torch.Tensor:
    """x: [B, H, S, D]; positions: [B, S] or [S].  Partial rotary
    (stablelm-style): only the first ``fraction`` of D is rotated, its
    even and odd columns as pairs."""
    d = x.shape[-1]
    rot = int(d * fraction) // 2 * 2
    if rot == 0:
        return x
    inv = torch.as_tensor(rope_frequencies(d, fraction, theta),
                          dtype=torch.float32, device=x.device)
    ang = positions.to(torch.float32)[..., None] * inv  # [B?, S, rot/2]
    if ang.dim() == 2:
        ang = ang[None]
    cos = torch.cos(ang)[:, None]                        # [B, 1, S, rot/2]
    sin = torch.sin(ang)[:, None]
    xr = x[..., :rot].to(torch.float32)
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    rotated = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                          dim=-1).reshape(xr.shape)
    return torch.cat([rotated.to(x.dtype), x[..., rot:]], dim=-1)


def sinusoidal_positions(n: int, d: int) -> np.ndarray:
    """Whisper-style sinusoidal position embeddings [n, d], float32: the
    sines of the d/2 frequencies, then their cosines."""
    pos = np.arange(n)[:, None]
    dim = np.arange(d // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * dim / d)
    return np.concatenate([np.sin(angle), np.cos(angle)],
                          axis=1).astype(np.float32)


# -- dense layer with the paper's quantized path -------------------------------

def linear(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None,
           quantized: bool = False) -> torch.Tensor:
    """``w`` is a float [K, N] weight or a quantized one
    (``models/quantized.py``); ``quantized`` takes the int8 path."""
    if quantized:
        from .quantized import pim_dense
        out = pim_dense(x, w)
    else:
        from ..distributed.tp import matmul
        out = matmul(x, w)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


# -- MLP blocks ----------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype, gated: bool = True) -> Params:
    p = {"up": dense_init(gen, d_model, d_ff, dtype),
         "down": dense_init(gen, d_ff, d_model, dtype)}
    if gated:
        p["gate"] = dense_init(gen, d_model, d_ff, dtype)
    return Params(**p)


def mlp(params, x: torch.Tensor, act: str = "silu", lut: bool = False,
        quantized: bool = False) -> torch.Tensor:
    from ..distributed.act_sharding import constrain
    # the stream whole on every "model" rank before the column-parallel
    # products (a sharded residual would make DTensor gather the weights)
    x = constrain(x, "btd")
    up = constrain(linear(x, params["up"], quantized=quantized), "btf")
    if "gate" in params:
        h = activation(constrain(linear(x, params["gate"],
                                        quantized=quantized), "btf"),
                       act, lut) * up
    else:
        h = activation(up, act, lut)
    return constrain(linear(h, params["down"], quantized=quantized), "btd")
