"""Lookup-table sigmoid and the fixed-point Taylor baseline (paper §3.2).

Port of the sigmoid half of ``repro.core.lut``.  The paper's LUT holds
sigmoid over [0, 20) at 10 fractional bits: 20 * 1024 int16 entries
(40 KB), reflected for negative inputs.  On the DPU it sits in the 64 KB
WRAM scratchpad or in the MRAM bank; on the H100 the ``lut_sigmoid``
kernel stages it in shared memory or reads it from global memory
(:mod:`repro_torch.kernels.lut_activation`).  This module keeps the
functional core: the table builder (numpy, as in the reference), the
plain fixed-point lookup, and the Taylor-series sigmoid of LOG-INT32.

It also holds the LM stack's activation LUTs (:class:`ActivationLut`,
``silu_lut``, ``gelu_lut``): the paper's Recommendation #5 applied to
SiLU and GELU under ``lut_activations``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from .fixed_point import _shift_round


@dataclasses.dataclass
class SigmoidLut:
    """Paper-faithful sigmoid LUT (Fig. 4).

    ``table[i] = round(sigmoid(i / 2**frac_bits) * 2**value_frac)`` for
    i in [0, boundary << frac_bits), stored int16 on one device.
    """

    table: torch.Tensor  # int16 [boundary << frac_bits]
    frac_bits: int
    boundary: int
    value_frac: int

    @property
    def nbytes(self) -> int:
        return self.table.numel() * 2


def build_sigmoid_lut(boundary: int = 20, frac_bits: int = 10,
                      value_frac: int = 15,
                      device: torch.device | str = "cpu") -> SigmoidLut:
    n = boundary << frac_bits
    xs = np.arange(n, dtype=np.float64) / float(1 << frac_bits)
    vals = 1.0 / (1.0 + np.exp(-xs))
    table = np.clip(np.round(vals * (1 << value_frac)), 0,
                    2 ** 15 - 1).astype(np.int16)
    return SigmoidLut(torch.from_numpy(table).to(device), frac_bits,
                      boundary, value_frac)


def lut_sigmoid_fixed(x_q: torch.Tensor, lut: SigmoidLut) -> torch.Tensor:
    """Sigmoid of Q(lut.frac_bits) input -> Q(lut.value_frac), int32.

    |x|, clamp at the boundary, one table read, reflection for x < 0.
    ``abs`` wraps at INT32_MIN to a negative index, which the clamp sends
    to 0 — as the reference's ``table[idx]`` normalizes and clamps it."""
    xq = x_q.to(torch.int32)
    idx = torch.clamp(torch.abs(xq), 0, lut.table.numel() - 1)
    v = lut.table[idx.long()].to(torch.int32)
    return torch.where(xq < 0, (1 << lut.value_frac) - v, v)


def taylor_exp_fixed(x_q: torch.Tensor, frac_bits: int, terms: int = 8,
                     range_shift: int = 3) -> torch.Tensor:
    """exp(-|x|) for Q(frac_bits) input: fixed-point Taylor series with
    range reduction exp(-x) = exp(-x / 2**m) ** (2**m).  Returns Q(f)."""
    one = 1 << frac_bits
    a = torch.clamp(torch.abs(x_q.to(torch.int32)), max=20 << frac_bits)
    t = a >> range_shift  # reduced argument, Q(frac_bits)
    # Horner evaluation of sum_k (-t)^k / k!; constants floor-divide as
    # the reference's int32 ``one // k!`` does (both operands positive)
    acc = torch.full_like(t, one // math.factorial(terms - 1))
    for k in range(terms - 2, -1, -1):
        acc = one // math.factorial(k) - _shift_round(t * acc, frac_bits)
    acc = torch.clamp(acc, min=0)
    for _ in range(range_shift):  # square back up
        acc = _shift_round(acc * acc, frac_bits)
    return acc


def taylor_sigmoid_fixed(x_q: torch.Tensor, frac_bits: int,
                         terms: int = 8) -> torch.Tensor:
    """sigmoid(x) = 1 / (1 + exp(-x)) in Q(frac_bits) via the Taylor exp
    and an integer floor division (``jnp``'s ``//``)."""
    one = 1 << frac_bits
    e = taylor_exp_fixed(x_q, frac_bits, terms=terms)  # exp(-|x|), Q(f)
    pos = torch.div(torch.full_like(e, 1 << (2 * frac_bits)),
                    torch.clamp(one + e, min=1), rounding_mode="floor")
    return torch.where(x_q < 0, one - pos, pos)


# ---------------------------------------------------------------------------
# Generic activation LUT for the LM stack (beyond-paper application).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ActivationLut:
    """Uniform-grid LUT for an activation over [x_min, x_max] (port of the
    reference's ``ActivationLut``).

    The table is built in float64 numpy and stored float32; a lookup takes
    entry ``round((x - x_min) / (x_max - x_min) * (n - 1))``, clipped to
    the table, and returns it in x's dtype.  The index is an integer, so
    no gradient reaches x (``jax.grad`` gives exactly 0 there).
    """

    table: np.ndarray  # float32 [n_entries]
    x_min: float
    x_max: float

    def __post_init__(self):
        self._on: dict = {}   # the table as a tensor, per device

    @classmethod
    def from_fn(cls, fn: Callable, x_min: float = -8.0, x_max: float = 8.0,
                n_entries: int = 4096) -> "ActivationLut":
        xs = np.linspace(x_min, x_max, n_entries, dtype=np.float64)
        table = np.asarray(fn(xs), dtype=np.float32)
        return cls(table, float(x_min), float(x_max))

    def table_on(self, device) -> torch.Tensor:
        device = torch.device(device)
        t = self._on.get(device)
        if t is None:
            t = self._on[device] = torch.from_numpy(self.table).to(device)
        return t

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        table = self.table_on(x.device)
        n = table.shape[0]
        with torch.no_grad():
            t = (x.to(torch.float32) - self.x_min) / (self.x_max - self.x_min)
            idx = torch.clamp(torch.round(t * (n - 1)), 0, n - 1).long()
        return table[idx].to(x.dtype)


def silu_lut(n_entries: int = 4096) -> ActivationLut:
    return ActivationLut.from_fn(lambda x: x / (1.0 + np.exp(-x)),
                                 x_min=-12.0, x_max=12.0, n_entries=n_entries)


def gelu_lut(n_entries: int = 4096) -> ActivationLut:
    # tanh-form GELU, as the reference
    c = np.sqrt(2.0 / np.pi)
    return ActivationLut.from_fn(
        lambda x: 0.5 * x * (1 + np.tanh(c * (x + 0.044715 * x ** 3))),
        x_min=-12.0, x_max=12.0, n_entries=n_entries)
