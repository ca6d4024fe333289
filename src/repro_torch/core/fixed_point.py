"""Fixed-point (Q-format) arithmetic, the numeric substrate of the paper.

Port of ``repro.core.fixed_point``.  Real values are 32-bit Q(m.f)
integers (value = int / 2**f); products shift right by ``frac_bits``
right after each multiply, so every intermediate fits int32.

int32 arithmetic wraps in two's complement, as in the reference.  Sums
pass ``dtype=torch.int32`` explicitly: ``torch.sum`` would otherwise
promote int32 to int64 where ``jnp.sum`` keeps int32 (an integer sum mod
2**32 is independent of order, so every backend agrees bit for bit).
"""
from __future__ import annotations

import torch


def mul_round_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Correctly-rounded float32 product: the float64 product of two
    float32 values is exact, and the down-convert rounds it once.  The
    caller's ``x - mul_round_f32(s, g)`` therefore rounds twice
    (multiply, then subtract) on every device, never as one fused
    multiply-add — the reference's two-rounding contract."""
    return (a.to(torch.float64) * b.to(torch.float64)).to(torch.float32)


def to_fixed(x, frac_bits: int, dtype: torch.dtype = torch.int32
             ) -> torch.Tensor:
    """float -> Q(frac_bits) fixed point, saturating at the dtype range.

    Rounds half to even in float32 (``torch.round``, as ``jnp.round``),
    then clamps in float64, where both int32 bounds are exact, so an
    out-of-range value saturates as XLA's convert does."""
    info = torch.iinfo(dtype)
    scaled = torch.round(torch.as_tensor(x).to(torch.float32)
                         * float(1 << frac_bits))
    return torch.clamp(scaled.to(torch.float64), info.min,
                       info.max).to(dtype)


def from_fixed(q: torch.Tensor, frac_bits: int) -> torch.Tensor:
    return q.to(torch.float32) / float(1 << frac_bits)


def _shift_round(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Arithmetic right-shift with round-to-nearest (ties toward +inf)."""
    if shift == 0:
        return x
    return (x + (1 << (shift - 1))) >> shift


def fx_dot(x_q: torch.Tensor, w_q: torch.Tensor, frac_bits: int
           ) -> torch.Tensor:
    """Fixed-point dot product along the last axis: Q(f) · Q(f) -> Q(f),
    each product shifted back to Q(f) before the int32 accumulation."""
    prod = x_q.to(torch.int32) * w_q.to(torch.int32)
    return torch.sum(_shift_round(prod, frac_bits), dim=-1,
                     dtype=torch.int32)


def fx_dot_hybrid(x_q8: torch.Tensor, w_q16: torch.Tensor, x_frac: int,
                  w_frac: int, out_frac: int,
                  acc_dtype: torch.dtype = torch.int16) -> torch.Tensor:
    """Hybrid-precision dot product (paper's LIN-HYB / LOG-HYB-LUT).

    8-bit inputs x 16-bit weights; products rescaled to Q(out_frac) and
    accumulated with saturation at 16 bits, sequentially over the
    feature axis — the paper's 16-bit dot product.  This sequential clip
    is no matmul, so it stays inline here, as in the reference.
    Returns Q(out_frac) in int32."""
    prod = x_q8.to(torch.int32) * w_q16.to(torch.int32)  # Q(x_frac+w_frac)
    shift = x_frac + w_frac - out_frac
    prod = _shift_round(prod, shift) if shift > 0 else prod << (-shift)
    info = torch.iinfo(acc_dtype)
    acc = torch.zeros(prod.shape[:-1], dtype=torch.int32,
                      device=prod.device)
    for i in range(prod.shape[-1]):
        acc = torch.clamp(acc + prod[..., i], info.min, info.max)
    return acc
