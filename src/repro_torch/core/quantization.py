"""Symmetric quantization utilities (paper §3, §5.4).

Port of ``repro.core.quantization``: ``x ~= q * scale`` with signed
``bits``-bit integers, one scale per tensor or one per index of an axis.
It feeds the quantized LM linears (``models/quantized.py``,
``kernels/quant_matmul.py``).

The dtypes follow the reference exactly.  The scale keeps the input's
dtype (a bf16 activation gets a bf16 per-tensor scale, and ``x / scale``
rounds in bf16 before ``torch.round``, as XLA does); ``torch.round`` and
``jnp.round`` both round half to even.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_INT_DTYPES = {8: torch.int8, 16: torch.int16, 32: torch.int32}

#: storage width in bytes of every on-bank dtype used by the workloads
STORAGE_BYTES = {"fp32": 4, "int32": 4, "int16": 2, "int8": 1}


def storage_bytes(dtype_name: str) -> int:
    """Bytes per element for a named storage dtype (see STORAGE_BYTES)."""
    try:
        return STORAGE_BYTES[dtype_name]
    except KeyError:
        raise ValueError(
            f"unknown storage dtype {dtype_name!r}; "
            f"known: {sorted(STORAGE_BYTES)}") from None


def int_dtype_for_bits(bits: int) -> torch.dtype:
    """Smallest signed integer dtype that stores `bits`-bit values."""
    for b, dt in _INT_DTYPES.items():
        if bits <= b:
            return dt
    raise ValueError(f"unsupported bit width {bits}")


@dataclasses.dataclass
class QuantParams:
    """Symmetric quantization parameters: ``x ~= q * scale``.

    ``scale`` is a 0-d tensor (per-tensor) or a tensor broadcastable
    against the quantized one (per-channel, reduced dims kept as 1).
    """

    scale: torch.Tensor
    bits: int
    axis: Optional[int] = None

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1


def symmetric_quantize(x: torch.Tensor, bits: int = 8,
                       axis: Optional[int] = None, eps: float = 1e-12
                       ) -> tuple[torch.Tensor, QuantParams]:
    """Quantize ``x`` symmetrically to signed ``bits``-bit integers.

    axis=None -> one scale for the whole tensor;
    axis=k    -> one scale per index of axis k (every other axis reduced).
    The scale has ``x``'s dtype, as ``jnp.maximum(amax, eps) / qmax``
    with weakly typed Python scalars.
    """
    qmax = 2 ** (bits - 1) - 1
    if axis is None:
        amax = torch.amax(torch.abs(x))
    else:
        # as the reference: a negative axis matches no dim, so every dim
        # is reduced (one scale, kept at x's rank)
        reduce_dims = tuple(i for i in range(x.dim()) if i != axis)
        amax = torch.amax(torch.abs(x), dim=reduce_dims, keepdim=True)
    scale = torch.clamp_min(amax, eps) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax)
    return (q.to(int_dtype_for_bits(bits)),
            QuantParams(scale=scale, bits=bits, axis=axis))


def dequantize(q: torch.Tensor, params: QuantParams) -> torch.Tensor:
    return q.to(torch.float32) * params.scale


def quantize_with(x: torch.Tensor, params: QuantParams) -> torch.Tensor:
    """Quantize using pre-computed params (e.g. train-set params on eval
    data)."""
    qmax = params.qmax
    q = torch.clamp(torch.round(x / params.scale), -qmax - 1, qmax)
    return q.to(int_dtype_for_bits(params.bits))
