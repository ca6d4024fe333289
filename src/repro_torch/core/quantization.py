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

from ..kernels.dispatch import is_dtensor

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
        amax = (ShardedAmax.apply(x) if is_dtensor(x)
                else torch.amax(torch.abs(x)))
    else:
        # as the reference: a negative axis matches no dim, so every dim
        # is reduced (one scale, kept at x's rank)
        reduce_dims = tuple(i for i in range(x.dim()) if i != axis)
        amax = (ShardedAmax.apply(x, reduce_dims) if is_dtensor(x) else
                torch.amax(torch.abs(x), dim=reduce_dims, keepdim=True))
    scale = true_divide(torch.clamp_min(amax, eps), qmax)
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax)
    return (q.to(int_dtype_for_bits(bits)),
            QuantParams(scale=scale, bits=bits, axis=axis))


def true_divide(x: torch.Tensor, n) -> torch.Tensor:
    """``x / n`` rounded once, as on the CPU and in XLA: on a CUDA tensor
    ``x / n`` with a Python number multiplies by its reciprocal, one ulp
    off for some x (a quantization scale, then its int8 values, would
    differ from the CPU's)."""
    return x / torch.full((), n, dtype=x.dtype, device=x.device)


class ShardedAmax(torch.autograd.Function):
    """``amax(|x|)`` of a DTensor over ``dims`` (kept, as size 1; None:
    every dim, a 0-d result), reduced over the ranks that split a reduced
    dim, with the gradient ``torch.amax``'s formula gives the whole
    tensor: split evenly over every element at the maximum, on whichever
    rank it lies (DTensor's sharded ``amax`` counts only local ones in
    its backward, and reduces through gloo's max on CUDA tensors)."""

    @staticmethod
    def forward(ctx, x, dims=None):
        from torch.distributed.tensor import DTensor, Replicate
        from ..distributed.collectives import reduce_over
        from ..distributed.tp import mesh_groups
        if any(p.is_partial() for p in x.placements):
            x = x.redistribute(placements=[
                Replicate() if p.is_partial() else p for p in x.placements])
        reduced = (tuple(range(x.ndim)) if dims is None
                   else tuple(d % x.ndim for d in dims))

        def split_reduced(p):
            return p.is_shard() and p.dim in reduced
        groups = mesh_groups(x, split_reduced)
        local = x.to_local()
        m = (torch.amax(torch.abs(local)) if dims is None else
             torch.amax(torch.abs(local), dim=reduced, keepdim=True))
        m = reduce_over(m, "max", groups)
        ctx.save_for_backward(local, m)
        ctx.meta = (x.device_mesh, x.placements, groups, dims, reduced)
        out_pl = [Replicate() if dims is None or split_reduced(p) else p
                  for p in x.placements]
        return DTensor.from_local(m, x.device_mesh, out_pl, run_check=False)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor
        from ..distributed.collectives import reduce_over
        local, m = ctx.saved_tensors
        mesh, placements, groups, dims, reduced = ctx.meta
        mask = torch.abs(local) == m
        count = reduce_over(mask.sum() if dims is None else
                            mask.sum(dim=reduced, keepdim=True),
                            "sum", groups)
        g = grad.to_local() if isinstance(grad, DTensor) else grad
        out = (g / count) * mask * local.sgn()
        return DTensor.from_local(out, mesh, placements,
                                  run_check=False), None


def dequantize(q: torch.Tensor, params: QuantParams) -> torch.Tensor:
    return q.to(torch.float32) * params.scale


def quantize_with(x: torch.Tensor, params: QuantParams) -> torch.Tensor:
    """Quantize using pre-computed params (e.g. train-set params on eval
    data)."""
    qmax = params.qmax
    q = torch.clamp(torch.round(x / params.scale), -qmax - 1, qmax)
    return q.to(int_dtype_for_bits(params.bits))
