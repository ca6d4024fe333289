"""int8-compressed gradient all-reduce with error feedback (port of
``repro.optim.grad_compression``).

The paper's central numerics insight — quantize to match what the hardware
moves/computes natively — applied to the *collective* term: gradients are
symmetrically quantized to int8 before the cross-replica reduction, with a
persistent error-feedback buffer so the quantization noise is unbiased over
steps (Karimireddy et al.-style EF-SGD).

The reference's arithmetic, op for op (a process group where it takes an
axis name): the scale is the group's MAX of ``max|g|``, ``max(amax,
1e-12) / 127``; ``round`` is half to even; every division is a true
division; the integer sum is an all-reduce in int32.  So the payload on
the wire is int32, 4 bytes an element: :func:`compressed_bytes_saved`
keeps the reference's 1-byte model, and the collectives count what they
are handed (``distributed.collectives.traffic``).

Used by the data-parallel trainer (``train/loop.py``); plain torch, as the
reference's is plain ``jnp``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..distributed.collectives import all_reduce, divide


def _scale(amax: torch.Tensor, group) -> torch.Tensor:
    all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    return divide(torch.clamp(amax, min=1e-12), 127.0)


def compress_decompress_psum(g: torch.Tensor, group=None) -> torch.Tensor:
    """Quantize -> int8 sum (in int32 to avoid overflow) -> dequantize.

    The scale itself is max-reduced first (one tiny collective) so every
    rank uses the same grid."""
    scale = _scale(torch.max(torch.abs(g)), group)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    total = all_reduce(q.to(torch.int32), group=group)
    return total.to(torch.float32) * scale


def ef_compress_psum(g: torch.Tensor, err: torch.Tensor, group,
                     world: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback variant: returns (mean gradient, new error buffer);
    each rank keeps its own buffer."""
    (mean,), (new_err,) = ef_compress_psum_stacked([g], [err], group, world)
    return mean, new_err


def ef_compress_psum_stacked(gs: list, errs: list, group, world: int
                             ) -> tuple[list, list]:
    """:func:`ef_compress_psum` of the tensors ``gs`` stacked along a new
    leading axis, without the stacked copy: one scale over all of them
    (the reference quantizes its stacked ``[reps, ...]`` layer leaves with
    one scale; the port keeps a tensor a layer).  Returns the lists of
    mean gradients and new error buffers."""
    corrected = [g.to(torch.float32) + e for g, e in zip(gs, errs)]
    amax = torch.stack([torch.max(torch.abs(c)) for c in corrected]).max()
    scale = _scale(amax, group)
    means, new_errs = [], []
    for c in corrected:
        q = torch.clamp(torch.round(c / scale), -127, 127)
        new_errs.append(c - q * scale)
        total = all_reduce(q.to(torch.int32), group=group)
        means.append(divide(total.to(torch.float32) * scale, world))
    return means, new_errs


def _leaves(tree) -> dict:
    if hasattr(tree, "named_parameters"):
        return dict(tree.named_parameters())
    return dict(tree)


def init_error_buffers(grads_tree) -> dict:
    """Float32 zeros for every leaf of a gradient dict or a Params tree,
    by name."""
    return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for n, g in _leaves(grads_tree).items()}


def compressed_bytes_saved(grads_tree) -> tuple[int, int]:
    """(bytes f32 all-reduce, bytes int8 all-reduce) for reporting: the
    reference's model."""
    n = sum(g.numel() for g in _leaves(grads_tree).values())
    return 4 * n, n

