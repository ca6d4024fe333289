"""int8 error-feedback compression as a pluggable ReduceStrategy.

Port of ``repro.systems.compress``.  :class:`CompressedReduce` wraps any
inner strategy and quantizes the float leaves of the reduce payload to
int8 with a persistent error-feedback buffer (EF-SGD), host-side where
the strategy's finalize leg runs.  ``TransferStats.compressed_bytes``
records the int8 bytes moved, and ``pim_to_cpu`` and the topology split
are charged at the compressed width.

* Only float leaves are quantized.  Integer (Q-format) leaves pass
  through exactly, at full width: compressing them would break the
  bit-exactness of the integer versions.
* With a host or hierarchical inner strategy the quantizer sees the
  stacked per-partial leaves before the host combine; with a fabric
  inner it sees the folded total.
* Error feedback persists on the strategy INSTANCE: pass an instance to
  keep the buffers across steps; ``reduce="compressed"`` builds a fresh
  one per call.

:func:`quantize_rows` is the sparse sibling the EMB deferred flush uses
(per-row scales; integer tables get integer scales, so the residual is
exact).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .base import (FabricReduce, ReduceStrategy, StrategyLike, _STRATEGIES,
                   _leaves, _map, _tree_bytes, host_array,
                   resolve_reduce_strategy)


def ef_quantize(arr: np.ndarray, err: np.ndarray):
    """One error-feedback quantization:
    ``(q int8, scale, dequantized f32, new error buffer)``."""
    corrected = np.asarray(arr, np.float32) + err
    amax = float(np.abs(corrected).max()) if corrected.size else 0.0
    scale = max(amax, 1e-12) / 127.0
    q = np.clip(np.rint(corrected / scale), -127, 127).astype(np.int8)
    deq = q.astype(np.float32) * np.float32(scale)
    return q, scale, deq, corrected - deq


def quantize_rows(upd: np.ndarray):
    """Per-row symmetric int8 quantization of sparse update rows
    ``[U, D]`` -> ``(q int8 [U, D], scales [U], deq, residual)``.

    Float rows use f32 scales (the residual is the float quantization
    error); integer Q-format rows use integer scales ``ceil(amax/127)``,
    so ``deq`` and the residual are exact int32 and re-staging the
    residual loses nothing."""
    upd = np.asarray(upd)
    if upd.size == 0:
        z = np.zeros_like(upd)
        return (np.zeros(upd.shape, np.int8),
                np.zeros((upd.shape[0],), np.float32), z, z)
    if np.issubdtype(upd.dtype, np.integer):
        amax = np.abs(upd.astype(np.int64)).max(axis=1)
        scales = np.maximum((amax + 126) // 127, 1)        # int, >= 1
        q = np.clip(np.rint(upd / scales[:, None]),
                    -127, 127).astype(np.int8)
        deq = (q.astype(np.int64) * scales[:, None]).astype(upd.dtype)
        return q, scales.astype(np.int32), deq, upd - deq
    a = upd.astype(np.float32)
    scales = np.maximum(np.abs(a).max(axis=1), 1e-12) / 127.0
    scales = scales.astype(np.float32)
    q = np.clip(np.rint(a / scales[:, None]), -127, 127).astype(np.int8)
    deq = (q.astype(np.float32) * scales[:, None]).astype(upd.dtype)
    return q, scales, deq, upd - deq


def _is_float(v) -> bool:
    if isinstance(v, torch.Tensor):
        return v.is_floating_point()
    return np.issubdtype(np.asarray(v).dtype, np.floating)


class CompressedReduce(ReduceStrategy):
    """int8 + error-feedback over any inner :class:`ReduceStrategy`."""

    fusable = False  # the quantizer is a host-side finalize leg

    def __init__(self, inner: StrategyLike = None):
        self.inner = (inner if isinstance(inner, ReduceStrategy)
                      else resolve_reduce_strategy(inner, FabricReduce()))
        #: persistent error-feedback buffers keyed by leaf position (the
        #: order of ``_leaves``: dict keys sorted)
        self._err: Dict[int, np.ndarray] = {}

    def bind(self, system) -> "CompressedReduce":
        self.inner = self.inner.bind(system)
        return self  # NOT a copy: the buffers must survive across steps

    def cache_token(self):
        return ("compressed", self.inner.cache_token())

    def device_reduce(self, partials):
        return self.inner.device_reduce(partials)

    def device_reduce_full(self, partials):
        return self.inner.device_reduce_full(partials)

    def rank_reduce(self, partials, blocks):
        return self.inner.rank_reduce(partials, blocks)

    def rank_reduce_full(self, partials, blocks):
        return self.inner.rank_reduce_full(partials, blocks)

    def finalize(self, system, out):
        positions = iter(range(len(_leaves(out))))

        def _leaf(leaf):
            i = next(positions)
            arr = host_array(leaf)
            if not np.issubdtype(arr.dtype, np.floating):
                return arr  # Q-format stays exact, full width
            err = self._err.get(i)
            if err is None or err.shape != arr.shape:
                err = np.zeros(arr.shape, np.float32)
            _, _, deq, new_err = ef_quantize(arr, err)
            self._err[i] = new_err
            return deq.astype(arr.dtype)
        return self.inner.finalize(system, _map(_leaf, out))

    def _wire_bytes(self, full_bytes: int, out) -> int:
        """Compressed wire width of an inner leg that would move
        ``full_bytes``: every (4-byte) float element ships as one int8
        byte, plus one f32 scale per float leaf; integer leaves ship at
        full width."""
        floats = [v for v in _leaves(out) if _is_float(v)]
        total = max(_tree_bytes(out), 1)
        float_bytes = full_bytes * _tree_bytes(floats) // total
        return (full_bytes - float_bytes) + float_bytes // 4 + 4 * len(floats)

    def count_pim_to_cpu(self, system, out) -> int:
        wire = self._wire_bytes(self.inner.count_pim_to_cpu(system, out),
                                out)
        system.stats.compressed_bytes += wire
        return wire

    def count_topology(self, system, out) -> tuple:
        local, cross = self.inner.count_topology(system, out)
        return self._wire_bytes(local, out), self._wire_bytes(cross, out)


_STRATEGIES["compressed"] = CompressedReduce
