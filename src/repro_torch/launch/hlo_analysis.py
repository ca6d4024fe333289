"""Per-rank op accounting of a traced step for the roofline (the port's
counterpart of ``repro.launch.hlo_analysis``, whose name it keeps).

The reference walks XLA's compiled HLO.  The port has no HLO: a step runs
eagerly, so :class:`OpTrace` counts the ops one rank runs while it does,
under the keys of the reference's ``corrected_totals``:

  - ``flops``: matrix-product flops of the rank's **local** shards
    (``2 M N K``: ``torch.utils.flop_counter``'s formulas), plus each
    kernel-tier launch's declared cost (``kernels/dispatch.py``).
    Elementwise flops are left out, as the reference leaves them out;
  - ``traffic_bytes``: twice the bytes of every op's output (written,
    then read once), the reference's proxy, plus each kernel's declared
    bytes;
  - ``collective_bytes``, ``collectives`` and ``collective_counts``: the
    output bytes of each ``_c10d_functional`` collective (the reference
    sums each collective's output shape), by the reference's kind names.

A loop runs as many times as it runs, so nothing needs the reference's
trip-count correction.  A DTensor op is counted through the local ops it
runs: the mode declines the DTensor-level call (``NotImplemented``), and
the shape-only ops DTensor runs on global shapes to propagate its
sharding run with the modes above it off (:meth:`OpTrace.__enter__`), so
neither this counter nor a memory tracker beside it sees them.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten

from ..kernels import dispatch
from ..systems.gpu_model import MATMUL_FLOPS, NO_WORK

#: ``_c10d_functional`` op -> the reference's collective kind
COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}


def _tensors(tree) -> list:
    return [v for v in tree_flatten(tree)[0] if isinstance(v, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpTrace(TorchDispatchMode):
    """Counts what one rank runs under it (module docstring); read the
    totals with :meth:`totals`.  It is pushed on ``dispatch.meters``, so
    a kernel-tier op is charged its declared cost (on its local shards)
    and what the op runs is not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.traffic_bytes = 0.0
        self.coll_bytes: dict = {}
        self.coll_counts: dict = {}
        self.n_ops = 0
        self._paused = 0
        self._propagator = None

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        prop = DTensor._op_dispatcher.sharding_propagator
        meta = prop._propagate_tensor_meta_non_cached

        def shape_only(op_schema):      # DTensor's global-shape fake ops
            with _disable_current_modes():
                return meta(op_schema)
        prop._propagate_tensor_meta_non_cached = shape_only
        self._propagator = prop
        dispatch.meters.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        dispatch.meters.remove(self)
        del self._propagator._propagate_tensor_meta_non_cached
        return super().__exit__(*exc)

    def charge(self, cost: dispatch.KernelCost) -> None:
        """Charge one kernel-tier launch its declared cost."""
        self.flops += cost.ops
        self.traffic_bytes += cost.bytes

    @contextlib.contextmanager
    def paused(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is not torch.Tensor and dispatch.is_dtensor_type(t)
               for t in types):
            return NotImplemented      # counted through its local ops
        out = func(*args, **kwargs)
        if not self._paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        if func.namespace == "_c10d_functional":
            kind = COLLECTIVES.get(name)
            if kind is not None:
                nbytes = sum(map(_nbytes, _tensors(out)))
                self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + nbytes
                self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
            return
        if func.is_view or name in NO_WORK:
            return
        self.n_ops += 1
        self.traffic_bytes += 2.0 * sum(map(_nbytes, _tensors(out)))
        packet = func.overloadpacket
        if packet in MATMUL_FLOPS:
            self.flops += MATMUL_FLOPS[packet](*args, **kwargs, out_val=out)

    def totals(self) -> dict:
        """The reference's ``corrected_totals`` keys."""
        return {"flops": self.flops,
                "traffic_bytes": self.traffic_bytes,
                "collective_bytes": float(sum(self.coll_bytes.values())),
                "collectives": {k: float(v) for k, v in
                                sorted(self.coll_bytes.items())},
                "collective_counts": dict(sorted(self.coll_counts.items()))}
