"""Modeled-GPU target: HostSystem numerics, A100 roofline reporting.

Port of ``repro.systems.gpu_model``.  The paper's GPU comparison points
(Figs. 13-17) come from a discrete GPU the reference's container does
not have.  :class:`ModeledGpuSystem` runs every workload with
:class:`~repro_torch.systems.host.HostSystem` semantics, on the caller's
device, so its results equal the host target's exactly, and prices each
launch on an A100 roofline (:class:`~repro_torch.launch.roofline.
GpuRoofline`)::

    seconds = launch_overhead + max(FLOPs / peak, bytes / HBM_bw)
    energy  = seconds * TDP

The reference reads FLOPs and bytes from XLA's cost analysis of the
compiled program.  The port counts them with :class:`OpCounter`, a
``TorchDispatchMode`` active around the first launch of each (program,
operand shapes and dtypes) pair; the count is cached and charged at
every launch of that pair, as the reference caches its analysis per
signature.  The launch counted is the one that runs anyway: a step
mutates state (EMB's tables, a chunk's static buffers), so nothing runs
twice.  The counter adds host time to that first launch only.

The conventions are those of XLA's ``HloCostAnalysis``:

  flops  ``torch.utils.flop_counter``'s formulas for the matmul family
         (with the same 2-per-multiply-add formulas for ``mv``, ``addmv``
         and ``dot``), one per output element for a pointwise op, one
         per input element for a reduction, one per update for a
         scatter-add;
  bytes  each op's operand and result bytes; views and metadata ops
         count nothing.

An op of the kernel tier reached through ``dispatch.launch`` is charged
its declared :class:`~repro_torch.kernels.dispatch.KernelCost` instead,
and the aten ops of whichever version runs are not counted, so a count
is the same on the CPU and on a card.  The count is unfused: every op's
operands and results are charged as if they went through memory, so its
bytes can only exceed what XLA counts for the fused program.

A fused k-step chunk is one launch whose count covers the k steps: step
fusion shrinks the modeled launch-overhead term as it shrinks the real
dispatch count.  On a card the chunk is a CUDA graph whose replay runs
no op; its capture is counted instead (``systems/step_graph.py``).

On a card the wall time of a ``gpu-model`` fit is the card's own, while
its modeled seconds are an A100's: their ratio (the compare's
``drift_ratio``) compares the two devices.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..kernels import dispatch
from ..launch.roofline import GpuRoofline, a100
from .base import _leaves, adopt_parent_session, check_lease_bounds
from .host import HostConfig, HostSystem

_aten = torch.ops.aten


def _mv_flops(a, b, *args, out_val=None, **kwargs) -> int:
    return 2 * a.shape[0] * a.shape[1]


def _addmv_flops(bias, a, b, *args, out_val=None, **kwargs) -> int:
    return 2 * a.shape[0] * a.shape[1]


def _dot_flops(a, b, *args, out_val=None, **kwargs) -> int:
    return 2 * a.numel()


#: aten op -> flops of one call: torch.utils.flop_counter's matmul-family
#: formulas, and the matrix-vector and dot products they leave out
MATMUL_FLOPS = {**flop_registry, _aten.mv: _mv_flops,
                _aten.addmv: _addmv_flops, _aten.dot: _dot_flops,
                _aten.vdot: _dot_flops}

#: ops that allocate, alias or read metadata: no flops, no bytes
NO_WORK = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "detach", "alias", "lift_fresh", "_unsafe_view",
    "_local_scalar_dense", "resize_", "set_"})

#: reductions, where an op carries no ``reduction`` tag: one flop per
#: input element
REDUCTIONS = frozenset({
    "sum", "mean", "amax", "amin", "argmax", "argmin", "max", "min",
    "prod", "any", "all", "std", "var", "norm", "linalg_vector_norm",
    "logsumexp", "cumsum", "cumprod"})

#: scatter-adds: one flop per update element (their last tensor argument)
SCATTERS = frozenset({"index_add", "index_add_", "scatter_add",
                      "scatter_add_", "scatter_reduce", "scatter_reduce_",
                      "index_put", "index_put_"})

_POINTWISE = torch.Tag.pointwise
_REDUCTION = getattr(torch.Tag, "reduction", None)


def _tensors(tree) -> list:
    return [v for v in tree_flatten(tree)[0] if isinstance(v, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts the flops and bytes of the ops run under it (the module's
    conventions), and the declared cost of every kernel-tier op launched
    under it."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self._paused = 0

    def __enter__(self):
        dispatch.meters.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        dispatch.meters.remove(self)
        return super().__exit__(*exc)

    def charge(self, cost: dispatch.KernelCost) -> None:
        """Charge one kernel-tier launch its declared cost."""
        self.flops += cost.ops
        self.bytes += cost.bytes

    @contextlib.contextmanager
    def paused(self):
        """Count nothing inside (a kernel-tier op already charged)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        if func.is_view or name in NO_WORK:
            return
        inputs, outputs = _tensors((args, kwargs)), _tensors(out)
        if any(t.device.type == "meta" for t in inputs + outputs):
            return          # shape bookkeeping, not work
        self.bytes += sum(map(_nbytes, inputs)) + sum(map(_nbytes, outputs))
        packet = func.overloadpacket
        if packet in MATMUL_FLOPS:
            self.flops += MATMUL_FLOPS[packet](*args, **kwargs, out_val=out)
        elif _POINTWISE in func.tags:
            self.flops += sum(t.numel() for t in outputs)
        elif (_REDUCTION is not None and _REDUCTION in func.tags) \
                or name in REDUCTIONS:
            self.flops += inputs[0].numel() if inputs else 0
        elif name in SCATTERS and inputs:
            self.flops += inputs[-1].numel()


def _operand_signature(tree) -> tuple:
    """Shapes and dtypes of a launch's array operands (the price key's
    second half): a launch's cost depends on nothing else."""
    return tuple((v.shape, v.dtype) for v in _leaves(tree)
                 if isinstance(v, (torch.Tensor, np.ndarray)))


@dataclasses.dataclass
class GpuModelConfig(HostConfig):
    roofline: GpuRoofline = dataclasses.field(default_factory=a100)


@dataclasses.dataclass
class GpuModelReport:
    """Accumulated roofline accounting of every launch on the system."""

    modeled_seconds: float = 0.0
    modeled_energy_j: float = 0.0
    launches: int = 0
    flops: float = 0.0
    hbm_bytes: float = 0.0

    def snapshot(self) -> "GpuModelReport":
        return dataclasses.replace(self)

    def delta(self, snapshot: "GpuModelReport") -> "GpuModelReport":
        return GpuModelReport(
            **{f.name: getattr(self, f.name) - getattr(snapshot, f.name)
               for f in dataclasses.fields(GpuModelReport)})


_REPORT_FIELDS = tuple(f.name for f in
                       dataclasses.fields(GpuModelReport))


class _MirrorGpuReport(GpuModelReport):
    """Slice-local roofline ledger that forwards every *increment* to the
    parent system's ``gpu`` report (the ``_MirrorStats`` pattern of
    systems/base.py), so a job queue's global totals accumulate in one
    place while each slice's ``snapshot()/delta()`` stays per job."""

    def __init__(self, parent: GpuModelReport):
        object.__setattr__(self, "_parent", parent)
        super().__init__()

    def __setattr__(self, name, value):
        if name in _REPORT_FIELDS:
            delta = value - getattr(self, name, 0)
            if delta > 0:
                setattr(self._parent, name,
                        getattr(self._parent, name) + delta)
        object.__setattr__(self, name, value)

    def snapshot(self) -> GpuModelReport:
        # a plain value snapshot: dataclasses.replace would construct
        # another mirror, whose __init__ wants a parent
        return GpuModelReport(**{f: getattr(self, f)
                                 for f in _REPORT_FIELDS})

    def delta(self, snapshot: GpuModelReport) -> GpuModelReport:
        return self.snapshot().delta(snapshot)


class ModeledGpuSystem(HostSystem):
    """Host execution on the caller's device whose time and energy report
    is an A100 roofline."""

    kind = "gpu-model"

    def __init__(self, config: Optional[GpuModelConfig] = None):
        super().__init__(config or GpuModelConfig())
        self.roofline: GpuRoofline = getattr(self.config, "roofline",
                                             None) or a100()
        self.gpu = GpuModelReport()
        #: (price key, operand signature) -> (flops, bytes), counted once
        self._cost_cache: dict = {}

    @contextlib.contextmanager
    def _counting(self, ckey: tuple):
        """Count what runs inside under an :class:`OpCounter` unless
        ``ckey``'s cost is cached already; cache it."""
        if ckey in self._cost_cache:
            yield
            return
        with OpCounter() as counter:
            yield
        self._cost_cache[ckey] = (counter.flops, counter.bytes)

    def _pricing(self, key: tuple, operands):
        return self._counting((key, _operand_signature(operands)))

    def _launch(self, key: tuple, run, operands):
        ckey = (key, _operand_signature(operands))
        with self._counting(ckey):
            out = run()
        flops, bytes_ = self._cost_cache[ckey]
        seconds = self.roofline.kernel_seconds(flops, bytes_)
        self.gpu.launches += 1
        self.gpu.flops += flops
        self.gpu.hbm_bytes += bytes_
        self.gpu.modeled_seconds += seconds
        self.gpu.modeled_energy_j += self.roofline.kernel_energy_j(seconds)
        return out

    # -- multi-tenancy -------------------------------------------------------

    def slice(self, lease) -> "ModeledGpuSystem":
        return GpuModelSlice(self, lease)


class GpuModelSlice(ModeledGpuSystem):
    """Lane-scoped view of a parent ModeledGpuSystem: the shared kernel
    registry and cost cache, mirrored TransferStats, and a slice-local
    :class:`_MirrorGpuReport` whose increments forward to the parent's
    ``gpu``, so ``slice.gpu.snapshot()/delta()`` gives one job's modeled
    seconds in a mixed queue."""

    def __init__(self, parent: ModeledGpuSystem, lease):
        check_lease_bounds(parent, lease, "lanes")
        self.parent = parent
        self.lease = lease
        super().__init__(dataclasses.replace(parent.config,
                                             n_cores=lease.n_cores))
        adopt_parent_session(self, parent)
        self.gpu = _MirrorGpuReport(parent.gpu)
        self._cost_cache = parent._cost_cache
