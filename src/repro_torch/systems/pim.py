"""PIM execution model (paper §2.2, Fig. 3) on one PyTorch device.

The paper's system: N PIM cores, each owning a DRAM bank; training data
is partitioned once and stays bank-resident; each iteration every core
computes a partial result over its shard; partials are reduced via the
host and the updated model is re-broadcast.

Mapping: a PIM core is one index of the leading ``cores`` axis of a
device tensor ``[C, n_pc, ...]``; its bank-resident shard is that slice.
The per-core kernels take the whole batch and launch once for all cores.
Rows are padded and ordered exactly as ``repro.systems.pim.PimSystem``
orders them, so every core holds the same rows as in the reference.

Backends, with the reference's names: ``"vmap"`` keeps every core on
one device; ``"shard_map"`` spreads the cores over the ranks of the
default ``torch.distributed`` process group (``systems/ranks.py``): rank
r holds only its block of cores, ``[start_r, stop_r)``, the same rows
each core holds in one process, and the reduces run as collectives.
Every rank runs the same host code.  ``n_shards``, the placements' byte
counts and ``TransferStats`` stay those of the whole machine, equal on
every rank and equal to the reference's.

Time on the modeled DPUs comes from
:class:`~repro_torch.systems.topology.HierarchicalCostModel`
(:meth:`PimSystem.cost_model`); the on-bank storage-dtype table its MRAM
byte counting reads (``WORKLOAD_STORAGE_DTYPE`` /
``workload_element_bytes``) lives here because it mirrors what
``PimDataset`` materializes.  ``DpuCostModel`` is the reference's
one-warning deprecation shim over the per-DPU leaf.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional

import numpy as np
import torch

from ..core.quantization import storage_bytes
from ..obs.trace import TRACER
from .base import System, _tree_bytes
from .ranks import CoreBlocks
from .topology import (DEFAULT_RANKS_PER_CHANNEL, DPU_FREQ_HZ,
                       DPU_MRAM_BYTES_PER_CYCLE, DPU_OP_CYCLES,
                       DPU_PIPELINE_SATURATION_THREADS,
                       HierarchicalCostModel, PimTopology)

__all__ = [
    "DPU_FREQ_HZ", "DPU_MRAM_BYTES_PER_CYCLE", "DPU_OP_CYCLES",
    "DPU_PIPELINE_SATURATION_THREADS", "DpuCostModel", "PimConfig",
    "PimSystem", "WORKLOAD_STORAGE_DTYPE", "workload_element_bytes",
]


@dataclasses.dataclass
class PimConfig:
    n_cores: int = 64
    n_threads: int = 16          # tasklets per core (the cost model's)
    reduce: str = "fabric"       # default strategy for map_reduce
    dpus_per_rank: Optional[int] = None  # None: largest divisor <= 64
    ranks_per_channel: int = DEFAULT_RANKS_PER_CHANNEL
    device: str = "cuda"
    backend: str = "vmap"        # "vmap" | "shard_map"


BACKENDS = ("vmap", "shard_map")


class PimSystem(System):
    """Host-orchestrated data-parallel execution over simulated PIM cores.

    ``backend="shard_map"`` needs an initialised default process group
    (``repro_torch.launch.mesh.spawn_ranks``, or ``torchrun`` and
    ``init_process_group``) and raises ``ValueError`` without one."""

    kind = "pim"

    def __init__(self, config: PimConfig, ranks: Optional[CoreBlocks] = None):
        if config.backend not in BACKENDS:
            raise ValueError(f"unknown PIM backend {config.backend!r}; "
                             f"known: {BACKENDS}")
        super().__init__(config)
        if config.backend == "shard_map":
            self.ranks = ranks or CoreBlocks.over_group(config.n_cores)

    @property
    def n_shards(self) -> int:
        return self.config.n_cores

    @property
    def topology(self) -> PimTopology:
        """The channel -> rank -> DPU tree this machine models."""
        return PimTopology.for_cores(
            self.config.n_cores,
            dpus_per_rank=self.config.dpus_per_rank,
            ranks_per_channel=self.config.ranks_per_channel)

    def cost_model(self) -> HierarchicalCostModel:
        """A :class:`HierarchicalCostModel` over this machine's tree."""
        return HierarchicalCostModel(self.topology)

    # -- data placement ------------------------------------------------------

    def _block(self) -> tuple:
        """This process's cores ``[start, stop)``: all of them, or the
        rank's block."""
        if self.ranks is None:
            return 0, self.config.n_cores
        return self.ranks.start, self.ranks.stop

    def shard_rows(self, x: np.ndarray, pad_value=0) -> torch.Tensor:
        """Partition rows across cores: (n, ...) -> (n_cores, n_pc, ...)
        (over ranks, this rank's cores of it).

        Equal-size shards (padding the tail as needed) mirror the paper's
        equal per-bank buffers.  Counts the modeled CPU->PIM bytes of
        every core and the shard_transfers/shard_bytes counters."""
        x = np.asarray(x)
        c = self.config.n_cores
        n = x.shape[0]
        n_pc = -(-n // c)
        start, stop = self._block()
        rows = x[min(n, start * n_pc):min(n, stop * n_pc)]
        pad = (stop - start) * n_pc - rows.shape[0]
        if pad:
            rows = np.concatenate(
                [rows, np.full((pad,) + x.shape[1:], pad_value, x.dtype)], 0)
        out = np.ascontiguousarray(rows).reshape(stop - start, n_pc,
                                                 *x.shape[1:])
        nbytes = c * n_pc * int(np.prod(x.shape[1:], dtype=np.int64)) \
            * x.dtype.itemsize
        self.stats.cpu_to_pim += nbytes
        self.stats.shard_transfers += 1
        self.stats.shard_bytes += nbytes
        return torch.from_numpy(out).to(self.device)

    def row_validity_mask(self, n: int) -> torch.Tensor:
        """(n_cores, n_pc) bool mask marking real (non-padding) rows
        (over ranks, this rank's cores of it)."""
        c = self.config.n_cores
        n_pc = -(-n // c)
        start, stop = self._block()
        idx = torch.arange(start * n_pc, stop * n_pc,
                           device=self.device).reshape(stop - start, n_pc)
        return idx < n

    def broadcast(self, tree: Any) -> Any:
        """Host -> all cores broadcast of model state (counted per core).
        Every rank already holds the model state it computed, so nothing
        moves."""
        nbytes = _tree_bytes(tree) * self.config.n_cores
        self.stats.cpu_to_pim += nbytes
        if TRACER.enabled:
            TRACER.instant("broadcast", self._trace_track, "transfer",
                           bytes=nbytes)
        return tree

    # -- multi-tenancy -------------------------------------------------------

    def slice(self, lease) -> "PimSystem":
        """A :class:`~repro_torch.sched.allocator.PimSlice` over the leased
        extent: itself a PimSystem, so trainers run on it unmodified."""
        from ..sched.allocator import PimSlice  # local: sched -> systems
        return PimSlice(self, lease)


# ---------------------------------------------------------------------------
# Storage-dtype table (feeds the cost model's MRAM byte counting).
# ---------------------------------------------------------------------------

#: on-bank storage dtype of the training data per (workload, version),
#: with the per-dtype widths of ``quantization.STORAGE_BYTES``; mirrors
#: the quantized views PimDataset materializes (``api/dataset.py``)
WORKLOAD_STORAGE_DTYPE: dict[tuple[str, str], str] = {
    ("lin", "fp32"): "fp32",
    ("lin", "int32"): "int32",
    ("lin", "hyb"): "int8",
    ("lin", "bui"): "int8",
    ("log", "fp32"): "fp32",
    ("log", "int32"): "int32",
    ("log", "int32_lut_mram"): "int32",
    ("log", "int32_lut_wram"): "int32",
    ("log", "hyb_lut"): "int8",
    ("log", "bui_lut"): "int8",
    ("dtr", "fp32"): "fp32",
    ("kme", "int16"): "int16",
    ("kme", "fp32"): "fp32",
    ("emb", "fp32"): "fp32",     # ShardedTable float shards
    ("emb", "int32"): "int32",   # ShardedTable Q(frac_bits) shards
}


def workload_element_bytes(workload: str, version: str) -> int:
    """Bytes per stored feature value for a workload version."""
    try:
        name = WORKLOAD_STORAGE_DTYPE[(workload, version)]
    except KeyError:
        raise ValueError(
            f"no storage dtype recorded for {workload}/{version}; "
            f"add it to WORKLOAD_STORAGE_DTYPE") from None
    return storage_bytes(name)


# ---------------------------------------------------------------------------
# DpuCostModel — deprecation shim over the hierarchical model.
# ---------------------------------------------------------------------------

_DPU_COST_MODEL_WARNED = False


class DpuCostModel(HierarchicalCostModel):
    """Deprecated flat cost model: use
    :class:`~repro_torch.systems.topology.HierarchicalCostModel`.

    The hierarchical model pinned to a single-DPU topology, so
    ``kernel_seconds``/``workload_seconds`` keep their per-DPU semantics
    (no transfer legs).  Emits one ``DeprecationWarning`` per process.
    """

    def __init__(self, freq_hz: float = DPU_FREQ_HZ,
                 saturation_threads: int = DPU_PIPELINE_SATURATION_THREADS):
        global _DPU_COST_MODEL_WARNED
        if not _DPU_COST_MODEL_WARNED:
            _DPU_COST_MODEL_WARNED = True
            warnings.warn(
                "DpuCostModel is deprecated; use "
                "repro_torch.systems.topology.HierarchicalCostModel "
                "(topology-aware launch pricing)",
                DeprecationWarning, stacklevel=2)
        super().__init__(topology=PimTopology(n_cores=1),
                         freq_hz=freq_hz,
                         saturation_threads=saturation_threads)
