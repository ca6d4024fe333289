"""Processor-centric host baseline (paper §5.4).

The paper's comparison points run the same algorithms on a conventional
processor: one resident copy of the data, fp32 hot loops, no
partitioning and no host<->device command traffic.  :class:`HostSystem`
is that target behind the :class:`~repro_torch.systems.base.System`
protocol, as ``repro.systems.host.HostSystem`` is in the reference:

  shard_rows      no partitioning: (n, ...) -> (1, n, ...)
  broadcast       free: the model lives where the kernel runs
  reduce          a sum over one shard; every strategy is a no-op
  TransferStats   ``dram_bytes`` counts the bytes each pass streams;
                  ``cpu_to_pim``/``pim_to_cpu`` stay 0
  transcendentals native (``exact_transcendentals``): LOG fp32 uses the
                  exact sigmoid
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .base import (System, _tree_bytes, adopt_parent_session,
                   check_lease_bounds)


@dataclasses.dataclass
class HostConfig:
    """Host target configuration.  ``n_cores`` is scheduling capacity,
    not a shard width; ``reduce`` is accepted for config compatibility
    (every strategy is degenerate over a single shard)."""

    n_cores: int = 8
    n_threads: int = 1           # config compatibility (the reference's)
    reduce: str = "fabric"
    device: str = "cuda"


class HostSystem(System):
    """One-image processor-centric execution of the System surface."""

    kind = "host"
    exact_transcendentals = True

    def __init__(self, config: HostConfig | None = None):
        super().__init__(config or HostConfig())

    @property
    def n_shards(self) -> int:
        return 1

    # -- data placement ------------------------------------------------------

    def shard_rows(self, x: np.ndarray, pad_value=0) -> torch.Tensor:
        """No partitioning: (n, ...) -> (1, n, ...), one resident image,
        counted as a view materialization but no CPU->PIM bytes."""
        out = np.ascontiguousarray(np.asarray(x)[None])
        self.stats.shard_transfers += 1
        self.stats.shard_bytes += out.nbytes
        return torch.from_numpy(out).to(self.device)

    def row_validity_mask(self, n: int) -> torch.Tensor:
        """(1, n) all-true mask: a single image needs no padding."""
        return torch.ones((1, n), dtype=torch.bool, device=self.device)

    def broadcast(self, tree: Any) -> Any:
        return tree

    # -- accounting: DRAM traffic instead of CPU<->PIM transfers -------------

    def _charge_launch_operands(self, sharded, replicated) -> None:
        # each training pass streams the resident operands from DRAM
        self.stats.dram_bytes += _tree_bytes(tuple(sharded)) \
            + _tree_bytes(tuple(replicated))

    def _charge_reduce(self, strat, out) -> None:
        pass  # no PIM->CPU boundary to cross

    def _charge_reduce_custom(self, out) -> None:
        pass

    def _charge_inter_core(self, nbytes: int) -> None:
        pass  # no host link between shards of one resident image

    def _charge_topology(self, rank_local: int, cross_rank: int) -> None:
        pass  # a single resident image has no rank tree

    def _charge_elementwise(self, sharded, replicated) -> None:
        self.stats.dram_bytes += _tree_bytes(tuple(sharded)) \
            + _tree_bytes(tuple(replicated))

    def _charge_chunk(self, carry, sharded, reduced_shape, strat,
                      k: int) -> None:
        # a fused k-step chunk still streams the dataset k times
        self.stats.dram_bytes += k * _tree_bytes(tuple(sharded))

    def _charge_chunk_boundary(self, carry, outs) -> None:
        pass

    # -- multi-tenancy -------------------------------------------------------

    def slice(self, lease) -> "HostSystem":
        return HostSlice(self, lease)


class HostSlice(HostSystem):
    """A lane-scoped accounting view of a parent :class:`HostSystem`.

    A host target has no core axis to carve, so a lease degrades to a
    grant of thread-pool lanes: the slice shares the parent's kernel
    registry, executes identically over the single resident image, and
    mirrors its ``TransferStats`` into the parent's, so per-job deltas
    stay attributable."""

    def __init__(self, parent: HostSystem, lease):
        check_lease_bounds(parent, lease, "lanes")
        self.parent = parent
        self.lease = lease
        super().__init__(dataclasses.replace(parent.config,
                                             n_cores=lease.n_cores))
        adopt_parent_session(self, parent)
