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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .base import System, _tree_bytes
from .topology import DEFAULT_RANKS_PER_CHANNEL, PimTopology


@dataclasses.dataclass
class PimConfig:
    n_cores: int = 64
    reduce: str = "fabric"       # default strategy for map_reduce
    dpus_per_rank: Optional[int] = None  # None: largest divisor <= 64
    ranks_per_channel: int = DEFAULT_RANKS_PER_CHANNEL
    device: str = "cuda"


class PimSystem(System):
    """Host-orchestrated data-parallel execution over simulated PIM cores."""

    kind = "pim"

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

    # -- data placement ------------------------------------------------------

    def shard_rows(self, x: np.ndarray, pad_value=0) -> torch.Tensor:
        """Partition rows across cores: (n, ...) -> (n_cores, n_pc, ...).

        Equal-size shards (padding the tail as needed) mirror the paper's
        equal per-bank buffers.  Counts the modeled CPU->PIM bytes and
        the shard_transfers/shard_bytes counters."""
        c = self.config.n_cores
        n = x.shape[0]
        n_pc = -(-n // c)
        pad = c * n_pc - n
        if pad:
            x = np.concatenate(
                [x, np.full((pad,) + x.shape[1:], pad_value, x.dtype)], 0)
        out = x.reshape(c, n_pc, *x.shape[1:])
        self.stats.cpu_to_pim += out.nbytes
        self.stats.shard_transfers += 1
        self.stats.shard_bytes += out.nbytes
        return torch.from_numpy(np.ascontiguousarray(out)).to(self.device)

    def row_validity_mask(self, n: int) -> torch.Tensor:
        """(n_cores, n_pc) bool mask marking real (non-padding) rows."""
        c = self.config.n_cores
        n_pc = -(-n // c)
        idx = torch.arange(c * n_pc, device=self.device).reshape(c, n_pc)
        return idx < n

    def broadcast(self, tree: Any) -> Any:
        """Host -> all cores broadcast of model state (counted per core).
        The simulated cores share one device, so nothing moves."""
        self.stats.cpu_to_pim += _tree_bytes(tree) * self.config.n_cores
        return tree
