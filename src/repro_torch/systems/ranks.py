"""The PIM cores spread over ``torch.distributed`` ranks.

Port of the reference's ``backend="shard_map"``, where every PIM core is
one device of a ``jax.Mesh`` "cores" axis.  Here rank r of a process
group owns one contiguous block ``[start_r, stop_r)`` of the cores axis
and keeps only those cores' shards on its device, as a leading axis of
``stop_r - start_r`` in place of ``n_cores``.  Every rank runs the same
host code (SPMD); the collectives of :class:`CoreBlocks` run over the
system's group in the same order on every rank.

:meth:`CoreBlocks.even` gives each rank ``n_cores // world`` cores, the
first ``n_cores % world`` ranks one more; a rank may own none (1 core
over 2 ranks, or a slice's lease that misses the rank's block).  A rank
without cores contributes each reduction's identity.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..distributed import collectives


def _identity(op: str, dtype: torch.dtype) -> float:
    """The identity of ``op`` over ``dtype``: 0 for a sum, the largest
    value for a min and the smallest for a max (infinities for floats)."""
    if op == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


_LOCAL = {"sum": lambda v: torch.sum(v, dim=0, dtype=v.dtype),
          "min": lambda v: torch.amin(v, dim=0),
          "max": lambda v: torch.amax(v, dim=0)}


def local_reduce(v: torch.Tensor, op: str) -> torch.Tensor:
    """``op`` over the leading (cores) axis of one rank's block; the
    identity, of the reduced shape, over an empty block."""
    if v.shape[0] == 0:
        return torch.full(v.shape[1:], _identity(op, v.dtype),
                          dtype=v.dtype, device=v.device)
    return _LOCAL[op](v)


class CoreBlocks:
    """Which rank owns which PIM cores, and the collectives over them.

    ``bounds[r]`` is rank r's ``(start, stop)``; the blocks are in rank
    order, contiguous and cover ``[0, n_cores)``.  ``timing=True`` makes
    every collective synchronize the device before and after and sum its
    host seconds in ``seconds`` (a measurement mode: it adds the syncs)."""

    def __init__(self, bounds: Sequence[tuple], rank: int, group=None):
        self.bounds = tuple((int(a), int(b)) for a, b in bounds)
        if any(b < a for a, b in self.bounds) or any(
                self.bounds[r][1] != self.bounds[r + 1][0]
                for r in range(len(self.bounds) - 1)):
            raise ValueError(f"core blocks {self.bounds} are not "
                             f"contiguous in rank order")
        self.rank = int(rank)
        self.group = group
        self.timing = False
        self.seconds = 0.0

    @classmethod
    def even(cls, n_cores: int, world: int, rank: int, group=None
             ) -> "CoreBlocks":
        """``n_cores`` over ``world`` ranks, block sizes differing by at
        most one, the larger blocks first."""
        q, r = divmod(int(n_cores), int(world))
        bounds, start = [], 0
        for i in range(world):
            stop = start + q + (i < r)
            bounds.append((start, stop))
            start = stop
        return cls(bounds, rank, group)

    @classmethod
    def over_group(cls, n_cores: int, group=None) -> "CoreBlocks":
        """:meth:`even` over ``group`` (default: the default process
        group), which must be initialised."""
        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError(
                "backend 'shard_map' spreads the PIM cores over "
                "torch.distributed ranks and needs an initialised default "
                "process group: run under "
                "repro_torch.launch.mesh.spawn_ranks, or under torchrun "
                "and call torch.distributed.init_process_group first")
        return cls.even(n_cores, dist.get_world_size(group),
                        dist.get_rank(group), group)

    def sub(self, start: int, stop: int) -> "CoreBlocks":
        """The blocks of the cores ``[start, stop)``, renumbered from 0:
        each rank's share of a lease, possibly empty."""
        bounds = [(min(max(a, start), stop) - start,
                   min(max(b, start), stop) - start) for a, b in self.bounds]
        return CoreBlocks(bounds, self.rank, self.group)

    # -- layout ---------------------------------------------------------------

    @property
    def world(self) -> int:
        return len(self.bounds)

    @property
    def n_cores(self) -> int:
        return self.bounds[-1][1]

    @property
    def start(self) -> int:
        return self.bounds[self.rank][0]

    @property
    def stop(self) -> int:
        return self.bounds[self.rank][1]

    @property
    def sizes(self) -> list:
        return [b - a for a, b in self.bounds]

    def __repr__(self) -> str:
        return (f"CoreBlocks(rank {self.rank} of {self.world}: cores "
                f"[{self.start}, {self.stop}) of {self.n_cores})")

    # -- collectives ----------------------------------------------------------

    def _timed(self, fn, device: torch.device):
        if not self.timing:
            return fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.seconds += time.perf_counter() - t0
        return out

    def gather(self, block: torch.Tensor,
               sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Every rank's ``block`` concatenated in rank order (rows in core
        order).  ``sizes`` gives each rank's row count (default: its core
        count)."""
        sizes = self.sizes if sizes is None else sizes
        return self._timed(lambda: collectives.all_gather_blocks(
            block, sizes, self.group), block.device)

    def reduce(self, v: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``op`` over every core's partial: over this rank's block, then
        across the ranks.  Integer sums wrap as the one-process sum does;
        min and max are exact."""
        out = local_reduce(v, op).contiguous()
        return self._timed(lambda: collectives.all_reduce(
            out, op, self.group), out.device)

    def broadcast_value(self, value: float, device: torch.device) -> float:
        """Rank 0's ``value`` (a float64) on every rank."""
        t = torch.tensor([float(value)], dtype=torch.float64, device=device)
        src = dist.get_global_rank(self.group, 0) if self.group else 0
        return float(collectives.broadcast(t, src, self.group)[0])
