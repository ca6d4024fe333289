"""The PIM machine's channel -> rank -> DPU tree (paper §2.2).

Port of the geometry half of ``repro.systems.topology``: the rank size,
the ranks per channel and :class:`PimTopology`.  The reduce strategies
read it — ``HierarchicalReduce`` derives its group from the rank and
classifies its reduce legs as rank-local or cross-rank.  The
hierarchical cost model is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

#: fixed per-DMA-transfer setup cost in cycles, and the largest single
#: MRAM<->WRAM DMA transfer the UPMEM SDK issues (2 KB); the streaming
#: rate is ~1.6 B/cycle (Gómez-Luna et al., arXiv:2105.03814, Fig. 7).
DPU_DMA_SETUP_CYCLES = 96.0
DPU_DMA_SEGMENT_BYTES = 2048
DPU_MRAM_BYTES_PER_CYCLE = 1.6

#: per-DPU scratchpad (WRAM) and bank (MRAM) capacities (paper §2.1).
DPU_WRAM_BYTES = 64 * 1024
DPU_MRAM_BYTES = 64 * 1024 * 1024

#: UPMEM hands workloads DPUs in ranks of 64 (paper §2.2).
DEFAULT_DPUS_PER_RANK = 64

#: modeled DIMM population: ranks sharing one memory channel.
DEFAULT_RANKS_PER_CHANNEL = 4


def default_rank_size(n_cores: int) -> int:
    """The auto-selected rank: the largest divisor of ``n_cores`` not
    exceeding the UPMEM rank of 64 (96 -> 48, 100 -> 50, 2556 -> 36)."""
    if n_cores <= 0:
        raise ValueError(f"n_cores must be positive, got {n_cores}")
    for rank in range(min(DEFAULT_DPUS_PER_RANK, n_cores), 0, -1):
        if n_cores % rank == 0:
            return rank
    return 1  # pragma: no cover — rank 1 always divides


@dataclasses.dataclass(frozen=True)
class ExtentFootprint:
    """The topology shadow of one core extent ``[start, start+n)``."""

    ranks: Tuple[int, ...]
    channels: Tuple[int, ...]

    @property
    def rank_straddling(self) -> bool:
        return len(self.ranks) > 1

    @property
    def channel_straddling(self) -> bool:
        return len(self.channels) > 1


@dataclasses.dataclass(frozen=True)
class PimTopology:
    """The channel -> rank -> DPU tree of one PIM machine: which rank and
    channel a core lives on, what footprint an extent casts, whether a
    working set fits WRAM, and what a segmented MRAM<->WRAM DMA costs."""

    n_cores: int
    dpus_per_rank: int = DEFAULT_DPUS_PER_RANK
    ranks_per_channel: int = DEFAULT_RANKS_PER_CHANNEL
    wram_bytes: int = DPU_WRAM_BYTES
    mram_bytes: int = DPU_MRAM_BYTES

    def __post_init__(self):
        if self.n_cores <= 0:
            raise ValueError(f"n_cores must be positive, got {self.n_cores}")
        if self.dpus_per_rank <= 0:
            raise ValueError("dpus_per_rank must be positive, got "
                             f"{self.dpus_per_rank}")
        if self.ranks_per_channel <= 0:
            raise ValueError("ranks_per_channel must be positive, got "
                             f"{self.ranks_per_channel}")

    @classmethod
    def for_cores(cls, n_cores: int,
                  dpus_per_rank: Optional[int] = None,
                  ranks_per_channel: int = DEFAULT_RANKS_PER_CHANNEL,
                  ) -> "PimTopology":
        """Build the tree for a machine size, auto-sizing the rank
        (largest divisor <= 64) when ``dpus_per_rank`` is None."""
        if dpus_per_rank is None:
            dpus_per_rank = default_rank_size(n_cores)
        return cls(n_cores=n_cores, dpus_per_rank=dpus_per_rank,
                   ranks_per_channel=ranks_per_channel)

    # -- tree geometry -------------------------------------------------------

    @property
    def n_ranks(self) -> int:
        return -(-self.n_cores // self.dpus_per_rank)

    @property
    def n_channels(self) -> int:
        return -(-self.n_ranks // self.ranks_per_channel)

    @property
    def cores_per_channel(self) -> int:
        return self.dpus_per_rank * self.ranks_per_channel

    def rank_of(self, core: int) -> int:
        if not 0 <= core < self.n_cores:
            raise ValueError(f"core {core} outside [0, {self.n_cores})")
        return core // self.dpus_per_rank

    def channel_of(self, core: int) -> int:
        return self.rank_of(core) // self.ranks_per_channel

    def footprint(self, start: int, n_cores: int) -> ExtentFootprint:
        """Ranks and channels the extent ``[start, start+n_cores)``
        touches (inclusive of partial ranks at either edge)."""
        if n_cores <= 0:
            raise ValueError(f"extent size must be positive, got {n_cores}")
        if start < 0 or start + n_cores > self.n_cores:
            raise ValueError(f"extent [{start}, {start + n_cores}) outside "
                             f"the machine [0, {self.n_cores})")
        first = self.rank_of(start)
        last = self.rank_of(start + n_cores - 1)
        ranks = tuple(range(first, last + 1))
        channels = tuple(sorted({r // self.ranks_per_channel
                                 for r in ranks}))
        return ExtentFootprint(ranks=ranks, channels=channels)

    def rank_cores(self, rank: int, start: int, n_cores: int) -> int:
        """How many cores of extent ``[start, start+n)`` live on ``rank``."""
        lo = max(start, rank * self.dpus_per_rank)
        hi = min(start + n_cores, (rank + 1) * self.dpus_per_rank)
        return max(0, hi - lo)

    # -- per-DPU memory costs ------------------------------------------------

    def wram_fits(self, working_set_bytes: int) -> bool:
        """Does a working set fit the 64 KB WRAM scratchpad (the LOG
        LUT's WRAM-vs-MRAM placement decision, paper §5.2.2)?"""
        return 0 <= working_set_bytes <= self.wram_bytes

    def mram_fits(self, resident_bytes: int) -> bool:
        return 0 <= resident_bytes <= self.mram_bytes

    def mram_wram_cycles(self, nbytes: float) -> float:
        """Cycles to stream ``nbytes`` between MRAM and WRAM in DMA
        segments of at most :data:`DPU_DMA_SEGMENT_BYTES`: each segment
        pays the fixed setup, then bytes move at the streaming rate."""
        if nbytes <= 0:
            return 0.0
        segments = -(-nbytes // DPU_DMA_SEGMENT_BYTES)
        return (segments * DPU_DMA_SETUP_CYCLES
                + nbytes / DPU_MRAM_BYTES_PER_CYCLE)
