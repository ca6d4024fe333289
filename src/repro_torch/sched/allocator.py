"""Bank allocation: carving the cores axis into rank-aligned slices.

Port of ``repro.sched.allocator``.  The paper's UPMEM runtime hands
workloads *ranks* of 64 DPUs (§2.2); the 2500+ cores are a pool many jobs
share.  :class:`BankAllocator` models that: the ``cores`` axis of a
:class:`~repro_torch.systems.pim.PimSystem` is carved into rank-aligned
extents with first-fit (or contention-aware) placement, reclaim with
free-extent coalescing, and fragmentation stats.  Its arithmetic is the
reference's, so both packages grant the same leases for the same
requests.

:class:`PimSlice` is the execution view of a lease: a sub-``PimSystem``
with ``n_cores = lease.n_cores``, so ``shard_rows``/``map_reduce``/
``broadcast`` re-scope automatically and existing trainers run
unmodified on a fraction of the machine.  Slice ``TransferStats`` are
slice-local and mirror every increment into the parent system's
counters, so global accounting keeps working while per-job deltas stay
attributable.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..obs.trace import TRACER
from ..systems.base import adopt_parent_session, check_lease_bounds
from ..systems.pim import PimSystem
from ..systems.topology import (DEFAULT_DPUS_PER_RANK, PimTopology,
                                default_rank_size)

#: UPMEM hands workloads DPUs in ranks of 64 (paper §2.2); the cost
#: model's rank tree (``systems/topology.py``) shares the definition
DEFAULT_RANK_SIZE = DEFAULT_DPUS_PER_RANK

#: placement policies: "first_fit" is the lowest-address scan;
#: "contention" scores every rank-aligned candidate by predicted channel
#: contention with live leases
PLACEMENT_POLICIES = ("first_fit", "contention")


@dataclasses.dataclass(frozen=True)
class BankLease:
    """A granted, rank-aligned extent of the cores axis.

    Carries its topology shadow (which physical ranks and memory
    channels the extent touches) so placement can
    score candidates against live leases and the scheduler can report
    rank-straddling tenancy without re-deriving geometry."""

    start: int
    n_cores: int
    #: physical ranks / memory channels this extent touches (filled by
    #: the allocator from its topology; empty for hand-built leases).
    ranks: tuple = ()
    channels: tuple = ()

    @property
    def stop(self) -> int:
        return self.start + self.n_cores

    @property
    def rank_straddling(self) -> bool:
        return len(self.ranks) > 1


@dataclasses.dataclass(frozen=True)
class FragmentationStats:
    """Allocator occupancy snapshot."""

    total_cores: int
    free_cores: int
    n_leases: int
    n_free_extents: int
    largest_free_extent: int
    #: 1 - largest_free/free: 0 = one contiguous hole, ->1 = shattered
    external_fragmentation: float
    #: per-memory-channel occupancy, channel index -> fraction of that
    #: channel's cores currently leased
    per_channel_occupancy: tuple = ()
    #: live leases spanning more than one physical rank
    rank_straddling_leases: int = 0

    @property
    def used_cores(self) -> int:
        return self.total_cores - self.free_cores


class BankAllocator:
    """Topology-aware allocator over a 1-D core axis with rank granularity.

    Invariants:
      * every lease is rank-aligned: ``start`` and ``n_cores`` are
        multiples of ``rank_size`` (requests round UP to whole ranks,
        mirroring UPMEM's rank-granular DPU allocation);
      * live leases never overlap;
      * free extents are kept sorted and coalesced, so releasing every
        lease always restores one maximal extent ``[0, n_cores)``;
      * every lease's ``ranks``/``channels`` footprint is exactly what
        ``topology.footprint(start, n_cores)`` derives from its extent.

    ``placement`` picks the policy:
      "first_fit"   lowest-address extent that fits (the default);
      "contention"  among ALL rank-aligned candidate positions, take
                    the one minimizing (predicted channel contention
                    with live leases, channels spanned, ranks spanned,
                    start) — rank-local beats rank-straddling, quiet
                    channels beat busy ones, and the tuple's final
                    ``start`` term keeps the choice deterministic.
    """

    def __init__(self, n_cores: int,
                 rank_size: Optional[int] = None,
                 topology: Optional[PimTopology] = None,
                 placement: str = "first_fit",
                 trace_track: Optional[str] = None):
        if n_cores <= 0:
            raise ValueError(f"n_cores must be positive, got {n_cores}")
        if rank_size is None:
            rank_size = default_rank_size(n_cores)
        else:
            rank_size = min(rank_size, n_cores)
            if rank_size <= 0 or n_cores % rank_size:
                raise ValueError(
                    f"rank_size {rank_size} must be positive and divide "
                    f"n_cores {n_cores} (rank-aligned carving)")
        if placement not in PLACEMENT_POLICIES:
            raise ValueError(f"unknown placement {placement!r}; "
                             f"known: {PLACEMENT_POLICIES}")
        self.n_cores = n_cores
        self.rank_size = rank_size
        if topology is None:
            # the allocation rank IS the physical rank unless told
            # otherwise — carving granularity and the cost model's rank
            # tree stay in agreement
            topology = PimTopology.for_cores(n_cores,
                                             dpus_per_rank=rank_size)
        self.topology = topology
        self.placement = placement
        #: trace timeline for channel-occupancy counter events (e.g.
        #: ``channels:pim``); None = no emission
        self.trace_track = trace_track
        self._free: List[tuple] = [(0, n_cores)]   # sorted (start, size)
        self._leases: dict[int, BankLease] = {}

    def _trace_occupancy(self, lease: BankLease) -> None:
        """Sample the occupancy of the channels a lease touches onto
        the allocator's trace track (one counter series per channel —
        the per-memory-channel rows of the Chrome timeline)."""
        if not TRACER.enabled or self.trace_track is None:
            return
        occ = self.channel_occupancy()
        for ch in (lease.channels or tuple(sorted(occ))):
            TRACER.counter(f"channel{ch}.occupancy", occ.get(ch, 0.0),
                           track=self.trace_track)

    def align(self, n_cores: Optional[int]) -> int:
        """Round a request up to whole ranks (None = one rank)."""
        if n_cores is None:
            return self.rank_size
        if n_cores <= 0:
            raise ValueError(f"requested n_cores must be positive, "
                             f"got {n_cores}")
        ranks = -(-n_cores // self.rank_size)
        return ranks * self.rank_size

    def _make_lease(self, start: int, size: int) -> BankLease:
        fp = self.topology.footprint(start, size)
        return BankLease(start, size, ranks=fp.ranks, channels=fp.channels)

    def _take(self, extent_index: int, start: int, size: int) -> BankLease:
        """Carve ``[start, start+size)`` out of free extent
        ``extent_index`` (splitting it into up to two remainders) and
        grant the lease."""
        ext_start, ext_size = self._free[extent_index]
        assert ext_start <= start and start + size <= ext_start + ext_size
        remainders = []
        if start > ext_start:
            remainders.append((ext_start, start - ext_start))
        tail = (ext_start + ext_size) - (start + size)
        if tail:
            remainders.append((start + size, tail))
        self._free[extent_index:extent_index + 1] = remainders
        lease = self._make_lease(start, size)
        self._leases[lease.start] = lease
        self._trace_occupancy(lease)
        return lease

    def _contention_score(self, start: int, size: int) -> tuple:
        """Placement score of a candidate (lower is better): predicted
        channel contention with live leases (how many lease-channel
        tenancies the candidate would share a channel with), then
        channels spanned, ranks spanned, and start for determinism."""
        fp = self.topology.footprint(start, size)
        live: Dict[int, int] = {}
        for lease in self._leases.values():
            for ch in lease.channels:
                live[ch] = live.get(ch, 0) + 1
        contention = sum(live.get(ch, 0) for ch in fp.channels)
        return (contention, len(fp.channels), len(fp.ranks), start)

    def allocate(self, n_cores: Optional[int] = None) -> Optional[BankLease]:
        """Grant a rank-aligned lease by the configured placement
        policy; None when nothing fits.

        Requests larger than the whole machine raise — they could never
        be satisfied and would livelock any admission loop."""
        size = self.align(n_cores)
        if size > self.n_cores:
            raise ValueError(
                f"request for {size} cores (rank-aligned) exceeds the "
                f"machine ({self.n_cores} cores)")
        if self.placement == "first_fit":
            for i, (start, extent) in enumerate(self._free):
                if extent >= size:
                    return self._take(i, start, size)
            return None
        # contention-aware: every rank-aligned start inside every free
        # extent is a candidate; pick the best-scoring one
        best = None
        for i, (start, extent) in enumerate(self._free):
            for j in range((extent - size) // self.rank_size + 1):
                cand = start + j * self.rank_size
                score = self._contention_score(cand, size)
                if best is None or score < best[0]:
                    best = (score, i, cand)
        if best is None:
            return None
        _, extent_index, start = best
        return self._take(extent_index, start, size)

    def release(self, lease: BankLease) -> None:
        """Reclaim a lease, coalescing adjacent free extents."""
        if self._leases.pop(lease.start, None) != lease:
            raise ValueError(f"lease {lease} is not live in this allocator")
        self._free.append((lease.start, lease.n_cores))
        self._free.sort()
        merged: List[tuple] = []
        for start, size in self._free:
            if merged and merged[-1][0] + merged[-1][1] == start:
                merged[-1] = (merged[-1][0], merged[-1][1] + size)
            else:
                merged.append((start, size))
        self._free = merged
        self._trace_occupancy(lease)

    @property
    def free_cores(self) -> int:
        return sum(size for _, size in self._free)

    @property
    def leases(self) -> tuple:
        return tuple(self._leases.values())

    def channel_occupancy(self) -> Dict[int, float]:
        """Per-memory-channel occupancy: channel index -> fraction of
        that channel's cores currently under lease."""
        topo = self.topology
        leased = {ch: 0 for ch in range(topo.n_channels)}
        for lease in self._leases.values():
            for rank in lease.ranks:
                cores = topo.rank_cores(rank, lease.start, lease.n_cores)
                leased[rank // topo.ranks_per_channel] += cores
        out = {}
        for ch in range(topo.n_channels):
            ch_cores = min(topo.cores_per_channel,
                           self.n_cores - ch * topo.cores_per_channel)
            out[ch] = leased[ch] / ch_cores if ch_cores else 0.0
        return out

    def fragmentation(self) -> FragmentationStats:
        free = self.free_cores
        largest = max((size for _, size in self._free), default=0)
        occ = self.channel_occupancy()
        return FragmentationStats(
            total_cores=self.n_cores,
            free_cores=free,
            n_leases=len(self._leases),
            n_free_extents=len(self._free),
            largest_free_extent=largest,
            external_fragmentation=(1.0 - largest / free) if free else 0.0,
            per_channel_occupancy=tuple(occ[ch]
                                        for ch in sorted(occ)),
            rank_straddling_leases=sum(
                1 for lease in self._leases.values()
                if lease.rank_straddling))


# ---------------------------------------------------------------------------
# Slice view.
# ---------------------------------------------------------------------------

class PimSlice(PimSystem):
    """A rank-aligned sub-view of a parent :class:`PimSystem`.

    The slice is itself a PimSystem whose ``n_cores`` is the lease size,
    so every execution-surface method (``put``/``shard_rows``/
    ``map_reduce``/``broadcast``/named kernels) is scoped to the slice
    and existing trainers run on it unmodified.  All cores are one
    device tensor's leading axis, so the scoping is in the shard shapes
    and the byte accounting.

    Slices share the parent's named-kernel registry (kernel names encode
    every closure parameter, so one kernel object serves every tenant)
    and mirror their ``TransferStats`` into the parent's.  Each keeps its
    own chunk-graph cache (``adopt_parent_session`` says why).

    Over ranks (``backend="shard_map"``) the slice's core i is the
    parent's core ``lease.start + i``, on the rank that owns that one:
    each rank holds its share of the lease, possibly none, and every rank
    runs the slice's fits.  Nothing compiled is shared between slices,
    so no state crosses two rank layouts.
    """

    def __init__(self, parent: PimSystem, lease: BankLease):
        check_lease_bounds(parent, lease)
        self.parent = parent
        self.lease = lease
        ranks = (None if parent.ranks is None
                 else parent.ranks.sub(lease.start, lease.stop))
        super().__init__(dataclasses.replace(parent.config,
                                             n_cores=lease.n_cores),
                         ranks=ranks)
        adopt_parent_session(self, parent)
