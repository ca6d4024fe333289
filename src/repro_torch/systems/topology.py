"""The PIM machine's channel -> rank -> DPU tree and its cost model.

Port of ``repro.systems.topology`` (paper §2.1-2.2, Figs. 8-12):

  :class:`PimTopology`           the static channel -> rank -> DPU tree:
                                 which ranks/channels a core extent
                                 touches, WRAM/MRAM capacities, and the
                                 segmented MRAM<->WRAM DMA cost.
  :class:`HierarchicalCostModel` prices a kernel launch as per-DPU
                                 pipeline/DMA time (the calibrated
                                 instruction tables are the leaf compute
                                 term) plus rank-serialized broadcast and
                                 gather legs over shared channels, with
                                 concurrent tenants dividing a channel's
                                 bandwidth.
  :class:`ExtentFootprint`       the rank/channel set of one core extent.

The reduce strategies read the tree (``HierarchicalReduce`` derives its
group from the rank); the compare (``launch/compare.py``) prices the PIM
rows with the cost model.  The model is pure Python arithmetic in the
reference's order of operations, so every result equals the
reference's as a float.

Calibration: the per-DPU leaf keeps the Fig. 8-10 version-ratio fit; the
transfer constants come from the UPMEM benchmarking literature
(provenance next to each constant) and reproduce the paper's Fig. 11-12
strong-scaling band: the serialized transfer legs are why the measured
2048/256-core speedup is 6.37-7.98x, not the flat model's 8.0x.
``DpuCostModel`` (``systems/pim.py``) remains as a one-warning
deprecation shim over the leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

# ---------------------------------------------------------------------------
# Per-DPU constants (paper §2.1 / UPMEM benchmarking literature).
# ---------------------------------------------------------------------------

#: DPU clock (paper Table 1: 425 MHz production silicon).
DPU_FREQ_HZ = 425e6

#: fine-grained multithreading: one instruction/cycle only once >= 11
#: tasklets are resident (paper Fig. 8-10 saturation shape).
DPU_PIPELINE_SATURATION_THREADS = 11

#: MRAM streaming bandwidth per DPU, bytes/cycle at large DMA sizes
#: (~700 MB/s at 425 MHz — Gómez-Luna et al., arXiv:2105.03814, Fig. 7).
DPU_MRAM_BYTES_PER_CYCLE = 1.6

#: fixed per-DMA-transfer setup cost in cycles.  UPMEM MRAM<->WRAM DMA
#: reaches its ~1.6 B/cycle streaming rate only at large transfer
#: sizes; small transfers are latency-dominated (arXiv:2105.03814
#: Fig. 7: 8-byte transfers run ~20x below peak).  ~96 cycles of setup
#: reproduces that small-transfer cliff.
DPU_DMA_SETUP_CYCLES = 96.0

#: largest single MRAM<->WRAM DMA transfer the SDK issues (2 KB).
DPU_DMA_SEGMENT_BYTES = 2048

#: per-DPU scratchpad (WRAM) and bank (MRAM) capacities (paper §2.1).
DPU_WRAM_BYTES = 64 * 1024
DPU_MRAM_BYTES = 64 * 1024 * 1024

# ---------------------------------------------------------------------------
# Host-link constants (rank/channel legs).
# ---------------------------------------------------------------------------

#: sustained host->rank (broadcast) and rank->host (gather) bandwidth
#: PER MEMORY CHANNEL.  The UPMEM benchmarking paper measures ~6.7 GB/s
#: aggregate CPU->DPU and ~4.7 GB/s DPU->CPU across the full 2556-DPU
#: machine (arXiv:2105.03814 §3.3); spread over the ~10 memory channels
#: its 20 ranks populate, that is ~0.67 / ~0.47 GB/s per channel.
CHANNEL_CPU_TO_PIM_BW = 0.67e9
CHANNEL_PIM_TO_CPU_BW = 0.47e9

#: fixed software setup per rank-level parallel transfer (the
#: ``dpu_push_xfer`` call overhead: gathering per-DPU buffers and
#: issuing the rank burst — tens of microseconds at UPMEM SDK scale).
RANK_XFER_LATENCY_S = 20e-6

#: UPMEM hands workloads DPUs in ranks of 64 (paper §2.2).
DEFAULT_DPUS_PER_RANK = 64

#: modeled DIMM population: 2 PIM DIMMs of 2 ranks each share one
#: memory channel (the paper's server populates 20 ranks on ~10
#: channels -> 2 ranks/channel at full build-out; we default to 4 so
#: modest core counts still exercise rank-vs-channel contention).
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


# ---------------------------------------------------------------------------
# Hierarchical cost model.
# ---------------------------------------------------------------------------

#: instruction-cost table (cycles/op at full pipeline) — calibrated so
#: the modeled version ratios match the paper's measured speedups:
#:   LIN-INT32 ~= 10x LIN-FP32 ("order of magnitude", §5.2.1)
#:   LIN-HYB   ~= 1.41x LIN-INT32 (+41%)
#:   LIN-BUI   ~= 1.25x LIN-HYB  (+25%)
#:   LOG LUT   ~= 53x  LOG-INT32 Taylor (§5.2.2)
#:   LOG-HYB-LUT ~= 1.28x LOG-INT32-LUT(WRAM); LOG-BUI-LUT ~= 1.43x HYB
DPU_OP_CYCLES: dict[str, float] = {
    "add32": 1.0,          # native
    "cmp": 1.0,            # native
    "load": 1.0,           # WRAM load (per 32-bit word, post-DMA)
    "mul8_builtin": 4.0,   # custom built-in multiply (Listing 1d)
    "mul16": 7.0,          # compiler-generated 8/16-bit multiply (Listing 1b)
    "mul32_emul": 24.0,    # runtime-emulated 32-bit multiply
    "div32_emul": 56.0,    # runtime-emulated division
    "fadd_emul": 55.0,     # software float add
    "fmul_emul": 70.0,     # software float multiply
    "lut_query_wram": 2.0,   # index clamp + load
    "lut_query_mram": 6.0,   # + DMA latency amortized over batched queries
}

#: per-iteration transfer-leg bytes per DPU for each modeled workload:
#: (broadcast bytes the host pushes to every DPU, gather bytes every
#: DPU ships back).  GD moves the (F+1)-vector both ways; K-Means
#: broadcasts k centroids and gathers per-cluster sums+counts; DTR
#: broadcasts a small split command and gathers per-node histograms.
def _gd_leg_bytes(n_features: int, k: int) -> Tuple[float, float]:
    return 4.0 * (n_features + 1), 4.0 * (n_features + 1)


def _kme_leg_bytes(n_features: int, k: int) -> Tuple[float, float]:
    return 4.0 * k * n_features, k * (4.0 * n_features + 8.0)


def _dtr_leg_bytes(n_features: int, k: int) -> Tuple[float, float]:
    return 64.0, 4.0 * 2 * 32      # command; 32-bin class histograms


#: modeled embedding width for EMB leg/leaf pricing — the dataset's
#: n_features is the (user, item) pair width (2), not the table dim,
#: so the model prices a representative dim (the trainer default)
EMB_MODEL_DIM = 8


def _emb_leg_bytes(n_features: int, k: int) -> Tuple[float, float]:
    """EMB per-step legs, ``k`` = minibatch size B (DESIGN.md §15.6):
    down, the broadcast minibatch (2 id columns + targets, int32/f32);
    up, the two gathered (B, dim) row blocks plus the relayed targets.
    The deferred flush payload is charged separately by the trainer
    (``TransferStats.flush_bytes``) — it amortizes over the window, so
    it is not part of the per-step launch price."""
    return 4.0 * 3 * k, 4.0 * k * (2 * EMB_MODEL_DIM + 1)


WORKLOAD_LEG_BYTES = {
    "lin": _gd_leg_bytes,
    "log": _gd_leg_bytes,
    "kme": _kme_leg_bytes,
    "dtr": _dtr_leg_bytes,
    "emb": _emb_leg_bytes,
}


@dataclasses.dataclass
class HierarchicalCostModel:
    """Topology-aware kernel/launch pricing (DESIGN.md §12).

    Three layers, matching the machine:

      per-DPU leaf   ``kernel_seconds``: the calibrated instruction
                     tables vs the *segmented* MRAM<->WRAM DMA cost
                     (all leased DPUs run in parallel);
      rank legs      ``broadcast_seconds``/``gather_seconds``: the host
                     moves model state rank-by-rank — one fixed setup
                     plus a burst per rank, ranks on one channel
                     serialized, channels in parallel;
      channel share  ``sharers`` tenants on a channel divide its
                     bandwidth (the contention the topology-aware
                     placer minimizes).

    ``step_seconds`` composes all three into the price of ONE training
    iteration on an extent; ``job_seconds`` multiplies it out — the
    scheduler's backfill ordering and ``capacity_estimate`` run on it.
    """

    topology: PimTopology
    freq_hz: float = DPU_FREQ_HZ
    saturation_threads: int = DPU_PIPELINE_SATURATION_THREADS
    cpu_to_pim_bw: float = CHANNEL_CPU_TO_PIM_BW
    pim_to_cpu_bw: float = CHANNEL_PIM_TO_CPU_BW
    rank_latency_s: float = RANK_XFER_LATENCY_S

    @classmethod
    def for_cores(cls, n_cores: int, **topo_kwargs) -> "HierarchicalCostModel":
        return cls(PimTopology.for_cores(n_cores, **topo_kwargs))

    # -- per-DPU leaf --------------------------------------------------------

    def kernel_seconds(self, instr_cycles: float, mram_bytes: float,
                       n_threads: int) -> float:
        """Single-DPU kernel time: pipeline term (saturating at 11
        tasklets) vs the segmented MRAM DMA term.  ``n_threads`` must
        be positive — a degenerate zero-thread lease is a caller bug,
        not a near-infinite compute time."""
        if n_threads <= 0:
            raise ValueError(
                f"n_threads must be positive, got {n_threads} "
                "(a lease cannot run a kernel with no tasklets)")
        tp = min(n_threads, self.saturation_threads) / self.saturation_threads
        compute = instr_cycles / tp
        memory = self.topology.mram_wram_cycles(mram_bytes)
        return max(compute, memory) / self.freq_hz

    # -- per-workload instruction estimates (per sample, F features) --------
    #
    # Calibrated against the paper's measured version-to-version speedups
    # (§5.2.1/§5.2.2) rather than summed from DPU_OP_CYCLES: the compiled
    # inner loops also contain loads, address arithmetic and loop control,
    # so the per-feature totals below are the fitted quantities.  Anchors:
    #   bui  ~ custom mul (4 instr, Listing 1d) + load/acc     -> 8
    #   hyb  ~ compiler 16-bit mul (7 instr, Listing 1b) + l/a -> 10
    #   int32~ emulated 32-bit mul + shifts                    -> 14
    #   fp32 ~ software float mul+add                          -> 120
    # giving fp32/int32 = 8.6x ("order of magnitude"), int32/hyb = 1.40
    # (+41%), hyb/bui = 1.25 (+25%).
    LIN_INSTR_PER_FEATURE = {"fp32": 120.0, "int32": 14.0,
                             "hyb": 10.0, "bui": 8.0}

    #: per-sample sigmoid cost.  The Taylor numbers are fitted to the
    #: paper's measured 53x LUT-over-Taylor speedup and the 65% INT32-
    #: over-FP32 reduction (§5.2.2).
    LOG_SIGMOID_CYCLES = {"fp32": 66_000.0, "int32": 24_000.0,
                          "int32_lut_mram": 6.0, "int32_lut_wram": 2.0,
                          "hyb_lut": 2.0, "bui_lut": 2.0}

    @staticmethod
    def lin_instr(version: str, n_features: int) -> float:
        per_feat = HierarchicalCostModel.LIN_INSTR_PER_FEATURE[version]
        overhead = 24.0 if version == "fp32" else 10.0
        # dot product + gradient pass back over features (second pass)
        return 2 * n_features * per_feat + overhead

    @staticmethod
    def log_instr(version: str, n_features: int) -> float:
        base_ver = {"fp32": "fp32", "int32": "int32",
                    "int32_lut_mram": "int32", "int32_lut_wram": "int32",
                    "hyb_lut": "hyb", "bui_lut": "bui"}[version]
        base = HierarchicalCostModel.lin_instr(base_ver, n_features)
        return base + HierarchicalCostModel.LOG_SIGMOID_CYCLES[version]

    @staticmethod
    def dtr_split_evaluate_instr(n_points: int) -> float:
        c = DPU_OP_CYCLES
        return n_points * (c["load"] + c["cmp"] + c["add32"])

    @staticmethod
    def kme_instr(n_points: int, n_features: int, k: int) -> float:
        c = DPU_OP_CYCLES
        per_pt = k * n_features * (c["load"] + c["mul16"] + c["add32"]) \
            + k * c["cmp"] + n_features * c["add32"]
        return n_points * per_pt

    def _workload_leaf(self, workload: str, version: str, n_samples: int,
                       n_features: int, n_cores: int, k: int = 16,
                       ) -> Tuple[float, float]:
        """(instr_cycles, mram_bytes) of one per-DPU training pass."""
        from .pim import workload_element_bytes  # table lives with PimSystem
        n_pc = -(-n_samples // n_cores)
        elem_bytes = workload_element_bytes(workload, version)
        bytes_ = n_pc * n_features * elem_bytes
        if workload == "lin":
            instr = n_pc * self.lin_instr(version, n_features)
        elif workload == "log":
            instr = n_pc * self.log_instr(version, n_features)
        elif workload == "dtr":
            instr = self.dtr_split_evaluate_instr(n_pc) * n_features
        elif workload == "kme":
            instr = self.kme_instr(n_pc, n_features, k)
        elif workload == "emb":
            # k = minibatch size; each sample is one dot + one axpy per
            # table over EMB_MODEL_DIM-wide rows — the same op mix as a
            # LIN step over that many features — plus a shard-local id
            # probe per lookup.  MRAM traffic is the touched rows, not
            # the resident shard (sparse access is the point).
            elem = workload_element_bytes("emb", version)
            instr = k * 2 * self.lin_instr(version, EMB_MODEL_DIM)
            bytes_ = k * 2 * EMB_MODEL_DIM * elem + n_pc * 4
        else:
            raise ValueError(workload)
        return instr, bytes_

    def workload_seconds(self, workload: str, version: str, n_samples: int,
                         n_features: int, n_cores: int, n_threads: int,
                         k: int = 16) -> float:
        """Per-DPU kernel seconds of one training pass — the Fig. 8-10
        quantity (kernel time only, no transfer legs)."""
        instr, bytes_ = self._workload_leaf(workload, version, n_samples,
                                            n_features, n_cores, k)
        return self.kernel_seconds(instr, bytes_, n_threads)

    # -- rank/channel transfer legs ------------------------------------------

    def _ranks_by_channel(self, start: int, n_cores: int
                          ) -> dict[int, list]:
        topo = self.topology
        fp = topo.footprint(start, n_cores)
        by_channel: dict[int, list] = {}
        for rank in fp.ranks:
            by_channel.setdefault(rank // topo.ranks_per_channel,
                                  []).append(rank)
        return by_channel

    def _leg_seconds(self, bytes_per_dpu: float, start: int, n_cores: int,
                     bw: float, sharers: int) -> float:
        """One rank-serialized transfer leg over the extent's channels:
        each touched rank pays the fixed transfer setup plus its burst
        (bytes_per_dpu x cores-on-rank) at the channel's bandwidth;
        ranks sharing a channel serialize, channels run in parallel,
        and ``sharers`` concurrent tenants divide each channel's
        bandwidth."""
        if bytes_per_dpu <= 0 or n_cores <= 0:
            return 0.0
        share = bw / max(1, sharers)
        worst = 0.0
        for _ch, ranks in self._ranks_by_channel(start, n_cores).items():
            t = 0.0
            for rank in ranks:
                cores = self.topology.rank_cores(rank, start, n_cores)
                t += self.rank_latency_s + bytes_per_dpu * cores / share
            worst = max(worst, t)
        return worst

    def broadcast_seconds(self, bytes_per_dpu: float, n_cores: int,
                          start: int = 0, sharers: int = 1) -> float:
        """Host -> extent model broadcast (CPU->PIM direction)."""
        return self._leg_seconds(bytes_per_dpu, start, n_cores,
                                 self.cpu_to_pim_bw, sharers)

    def gather_seconds(self, bytes_per_dpu: float, n_cores: int,
                       start: int = 0, sharers: int = 1) -> float:
        """Extent -> host partial gather (PIM->CPU direction)."""
        return self._leg_seconds(bytes_per_dpu, start, n_cores,
                                 self.pim_to_cpu_bw, sharers)

    def launch_seconds(self, instr_cycles: float, mram_bytes: float,
                       n_threads: int, *, broadcast_bytes_per_dpu: float = 0.0,
                       gather_bytes_per_dpu: float = 0.0, n_cores: int = 1,
                       start: int = 0, sharers: int = 1) -> float:
        """Full price of one launch on an extent: per-DPU kernel time
        (all leased DPUs in parallel) + the serialized broadcast and
        gather legs."""
        return (self.kernel_seconds(instr_cycles, mram_bytes, n_threads)
                + self.broadcast_seconds(broadcast_bytes_per_dpu, n_cores,
                                         start, sharers)
                + self.gather_seconds(gather_bytes_per_dpu, n_cores,
                                      start, sharers))

    # -- end-to-end workload pricing -----------------------------------------

    def step_seconds(self, workload: str, version: str, n_samples: int,
                     n_features: int, n_cores: Optional[int] = None,
                     n_threads: int = 16, k: int = 16, start: int = 0,
                     sharers: int = 1) -> float:
        """One training iteration on the extent ``[start, start+n)``:
        kernel + broadcast + gather.  This is the quantity the Fig.
        11-12 scaling curves measure — at 2048 cores the serialized
        legs are why speedup-vs-256 lands below the flat model's 8.0x.
        """
        if n_cores is None:
            n_cores = self.topology.n_cores
        instr, bytes_ = self._workload_leaf(workload, version, n_samples,
                                            n_features, n_cores, k)
        leg = WORKLOAD_LEG_BYTES.get(workload)
        bcast, gather = leg(n_features, k) if leg else (0.0, 0.0)
        return self.launch_seconds(
            instr, bytes_, n_threads,
            broadcast_bytes_per_dpu=bcast, gather_bytes_per_dpu=gather,
            n_cores=n_cores, start=start, sharers=sharers)

    def job_seconds(self, workload: str, version: str, n_samples: int,
                    n_features: int, n_iters: int,
                    n_cores: Optional[int] = None, n_threads: int = 16,
                    k: int = 16, start: int = 0, sharers: int = 1) -> float:
        """Modeled end-to-end time of an ``n_iters``-iteration fit —
        the scheduler's backfill-ordering and capacity-planning unit."""
        return max(0, n_iters) * self.step_seconds(
            workload, version, n_samples, n_features, n_cores, n_threads,
            k, start, sharers)

    # -- contention -----------------------------------------------------------

    def contention_sharers(self, start: int, n_cores: int,
                           live_extents: Iterable[Tuple[int, int]]) -> int:
        """How many tenants (this one included) share this extent's
        busiest channel — the divisor the transfer legs see.  The
        placement scorer minimizes exactly this quantity."""
        fp = self.topology.footprint(start, n_cores)
        per_channel = {ch: 1 for ch in fp.channels}
        for other_start, other_n in live_extents:
            if other_n <= 0:
                continue
            other = self.topology.footprint(other_start, other_n)
            for ch in other.channels:
                if ch in per_channel:
                    per_channel[ch] += 1
        return max(per_channel.values(), default=1)
