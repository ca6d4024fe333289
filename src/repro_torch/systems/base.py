"""The ``System`` protocol: data placement, reduce strategies, execution.

Port of ``repro.systems.base``.  A trainer sees only ``dataset.system``;
the system owns the device, the resident shards, the named-kernel
registry and the ``TransferStats`` accounting.  :class:`StepProgram` runs
k training steps as one fused chunk and :class:`ChunkPipeline` keeps
chunks in flight while the host drains earlier boundaries; on a CUDA
device each chunk is one CUDA graph replay (``systems/step_graph.py``).

The simulated cores are the leading axis of one device tensor
``[C, n_pc, ...]``.  A per-core kernel here is written over that whole
batch — ``kernel(*sharded, *replicated)`` returns partials with a
leading cores axis — so one launch covers every core, where the
reference traced a per-core function under ``jax.vmap``.

The byte counters are deterministic integers computed from the same
shapes and dtypes as the reference's, so a port fit and a reference fit
of the same calls leave equal ``TransferStats``.

Every launch — a ``map_*`` call or a fused chunk — runs through
:meth:`System._launch`, the counterpart of the reference's
``_record_execution`` hook: a modeled target
(:class:`~repro_torch.systems.gpu_model.ModeledGpuSystem`) prices it
there; the PIM and host targets just run it.

Over ranks (``PimConfig(backend="shard_map")``, ``systems/ranks.py``)
a rank's tensors hold its own block of cores, and each strategy's
:meth:`ReduceStrategy.rank_reduce` returns on every rank what its
``device_reduce`` returns over all the cores in one process; the
accounting, which reads the shapes of that result, stays the same.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import enum
import threading
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from ..distributed import collectives
from ..obs.trace import NULL_SPAN, TRACER
from .ranks import CoreBlocks


class ReduceVia(enum.Enum):
    """Legacy reduction selector, kept for config compatibility: the
    per-call ``strategy=`` accepts these, their string values, or a
    :class:`ReduceStrategy`."""

    FABRIC = "fabric"              # on-device sum over the cores axis
    HOST = "host"                  # explicit host round trip (the paper's)
    HIERARCHICAL = "hierarchical"  # rank-level device sum + host combine


@dataclasses.dataclass
class TransferStats:
    """Byte counters mirroring the paper's CPU-PIM / PIM-CPU breakdowns.

    On a :class:`~repro_torch.systems.pim.PimSystem`, ``cpu_to_pim``
    counts every host->bank byte (dataset shards and model broadcasts)
    and ``pim_to_cpu`` the reduce legs back.  On a
    :class:`~repro_torch.systems.host.HostSystem` those stay zero and
    ``dram_bytes`` counts the bytes each training pass streams.
    ``shard_transfers``/``shard_bytes`` count dataset view
    materializations; ``kernel_launches`` and ``host_syncs`` count
    ``map_*`` calls and fused chunks (one each per chunk).  The
    remaining fields belong to layers not ported yet and stay zero; they
    are kept so the whole record compares equal to the reference's.
    """

    cpu_to_pim: int = 0
    pim_to_cpu: int = 0
    inter_core_via_host: int = 0
    shard_transfers: int = 0
    shard_bytes: int = 0
    kernel_launches: int = 0
    host_syncs: int = 0
    dram_bytes: int = 0
    rank_local_bytes: int = 0
    cross_rank_bytes: int = 0
    flush_bytes: int = 0
    compressed_bytes: int = 0

    def reset(self) -> None:
        for field in dataclasses.fields(TransferStats):
            setattr(self, field.name, 0)

    def snapshot(self) -> "TransferStats":
        """Point-in-time copy of every counter (a plain TransferStats),
        taken under the mirroring lock so that a reading never sees a
        slice's increment half-propagated to its parent."""
        with _STATS_LOCK:
            return TransferStats(
                **{f.name: getattr(self, f.name)
                   for f in dataclasses.fields(TransferStats)})

    def delta(self, snapshot: "TransferStats") -> "TransferStats":
        """Counters accumulated since ``snapshot`` was taken."""
        return TransferStats(
            **{f.name: getattr(self, f.name) - getattr(snapshot, f.name)
               for f in dataclasses.fields(TransferStats)})


_STAT_FIELDS = tuple(f.name for f in dataclasses.fields(TransferStats))

#: Serializes _MirrorStats increment mirroring against snapshot readings
#: on other threads.  Reentrant because a mirror's parent can itself be a
#: mirror (a slice of a slice).
_STATS_LOCK = threading.RLock()


class _MirrorStats(TransferStats):
    """Slice-local counters that forward every *increment* to the parent
    system's stats.  ``reset()`` zeroes only the slice view: the parent's
    cumulative totals are never rolled back (only positive deltas
    mirror)."""

    def __init__(self, parent: TransferStats):
        object.__setattr__(self, "_parent", parent)
        super().__init__()

    def __setattr__(self, name, value):
        if name in _STAT_FIELDS:
            with _STATS_LOCK:
                delta = value - getattr(self, name, 0)
                if delta > 0:
                    setattr(self._parent, name,
                            getattr(self._parent, name) + delta)
                object.__setattr__(self, name, value)
            return
        object.__setattr__(self, name, value)


def check_lease_bounds(parent: "System", lease, unit: str = "cores") -> None:
    """Reject a lease extending past the parent's capacity (shared by
    every slice type: PimSlice, HostSlice, GpuModelSlice)."""
    if lease.stop > parent.config.n_cores:
        raise ValueError(f"lease {lease} exceeds the parent system "
                         f"({parent.config.n_cores} {unit})")


def adopt_parent_session(slice_: "System", parent: "System") -> None:
    """Wire a slice to its parent's session state: mirrored stats and the
    shared kernel registry (one kernel object serves every tenant).

    The reference also shares its jit cache.  The port's counterpart,
    ``_step_cache``, holds CUDA graphs that read the shards at the
    addresses they were captured on, and a dataset belongs to one slice,
    so no graph of one slice could serve another; each slice keeps its
    own, so that one slice's fit releasing its program's graphs
    (``StepProgram.release``) never drops another slice's."""
    slice_.stats = _MirrorStats(parent.stats)
    slice_._kernels = parent._kernels
    slice_._kernel_gen = parent._kernel_gen


def run_steps(gen):
    """Drain a trainer step generator and return its result (which
    travels on ``StopIteration``)."""
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            return stop.value


class ChunkTick(int):
    """What a resumable trainer's ``fit_steps`` yields per chunk: the
    iteration count it advanced, plus a lazy ``snapshot()`` of the
    chunk-boundary state (valid while the generator is suspended at
    this yield)."""

    def __new__(cls, iters: int, snapshot_fn: Optional[Callable] = None):
        tick = super().__new__(cls, iters)
        tick._snapshot_fn = snapshot_fn
        return tick

    @property
    def resumable(self) -> bool:
        return self._snapshot_fn is not None

    def snapshot(self) -> Optional[dict]:
        if self._snapshot_fn is None:
            return None
        return self._snapshot_fn()


def chunk_schedule(n_iters: int, fuse_steps: int, record_every: int,
                   start: int = 0):
    """Chunk sizes covering ``n_iters`` iterations from ``start``, with
    record points forced onto chunk boundaries: each chunk is
    ``min(fuse_steps, next record point, remaining)``."""
    it = start
    while it < n_iters:
        k = min(fuse_steps, n_iters - it)
        if record_every:
            next_rec = (it // record_every + 1) * record_every
            k = min(k, next_rec - it)
        yield k
        it += k


# ---------------------------------------------------------------------------
# Pytrees of tensors (dicts and tuples, as the trainers build them).
# ---------------------------------------------------------------------------

def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [v for item in tree for v in _leaves(item)]
    return [tree]


def _map(fn, tree):
    """``fn`` over the leaves, visited in ``_leaves`` order."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaf_bytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    return int(np.asarray(v).nbytes)


def _tree_bytes(tree) -> int:
    return sum(_leaf_bytes(v) for v in _leaves(tree) if v is not None)


def _host_sum(tree):
    """Copy per-core partials to the host and reduce them with numpy's
    promoted accumulators (int64 / float64), as the reference does."""
    def _sum(v):
        a = host_array(v)
        if np.issubdtype(a.dtype, np.integer):
            return np.sum(a.astype(np.int64), axis=0)
        return np.sum(a.astype(np.float64), axis=0)
    return _map(_sum, tree)


def host_array(v) -> np.ndarray:
    """A reduced result as a host array: fabric reduces leave tensors on
    the device, host reduces numpy arrays."""
    if isinstance(v, torch.Tensor):
        return v.cpu().numpy()
    return np.asarray(v)


def _device_sum(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum keeping the partial's dtype (int32 stays int32, like jnp.sum)."""
    return torch.sum(v, dim=dim, dtype=v.dtype)


# ---------------------------------------------------------------------------
# Reduction strategies (pluggable per map_reduce call).
# ---------------------------------------------------------------------------

class ReduceStrategy:
    """How per-core partials are combined into the host-visible result.

    ``device_reduce`` runs on the device; ``finalize`` on the host
    afterwards; ``count_pim_to_cpu`` models the PIM->CPU bytes the
    schedule moves (PIM systems only — processor-centric systems bypass
    strategy byte accounting, see ``System._charge_reduce``).

    Step fusion: ``fusable`` says whether the schedule can run entirely
    on the device inside a fused chunk; ``device_reduce_full`` is the
    fully on-device reduction a chunk's steps use; ``count_chunk``
    charges a chunk's reduce movement, k times one step's.

    Over ranks ``rank_reduce`` / ``rank_reduce_full`` take one rank's
    block of partials and return, on every rank, what ``device_reduce``
    / ``device_reduce_full`` return over every core: by default the
    blocks are gathered in core order and reduced as in one process.
    """

    #: False when the per-step reduction needs the host (HostReduce): a
    #: StepProgram then degrades to per-step map_reduce calls
    fusable = True

    def bind(self, system: "System") -> "ReduceStrategy":
        """Resolve topology-derived parameters against the system about
        to execute (called once per map_reduce or StepProgram)."""
        return self

    def cache_token(self):
        """What distinguishes this strategy in a chunk-graph key."""
        return type(self).__name__

    def device_reduce(self, partials):
        return partials

    def device_reduce_full(self, partials):
        """Complete on-device reduction, for the steps of a fused chunk."""
        return self.device_reduce(partials)

    def rank_reduce(self, partials, blocks: CoreBlocks):
        return self.device_reduce(_map(blocks.gather, partials))

    def rank_reduce_full(self, partials, blocks: CoreBlocks):
        return self.device_reduce_full(_map(blocks.gather, partials))

    def finalize(self, system: "System", out):
        return out

    def count_pim_to_cpu(self, system: "System", out) -> int:
        raise NotImplementedError

    def count_topology(self, system: "System", out) -> tuple:
        """Rank-level split ``(rank_local_bytes, cross_rank_bytes)`` of
        one step's reduce movement: flat schedules ship every partial
        over the host link, so all of it crosses a rank boundary."""
        return 0, self.count_pim_to_cpu(system, out)

    def count_chunk(self, system: "System", out, k: int) -> None:
        """Charge k fused steps' reduce movement (``out`` has the shapes
        of one step's ``device_reduce`` result)."""
        system.stats.pim_to_cpu += k * self.count_pim_to_cpu(system, out)
        rank_local, cross_rank = self.count_topology(system, out)
        system._charge_topology(k * rank_local, k * cross_rank)


class FabricReduce(ReduceStrategy):
    """On-device sum over the cores axis; over ranks, a sum over the
    rank's block, then an all-reduce."""

    def device_reduce(self, partials):
        return _map(lambda v: _device_sum(v, 0), partials)

    def rank_reduce(self, partials, blocks):
        return _map(lambda v: blocks.reduce(v, "sum"), partials)

    rank_reduce_full = rank_reduce

    def count_pim_to_cpu(self, system, out) -> int:
        # every core ships its partial of the reduced shape to the host
        return _tree_bytes(out) * system.config.n_cores


class HostReduce(ReduceStrategy):
    """Paper-faithful schedule: per-core partials are copied to the host
    and reduced with numpy; the result lives on the host.  Not fusable:
    the reduce is itself a host round trip.  Over ranks every rank
    gathers every core's partial in core order and sums them as one
    process does."""

    fusable = False

    def count_pim_to_cpu(self, system, out) -> int:
        return _tree_bytes(out)  # stacked (n_cores, ...) leaves

    def finalize(self, system, out):
        return _host_sum(out)


class HierarchicalReduce(ReduceStrategy):
    """Two-level schedule: a device sum inside each rank of
    ``group_size`` cores, then a host combine of the rank partials.

    ``group_size=None`` derives the group from the executing system's
    rank tree at :meth:`bind` time (the largest divisor of the core count
    that fits one rank)."""

    def __init__(self, group_size: Optional[int] = 8):
        self.group_size = group_size

    def bind(self, system: "System") -> "HierarchicalReduce":
        if self.group_size is not None:
            return self
        from .topology import DEFAULT_DPUS_PER_RANK
        topo = getattr(system, "topology", None)
        cap = topo.dpus_per_rank if topo is not None else DEFAULT_DPUS_PER_RANK
        n = system.config.n_cores
        group = max((d for d in range(1, min(cap, n) + 1) if n % d == 0),
                    default=1)
        return HierarchicalReduce(group)

    def cache_token(self):
        return ("hier", self.group_size)

    def _groups(self, n_cores: int) -> int:
        g = self.group_size
        return n_cores // g if g > 1 and n_cores % g == 0 else 0

    def _plan(self, start: int, stop: int) -> tuple:
        """A block's cores ``[start, stop)`` as ``(head, groups, tail)``:
        ``head`` raw partials ending the group the block starts inside,
        the number of whole groups, and ``tail`` raw partials starting
        the group it stops inside."""
        g = self.group_size
        head_end = min(stop, -(-start // g) * g)
        first, last = -(-start // g), max(stop // g, -(-start // g))
        return (head_end - start, last - first,
                max(0, stop - max(last * g, head_end)))

    def rank_reduce(self, partials, blocks):
        """The group sums of the one-process schedule, in group order, on
        every rank: a rank sums its whole groups on its device and ships
        the raw partials of a group that straddles a rank boundary,
        which every rank then sums as the one-process reduce sums a
        group."""
        if not self._groups(blocks.n_cores):
            return _map(blocks.gather, partials)
        g = self.group_size
        plans = [self._plan(a, b) for a, b in blocks.bounds]
        head, n_whole, _ = plans[blocks.rank]

        def _grouped(v):
            rest = v.shape[1:]
            whole = v[head:head + n_whole * g]
            payload = torch.cat([v[:head], _device_sum(
                whole.reshape(n_whole, g, *rest), 1), v[head + n_whole * g:]])
            full = blocks.gather(payload, [sum(p) for p in plans])
            groups, pending, pos = [], [], 0
            for h, n, t in plans:
                for kind, rows in (("raw", h), ("sum", n), ("raw", t)):
                    piece = full[pos:pos + rows]
                    pos += rows
                    if kind == "sum":
                        groups.append(piece)
                        continue
                    pending.append(piece)
                    if sum(p.shape[0] for p in pending) == g:
                        groups.append(_device_sum(
                            torch.cat(pending).reshape(1, g, *rest), 1))
                        pending = []
            return torch.cat(groups)
        return _map(_grouped, partials)

    def rank_reduce_full(self, partials, blocks):
        return _map(lambda v: _device_sum(v, 0),
                    self.rank_reduce(partials, blocks))

    def device_reduce(self, partials):
        def _grouped(v):
            n_groups = self._groups(v.shape[0])
            if not n_groups:        # awkward core count: flat host schedule
                return v
            return _device_sum(
                v.reshape(n_groups, self.group_size, *v.shape[1:]), 1)
        return _map(_grouped, partials)

    def count_pim_to_cpu(self, system, out) -> int:
        return _tree_bytes(out)  # (n_groups, ...) rank partials

    def _groups_rank_local(self, system: "System") -> bool:
        """Do the reduce groups sit inside physical ranks?"""
        topo = getattr(system, "topology", None)
        return (topo is not None and self.group_size is not None
                and 1 < self.group_size <= topo.dpus_per_rank
                and topo.dpus_per_rank % self.group_size == 0)

    def count_topology(self, system, out) -> tuple:
        # every core's partial folds into its group, then the rank
        # partials cross to the host; the intra-group leg is rank-local
        # only when the groups are rank-aligned
        if not self._groups(system.config.n_cores):
            return 0, _tree_bytes(out)        # flat fallback: all cross
        out_bytes = _tree_bytes(out)
        intra = out_bytes * self.group_size
        if self._groups_rank_local(system):
            return intra, out_bytes
        return 0, intra + out_bytes

    def device_reduce_full(self, partials):
        """In a fused chunk the rank partials are summed on the device, in
        the partials' dtype (int32 wraps as the host sum's demotion does)."""
        return _map(lambda v: _device_sum(v, 0), self.device_reduce(partials))

    def count_chunk(self, system, out, k: int) -> None:
        # each step the rank partials leave the ranks and cross the
        # modeled host link, as in the unfused schedule
        system.stats.pim_to_cpu += k * self.count_pim_to_cpu(system, out)
        if self._groups(system.config.n_cores):
            system._charge_inter_core(k * _tree_bytes(out))
        rank_local, cross_rank = self.count_topology(system, out)
        system._charge_topology(k * rank_local, k * cross_rank)

    def finalize(self, system, out):
        # record the rank->host leg (none if the core count forced the
        # flat fallback); a processor-centric target charges nothing
        if self._groups(system.config.n_cores):
            system._charge_inter_core(_tree_bytes(out))
        return _host_sum(out)


_STRATEGIES: dict[str, Callable[[], ReduceStrategy]] = {
    "fabric": FabricReduce,
    "host": HostReduce,
    "hierarchical": HierarchicalReduce,
    # topology-derived group (resolved per system at bind time)
    "hierarchical-auto": lambda: HierarchicalReduce(group_size=None),
}

StrategyLike = Union[None, str, ReduceVia, ReduceStrategy]


def resolve_reduce_strategy(spec: StrategyLike,
                            default: StrategyLike = None) -> ReduceStrategy:
    if spec is None:
        spec = default if default is not None else "fabric"
    if isinstance(spec, ReduceStrategy):
        return spec
    if isinstance(spec, ReduceVia):
        spec = spec.value
    if isinstance(spec, str) and spec in _STRATEGIES:
        return _STRATEGIES[spec]()
    raise ValueError(f"unknown reduce strategy {spec!r}; "
                     f"known: {sorted(_STRATEGIES)}")


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The torch device a system runs on.  ``"cuda"`` without a GPU
    raises: a system never carries on on the CPU in its place."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                f"is False; pass device='cpu' to run on the CPU")
        # fp32 versions are full float32 arithmetic: no TF32 products
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or "
                         f"'cpu'")
    return dev


# ---------------------------------------------------------------------------
# The System protocol.
# ---------------------------------------------------------------------------

class System:
    """Abstract execution target behind the workload-session API.

    Subclasses implement the placement surface (``shard_rows``,
    ``row_validity_mask``, ``broadcast``), declare ``kind`` and
    ``n_shards``, and override the ``_charge_*`` accounting hooks; the
    kernel registry, the reduce strategies and the ``map_*`` execution
    are shared here.  ``config`` exposes ``n_cores``, ``reduce`` (the
    default strategy) and ``device``.
    """

    #: target identity: "pim" | "host" (CLI spelling)
    kind: str = "abstract"
    #: True on processor-centric targets: the LOG fp32 baseline then uses
    #: the exact sigmoid, not the DPU Taylor expansion.
    exact_transcendentals: bool = False
    #: this rank's block of the cores when they are spread over ranks
    #: (``systems/ranks.py``); None when one process holds every core
    ranks: Optional[CoreBlocks] = None

    def __init__(self, config):
        self.config = config
        self.device = resolve_device(config.device)
        self.stats = TransferStats()
        self._kernels: dict[str, Callable] = {}
        self._kernel_gen: dict[str, int] = {}
        #: StepProgram's per-system cache: one step's reduce shapes and
        #: the captured chunk graphs (see StepProgram)
        self._step_cache: dict = {}
        #: trace timeline for this system's kernel launches (precomputed
        #: so that the hot path never builds the string)
        self._trace_track = f"system:{self.kind}"

    def _launch_span(self, op: str, kkey):
        """Span covering one launch on the system's trace track: on a
        card, the enqueue of its kernels (no span synchronizes).

        The overhead contract (``obs/trace.py``): with tracing off this
        returns the shared no-op before any span *name* is built."""
        if not TRACER.enabled:
            return NULL_SPAN
        name = (kkey[1] if kkey[0] == "named"
                else getattr(kkey[1], "__name__", "fn"))
        return TRACER.span(f"{op}:{name}", self._trace_track, "launch")

    @property
    def n_shards(self) -> int:
        """Width of the leading shard axis ``shard_rows`` produces."""
        raise NotImplementedError

    # -- data placement ------------------------------------------------------

    def put(self, X, y=None):
        """Place a dataset on this system ONCE and return a
        :class:`repro_torch.api.dataset.PimDataset` handle that caches
        its quantized views."""
        from ..api.dataset import PimDataset  # local import: api -> systems
        return PimDataset(self, X, y)

    def put_table(self, weights, *, placement: str = "mod", seed: int = 0):
        """Row-shard an embedding table across this system's shards ONCE
        and return a :class:`repro_torch.api.table.ShardedTable` handle
        (the PimDataset sibling for sharded model state)."""
        from ..api.table import ShardedTable  # local import: api -> systems
        return ShardedTable(self, weights, placement=placement, seed=seed)

    def shard_rows(self, x: np.ndarray, pad_value=0) -> torch.Tensor:
        """Partition rows: (n, ...) -> (n_shards, n_per_shard, ...)."""
        raise NotImplementedError

    def row_validity_mask(self, n: int) -> torch.Tensor:
        """(n_shards, n_per_shard) bool mask marking real rows."""
        raise NotImplementedError

    def broadcast(self, tree: Any) -> Any:
        """Model-state broadcast to every execution site (accounted)."""
        raise NotImplementedError

    def gather_cores(self, t: torch.Tensor) -> torch.Tensor:
        """A resident ``[n_shards, ...]`` tensor whole: over ranks every
        rank's block gathered in core order (untimed: not a reduce);
        otherwise ``t`` itself."""
        if self.ranks is None:
            return t
        return collectives.all_gather_blocks(t, self.ranks.sizes,
                                             self.ranks.group)

    # -- kernel registry -----------------------------------------------------

    def register_kernel(self, name: str, fn: Callable) -> str:
        """Register (or replace) a named per-core kernel; re-registering
        a name with a different function bumps its generation."""
        if self._kernels.get(name) is not fn:
            self._kernel_gen[name] = self._kernel_gen.get(name, -1) + 1
            self._kernels[name] = fn
        return name

    def named_kernel(self, name: str, builder: Callable[[], Callable]) -> str:
        """Register ``builder()`` under ``name`` unless already present:
        encode the factory's parameters in the name and the kernel is
        reused across fits."""
        if name not in self._kernels:
            self.register_kernel(name, builder())
        return name

    def registered_kernels(self) -> tuple:
        return tuple(sorted(self._kernels))

    def _resolve_kernel(self, kernel) -> Callable:
        if isinstance(kernel, str):
            fn = self._kernels.get(kernel)
            if fn is None:
                raise KeyError(
                    f"no kernel registered under {kernel!r}; "
                    f"known: {sorted(self._kernels)}")
            return fn
        if not callable(kernel):
            raise TypeError(f"kernel must be a registered name or a "
                            f"callable, got {type(kernel).__name__}")
        return kernel

    def _kernel_key(self, kernel) -> tuple:
        """A kernel's identity in a launch's price key: (name, generation)
        for a registered name, the function itself for a callable."""
        if isinstance(kernel, str):
            return ("named", kernel, self._kernel_gen[kernel])
        return ("fn", kernel)

    # -- launch pricing ------------------------------------------------------

    def _launch(self, key: tuple, run: Callable, operands):
        """Run one launch, ``run()``, and return its result.  ``key``
        names the program (kernel, strategy, chunk length) and
        ``operands`` are its inputs; a modeled target prices the launch
        by both (:class:`~repro_torch.systems.gpu_model.
        ModeledGpuSystem`).  The PIM and host targets just run it."""
        return run()

    def _pricing(self, key: tuple, operands):
        """Context in which a modeled target counts the work of the
        launch ``key`` once per operand signature; a CUDA graph's capture
        runs in it (``systems/step_graph.py``), since a replay runs no
        op it could count.  A no-op here."""
        return contextlib.nullcontext()

    # -- accounting hooks (per-system TransferStats semantics) ---------------

    def _charge_launch_operands(self, sharded, replicated) -> None:
        """Per-launch operand movement: none on PIM (bank-resident)."""

    def _charge_reduce(self, strat: ReduceStrategy, out) -> None:
        self.stats.pim_to_cpu += strat.count_pim_to_cpu(self, out)
        rank_local, cross_rank = strat.count_topology(self, out)
        self._charge_topology(rank_local, cross_rank)

    def _charge_reduce_custom(self, out) -> None:
        # flat custom reduce: every per-core partial crosses to the host
        self.stats.pim_to_cpu += _tree_bytes(out) * self.config.n_cores
        self._charge_topology(0, _tree_bytes(out) * self.config.n_cores)

    def _charge_topology(self, rank_local: int, cross_rank: int) -> None:
        self.stats.rank_local_bytes += rank_local
        self.stats.cross_rank_bytes += cross_rank

    def _charge_inter_core(self, nbytes: int) -> None:
        self.stats.inter_core_via_host += nbytes

    def _charge_elementwise(self, sharded, replicated) -> None:
        self.stats.cpu_to_pim += _tree_bytes(tuple(replicated)) \
            * self.config.n_cores

    def _charge_chunk(self, carry, sharded, reduced_shape,
                      strat: ReduceStrategy, k: int) -> None:
        """One fused k-step chunk: the carry (model state) enters the
        banks once per chunk; the reduce legs move k times one step's
        bytes."""
        self.stats.cpu_to_pim += _tree_bytes(carry) * self.config.n_cores
        strat.count_chunk(self, reduced_shape, k)

    def _charge_chunk_boundary(self, carry, outs) -> None:
        """One sync per chunk boundary: the final carry and the stacked
        per-step emits."""
        self.stats.pim_to_cpu += _tree_bytes(carry) + _tree_bytes(outs)

    # -- execution ------------------------------------------------------------

    def _reduce(self, strat: ReduceStrategy, partials):
        if self.ranks is None:
            return strat.device_reduce(partials)
        return strat.rank_reduce(partials, self.ranks)

    def _reduce_full(self, strat: ReduceStrategy, partials):
        if self.ranks is None:
            return strat.device_reduce_full(partials)
        return strat.rank_reduce_full(partials, self.ranks)

    def map_reduce(self, kernel, sharded: tuple, replicated: tuple,
                   strategy: StrategyLike = None):
        """Run ``kernel(*sharded, *replicated)`` over all cores in one
        batched call and reduce the resulting tree across the cores
        axis with ``strategy`` (default: the system config's)."""
        strat = resolve_reduce_strategy(strategy,
                                        self.config.reduce).bind(self)
        fn = self._resolve_kernel(kernel)
        self.stats.kernel_launches += 1
        self.stats.host_syncs += 1
        self._charge_launch_operands(sharded, replicated)
        kkey = self._kernel_key(kernel)
        with self._launch_span("map_reduce", kkey):
            out = self._launch(
                ("map_reduce", kkey, len(sharded), len(replicated),
                 strat.cache_token()),
                lambda: self._reduce(strat, fn(*sharded, *replicated)),
                (sharded, replicated))
        self._charge_reduce(strat, out)
        return strat.finalize(self, out)

    def map_reduce_custom(self, kernel, sharded: tuple,
                          replicated: tuple, reduce: dict):
        """Like map_reduce but with per-key reduce ops ("sum"|"min"|"max")
        over the cores axis (over ranks: over the rank's block, then an
        all-reduce with the same op)."""
        fn = self._resolve_kernel(kernel)
        self.stats.kernel_launches += 1
        self.stats.host_syncs += 1
        self._charge_launch_operands(sharded, replicated)
        if self.ranks is not None:
            ops = {op: (lambda v, op=op: self.ranks.reduce(v, op))
                   for op in ("sum", "min", "max")}
        else:
            ops = {"sum": lambda v: _device_sum(v, 0),
                   "min": lambda v: torch.amin(v, dim=0),
                   "max": lambda v: torch.amax(v, dim=0)}

        def run():
            partials = fn(*sharded, *replicated)
            return {k: ops[reduce[k]](v) for k, v in partials.items()}
        kkey = self._kernel_key(kernel)
        with self._launch_span("custom", kkey):
            out = self._launch(
                ("custom", kkey, tuple(sorted(reduce.items()))), run,
                (sharded, replicated))
        self._charge_reduce_custom(out)
        return out

    def map_elementwise(self, kernel, sharded: tuple, replicated: tuple):
        """Per-core kernel with no reduction: the output stays resident.
        Only the replicated arguments cross the boundary."""
        fn = self._resolve_kernel(kernel)
        self.stats.kernel_launches += 1
        self._charge_elementwise(sharded, replicated)
        kkey = self._kernel_key(kernel)
        with self._launch_span("elem", kkey):
            return self._launch(("elem", kkey),
                                lambda: fn(*sharded, *replicated),
                                (sharded, replicated))

    def step_program(self, kernel, prepare: Callable, update: Callable,
                     *, name: str, strategy: StrategyLike = None,
                     select: Optional[Callable] = None,
                     shipped: Optional[Callable] = None) -> "StepProgram":
        """A :class:`StepProgram` over ``kernel``: ``prepare(carry) ->
        replicated`` derives one step's broadcast arguments from the
        carry, ``update(carry, reduced) -> (carry, out)`` applies the
        update, ``select(sharded, x) -> sharded`` (optional) derives
        each step's shard view from a per-step input ``x``, and
        ``shipped(outs)`` (optional) maps the stacked emits to what the
        boundary sync moves to the host (default: all of them).
        ``name`` must encode every parameter baked into the closures."""
        return StepProgram(self, kernel, prepare, update, name=name,
                           strategy=strategy, select=select,
                           shipped=shipped)

    # -- multi-tenancy -------------------------------------------------------

    def slice(self, lease) -> "System":
        """Execution view scoped to a :class:`~repro_torch.sched.allocator.
        BankLease`: the surface the job scheduler runs tenants on."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support scheduling slices")


def _stack(outs: list):
    """The per-step emits of a chunk stacked along a new leading axis
    (None when ``update`` emits nothing)."""
    if not outs or outs[0] is None:
        return None
    first = outs[0]
    if isinstance(first, dict):
        return {k: _stack([o[k] for o in outs]) for k in sorted(first)}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([o[i] for o in outs])
                           for i in range(len(first)))
    return torch.stack([torch.as_tensor(v) for v in outs])


def _signature(tree) -> tuple:
    return tuple((tuple(v.shape), v.dtype) for v in _leaves(tree)
                 if isinstance(v, torch.Tensor))


class StepProgram:
    """k consecutive training steps as ONE fused chunk: one launch and one
    host sync instead of k of each.

    Each step runs ``prepare(carry)``, the per-core kernel over the
    shards (or ``select(sharded, xs[i])``), the strategy's full on-device
    reduce and ``update(carry, reduced)`` — the closures the serial loop
    applies between launches, so for the integer versions a fused chunk
    is bit-identical to k serial steps.  On the CPU the chunk is a plain
    loop of those k steps.  On a CUDA device it is one replay of a CUDA
    graph captured from them (:class:`~repro_torch.systems.step_graph.
    ChunkGraph`), one graph per program, strategy, k, operand shapes and
    core count, as the reference keys its compiled scans; a capture or a
    replay that fails raises.

    Accounting follows the reference: the carry broadcast once per
    chunk, the reduce legs k times, one boundary sync of the final carry
    and the emits (or the part of them ``shipped`` names).  A
    non-``fusable`` strategy (HostReduce, CompressedReduce) degrades to k
    ordinary ``map_reduce`` steps with the unfused accounting.

    Over ranks each step's reduce is a collective, which a CUDA graph
    over gloo cannot hold, so a chunk runs its k steps one by one with
    the reduce between them, on the card as on the CPU, under the fused
    accounting.  ``counts`` says which ran: ``"replays"`` of a chunk
    graph, ``"eager"`` chunks of k steps.
    """

    def __init__(self, system: System, kernel, prepare: Callable,
                 update: Callable, *, name: str,
                 strategy: StrategyLike = None,
                 select: Optional[Callable] = None,
                 shipped: Optional[Callable] = None):
        self.system = system
        self.prepare = prepare
        self.update = update
        self.select = select
        self.shipped = shipped
        self.name = name
        self.strategy = resolve_reduce_strategy(
            strategy, system.config.reduce).bind(system)
        self._kernel = kernel
        self._fn = system._resolve_kernel(kernel)
        self._kkey = system._kernel_key(kernel)
        self.counts: collections.Counter = collections.Counter()

    def _key(self, *parts) -> tuple:
        return (self._fn, self.name, self.strategy.cache_token(), *parts,
                self.system.config.n_cores)

    def price_key(self, k: int, xs) -> tuple:
        """The price key of a k-step chunk: one priced launch covers the
        k steps, on the CPU and on a card alike."""
        return ("step_program", self._kkey, self.name,
                self.strategy.cache_token(), k, xs is not None,
                self.system.config.n_cores)

    def steps(self, carry, sharded: tuple, xs, k: int):
        """The k steps, eagerly: ``(carry, stacked emits)``.  The first
        call for an operand signature records one step's reduce shapes
        (as meta tensors) for the chunk accounting."""
        key = self._key("reduce", _signature((carry, sharded)))
        outs = []
        for i in range(k):
            shards = sharded
            if xs is not None:
                shards = tuple(self.select(sharded, _map(lambda v: v[i],
                                                         xs)))
            partials = self._fn(*shards, *self.prepare(carry))
            if key not in self.system._step_cache:
                self.system._step_cache[key] = self.strategy.device_reduce(
                    _map(self._meta_partial, partials))
            carry, out = self.update(
                carry, self.system._reduce_full(self.strategy, partials))
            outs.append(out)
        return carry, _stack(outs)

    def _meta_partial(self, v: torch.Tensor) -> torch.Tensor:
        """A partial's shape over every core, as a meta tensor (over ranks
        ``v`` holds the rank's block)."""
        lead = v.shape[:1] if self.system.ranks is None \
            else (self.system.n_shards,)
        return torch.empty((*lead, *v.shape[1:]), dtype=v.dtype,
                           device="meta")

    def run(self, carry, sharded: tuple, k: int, xs=None, *,
            donate: bool = True):
        """Advance ``carry`` by ``k`` fused steps over the resident
        shards; returns ``(carry, outs)``, ``outs`` stacking the per-step
        emits.  ``xs`` is a tree of per-step inputs with leading dim k,
        routed to ``select``.  ``donate=False`` hands back a carry that
        stays valid while later chunks run (a :class:`ChunkPipeline` of
        depth >= 2); numerics are the same either way."""
        sharded = tuple(sharded)
        if k <= 0:
            return carry, None
        if xs is not None and self.select is None:
            raise ValueError("xs given but this StepProgram has no "
                             "select hook")
        if not self.strategy.fusable:
            return self._run_per_step(carry, sharded, k, xs)
        stats = self.system.stats
        stats.kernel_launches += 1
        stats.host_syncs += 1
        carry_in = carry
        if _leaves(carry)[0].device.type == "cuda" and \
                self.system.ranks is None:
            from .step_graph import chunk_graph
            graph = chunk_graph(self, carry, sharded, xs, k)
            self.counts["replays"] += 1

            def run():
                return graph.replay(carry_in, xs, clone=not donate)
        else:
            self.counts["eager"] += 1

            def run():
                return self.steps(carry_in, sharded, xs, k)
        span = (TRACER.span(f"chunk:{self.name}", self.system._trace_track,
                            "launch", k=k) if TRACER.enabled else NULL_SPAN)
        with span:
            carry, outs = self.system._launch(self.price_key(k, xs), run,
                                              (carry_in, sharded, xs))
        reduced = self.system._step_cache[
            self._key("reduce", _signature((carry_in, sharded)))]
        self.system._charge_chunk(carry_in, sharded, reduced,
                                  self.strategy, k)
        self.system._charge_chunk_boundary(
            carry, outs if self.shipped is None else self.shipped(outs))
        return carry, outs

    def release(self) -> None:
        """Drop this program's cached chunk graphs, with their memory
        pools, and its reduce shapes.  A fit calls it when it ends, so a
        graph never outlives the fit whose closures it captured."""
        cache = self.system._step_cache
        for key in [k for k in cache if k[:2] == (self._fn, self.name)]:
            del cache[key]

    def _run_per_step(self, carry, sharded: tuple, k: int, xs=None):
        """k single steps, each with the broadcast, reduce and update of
        the unfused loop (launches, syncs and bytes as if not fused)."""
        outs = []
        for i in range(k):
            shards = sharded
            if xs is not None:
                shards = tuple(self.select(sharded, _map(lambda v: v[i],
                                                         xs)))
            replicated = self.system.broadcast(self.prepare(carry))
            reduced = self.system.map_reduce(
                self._kernel, shards, tuple(replicated),
                strategy=self.strategy)
            carry, out = self.update(carry, reduced)
            outs.append(out)
        return carry, _stack(outs)


@dataclasses.dataclass
class ChunkBoundary:
    """One dispatched chunk inside a :class:`ChunkPipeline`: its carry and
    emits, the caller's ``tag`` (host state captured at dispatch: the
    iteration count, the packed rng, ...), and on a CUDA device a copy of
    both in pinned host memory with the event that marks it complete."""

    k: int
    carry: Any
    outs: Any
    tag: Any = None
    _host: Any = dataclasses.field(default=None, repr=False)
    _ready: Any = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        leaves = [v for v in _leaves((self.carry, self.outs))
                  if isinstance(v, torch.Tensor)]
        if leaves and leaves[0].device.type == "cuda":
            def _pinned(v):
                if not isinstance(v, torch.Tensor):
                    return v
                out = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                return out.copy_(v, non_blocking=True)
            self._host = _map(_pinned, (self.carry, self.outs))
            self._ready = torch.cuda.Event()
            self._ready.record()

    def host(self) -> tuple:
        """``(carry, outs)`` on the host.  On a card this waits for this
        boundary's copy only, not for the chunks dispatched after it."""
        if self._ready is None:
            return self.carry, self.outs
        self._ready.synchronize()
        return self._host


class ChunkPipeline:
    """Keeps ``depth`` chunks of a :class:`StepProgram` in flight.

    ``dispatch()`` launches the next chunk at once and hands back the
    boundaries that have fallen ``depth`` behind, which the caller drains
    (``ChunkBoundary.host()``) while the device works.  Everything the
    drain needs from the host (iteration counters, rng state) travels in
    the boundary's ``tag``, captured at dispatch.  ``depth=1`` is the
    serial cadence (dispatch, drain, repeat) with the carry donated;
    ``depth>=2`` keeps each boundary's carry valid while the next chunk
    runs.  Pipelining reorders host work only: a pipelined fit is
    bit-identical to the serial one."""

    def __init__(self, program: StepProgram, depth: int = 2):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self.program = program
        self.depth = depth
        self._pending: collections.deque = collections.deque()

    @property
    def donate(self) -> bool:
        """Depth 1 never holds a boundary while the next chunk runs."""
        return self.depth == 1

    def dispatch(self, carry, sharded: tuple, k: int, xs=None, tag=None):
        """Launch the next ``k``-step chunk; returns ``(new_carry,
        drained)``, ``drained`` listing the boundaries now due (empty
        until the pipeline fills).  Feed ``new_carry`` to the next
        dispatch; read drained boundaries instead of it."""
        carry, outs = self.program.run(carry, sharded, k, xs=xs,
                                       donate=self.donate)
        self._pending.append(ChunkBoundary(k, carry, outs, tag))
        drained = []
        while len(self._pending) >= self.depth:
            drained.append(self._pending.popleft())
        return carry, drained

    def flush(self) -> list:
        """Hand back every boundary still in flight (end of schedule or
        early stop; boundaries dispatched after a stop are the caller's
        to discard)."""
        drained = list(self._pending)
        self._pending.clear()
        return drained
