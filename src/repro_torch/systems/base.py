"""The ``System`` protocol: data placement, reduce strategies, execution.

Port of the main-path half of ``repro.systems.base``.  A trainer sees
only ``dataset.system``; the system owns the device, the resident shards,
the named-kernel registry and the ``TransferStats`` accounting.

The simulated cores are the leading axis of one device tensor
``[C, n_pc, ...]``.  A per-core kernel here is written over that whole
batch — ``kernel(*sharded, *replicated)`` returns partials with a
leading cores axis — so one launch covers every core, where the
reference traced a per-core function under ``jax.vmap``.

The byte counters are deterministic integers computed from the same
shapes and dtypes as the reference's, so a port fit and a reference fit
of the same calls leave equal ``TransferStats``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import numpy as np
import torch


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
    ``map_*`` calls.  The remaining fields belong to layers not ported
    yet and stay zero; they are kept so the whole record compares equal
    to the reference's.
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

    def snapshot(self) -> "TransferStats":
        """Point-in-time copy of every counter."""
        return dataclasses.replace(self)


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
    return sum(_leaf_bytes(v) for v in _leaves(tree))


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
    """

    def bind(self, system: "System") -> "ReduceStrategy":
        """Resolve topology-derived parameters against the system about
        to execute (called once per map_reduce)."""
        return self

    def device_reduce(self, partials):
        return partials

    def finalize(self, system: "System", out):
        return out

    def count_pim_to_cpu(self, system: "System", out) -> int:
        raise NotImplementedError

    def count_topology(self, system: "System", out) -> tuple:
        """Rank-level split ``(rank_local_bytes, cross_rank_bytes)`` of
        one step's reduce movement: flat schedules ship every partial
        over the host link, so all of it crosses a rank boundary."""
        return 0, self.count_pim_to_cpu(system, out)


class FabricReduce(ReduceStrategy):
    """On-device sum over the cores axis."""

    def device_reduce(self, partials):
        return _map(lambda v: _device_sum(v, 0), partials)

    def count_pim_to_cpu(self, system, out) -> int:
        # every core ships its partial of the reduced shape to the host
        return _tree_bytes(out) * system.config.n_cores


class HostReduce(ReduceStrategy):
    """Paper-faithful schedule: per-core partials are copied to the host
    and reduced with numpy; the result lives on the host."""

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

    def _groups(self, n_cores: int) -> int:
        g = self.group_size
        return n_cores // g if g > 1 and n_cores % g == 0 else 0

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

StrategyLike = Union[None, str, ReduceStrategy]


def resolve_reduce_strategy(spec: StrategyLike,
                            default: StrategyLike = None) -> ReduceStrategy:
    if spec is None:
        spec = default if default is not None else "fabric"
    if isinstance(spec, ReduceStrategy):
        return spec
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

    def __init__(self, config):
        self.config = config
        self.device = resolve_device(config.device)
        self.stats = TransferStats()
        self._kernels: dict[str, Callable] = {}
        self._kernel_gen: dict[str, int] = {}

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

    # -- execution ------------------------------------------------------------

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
        out = strat.device_reduce(fn(*sharded, *replicated))
        self._charge_reduce(strat, out)
        return strat.finalize(self, out)

    def map_reduce_custom(self, kernel, sharded: tuple,
                          replicated: tuple, reduce: dict):
        """Like map_reduce but with per-key reduce ops ("sum"|"min"|"max")
        over the cores axis."""
        fn = self._resolve_kernel(kernel)
        self.stats.kernel_launches += 1
        self.stats.host_syncs += 1
        self._charge_launch_operands(sharded, replicated)
        partials = fn(*sharded, *replicated)
        ops = {"sum": lambda v: _device_sum(v, 0),
               "min": lambda v: torch.amin(v, dim=0),
               "max": lambda v: torch.amax(v, dim=0)}
        out = {k: ops[reduce[k]](v) for k, v in partials.items()}
        self._charge_reduce_custom(out)
        return out

    def map_elementwise(self, kernel, sharded: tuple, replicated: tuple):
        """Per-core kernel with no reduction: the output stays resident.
        Only the replicated arguments cross the boundary."""
        fn = self._resolve_kernel(kernel)
        self.stats.kernel_launches += 1
        self._charge_elementwise(sharded, replicated)
        return fn(*sharded, *replicated)
