"""Op registry for the kernel tier.

Every op registers two implementations of one function: a CUDA wrapper
that launches a hand-written kernel, and a plain PyTorch version.
:func:`launch` picks by the device of the op's first tensor: a CUDA
tensor gets the kernel, a CPU tensor the plain version.  There is no
environment switch and no fallback — a CUDA wrapper whose build or
launch fails raises.

``launch_counts[op]`` is bumped by the CUDA wrapper right after its
kernel launched, so a run can show that its main path went through the
kernels (reset it with :func:`reset_launch_counts`).  A fused chunk
replayed from a CUDA graph calls no wrapper: the graph adds the counts
its capture recorded at every replay (``systems/step_graph.py``), and
``graph_replays[name]`` counts the replays of each program.

Each op of the PIM-ML workloads also declares its cost, a
:class:`KernelCost` computed from its arguments' shapes: the operations
it performs and the bytes it must move (each input read once, each
output written once).  ``chip_smoke.py`` takes a kernel's bound from it,
and an op counter pricing a launch (``systems/gpu_model.py``'s
:class:`~repro_torch.systems.gpu_model.OpCounter`, pushed on
:data:`meters`) charges it in place of the aten ops of whichever version
runs, so a count is the same on the CPU and on a card.  Under a counter
an op that declares no cost raises: it is never priced at 0.

The LM ops also run on sharded and on fake tensors.  A launch whose
tensors include a ``DTensor`` goes to the op's ``sharded`` rule, which
launches the op on each rank's local shards and wraps the result with the
placements the rule derives (:func:`on_shards`): the kernel runs on a
shard, and no rule gathers a weight.  A fake tensor (``FakeTensorMode``,
the dry-run) gets the op's ``fake`` result, of the right shape and dtype
and computed from nothing; under a counter it is charged the declared
cost like any launch.  A real CUDA tensor still launches the kernel.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """What one call of an op must do: ``ops`` operations of type
    ``rate`` ("int32", "fp32", "int8" or "bf16": the peak they run at; a
    multiply-add counts 2) and ``bytes`` moved, each input read once and
    each output written once."""

    ops: float
    bytes: float
    rate: str


@dataclasses.dataclass(frozen=True)
class KernelOp:
    """One dispatchable op: a CUDA kernel wrapper, its plain version, its
    declared cost and, for the LM ops, its result on fake tensors and its
    rule for sharded ones."""

    name: str
    cuda: Callable
    plain: Callable
    cost: Optional[Callable[..., KernelCost]] = None
    fake: Optional[Callable] = None
    sharded: Optional[Callable] = None


_OPS: Dict[str, KernelOp] = {}

#: kernel families imported on first use; each registers its ops
_FAMILIES = ("quant_matmul", "lut_activation", "kmeans_assign",
             "gini_split", "sparse_gather", "flash_attention")

#: kernel launches per op, counted by the CUDA wrappers and, for a
#: replayed chunk graph, by the replay
launch_counts: Dict[str, int] = {}
#: chunk-graph replays per StepProgram name
graph_replays: Dict[str, int] = {}
#: the op counters pricing the launch in progress, innermost last
meters: list = []


def register_op(name: str, *, cuda: Callable, plain: Callable,
                cost: Optional[Callable[..., KernelCost]] = None,
                fake: Optional[Callable] = None,
                sharded: Optional[Callable] = None) -> None:
    _OPS[name] = KernelOp(name=name, cuda=cuda, plain=plain, cost=cost,
                          fake=fake, sharded=sharded)


def declared_cost(op: str, *args, **kwargs) -> KernelCost:
    """``op``'s cost on these arguments; raises if it declares none."""
    cost = get_op(op).cost
    if cost is None:
        raise NotImplementedError(
            f"{op}: no declared cost (kernels/dispatch.py); a priced launch "
            f"cannot count it")
    return cost(*args, **kwargs)


def get_op(name: str) -> KernelOp:
    for fam in _FAMILIES:  # cached after the first import
        importlib.import_module(f"{__package__}.{fam}")
    try:
        return _OPS[name]
    except KeyError:
        raise KeyError(f"unknown kernel op {name!r}; known: "
                       f"{sorted(_OPS)}") from None


def count_launch(op: str, n: int = 1) -> None:
    launch_counts[op] = launch_counts.get(op, 0) + n


def count_replay(name: str) -> None:
    graph_replays[name] = graph_replays.get(name, 0) + 1


def reset_launch_counts() -> None:
    launch_counts.clear()
    graph_replays.clear()


def is_dtensor(t) -> bool:
    if not isinstance(t, torch.Tensor) or type(t) is torch.Tensor:
        return False
    return is_dtensor_type(type(t))


def is_dtensor_type(cls) -> bool:
    from torch.distributed.tensor import DTensor
    return issubclass(cls, DTensor)


def is_fake(t) -> bool:
    """Whether ``t`` (a DTensor: its local shard) is a fake tensor."""
    if not isinstance(t, torch.Tensor) or type(t) is torch.Tensor:
        return False
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(getattr(t, "_local_tensor", t), FakeTensor)


def launch(op: str, x: torch.Tensor, *args, **kwargs):
    """Run ``op`` on ``x``'s device: its CUDA kernel or its plain
    version; on DTensors its ``sharded`` rule, on fake tensors its
    ``fake`` result.  Under an op counter the op is charged its declared
    cost and what it runs is not counted."""
    entry = get_op(op)
    if any(map(is_dtensor, (x,) + args)):
        if entry.sharded is None:
            raise NotImplementedError(f"{op}: no rule for sharded "
                                      f"(DTensor) inputs")
        return entry.sharded(x, *args, **kwargs)
    if meters:
        meter = meters[-1]
        meter.charge(declared_cost(op, x, *args, **kwargs))
        with meter.paused():
            return _run(entry, op, x, *args, **kwargs)
    return _run(entry, op, x, *args, **kwargs)


def on_shards(op: str, placements: list, *args, **kwargs):
    """Launch ``op`` on the local shards of ``args``' DTensors (their
    mesh: the first one's) and wrap each tensor it returns as a DTensor
    with ``placements[i]``; to_local and from_local carry the gradient."""
    from torch.distributed.tensor import DTensor
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    local = [a.to_local() if isinstance(a, DTensor) else a for a in args]
    out = launch(op, *local, **kwargs)
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(o, mesh, p, run_check=False)
                     for o, p in zip(out, placements))
    return DTensor.from_local(out, mesh, placements[0], run_check=False)


def _run(entry: KernelOp, op: str, x: torch.Tensor, *args, **kwargs):
    if type(x) is not torch.Tensor and is_fake(x):
        if entry.fake is None:
            raise NotImplementedError(f"{op}: no result on fake tensors")
        return entry.fake(x, *args, **kwargs)
    if x.device.type == "cuda":
        return entry.cuda(x, *args, **kwargs)
    if x.device.type == "cpu":
        return entry.plain(x, *args, **kwargs)
    raise ValueError(f"{op}: no implementation for device {x.device}")
