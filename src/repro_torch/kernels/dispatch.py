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
    """One dispatchable op: a CUDA kernel wrapper, its plain version and,
    for the PIM-ML ops, its declared cost."""

    name: str
    cuda: Callable
    plain: Callable
    cost: Optional[Callable[..., KernelCost]] = None


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
                cost: Optional[Callable[..., KernelCost]] = None) -> None:
    _OPS[name] = KernelOp(name=name, cuda=cuda, plain=plain, cost=cost)


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


def launch(op: str, x: torch.Tensor, *args, **kwargs):
    """Run ``op`` on ``x``'s device: its CUDA kernel or its plain
    version.  Under an op counter the op is charged its declared cost and
    what it runs is not counted."""
    if meters:
        meter = meters[-1]
        meter.charge(declared_cost(op, x, *args, **kwargs))
        with meter.paused():
            return _run(get_op(op), op, x, *args, **kwargs)
    return _run(get_op(op), op, x, *args, **kwargs)


def _run(entry: KernelOp, op: str, x: torch.Tensor, *args, **kwargs):
    if x.device.type == "cuda":
        return entry.cuda(x, *args, **kwargs)
    if x.device.type == "cpu":
        return entry.plain(x, *args, **kwargs)
    raise ValueError(f"{op}: no implementation for device {x.device}")
