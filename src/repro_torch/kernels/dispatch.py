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
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict

import torch


@dataclasses.dataclass(frozen=True)
class KernelOp:
    """One dispatchable op: a CUDA kernel wrapper + its plain version."""

    name: str
    cuda: Callable
    plain: Callable


_OPS: Dict[str, KernelOp] = {}

#: kernel families imported on first use; each registers its ops
_FAMILIES = ("quant_matmul", "lut_activation", "kmeans_assign",
             "gini_split", "sparse_gather", "flash_attention")

#: kernel launches per op, counted by the CUDA wrappers and, for a
#: replayed chunk graph, by the replay
launch_counts: Dict[str, int] = {}
#: chunk-graph replays per StepProgram name
graph_replays: Dict[str, int] = {}


def register_op(name: str, *, cuda: Callable, plain: Callable) -> None:
    _OPS[name] = KernelOp(name=name, cuda=cuda, plain=plain)


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
    version."""
    entry = get_op(op)
    if x.device.type == "cuda":
        return entry.cuda(x, *args, **kwargs)
    if x.device.type == "cpu":
        return entry.plain(x, *args, **kwargs)
    raise ValueError(f"{op}: no implementation for device {x.device}")
