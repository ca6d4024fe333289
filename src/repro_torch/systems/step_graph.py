"""A fused chunk of a StepProgram as one CUDA graph.

On a CUDA device :meth:`~repro_torch.systems.base.StepProgram.run`
replays one graph per chunk instead of launching the k steps' kernels
from Python.  :func:`chunk_graph` captures it on the first chunk of its
key — the program's kernel and name, the strategy, k, whether per-step
inputs ride along, the shapes of the carry and those inputs, the
addresses and shapes of the resident shards, and the core count — and
caches it on the system.

Capture: the static inputs are copies of the first carry and per-step
inputs; one eager step on a side stream warms up what a capture cannot
do (a kernel library's first build and load, a kernel's shared-memory
opt-in); then the k steps are captured into one graph with its own
memory pool.  The shards are read where they lie: a graph is only
replayed on shards at the addresses it was captured on, so a caller
whose state moves (the EMB tables after a flush) copies it back into
place first.

Replay: the incoming carry and inputs are copied into the static inputs,
the graph is replayed on the current stream, and the outputs are handed
back as they are (the next replay overwrites them, the counterpart of
the reference's donated carry) or cloned, so a pipelined boundary stays
readable while the next chunk runs.

Lifetime: a graph holds its program, so every tensor the captured
steps' closures read stays alive as long as the graph; a fit drops its
program's graphs, and with them their memory pools, when it ends
(:meth:`~repro_torch.systems.base.StepProgram.release`).

Launch counts: a replay calls no kernel wrapper, so the graph records
the count each op gained during its capture and adds it again at every
replay; the warm-up's and the capture's own counts are taken back.
``dispatch.graph_replays`` counts the replays per program name.
Pricing: a replay runs no op a modeled target could count either, so
the capture runs inside ``System._pricing`` under the chunk's price key:
a ``ModeledGpuSystem`` counts the k captured steps once there, as one
launch, and charges that cost at every replay.
Nothing falls back: a failed capture or replay raises.
"""
from __future__ import annotations

import torch

from ..kernels import dispatch
from .base import _leaves, _map, _signature


def _copy_into(dst, src) -> None:
    for d, s in zip(_leaves(dst), _leaves(src)):
        if d.data_ptr() != s.data_ptr():
            d.copy_(s, non_blocking=True)


class ChunkGraph:
    """One captured k-step chunk of a StepProgram."""

    def __init__(self, program, carry, sharded: tuple, xs, k: int):
        #: what the captured closures read lives as long as the graph
        self.program = program
        self.name = program.name
        self.k = k
        dev = _leaves(carry)[0].device
        self.carry_in = _map(lambda v: v.clone(), carry)
        self.xs_in = (None if xs is None
                      else _map(lambda v: v.to(dev, copy=True), xs))
        saved = dict(dispatch.launch_counts)
        try:
            with torch.cuda.device(dev):
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    program.steps(self.carry_in, sharded, self.xs_in, 1)
                torch.cuda.current_stream().wait_stream(side)
                torch.cuda.synchronize()
                self.graph = torch.cuda.CUDAGraph()
                mark = dict(dispatch.launch_counts)
                with torch.cuda.graph(self.graph), program.system._pricing(
                        program.price_key(k, xs), (carry, sharded, xs)):
                    self.carry_out, self.outs = program.steps(
                        self.carry_in, sharded, self.xs_in, k)
                self.launches = {
                    op: n - mark.get(op, 0)
                    for op, n in dispatch.launch_counts.items()
                    if n != mark.get(op, 0)}
        finally:
            dispatch.launch_counts.clear()
            dispatch.launch_counts.update(saved)

    def replay(self, carry, xs, clone: bool):
        """Run the chunk on ``carry`` (and per-step inputs ``xs``);
        returns ``(carry, outs)``."""
        _copy_into(self.carry_in, carry)
        if xs is not None:
            _copy_into(self.xs_in, xs)
        self.graph.replay()
        for op, n in self.launches.items():
            dispatch.count_launch(op, n)
        dispatch.count_replay(self.name)
        if clone:
            return _map(lambda v: None if v is None else v.clone(),
                        (self.carry_out, self.outs))
        return self.carry_out, self.outs


def chunk_graph(program, carry, sharded: tuple, xs, k: int) -> ChunkGraph:
    """The cached :class:`ChunkGraph` of this chunk's key, captured on a
    miss."""
    key = program._key(
        "graph", k, xs is not None, _signature((carry, xs)),
        tuple((v.data_ptr(), tuple(v.shape), v.stride(), v.dtype)
              for v in _leaves(sharded)))
    cache = program.system._step_cache
    graph = cache.get(key)
    if graph is None:
        graph = cache[key] = ChunkGraph(program, carry, sharded, xs, k)
    return graph

