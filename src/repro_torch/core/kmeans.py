"""K-Means clustering on the PIM system (paper §3.4, Lloyd's method).

Port of ``repro.core.kmeans``.  The training set is partitioned over the
simulated cores and quantized to 16-bit integers; per iteration every
core (1) finds each point's nearest centroid with integer distance
arithmetic and (2) accumulates per-cluster per-coordinate sums and
counts — one batched ``kmeans_assign`` launch over the ``[C, n_pc, F]``
shards; the host (3) reduces the partials, recomputes the centroids in
float64 numpy, checks the relative Frobenius shift for convergence and
re-broadcasts the quantized centroids.  The whole algorithm restarts
``n_init`` times from ``rng.choice`` draws of the same numpy MT19937
stream as the reference; the host keeps the clustering with the lowest
inertia, which the cores compute after convergence.

Coordinates are quantized to +-2047 (``QUANT_RANGE``), so the int32
distances are exact for the evaluated sizes; the int32 reduce of the
coordinate sums across the cores wraps as the reference's does.  The
int16 version's centroids, labels and iteration counts are bit-identical
to the reference at the same core count; inertia is a float32 sum whose
order differs.  ``fp32`` is the processor-centric float baseline.

``fuse_steps > 1`` runs Lloyd's iterations in fused chunks (one CUDA
graph replay each on a card) with the reference's on-device float32
update and convergence latch: the fused arithmetic, not the serial loop's
float64 one, so fused centroids are held close to the serial ones, and
equal to the reference's fused ones.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..elastic.state import pack_rng, unpack_rng
from ..kernels import dispatch
from ..kernels.kmeans_assign import cluster_totals, sq_norms, wrapped_cross
from ..systems import (ChunkPipeline, ChunkTick, chunk_schedule,
                       host_array, run_steps)
from .metrics import frobenius_shift

# 12-bit symmetric range stored in int16.  The quantizing + sharding
# path, PimDataset.kmeans_view (repro_torch/api/dataset.py), imports
# this constant — single source of truth.
QUANT_RANGE = 2047

#: "int16" is the paper's PIM version (quantized Lloyd's); "fp32" is the
#: processor-centric float path, runnable on any System
VERSIONS = ("int16", "fp32")


@dataclasses.dataclass
class KMeansConfig:
    k: int = 16
    max_iters: int = 300
    tol: float = 1e-4           # relative Frobenius norm (paper §5.1.4)
    n_init: int = 1
    seed: int = 0
    #: data/arithmetic precision: "int16" or "fp32"
    version: str = "int16"
    #: step fusion: this many Lloyd's iterations per fused chunk.  The
    #: convergence check runs on the device (a ``done`` flag in the carry
    #: freezes the centroids), so a chunk may cover fewer effective
    #: iterations than its length; the host stops at the first converged
    #: boundary.  The fused update is float32 where the serial loop's is
    #: float64.  1 = the host-orchestrated loop.
    fuse_steps: int = 1
    #: fused chunks in flight before the host drains a boundary: boundary
    #: N's done flag is read while chunk N+1 runs (an overshot chunk is a
    #: frozen no-op, discarded unread).  Only used when ``fuse_steps > 1``.
    pipeline_depth: int = 2


@dataclasses.dataclass
class KMeansResult:
    centroids: np.ndarray       # float32 [k, F] (dequantized)
    inertia: float
    n_iters: int
    labels: Optional[np.ndarray] = None


# ---------------------------------------------------------------------------
# Per-core kernels, batched over the leading cores axis: shards are
# [C, n, F] / [C, n], partials come back with a leading C axis.
# ---------------------------------------------------------------------------

def _float_distances(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``||c||^2 - 2 x.c`` in float32, the fp32 version's tie-breaking
    expression (the per-row ``||x||^2`` cannot change an argmin)."""
    return torch.sum(c * c, dim=1) - 2.0 * torch.matmul(x, c.T)


def _assign_kernel_factory(k: int, quantized: bool = True):
    """Assignment + accumulation.

    The int16 (PIM) version is the ``kmeans_assign`` op (the CUDA kernel
    on a card); the fp32 baseline is an inline float distance and one-hot
    accumulation.  Shard padding rows are all-zero vectors: they add
    nothing to ``sums`` and one spurious count each at the zero vector's
    label, the first argmin of the centroids' squared norms (the distance
    with ``x = 0``); those counts are subtracted here — the only pad
    correction on this path."""
    def _kernel(Xq, valid, Cq):
        if quantized:
            labels, sums, counts = dispatch.launch("kmeans_assign",
                                                   Xq.contiguous(), Cq)
            zero_dist = sq_norms(Cq.to(torch.int32))
        else:
            labels = torch.argmin(_float_distances(Xq, Cq),
                                  dim=-1).to(torch.int32)
            onehot = (labels.unsqueeze(-1) == torch.arange(
                k, dtype=torch.int32, device=labels.device))
            sums = torch.matmul(onehot.to(torch.float32).transpose(-1, -2),
                                Xq)
            counts = cluster_totals(labels, torch.ones_like(labels), k)
            zero_dist = torch.sum(Cq * Cq, dim=1)
        n_pad = torch.sum(~valid, dim=-1, dtype=torch.int32)
        at_zero = torch.arange(k, device=counts.device) == torch.argmin(
            zero_dist)
        return {"sums": sums,
                "counts": counts - n_pad.unsqueeze(-1) * at_zero}
    return _kernel


def _inertia_kernel_factory(k: int, quantized: bool = True):
    def _kernel(Xq, valid, Cq):
        if quantized:
            x, c = Xq.to(torch.int32), Cq.to(torch.int32)
            # the reference's term order: ||x||^2 - 2 x.c + ||c||^2
            dist = (sq_norms(x).unsqueeze(-1) - 2 * wrapped_cross(x, c)
                    + sq_norms(c))
        else:
            dist = (torch.sum(Xq * Xq, dim=-1).unsqueeze(-1)
                    - 2 * torch.matmul(Xq, Cq.T)
                    + torch.sum(Cq * Cq, dim=1))
        best = torch.amin(dist, dim=-1)
        # int32 sums can overflow over a whole shard: accumulate in f32 on
        # the way out (the host reduces in f64)
        return {"inertia": torch.sum(
            torch.where(valid, best, 0).to(torch.float32), dim=-1)}
    return _kernel


def _labels_kernel_factory(k: int, quantized: bool = True):
    """Labels-only predict path: a plain argmin over the same distance
    expression the assignment kernel uses (identical tie-breaking),
    without the accumulation nobody reads on the inference path."""
    def _kernel(Xq, valid, Cq):
        if quantized:
            x, c = Xq.to(torch.int32), Cq.to(torch.int32)
            dist = sq_norms(c) - 2 * wrapped_cross(x, c)
        else:
            dist = _float_distances(Xq, Cq)
        return torch.argmin(dist, dim=-1).to(torch.int32)
    return _kernel


def _as_f32(v, device: torch.device) -> torch.Tensor:
    """A reduced partial as float32 on ``device``; host reduces arrive as
    numpy int64, converted directly as ``jnp.asarray(v, float32)`` does."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    return torch.from_numpy(np.asarray(v)).to(device).to(torch.float32)


def _make_lloyd_step_fns(cfg: KMeansConfig):
    """(prepare, update) of one fused Lloyd's iteration.

    The carry is ``(C float32 [k, F] in quantized units, done bool, n_it
    int32)``.  ``done`` latches once the relative Frobenius shift drops
    below ``cfg.tol`` and freezes the centroids, so the steps of a chunk
    past convergence change nothing; ``n_it`` counts only the steps taken
    before it, the host loop's iteration count."""
    tol = float(np.float32(cfg.tol))
    quantized = cfg.version == "int16"

    def prepare(carry):
        C = carry[0]
        return (torch.round(C).to(torch.int16),) if quantized else (C,)

    def update(carry, reduced):
        C, done, n_it = carry
        sums = _as_f32(reduced["sums"], C.device)
        counts = _as_f32(reduced["counts"], C.device).unsqueeze(-1)
        new = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                          C)
        shift = (torch.linalg.norm(new - C)
                 / torch.clamp(torch.linalg.norm(C), min=1e-12))
        new = torch.where(done, C, new)
        n_it = n_it + (~done).to(torch.int32)
        return (new, done | (shift < tol), n_it), None
    return prepare, update


# ---------------------------------------------------------------------------
# Host-orchestrated Lloyd's loop (paper §3.4 flow).
# ---------------------------------------------------------------------------

def fit_steps(dataset, cfg: Optional[KMeansConfig] = None,
              return_labels: bool = True, *,
              state: Optional[dict] = None):
    """Generator form of Lloyd's: one assign/update step per ``next()``
    (across all ``n_init`` restarts), the KMeansResult on StopIteration.
    Each ``next()`` yields a :class:`~repro_torch.systems.base.ChunkTick`
    whose ``snapshot()`` holds the restart state (centroids, done-latch,
    restart index, rng stream, best so far) in the reference's schema.
    Passing a snapshot back as ``state`` — one of this package's or one
    the reference's serial ``fit_steps`` produced — resumes exactly
    there: the rng restores to the same stream position, so later
    restarts draw the same init points an uninterrupted fit would.  The
    end-of-restart inertia/labels passes run at the head of the
    ``next()`` that follows convergence."""
    cfg = cfg or KMeansConfig()
    if cfg.version not in VERSIONS:
        raise ValueError(f"unknown KME version {cfg.version!r}; known: "
                         f"{VERSIONS}")
    quantized = cfg.version == "int16"
    system = dataset.system
    n = dataset.n
    rng = np.random.RandomState(cfg.seed)
    view = dataset.kmeans_view(cfg.version)
    Xs, valid = view.shards, view.mask
    Xq_np, scale = view.host_q, view.scale

    def _cast_centroids(C):
        """Broadcast form of the carry: rounded int16 on the quantized
        path (the paper's re-quantized centroids), plain float32 on the
        processor-centric fp32 path."""
        if quantized:
            return torch.from_numpy(np.round(C).astype(np.int16)).to(
                system.device)
        return torch.from_numpy(np.asarray(C, np.float32)).to(system.device)

    # the reference's kernel names: int16 predates the fp32 version
    vtag = "" if quantized else "fp32/"
    assign_k = system.named_kernel(
        f"kme.assign/{vtag}k{cfg.k}",
        lambda: _assign_kernel_factory(cfg.k, quantized))
    inertia_k = system.named_kernel(
        f"kme.inertia/{vtag}k{cfg.k}",
        lambda: _inertia_kernel_factory(cfg.k, quantized))
    labels_k = system.named_kernel(
        f"kme.labels/{vtag}k{cfg.k}",
        lambda: _labels_kernel_factory(cfg.k, quantized))
    program = None
    if cfg.fuse_steps > 1:
        prepare, update = _make_lloyd_step_fns(cfg)
        program = system.step_program(
            assign_k, prepare, update,
            name=f"kme.step/{vtag}k{cfg.k}/tol{cfg.tol}")

    best: Optional[KMeansResult] = None
    init0 = 0
    it_total = 0        # iterations yielded across all restarts
    resume: Optional[dict] = None
    if state is not None:
        arrays, meta = state["arrays"], state["meta"]
        init0 = int(meta["init"])
        it_total = int(meta["iters"])
        resume = {"C": np.asarray(arrays["C"], np.float32),
                  "done": bool(meta["done"]),
                  "n_it": int(meta["n_it"]),
                  "it_sched": int(meta.get("it_sched", meta["n_it"]))}
        if meta.get("has_best"):
            best = KMeansResult(
                centroids=np.asarray(arrays["best_centroids"], np.float32),
                inertia=float(meta["best_inertia"]),
                n_iters=int(meta["best_n_iters"]),
                labels=(np.asarray(arrays["best_labels"])
                        if "best_labels" in arrays else None))
        rng = unpack_rng(arrays, meta) or rng

    init = init0
    C = None
    done = False
    n_it = 0
    it_sched = 0        # chunk-scheduled iterations (the fused resume key)

    def snapshot_at(C_v, done_v, n_it_v, it_total_v, it_sched_v, ra, rm):
        """A snapshot bound to one boundary's state.  ``best`` and
        ``init`` stay live: they change only between restarts, and every
        boundary of a restart drains (or is discarded) before it ends."""
        def _snap():
            arrays = {"C": np.asarray(C_v, np.float32)}
            meta = {"iters": int(it_total_v), "init": int(init),
                    "done": bool(done_v), "n_it": int(n_it_v),
                    "it_sched": int(it_sched_v),
                    "has_best": best is not None}
            if best is not None:
                arrays["best_centroids"] = np.asarray(best.centroids,
                                                      np.float32)
                meta["best_inertia"] = float(best.inertia)
                meta["best_n_iters"] = int(best.n_iters)
                if best.labels is not None:
                    arrays["best_labels"] = np.asarray(best.labels)
            arrays.update(ra)
            meta.update(rm)
            return {"arrays": arrays, "meta": meta}
        return _snap

    def _snapshot():
        return snapshot_at(C, done, n_it, it_total, n_it,
                           *pack_rng(rng))()

    try:
        for init in range(init0, cfg.n_init):
            if resume is not None:
                # re-enter the preempted restart: no new init draw — the rng
                # stream was saved post-draw
                C, done, n_it = resume["C"], resume["done"], resume["n_it"]
                it_sched = resume["it_sched"]
                resume = None
            else:
                # host picks random points as initial centroids (paper:
                # random init)
                idx = rng.choice(n, size=cfg.k, replace=False)
                C = Xq_np[idx].astype(np.float32)           # quantized units
                done = False
                n_it = 0
                it_sched = 0
            if program is not None:
                # boundary N's done flag is read while chunk N+1 runs; the
                # latch makes an overshot chunk a frozen no-op, discarded
                # unread; the counters advance at drain time from the tags
                dev = system.device
                dcarry = (torch.from_numpy(np.array(C, np.float32)).to(dev),
                          torch.tensor(bool(done), device=dev),
                          torch.tensor(n_it, dtype=torch.int32, device=dev))
                pipe = ChunkPipeline(program, max(1, int(cfg.pipeline_depth)))
                disp_sched, disp_total = it_sched, it_total

                def boundaries():
                    nonlocal dcarry, disp_sched, disp_total
                    for k in chunk_schedule(cfg.max_iters, cfg.fuse_steps, 0,
                                            start=it_sched):
                        disp_sched += k
                        disp_total += k
                        dcarry, drained = pipe.dispatch(
                            dcarry, (Xs, valid), k,
                            tag=(disp_sched, disp_total, *pack_rng(rng)))
                        yield from drained
                    yield from pipe.flush()

                if not done:        # resumed after convergence: nothing to do
                    for bnd in boundaries():
                        it_sched, it_total, ra, rm = bnd.tag
                        (C_t, done_t, n_it_t), _ = bnd.host()
                        C = C_t.numpy()
                        done, n_it = bool(done_t), int(n_it_t)
                        yield ChunkTick(bnd.k, snapshot_at(
                            C, done, n_it, it_total, it_sched, ra, rm))
                        if done:
                            break
            else:
                while not done and n_it < cfg.max_iters:
                    Cq = system.broadcast((_cast_centroids(C),))[0]
                    part = system.map_reduce(assign_k, (Xs, valid), (Cq,))
                    sums = np.asarray(host_array(part["sums"]), np.float64)
                    counts = np.asarray(host_array(part["counts"]), np.float64)
                    newC = np.where(counts[:, None] > 0,
                                    sums / np.maximum(counts[:, None], 1), C)
                    shift = frobenius_shift(C, newC)
                    C = newC.astype(np.float32)
                    n_it += 1
                    done = shift < cfg.tol
                    it_total += 1
                    yield ChunkTick(1, _snapshot)
            part = system.map_reduce(inertia_k, (Xs, valid),
                                     (_cast_centroids(C),))
            # inertia needs + ||x||^2 which the kernel includes; convert units
            inertia = float(host_array(part["inertia"])) * float(scale) ** 2
            if best is None or inertia < best.inertia:
                best = KMeansResult(centroids=C * scale, inertia=inertia,
                                    n_iters=n_it)
                if return_labels:
                    lbl = system.map_elementwise(labels_k, (Xs, valid),
                                                 (_cast_centroids(C),))
                    best.labels = host_array(
                        system.gather_cores(lbl)).reshape(-1)[:n]
    finally:
        if program is not None:
            # the chunk graphs die with the fit that captured them
            program.release()
    return best


def fit(dataset, cfg: Optional[KMeansConfig] = None,
        return_labels: bool = True) -> KMeansResult:
    """Lloyd's over a resident PimDataset.  The quantized view is
    materialized once; all ``n_init`` restarts — and any later refit
    with different (k, seed, tol) — reuse the resident shards."""
    return run_steps(fit_steps(dataset, cfg, return_labels))
