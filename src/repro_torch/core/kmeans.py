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
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..elastic.state import pack_rng, unpack_rng
from ..kernels import dispatch
from ..kernels.kmeans_assign import cluster_totals, sq_norms, wrapped_cross
from ..systems import ChunkTick, host_array, run_steps
from .linreg import check_unfused
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
    #: step fusion (k Lloyd's iterations per launch) is not ported yet;
    #: only the host-orchestrated per-step loop (1) runs
    fuse_steps: int = 1


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
    check_unfused(cfg)
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
                  "n_it": int(meta["n_it"])}
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

    def _snapshot():
        arrays = {"C": np.asarray(C, np.float32)}
        meta = {"iters": int(it_total), "init": int(init),
                "done": bool(done), "n_it": int(n_it),
                "it_sched": int(n_it), "has_best": best is not None}
        if best is not None:
            arrays["best_centroids"] = np.asarray(best.centroids, np.float32)
            meta["best_inertia"] = float(best.inertia)
            meta["best_n_iters"] = int(best.n_iters)
            if best.labels is not None:
                arrays["best_labels"] = np.asarray(best.labels)
        ra, rm = pack_rng(rng)
        arrays.update(ra)
        meta.update(rm)
        return {"arrays": arrays, "meta": meta}

    for init in range(init0, cfg.n_init):
        if resume is not None:
            # re-enter the preempted restart: no new init draw — the rng
            # stream was saved post-draw
            C, done, n_it = resume["C"], resume["done"], resume["n_it"]
            resume = None
        else:
            # host picks random points as initial centroids (paper:
            # random init)
            idx = rng.choice(n, size=cfg.k, replace=False)
            C = Xq_np[idx].astype(np.float32)           # quantized units
            done = False
            n_it = 0
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
                best.labels = host_array(lbl).reshape(-1)[:n]
    return best


def fit(dataset, cfg: Optional[KMeansConfig] = None,
        return_labels: bool = True) -> KMeansResult:
    """Lloyd's over a resident PimDataset.  The quantized view is
    materialized once; all ``n_init`` restarts — and any later refit
    with different (k, seed, tol) — reuse the resident shards."""
    return run_steps(fit_steps(dataset, cfg, return_labels))
