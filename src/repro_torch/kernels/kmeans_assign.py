"""Op ``kmeans_assign``: the assign-and-accumulate step of KME int16.

``dispatch.launch("kmeans_assign", x_q, c_q)``: int16 points
``[C, n_pc, F]`` (the cores' resident shards) and int16 centroids
``[K, F]`` -> per core, in one launch for all cores,

  labels  int32 ``[C, n_pc]``    first ``argmin_k(||c_k||^2 - 2 x.c_k)``
  sums    int32 ``[C, K, F]``    per-cluster coordinate sums
  counts  int32 ``[C, K]``       per-cluster point counts

The distance arithmetic is int32 and wraps as JAX's does, so full-range
int16 inputs give the reference's labels.  Every row counts, pad rows
included: the trainer's valid-mask correction is the only one.

  :func:`kmeans_assign_cuda`   the hand-written kernel
                               (``csrc/kmeans_assign.cu``, port of
                               ``repro/kernels/kmeans_assign/kernel.py``
                               ``kmeans_assign``)
  :func:`kmeans_assign_plain`  the plain PyTorch version (follows
                               ``repro/kernels/kmeans_assign/ref.py``)
"""
from __future__ import annotations

import ctypes

import torch

from . import build, dispatch

#: the kernel stages the centroids and per-block sums in (static-limit)
#: shared memory: K*F int32 twice, plus K norms and K counts
MAX_SHARED_BYTES = 48 * 1024
#: one launch covers every core on the grid's y axis
MAX_CORES = 65535


def wrapped_cross(x32: torch.Tensor, c32: torch.Tensor) -> torch.Tensor:
    """int32 ``x @ c.T`` that wraps like JAX's int32 dot: ``[..., N, F]``,
    ``[K, F]`` -> ``[..., N, K]``.  torch has no int32 matmul on CUDA, so
    each centroid's products are summed in int32 (a modular sum, exact
    whatever the order)."""
    return torch.stack([torch.sum(x32 * c32[k], dim=-1, dtype=torch.int32)
                        for k in range(c32.shape[0])], dim=-1)


def sq_norms(c32: torch.Tensor) -> torch.Tensor:
    """Per-row int32 ``sum(c * c)``, wrapping like ``jnp.sum``."""
    return torch.sum(c32 * c32, dim=-1, dtype=torch.int32)


def cluster_totals(labels: torch.Tensor, values: torch.Tensor,
                   k: int) -> torch.Tensor:
    """Per-core sums of ``values`` ``[C, n, ...]`` by ``labels``
    ``[C, n]`` -> ``[C, k, ...]`` (integer adds: exact in any order)."""
    out = torch.zeros((labels.shape[0], k, *values.shape[2:]),
                      dtype=values.dtype, device=values.device)
    idx = labels.long().reshape(*labels.shape, *([1] * (values.dim() - 2)))
    return out.scatter_add_(1, idx.expand_as(values), values)


def kmeans_assign_plain(x_q: torch.Tensor, c_q: torch.Tensor):
    x, c = x_q.to(torch.int32), c_q.to(torch.int32)
    dist = sq_norms(c) - 2 * wrapped_cross(x, c)   # ||x||^2 omitted
    labels = torch.argmin(dist, dim=-1).to(torch.int32)   # first minimum
    k = c.shape[0]
    return (labels, cluster_totals(labels, x, k),
            cluster_totals(labels, torch.ones_like(labels), k))


def _bind() -> ctypes.CDLL:
    lib = build.load("kmeans_assign")
    fn = lib.kmeans_assign_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def shared_bytes(k: int, f: int) -> int:
    """Shared memory one block of the kernel needs."""
    return 4 * (2 * k * f + 2 * k)


def kmeans_assign_cuda(x_q: torch.Tensor, c_q: torch.Tensor):
    """Launch the CUDA kernel on the current stream; raises on anything
    it does not take and on a launch error."""
    if not (x_q.is_cuda and c_q.device == x_q.device):
        raise ValueError(f"kmeans_assign_cuda: x and c must be on one CUDA "
                         f"device, got {x_q.device} and {c_q.device}")
    if x_q.dtype != torch.int16 or c_q.dtype != torch.int16:
        raise TypeError(f"kmeans_assign_cuda: int16 operands required, got "
                        f"{x_q.dtype} and {c_q.dtype}")
    if x_q.dim() != 3 or c_q.dim() != 2 or c_q.shape[1] != x_q.shape[2]:
        raise ValueError(f"kmeans_assign_cuda: shapes {tuple(x_q.shape)} "
                         f"and {tuple(c_q.shape)} do not form [C, n, F] "
                         f"and [K, F]")
    if not (x_q.is_contiguous() and c_q.is_contiguous()):
        raise ValueError("kmeans_assign_cuda: operands must be contiguous")
    n_cores, n_pc, f_dim = x_q.shape
    k = c_q.shape[0]
    if not (0 < k and 0 < f_dim and shared_bytes(k, f_dim) <= MAX_SHARED_BYTES
            and n_cores <= MAX_CORES):
        raise ValueError(f"kmeans_assign_cuda: K={k}, F={f_dim} or "
                         f"C={n_cores} out of range (K*F int32 centroids and "
                         f"sums must fit {MAX_SHARED_BYTES} B of shared "
                         f"memory)")
    dev = x_q.device
    labels = torch.empty((n_cores, n_pc), dtype=torch.int32, device=dev)
    sums = torch.zeros((n_cores, k, f_dim), dtype=torch.int32, device=dev)
    counts = torch.zeros((n_cores, k), dtype=torch.int32, device=dev)
    if n_cores == 0 or n_pc == 0:
        return labels, sums, counts
    lib = _bind()
    vec = int(f_dim % 8 == 0 and x_q.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.kmeans_assign_launch(
            x_q.data_ptr(), c_q.data_ptr(), labels.data_ptr(),
            sums.data_ptr(), counts.data_ptr(), n_cores, n_pc, f_dim, k,
            vec, stream)
    if err:
        raise RuntimeError(f"kmeans_assign kernel launch failed: CUDA error "
                           f"{err}")
    dispatch.count_launch("kmeans_assign")
    return labels, sums, counts


dispatch.register_op("kmeans_assign", cuda=kmeans_assign_cuda,
                     plain=kmeans_assign_plain)
