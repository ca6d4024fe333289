"""Op ``kmeans_assign``: the assign-and-accumulate step of KME int16.

``dispatch.launch("kmeans_assign", x_q, c_q)``: int16 points
``[C, n_pc, F]`` (the cores' resident shards) and int16 centroids
``[K, F]`` -> per core, in one launch for all cores,

  labels  int32 ``[C, n_pc]``    first ``argmin_k(||c_k||^2 - 2 x.c_k)``
  sums    int32 ``[C, K, F]``    per-cluster coordinate sums
  counts  int32 ``[C, K]``       per-cluster point counts

The distance arithmetic is int32 and wraps as JAX's does, so full-range
int16 inputs give the reference's labels.  Every row counts, pad rows
included: the trainer's pad correction is the only one.

  :func:`kmeans_assign_cuda`   the hand-written kernel
                               (``csrc/kmeans_assign.cu``, port of
                               ``repro/kernels/kmeans_assign/kernel.py``
                               ``kmeans_assign``)
  :func:`kmeans_assign_plain`  the plain PyTorch version (follows
                               ``repro/kernels/kmeans_assign/ref.py``)
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import build, dispatch
from .quant_matmul import H100_SMS

#: one launch covers every core on the grid's y axis
MAX_CORES = 65535
#: the dynamic shared memory one block may opt in to on the H100
MAX_SHARED_BYTES = 232_448
#: warps of a block, rows a warp takes at a time, ring stages (K and F up
#: to 16: registers hold the sums, a ring row is 32 bytes; wider: shared
#: memory holds them, a row is F + 8 int16 padded to 16)
WARPS, CHUNK = 8, 32
FIXED_STAGES, WIDE_STAGES = 8, 2
#: the byte-split products add at most 65,280 a feature into one
#: accumulator (xh.cl + xl.ch: 128 * 255 twice): exact in int32 over this
#: many features
MAX_EXACT_DEPTH = (2 ** 31 - 1) // (2 * 128 * 255)


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


def split_cross(x16: torch.Tensor, c16: torch.Tensor) -> torch.Tensor:
    """``wrapped_cross`` as the kernel forms it on the tensor cores: int16
    ``x = 256 xh + xl`` with ``xh = x >> 8`` (s8) and ``xl = x & 0xff``
    (u8), the centroids likewise, three int32 accumulators (``xh.ch``,
    ``xh.cl + xl.ch``, ``xl.cl``), each exact, composed modulo 2**32:
    ``[..., N, F]``, ``[K, F]`` -> int32 ``[..., N, K]``."""
    if c16.shape[-1] > MAX_EXACT_DEPTH:
        raise ValueError(f"split_cross: F={c16.shape[-1]} exceeds "
                         f"{MAX_EXACT_DEPTH}, past which an accumulator "
                         f"wraps")
    x, c = x16.to(torch.int32), c16.to(torch.int32)
    xh, xl, ch, cl = x >> 8, x & 0xff, c >> 8, c & 0xff

    def acc(*pairs):                     # exact: |sum| < 2**31
        return sum(wrapped_cross(a, b) for a, b in pairs).to(torch.int64)
    total = ((acc((xh, ch)) << 16) + (acc((xh, cl), (xl, ch)) << 8)
             + acc((xl, cl))) & 0xFFFFFFFF
    return torch.where(total >= 2 ** 31, total - 2 ** 32,
                       total).to(torch.int32)


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
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class KmeansPlan:
    """How ``csrc/kmeans_assign.cu`` lays out one launch."""

    k_pad: int            # K up to a multiple of 16
    f_pad: int            # F up to a multiple of 16
    fixed: bool           # K, F <= 16: the sums stay in registers
    ctas_per_core: int
    rows_per_cta: int     # a multiple of CHUNK
    smem_bytes: int

    @property
    def atomic_out(self) -> bool:
        """Several blocks add into a core's partial (zeroed first); one
        block stores it (allocated empty)."""
        return self.ctas_per_core > 1

    def row_ranges(self, n_pc: int) -> list[tuple[int, int]]:
        """The rows ``[r0, r1)`` each block of a core counts."""
        return [(i * self.rows_per_cta,
                 min(n_pc, (i + 1) * self.rows_per_cta))
                for i in range(self.ctas_per_core)]


def kmeans_assign_plan(n_cores: int, n_pc: int, k: int, f: int,
                       sms: int = H100_SMS) -> KmeansPlan:
    """One block per core unless the cores are too few to fill ``sms``
    four times over; then a core's rows split over blocks of at least
    four chunks a warp."""
    k_pad, f_pad = 16 * _ceil(k, 16), 16 * _ceil(f, 16)
    fixed = k_pad == f_pad == 16
    stages = FIXED_STAGES if fixed else WIDE_STAGES
    smem = 4 * ((k_pad // 8) * (f_pad // 16) * 64      # centroid fragments
                + k_pad                                # norms
                + k_pad * f_pad + k_pad)               # the block's sums
    row_bytes = 32 if fixed else (f_pad + 8) * 2
    smem += WARPS * stages * CHUNK * row_bytes         # the x rings
    want = _ceil(4 * sms, max(n_cores, 1))
    ctas = max(1, min(want, _ceil(n_pc, 4 * WARPS * CHUNK)))
    rows = CHUNK * _ceil(_ceil(n_pc, ctas), CHUNK) if n_pc else CHUNK
    return KmeansPlan(k_pad=k_pad, f_pad=f_pad, fixed=fixed,
                      ctas_per_core=max(1, _ceil(n_pc, rows)),
                      rows_per_cta=rows, smem_bytes=smem)


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
    plan = kmeans_assign_plan(n_cores, n_pc, k, f_dim)
    if not (0 < k and 0 < f_dim and plan.smem_bytes <= MAX_SHARED_BYTES
            and n_cores <= MAX_CORES):
        raise ValueError(f"kmeans_assign_cuda: K={k}, F={f_dim} or "
                         f"C={n_cores} out of range (the kernel's centroids, "
                         f"sums and row rings take {plan.smem_bytes} B of "
                         f"the {MAX_SHARED_BYTES} B of shared memory a "
                         f"block may have)")
    dev = x_q.device
    labels = torch.empty((n_cores, n_pc), dtype=torch.int32, device=dev)
    if n_cores == 0 or n_pc == 0:
        return (labels,
                torch.zeros((n_cores, k, f_dim), dtype=torch.int32,
                            device=dev),
                torch.zeros((n_cores, k), dtype=torch.int32, device=dev))
    # one block per core stores every entry; several add into zeros
    alloc = torch.zeros if plan.atomic_out else torch.empty
    sums = alloc((n_cores, k, f_dim), dtype=torch.int32, device=dev)
    counts = alloc((n_cores, k), dtype=torch.int32, device=dev)
    lib = _bind()
    vec = int(f_dim % 8 == 0 and x_q.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.kmeans_assign_launch(
            x_q.data_ptr(), c_q.data_ptr(), labels.data_ptr(),
            sums.data_ptr(), counts.data_ptr(), n_cores, plan.ctas_per_core,
            n_pc, f_dim, k, plan.k_pad, plan.f_pad, int(plan.fixed),
            plan.rows_per_cta, plan.smem_bytes, vec, stream)
    if err:
        raise RuntimeError(f"kmeans_assign kernel launch failed: CUDA error "
                           f"{err}")
    dispatch.count_launch("kmeans_assign")
    return labels, sums, counts


def kmeans_assign_cost(x_q: torch.Tensor,
                       c_q: torch.Tensor) -> dispatch.KernelCost:
    """x and the centroids read; the int32 labels and each core's int32
    sums and counts written.  The products run on the tensor cores as
    four int8 products of the int16 operands' bytes: 8 n K F int8
    operations for the distances' 2 n K F."""
    n_cores, n_pc, f_dim = x_q.shape
    n, k = n_cores * n_pc, c_q.shape[0]
    return dispatch.KernelCost(
        ops=4 * 2 * n * k * f_dim,
        bytes=x_q.numel() * x_q.element_size()
        + c_q.numel() * c_q.element_size() + n * 4
        + n_cores * k * (f_dim + 1) * 4,
        rate="int8")


dispatch.register_op("kmeans_assign", cuda=kmeans_assign_cuda,
                     plain=kmeans_assign_plain, cost=kmeans_assign_cost)
