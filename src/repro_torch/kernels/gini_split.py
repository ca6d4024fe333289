"""Op ``gini_split``: the split-evaluate counts of DTR.

``dispatch.launch("gini_split", x, y, leaf, thresholds, n_classes)``:
f32 points ``[C, n_pc, F]`` with int32 classes and leaf ids ``[C, n_pc]``
(the cores' resident shards) and f32 candidate thresholds ``[L, F]`` ->
per core, in one launch for all cores,

  below  int32 ``[C, L, n_classes, F]``  rows with ``x <= th[leaf, f]``
  total  int32 ``[C, L, n_classes]``     rows per (leaf, class)

Rows whose leaf is outside ``[0, L)`` or class outside
``[0, n_classes)`` count nowhere.  There is no pad handling here: the
trainer sends its invalid rows to leaf -1.

  :func:`gini_split_cuda`   the hand-written kernel
                            (``csrc/gini_counts.cu``, port of
                            ``repro/kernels/gini_split/kernel.py``
                            ``gini_counts``)
  :func:`gini_split_plain`  the plain PyTorch version (follows
                            ``repro/kernels/gini_split/ref.py``)
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import build, dispatch
from .quant_matmul import H100_SMS

#: the kernel's leaf window, in opt-in dynamic shared memory: 2,048
#: leaves at two classes and 16 features, since a depth-10 tree numbers
#: 2,047 nodes.  Shared memory and L1 split one 256 KB array per SM, and
#: the rows and the threshold gathers stream through L1: in trials on an
#: H100 a window of all the 227 KB a block may have left L1 too small and
#: was much slower where the leaves spread wide
WINDOW_BYTES = 2048 * 2 * 9 * 4
#: rows of one pass: no 16-bit counter of the window may carry
ROWS_PER_PASS = 65_535
#: one launch covers every core on the grid's y axis
MAX_CORES = 65535


@dataclasses.dataclass(frozen=True)
class GiniPlan:
    """How ``csrc/gini_counts.cu`` lays out one launch: ``ctas_per_core``
    blocks of ``rows_per_cta`` rows a core; each block's window keeps
    16-bit counters, two to a 32-bit word, for ``F`` features and the
    total of each (leaf, class) slot."""

    slot_words: int       # words of a (leaf, class) slot, times n_classes
    window_words: int     # dynamic shared memory / 4
    rows_per_pass: int
    ctas_per_core: int
    rows_per_cta: int

    @property
    def window_leaves(self) -> int:
        return self.window_words // self.slot_words

    @property
    def atomic_out(self) -> bool:
        """Several blocks add into a core's partial (zeroed first); one
        block stores every entry of it (allocated empty)."""
        return self.ctas_per_core > 1

    def row_ranges(self, n_pc: int) -> list[tuple[int, int]]:
        """The rows ``[r0, r1)`` each block of a core counts."""
        return [(i * self.rows_per_cta,
                 min(n_pc, (i + 1) * self.rows_per_cta))
                for i in range(self.ctas_per_core)]

    def passes(self, r0: int, r1: int) -> list[tuple[int, int]]:
        """The row ranges ``[p0, p1)`` a block counts between flushes."""
        return [(p0, min(r1, p0 + self.rows_per_pass))
                for p0 in range(r0, r1, self.rows_per_pass)]


def gini_plan(n_cores: int, n_pc: int, n_leaves: int, n_classes: int,
              f_dim: int, sms: int = H100_SMS) -> GiniPlan:
    """One block per core (an SM each: the window takes most of its
    shared memory) unless the cores are fewer than ``sms``; then a core's
    rows split over as many blocks as keep the SMs busy in one wave, and
    no more than the core has passes of rows."""
    slot_words = n_classes * ((f_dim + 2) // 2)
    leaves = min(n_leaves, WINDOW_BYTES // (4 * slot_words))
    want = max(1, sms // max(n_cores, 1))
    ctas = max(1, min(want, -(-n_pc // ROWS_PER_PASS)))
    rows = max(1, -(-n_pc // ctas))
    return GiniPlan(slot_words=slot_words, window_words=leaves * slot_words,
                    rows_per_pass=ROWS_PER_PASS,
                    ctas_per_core=max(1, -(-n_pc // rows)),
                    rows_per_cta=rows)


def gini_split_plain(x: torch.Tensor, y: torch.Tensor, leaf: torch.Tensor,
                     thresholds: torch.Tensor, n_classes: int):
    n_cores, n_pc, f_dim = x.shape
    n_leaves = thresholds.shape[0]
    ok = (leaf >= 0) & (leaf < n_leaves) & (y >= 0) & (y < n_classes)
    lid = torch.where(ok, leaf, 0).long()
    below = (x <= thresholds[lid]) & ok.unsqueeze(-1)
    # one flat segment per (core, leaf, class); rows that count nowhere
    # go to a spill segment past the end, dropped below
    n_seg = n_leaves * n_classes
    core = torch.arange(n_cores, device=x.device).unsqueeze(-1)
    seg = torch.where(ok, core * n_seg + lid * n_classes + y.long(),
                      n_cores * n_seg).reshape(-1)
    counts = torch.zeros((n_cores * n_seg + 1, f_dim), dtype=torch.int32,
                         device=x.device)
    counts.index_add_(0, seg, below.reshape(-1, f_dim).to(torch.int32))
    totals = torch.zeros(n_cores * n_seg + 1, dtype=torch.int32,
                         device=x.device)
    totals.index_add_(0, seg, torch.ones_like(seg, dtype=torch.int32))
    return (counts[:-1].reshape(n_cores, n_leaves, n_classes, f_dim),
            totals[:-1].reshape(n_cores, n_leaves, n_classes))


def _bind() -> ctypes.CDLL:
    lib = build.load("gini_counts")
    fn = lib.gini_counts_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def gini_split_cuda(x: torch.Tensor, y: torch.Tensor, leaf: torch.Tensor,
                    thresholds: torch.Tensor, n_classes: int):
    """Launch the CUDA kernel on the current stream; raises on anything
    it does not take and on a launch error."""
    dev = x.device
    if not (x.is_cuda and all(t.device == dev for t in (y, leaf,
                                                         thresholds))):
        raise ValueError("gini_split_cuda: every operand must be on one "
                         "CUDA device")
    if (x.dtype != torch.float32 or thresholds.dtype != torch.float32
            or y.dtype != torch.int32 or leaf.dtype != torch.int32):
        raise TypeError(f"gini_split_cuda: f32 x and thresholds, int32 y "
                        f"and leaf required, got {x.dtype}, "
                        f"{thresholds.dtype}, {y.dtype}, {leaf.dtype}")
    if not (x.dim() == 3 and y.shape == x.shape[:2]
            and leaf.shape == x.shape[:2] and thresholds.dim() == 2
            and thresholds.shape[1] == x.shape[2]):
        raise ValueError(f"gini_split_cuda: shapes x {tuple(x.shape)}, y "
                         f"{tuple(y.shape)}, leaf {tuple(leaf.shape)}, "
                         f"thresholds {tuple(thresholds.shape)} do not form "
                         f"[C, n, F], [C, n], [C, n], [L, F]")
    if not all(t.is_contiguous() for t in (x, y, leaf, thresholds)):
        raise ValueError("gini_split_cuda: operands must be contiguous")
    n_cores, n_pc, f_dim = x.shape
    n_leaves = thresholds.shape[0]
    if not (0 < n_classes and 0 < f_dim and n_cores <= MAX_CORES
            and n_leaves * n_classes * (f_dim + 1) < 2 ** 31):
        raise ValueError(f"gini_split_cuda: C={n_cores}, L={n_leaves}, "
                         f"n_classes={n_classes} or F={f_dim} out of range")
    plan = gini_plan(n_cores, n_pc, n_leaves, n_classes, f_dim)
    # one block a core stores every entry, zeros included; several add
    alloc = torch.zeros if plan.atomic_out else torch.empty
    below = alloc((n_cores, n_leaves, n_classes, f_dim), dtype=torch.int32,
                  device=dev)
    total = alloc((n_cores, n_leaves, n_classes), dtype=torch.int32,
                  device=dev)
    if n_cores == 0 or n_leaves == 0:
        return below, total
    lib = _bind()
    vec = int(f_dim % 4 == 0 and x.data_ptr() % 16 == 0
              and thresholds.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gini_counts_launch(
            x.data_ptr(), y.data_ptr(), leaf.data_ptr(),
            thresholds.data_ptr(), below.data_ptr(), total.data_ptr(),
            n_cores, n_pc, plan.ctas_per_core, plan.rows_per_cta, f_dim,
            n_leaves, n_classes, plan.window_words, plan.rows_per_pass, vec,
            stream)
    if err:
        raise RuntimeError(f"gini_counts kernel launch failed: CUDA error "
                           f"{err}")
    dispatch.count_launch("gini_split")
    return below, total


def gini_split_cost(x: torch.Tensor, y: torch.Tensor, leaf: torch.Tensor,
                    thresholds: torch.Tensor,
                    n_classes: int) -> dispatch.KernelCost:
    """x, the labels, the leaf ids and the thresholds read; each core's
    int32 counts and totals written; one float32 compare a feature a
    row."""
    n_cores, n_pc, f_dim = x.shape
    n, n_leaves = n_cores * n_pc, thresholds.shape[0]
    return dispatch.KernelCost(
        ops=n * f_dim,
        bytes=n * (f_dim + 2) * 4 + n_leaves * f_dim * 4
        + n_cores * n_leaves * n_classes * (f_dim + 1) * 4,
        rate="fp32")


dispatch.register_op("gini_split", cuda=gini_split_cuda,
                     plain=gini_split_plain, cost=gini_split_cost)
