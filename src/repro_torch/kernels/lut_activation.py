"""Op ``lut_sigmoid``: the LUT sigmoid of LOG, in the paper's two placements.

``dispatch.launch("lut_sigmoid", x_q, lut, placement=...)``: int32 Q(f)
of any shape -> int32 Q(lut.value_frac) of the same shape (paper Fig. 4).

  placement="wram"  the kernel stages the table in shared memory — the
                    paper's WRAM scratchpad (LOG-INT32-LUT (WRAM), HYB/BUI)
  placement="mram"  the kernel reads the table from global memory — the
                    paper's MRAM bank (LOG-INT32-LUT (MRAM))

Both placements give identical values.

  :func:`lut_sigmoid_cuda`   the hand-written kernel
                             (``csrc/lut_sigmoid.cu``, port of
                             ``repro/kernels/lut_activation/kernel.py``
                             ``lut_sigmoid_vmem``)
  :func:`lut_sigmoid_plain`  the plain PyTorch version
                             (``lut.lut_sigmoid_fixed``)
  :func:`lut_sigmoid_plan`   the kernel's launch: its scalar head, 16-byte
                             vectors and scalar tail, and its grid
  :func:`aligned_like`       the output, as far past a 16-byte boundary
                             as the input
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..core.lut import SigmoidLut, lut_sigmoid_fixed
from . import build, dispatch
from .quant_matmul import H100_SMS, _sm_count

PLACEMENTS = ("wram", "mram")
#: the WRAM placement stages the whole table in (static-limit) shared memory
MAX_SHARED_TABLE = 48 * 1024 // 2
#: the kernel streams 16-byte vectors of VEC int32, UNROLL of them a thread
#: before its first lookup of a round (``csrc/lut_sigmoid.cu``'s kUnroll)
VEC, UNROLL = 4, 4
#: the persistent grid of both placements: threads per block, blocks per
#: SM.  WRAM stages the table once per block: 264 blocks read 10.8 MB from
#: L2 on an H100 (132 blocks of 1024 threads stage half that, and ran 4%
#: slower)
THREADS, BLOCKS_PER_SM = 512, 2


def _check_placement(placement: str) -> None:
    if placement not in PLACEMENTS:
        raise ValueError(f"unknown LUT placement {placement!r}; known: "
                         f"{PLACEMENTS}")


def lut_sigmoid_plain(x_q: torch.Tensor, lut: SigmoidLut,
                      placement: str = "wram") -> torch.Tensor:
    _check_placement(placement)  # both placements give the same values
    return lut_sigmoid_fixed(x_q, lut)


@dataclasses.dataclass(frozen=True)
class LutPlan:
    """How ``csrc/lut_sigmoid.cu`` lays out one launch over n elements:
    ``head`` elements one at a time, ``vectors`` 16-byte vectors from
    element ``head`` on, ``tail`` elements one at a time after them."""

    head: int
    vectors: int
    tail: int
    grid: int
    block: int
    smem_bytes: int     # the staged table (WRAM), 0 for MRAM


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def lut_sigmoid_plan(n: int, x_offset: int, out_offset: int, n_table: int,
                     placement: str, sms: int = H100_SMS) -> LutPlan:
    """The launch for n int32 elements of x at ``x_offset`` bytes past a
    16-byte boundary into out at ``out_offset``, which must be the same
    (:func:`aligned_like`): a head up to the first boundary, then whole
    vectors, then the rest.  A persistent grid of at most ``sms`` x
    BLOCKS_PER_SM blocks, no more than the elements fill."""
    _check_placement(placement)
    if not (0 < n_table and (placement == "mram"
                             or n_table <= MAX_SHARED_TABLE)):
        raise ValueError(f"lut_sigmoid_plan: a table of {n_table} entries "
                         f"does not fit placement {placement!r} (shared "
                         f"memory holds {MAX_SHARED_TABLE})")
    if x_offset % 4 or (x_offset - out_offset) % 16:
        raise ValueError(f"lut_sigmoid_plan: x and out at {x_offset} and "
                         f"{out_offset} B past a 16-byte boundary cannot "
                         f"stream as vectors together")
    head = min(n, (16 - x_offset % 16) % 16 // 4)
    vectors = (n - head) // VEC
    grid = max(1, min(sms * BLOCKS_PER_SM,
                      _ceil(n, VEC * UNROLL * THREADS)))
    return LutPlan(head=head, vectors=vectors,
                   tail=n - head - VEC * vectors, grid=grid, block=THREADS,
                   smem_bytes=(16 * _ceil(2 * n_table, 16)
                               if placement == "wram" else 0))


@functools.cache
def _launch_fn():
    """The C entry point, bound once (``argtypes`` set once)."""
    fn = build.load("lut_sigmoid").lut_sigmoid_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def aligned_like(x_q: torch.Tensor) -> torch.Tensor:
    """An empty int32 tensor of int32 x's shape that starts as far past a
    16-byte boundary as x does, so that the two stream as vectors
    together."""
    lead = x_q.data_ptr() % 16 // 4
    return torch.empty(x_q.numel() + lead, dtype=torch.int32,
                       device=x_q.device)[lead:].view(x_q.shape)


def lut_sigmoid_cuda(x_q: torch.Tensor, lut: SigmoidLut,
                     placement: str = "wram") -> torch.Tensor:
    """Launch the CUDA kernel on the current stream into an
    :func:`aligned_like` output; raises on anything it does not take and
    on a launch error."""
    table = lut.table
    if not (x_q.is_cuda and table.device == x_q.device):
        raise ValueError(f"lut_sigmoid_cuda: x and the table must be on one "
                         f"CUDA device, got {x_q.device} and {table.device}")
    if x_q.dtype != torch.int32 or table.dtype != torch.int16:
        raise TypeError(f"lut_sigmoid_cuda: int32 input and int16 table "
                        f"required, got {x_q.dtype} and {table.dtype}")
    if not (x_q.is_contiguous() and table.is_contiguous()
            and table.dim() == 1):
        raise ValueError("lut_sigmoid_cuda: contiguous input and 1-D table "
                         "required")
    if not 0 <= lut.value_frac < 31:
        raise ValueError(f"lut_sigmoid_cuda: value_frac={lut.value_frac} "
                         f"out of range")
    out = aligned_like(x_q)
    n = out.numel()
    plan = lut_sigmoid_plan(n, x_q.data_ptr() % 16, out.data_ptr() % 16,
                            table.numel(), placement,
                            _sm_count(x_q.device.index))
    if n == 0:
        return out
    if placement == "wram" and table.data_ptr() % 16:
        table = table.clone()       # 16-byte cp.async reads an aligned copy
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launch_fn()(x_q.data_ptr(), table.data_ptr(), out.data_ptr(),
                           plan.head, plan.vectors, plan.tail, table.numel(),
                           lut.value_frac, int(placement == "wram"),
                           plan.grid, plan.block, plan.smem_bytes, stream)
    if err:
        raise RuntimeError(f"lut_sigmoid kernel launch failed: CUDA error "
                           f"{err}")
    dispatch.count_launch("lut_sigmoid")
    return out


def lut_sigmoid_cost(x_q: torch.Tensor, lut: SigmoidLut,
                     placement: str = "wram") -> dispatch.KernelCost:
    """z read and the int32 result written, the table read once; five
    int32 operations an element, as ``PERF.md`` section 6 counts the
    bound."""
    return dispatch.KernelCost(
        ops=5 * x_q.numel(),
        bytes=x_q.numel() * 8 + lut.table.numel() * lut.table.element_size(),
        rate="int32")


dispatch.register_op("lut_sigmoid", cuda=lut_sigmoid_cuda,
                     plain=lut_sigmoid_plain, cost=lut_sigmoid_cost)
