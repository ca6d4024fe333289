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
"""
from __future__ import annotations

import ctypes

import torch

from ..core.lut import SigmoidLut, lut_sigmoid_fixed
from . import build, dispatch

PLACEMENTS = ("wram", "mram")
#: the WRAM placement stages the whole table in (static-limit) shared memory
MAX_SHARED_TABLE = 48 * 1024 // 2


def _check_placement(placement: str) -> None:
    if placement not in PLACEMENTS:
        raise ValueError(f"unknown LUT placement {placement!r}; known: "
                         f"{PLACEMENTS}")


def lut_sigmoid_plain(x_q: torch.Tensor, lut: SigmoidLut,
                      placement: str = "wram") -> torch.Tensor:
    _check_placement(placement)  # both placements give the same values
    return lut_sigmoid_fixed(x_q, lut)


def _bind() -> ctypes.CDLL:
    lib = build.load("lut_sigmoid")
    fn = lib.lut_sigmoid_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def lut_sigmoid_cuda(x_q: torch.Tensor, lut: SigmoidLut,
                     placement: str = "wram") -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; raises on anything
    it does not take and on a launch error."""
    _check_placement(placement)
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
    n_table = table.numel()
    if not (0 < n_table and (placement == "mram"
                             or n_table <= MAX_SHARED_TABLE)
            and 0 <= lut.value_frac < 31):
        raise ValueError(f"lut_sigmoid_cuda: table of {n_table} entries or "
                         f"value_frac={lut.value_frac} out of range for "
                         f"placement {placement!r}")
    out = torch.empty_like(x_q)
    n = out.numel()
    if n == 0:
        return out
    lib = _bind()
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lut_sigmoid_launch(x_q.data_ptr(), table.data_ptr(),
                                     out.data_ptr(), n, n_table,
                                     lut.value_frac,
                                     int(placement == "wram"), stream)
    if err:
        raise RuntimeError(f"lut_sigmoid kernel launch failed: CUDA error "
                           f"{err}")
    dispatch.count_launch("lut_sigmoid")
    return out


dispatch.register_op("lut_sigmoid", cuda=lut_sigmoid_cuda,
                     plain=lut_sigmoid_plain)
