"""Op ``fx_matvec``: the Q-format matvec of the LIN/LOG INT32 versions.

``dispatch.launch("fx_matvec", x_q, w_q, frac_bits)``: int32 Q(f)
``[..., F]`` · int32 ``[F]`` -> int32 ``[...]``, each product rounded
back to Q(f) by ``(p + 2^(f-1)) >> f`` before the int32 sum.  The
trainers pass the cores' shards ``[C, n_pc, F]`` whole, so one launch
covers every core.

  :func:`fx_matvec_cuda`   the hand-written kernel (``csrc/fx_matvec.cu``,
                           port of ``repro/kernels/quant_matmul/kernel.py``
                           ``fx_matvec``)
  :func:`fx_matvec_plain`  the plain PyTorch version (``fixed_point.fx_dot``)
"""
from __future__ import annotations

import ctypes

import torch

from ..core.fixed_point import fx_dot
from . import build, dispatch

#: w is staged in the kernel's (static-limit) shared memory
MAX_FEATURES = 48 * 1024 // 4


def fx_matvec_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                    frac_bits: int) -> torch.Tensor:
    return fx_dot(x_q, w_q, frac_bits)


def _bind() -> ctypes.CDLL:
    lib = build.load("fx_matvec")
    fn = lib.fx_matvec_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def fx_matvec_cuda(x_q: torch.Tensor, w_q: torch.Tensor,
                   frac_bits: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; raises on anything
    it does not take and on a launch error."""
    if not (x_q.is_cuda and w_q.device == x_q.device):
        raise ValueError(f"fx_matvec_cuda: x and w must be on one CUDA "
                         f"device, got {x_q.device} and {w_q.device}")
    if x_q.dtype != torch.int32 or w_q.dtype != torch.int32:
        raise TypeError(f"fx_matvec_cuda: int32 operands required, got "
                        f"{x_q.dtype} and {w_q.dtype}")
    if x_q.dim() < 1 or w_q.shape != (x_q.shape[-1],):
        raise ValueError(f"fx_matvec_cuda: shapes {tuple(x_q.shape)} and "
                         f"{tuple(w_q.shape)} do not form [..., F] . [F]")
    if not (x_q.is_contiguous() and w_q.is_contiguous()):
        raise ValueError("fx_matvec_cuda: operands must be contiguous")
    f_dim = x_q.shape[-1]
    if not (0 <= frac_bits < 32 and f_dim <= MAX_FEATURES):
        raise ValueError(f"fx_matvec_cuda: frac_bits={frac_bits} or "
                         f"F={f_dim} out of range")
    out = torch.empty(x_q.shape[:-1], dtype=torch.int32, device=x_q.device)
    n = out.numel()
    if n == 0:
        return out
    lib = _bind()
    vec = int(f_dim % 4 == 0 and x_q.data_ptr() % 16 == 0)
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fx_matvec_launch(x_q.data_ptr(), w_q.data_ptr(),
                                   out.data_ptr(), n, f_dim, frac_bits, vec,
                                   stream)
    if err:
        raise RuntimeError(f"fx_matvec kernel launch failed: CUDA error "
                           f"{err}")
    dispatch.count_launch("fx_matvec")
    return out


dispatch.register_op("fx_matvec", cuda=fx_matvec_cuda, plain=fx_matvec_plain)
