"""The quantized matmul family: ``fx_matvec``, ``int_matmul``, ``quant_matmul``.

``dispatch.launch("fx_matvec", x_q, w_q, frac_bits)``: int32 Q(f)
``[..., F]`` · int32 ``[F]`` -> int32 ``[...]``, each product rounded
back to Q(f) by ``(p + 2^(f-1)) >> f`` before the int32 sum.  The
trainers pass the cores' shards ``[C, n_pc, F]`` whole, so one launch
covers every core.  With lanes, ``w_q`` int32 ``[K, F]`` (K models over
the same rows: the fused learning-rate sweep, ``sched/gang.py``) gives
int32 ``[..., K]``, each lane the same sum; one launch reads x once for
all K lanes, where the reference vmaps its Pallas kernel over the lanes.

``dispatch.launch("int_matmul", a_q, b_q)``: int8 ``[M, K]`` @ int8
``[K, N]`` -> int32 ``[M, N]``, exact (``|sum| <= K * 128**2 < 2**31`` for
``K <= MAX_K``).  ``quant_matmul`` adds the dequant of
``repro/kernels/quant_matmul/ops.py::_quant_matmul_pallas``, and
:func:`quant_dense` is the float-in, float-out int8 linear of the LM
stack's ``quantize_dense`` path: the activations quantized per tensor on
the fly against int8 weights with per-column scales.

  :func:`fx_matvec_cuda`   the hand-written kernel (``csrc/fx_matvec.cu``,
                           port of ``repro/kernels/quant_matmul/kernel.py``
                           ``fx_matvec``)
  :func:`fx_matvec_plain`  the plain PyTorch version (``fixed_point.fx_dot``)
  :func:`int_matmul_cuda`  the hand-written kernels (``csrc/int_matmul.cu``,
                           port of ``kernel.py`` ``int_matmul``): int8
                           tensor cores for M > 16, a stream over b for
                           M <= 16, as :func:`int_matmul_plan` decides
  :func:`int_matmul_plain`, :func:`quant_matmul_plain`
                           the plain PyTorch versions (``ref.py``)
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from ..core.fixed_point import fx_dot
from ..core.quantization import symmetric_quantize
from . import build, dispatch

#: w (all K lanes of it) is staged in the kernel's (static-limit) shared
#: memory: K * F <= MAX_FEATURES
MAX_FEATURES = 48 * 1024 // 4


def fx_matvec_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                    frac_bits: int) -> torch.Tensor:
    if w_q.dim() == 2:         # lanes: [..., 1, F] against [K, F]
        return fx_dot(x_q.unsqueeze(-2), w_q, frac_bits)
    return fx_dot(x_q, w_q, frac_bits)


@functools.cache
def _bind() -> ctypes.CDLL:
    lib = build.load("fx_matvec")
    fn = lib.fx_matvec_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.fx_matvec_lanes_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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
    lanes = w_q.dim() == 2
    if (x_q.dim() < 1 or w_q.dim() not in (1, 2)
            or w_q.shape[-1] != x_q.shape[-1]):
        raise ValueError(f"fx_matvec_cuda: shapes {tuple(x_q.shape)} and "
                         f"{tuple(w_q.shape)} do not form [..., F] . [F] or "
                         f"[..., F] . [K, F]")
    if not (x_q.is_contiguous() and w_q.is_contiguous()):
        raise ValueError("fx_matvec_cuda: operands must be contiguous")
    f_dim = x_q.shape[-1]
    k = w_q.shape[0] if lanes else 1
    if not (0 <= frac_bits < 32 and k * f_dim <= MAX_FEATURES):
        raise ValueError(f"fx_matvec_cuda: frac_bits={frac_bits} or "
                         f"K={k} x F={f_dim} out of range")
    out = torch.empty(x_q.shape[:-1] + ((k,) if lanes else ()),
                      dtype=torch.int32, device=x_q.device)
    if out.numel() == 0:
        return out
    n = out.numel() // k               # rows of x
    lib = _bind()
    vec = int(f_dim % 4 == 0 and x_q.data_ptr() % 16 == 0)
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if k == 1:                     # [F] or one lane: the row kernel
            err = lib.fx_matvec_launch(x_q.data_ptr(), w_q.data_ptr(),
                                       out.data_ptr(), n, f_dim, frac_bits,
                                       vec, stream)
        else:
            err = lib.fx_matvec_lanes_launch(
                x_q.data_ptr(), w_q.data_ptr(), out.data_ptr(), n, f_dim, k,
                frac_bits, vec, stream)
    if err:
        raise RuntimeError(f"fx_matvec kernel launch failed: CUDA error "
                           f"{err}")
    dispatch.count_launch("fx_matvec")
    return out


def fx_matvec_cost(x_q: torch.Tensor, w_q: torch.Tensor,
                   frac_bits: int) -> dispatch.KernelCost:
    """x and w read once, the int32 ``[...]`` (``[..., K]``) result
    written; four int32 operations an element of x per lane, as
    ``PERF.md`` section 6 counts the bound."""
    n = x_q.numel() // max(1, x_q.shape[-1])
    k = w_q.shape[0] if w_q.dim() == 2 else 1
    return dispatch.KernelCost(
        ops=4 * x_q.numel() * k,
        bytes=x_q.numel() * x_q.element_size()
        + w_q.numel() * w_q.element_size() + n * k * 4,
        rate="int32")


dispatch.register_op("fx_matvec", cuda=fx_matvec_cuda, plain=fx_matvec_plain,
                     cost=fx_matvec_cost)


#: the largest K whose int32 sum cannot overflow: K * 128**2 <= 2**31
MAX_K = 1 << 17
#: columns of c: the tensor-core grid's y axis holds 65535 tiles of 128
MAX_N = 65535 * 128
#: the most rows of a that the streaming (decode) kernel takes; more rows
#: go to the tensor cores
STREAM_MAX_M = 16
#: SMs of an H100: the planner's default card
H100_SMS = 132
#: the tensor-core kernel's tile: 128 x 128 of c, 128 bytes of k per step
TC_TILE = TC_BK = 128
#: the streaming kernel: 256 columns per block, k in passes of 64 (16
#: groups of 4), at most 4096 k per block (a's slice lives in shared
#: memory), ~4 blocks in flight per SM
STREAM_COLS, STREAM_KSTEP, STREAM_MAX_KSPLIT = 256, 64, 4096
STREAM_BLOCKS_PER_SM = 4


def _cdiv(x: int, y: int) -> int:
    return -(-x // y)


@dataclasses.dataclass(frozen=True)
class IntMatmulPlan:
    """How one ``int_matmul`` launch runs: ``path`` "tc" (int8 tensor
    cores) or "stream" (a pass over b for a few rows of a), ``splits``
    slices of K, slice z covering k in ``[z * k_per_split, min(K, (z + 1)
    * k_per_split))`` (partial sums meet in c through integer atomics when
    ``splits > 1``), and for "stream" ``mt`` rows of a per block."""

    path: str
    splits: int
    k_per_split: int
    mt: int = 0


def int_matmul_plan(m: int, n: int, k: int,
                    n_sms: int = H100_SMS) -> IntMatmulPlan:
    """The launch of ``int_matmul`` for a ``[m, k] @ [k, n]`` product on a
    card with ``n_sms`` SMs (m, n, k >= 1; the tensor-core kernel's k,
    padded to a multiple of 16, has as many TC_BK steps).  K is split only as far as it takes
    to give every SM work: "tc" when fewer tiles than SMs, "stream" to
    about STREAM_BLOCKS_PER_SM blocks per SM."""
    if m <= STREAM_MAX_M:
        mt = 1 if m == 1 else 4
        blocks = _cdiv(n, STREAM_COLS) * _cdiv(m, mt)
        want = _cdiv(STREAM_BLOCKS_PER_SM * n_sms, blocks)
        splits = max(1, min(want, _cdiv(k, STREAM_KSTEP)))
        kps = min(_cdiv(_cdiv(k, splits), STREAM_KSTEP) * STREAM_KSTEP,
                  STREAM_MAX_KSPLIT)
        return IntMatmulPlan("stream", _cdiv(k, kps), kps, mt)
    ksteps = _cdiv(k, TC_BK)
    tiles = _cdiv(m, TC_TILE) * _cdiv(n, TC_TILE)
    splits = max(1, min(n_sms // tiles, ksteps))
    per_split = _cdiv(ksteps, splits)
    return IntMatmulPlan("tc", _cdiv(ksteps, per_split), per_split * TC_BK)


def tma_operands(a_q: torch.Tensor, b_q: torch.Tensor):
    """a and b as the tensor-core path reads them through TMA: 16-byte
    aligned, K and b's row pitch multiples of 16.  An operand that is not
    gets a zero-padded copy (zero k adds nothing; columns of b past N are
    not stored).  Returns ``(a, b)``; ``b.shape[1]`` is the row pitch."""
    (m, k), n = a_q.shape, b_q.shape[1]
    kp, np_ = _cdiv(k, 16) * 16, _cdiv(n, 16) * 16
    if kp != k:
        a_q = F.pad(a_q, (0, kp - k))
    elif a_q.data_ptr() % 16:
        a_q = a_q.clone()
    if kp != k or np_ != n:
        b_q = F.pad(b_q, (0, np_ - n, 0, kp - k))
    elif b_q.data_ptr() % 16:
        b_q = b_q.clone()
    return a_q, b_q


def int_matmul_plain(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """``ref.py::int_matmul_ref``.  The product runs in float64, exact here:
    every partial sum is an integer below 2**31 < 2**53 (ATen has no CUDA
    integer matmul)."""
    return (a_q.to(torch.float64) @ b_q.to(torch.float64)).to(torch.int32)


def _dequant(acc: torch.Tensor, a_scale: torch.Tensor,
             b_scale: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """``acc.astype(f32) * (a_scale * b_scale)`` with jnp's promotion: a
    bf16 per-tensor scale times the f32 per-column scales is f32."""
    scale = a_scale.to(torch.float32) * b_scale.to(torch.float32)
    return (acc.to(torch.float32) * scale).to(out_dtype)


def quant_matmul_plain(a_q: torch.Tensor, b_q: torch.Tensor,
                       a_scale: torch.Tensor, b_scale: torch.Tensor,
                       out_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """``ref.py::quant_matmul_ref``: a_q int8 [M, K], b_q int8 [K, N],
    a_scale [] or [M, 1], b_scale [] or [1, N]."""
    return _dequant(int_matmul_plain(a_q, b_q), a_scale, b_scale, out_dtype)


@functools.cache
def _int_matmul_fns():
    """The two C entry points, bound once (``argtypes`` set once)."""
    lib = build.load("int_matmul")
    tc, stream = lib.int_matmul_tc_launch, lib.int_matmul_stream_launch
    tc.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    stream.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
    tc.restype = stream.restype = ctypes.c_int
    return tc, stream


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def int_matmul_cuda(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """Launch the int8 matmul kernel :func:`int_matmul_plan` picks, on the
    current stream; raises on anything it does not take and on a launch
    error.  An empty product launches nothing."""
    if not (a_q.is_cuda and b_q.device == a_q.device):
        raise ValueError(f"int_matmul_cuda: a and b must be on one CUDA "
                         f"device, got {a_q.device} and {b_q.device}")
    if a_q.dtype != torch.int8 or b_q.dtype != torch.int8:
        raise TypeError(f"int_matmul_cuda: int8 operands required, got "
                        f"{a_q.dtype} and {b_q.dtype}")
    if a_q.dim() != 2 or b_q.dim() != 2 or a_q.shape[1] != b_q.shape[0]:
        raise ValueError(f"int_matmul_cuda: shapes {tuple(a_q.shape)} and "
                         f"{tuple(b_q.shape)} do not form [M, K] @ [K, N]")
    if not (a_q.is_contiguous() and b_q.is_contiguous()):
        raise ValueError("int_matmul_cuda: operands must be contiguous")
    (m, k), n = a_q.shape, b_q.shape[1]
    if k > MAX_K or n > MAX_N:
        raise ValueError(f"int_matmul_cuda: K={k} > {MAX_K} could overflow "
                         f"int32, or N={n} > {MAX_N}")
    out = torch.empty((m, n), dtype=torch.int32, device=a_q.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    tc, stream_fn = _int_matmul_fns()
    with torch.cuda.device(a_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        plan = int_matmul_plan(m, n, k, _sm_count(a_q.device.index))
        if plan.path == "stream":
            err = stream_fn(a_q.data_ptr(), b_q.data_ptr(), out.data_ptr(),
                            m, n, k, plan.mt, plan.splits, plan.k_per_split,
                            stream)
        else:
            a_t, b_t = tma_operands(a_q, b_q)
            err = tc(a_t.data_ptr(), b_t.data_ptr(), out.data_ptr(), m, n,
                     a_t.shape[1], b_t.shape[1], plan.splits,
                     plan.k_per_split // TC_BK, stream)
    if err:
        raise RuntimeError(f"int_matmul kernel launch failed: error {err} "
                           f"(CUDA error, or -1/-2: no TMA tensor map)")
    dispatch.count_launch("int_matmul")
    return out


def quant_matmul_cuda(a_q: torch.Tensor, b_q: torch.Tensor,
                      a_scale: torch.Tensor, b_scale: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """The int8 kernel, then the f32 dequant (``_quant_matmul_pallas``)."""
    return _dequant(int_matmul_cuda(a_q, b_q), a_scale, b_scale, out_dtype)


def quant_dense(x: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """x float [..., K]; w_q int8 [K, N]; w_scale [1, N] per column.

    The activations are quantized per tensor on the fly (symmetric, in
    x's dtype), multiplied in int8 -> int32 and dequantized in f32; the
    result has x's dtype."""
    lead, k = x.shape[:-1], x.shape[-1]
    x_q, xp = symmetric_quantize(x.reshape(-1, k), bits=8)
    out = dispatch.launch("quant_matmul", x_q, w_q, xp.scale, w_scale)
    return out.reshape(*lead, -1).to(x.dtype)


def int_matmul_cost(a_q: torch.Tensor, b_q: torch.Tensor
                    ) -> dispatch.KernelCost:
    """``2 M N K`` int8 operations; a and b read, the int32 c written."""
    (m, k), n = a_q.shape, b_q.shape[1]
    return dispatch.KernelCost(ops=2.0 * m * n * k,
                               bytes=float(m * k + k * n + 4 * m * n),
                               rate="int8")


def quant_matmul_cost(a_q: torch.Tensor, b_q: torch.Tensor,
                      a_scale: torch.Tensor, b_scale: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32
                      ) -> dispatch.KernelCost:
    """``int_matmul``'s product; a, b and the scales read, the
    dequantized ``[M, N]`` written in ``out_dtype``."""
    (m, k), n = a_q.shape, b_q.shape[1]
    nbytes = (m * k + k * n + a_scale.numel() * a_scale.element_size()
              + b_scale.numel() * b_scale.element_size()
              + m * n * torch.empty((), dtype=out_dtype).element_size())
    return dispatch.KernelCost(ops=2.0 * m * n * k, bytes=float(nbytes),
                               rate="int8")


def int_matmul_fake(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    return a_q.new_empty((a_q.shape[0], b_q.shape[1]), dtype=torch.int32)


def quant_matmul_fake(a_q, b_q, a_scale, b_scale,
                      out_dtype: torch.dtype = torch.float32):
    return a_q.new_empty((a_q.shape[0], b_q.shape[1]), dtype=out_dtype)


def product_placements(a_q, b_q) -> list:
    """The placements of ``a @ b`` on each mesh dim, from a's and b's: a's
    rows split (``Shard(0)``, b replicated) split c's rows; b's columns
    split (column-parallel) split c's columns; a's K split against b's
    (row-parallel) leaves partial sums; replicated stays replicated.  Any
    other pair raises: no rule gathers an operand."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    rules = {(Replicate(), Replicate()): Replicate(),
             (Shard(0), Replicate()): Shard(0),
             (Replicate(), Shard(1)): Shard(1),
             (Shard(1), Shard(0)): Partial()}
    out = []
    for pa, pb in zip(a_q.placements, b_q.placements):
        if (pa, pb) not in rules:
            raise ValueError(f"int_matmul: no rule for a {pa} against b "
                             f"{pb} (a {tuple(a_q.shape)}, b "
                             f"{tuple(b_q.shape)})")
        out.append(rules[pa, pb])
    return out


def _as_dtensors(*ts):
    """Each tensor as a DTensor on the first DTensor's mesh; a plain
    tensor replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = next(t.device_mesh for t in ts if isinstance(t, DTensor))
    return tuple(t if isinstance(t, DTensor) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False) for t in ts)


def _a_placements(a_q, b_q) -> list:
    """The placements a must have against b's (b, the weight, is never
    moved): split K where b splits K, rows kept split or replicated where
    b is replicated, replicated where b splits its columns."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for pa, pb in zip(a_q.placements, b_q.placements):
        if pb.is_shard(0):
            out.append(Shard(1))
        elif pb.is_replicate() and (pa.is_replicate() or pa.is_shard(0)):
            out.append(pa)
        else:
            out.append(Replicate())
    return out


def int_matmul_sharded(a_q, b_q):
    """``int_matmul`` on each rank's shards, placed by
    :func:`product_placements`; row-parallel products stay ``Partial``:
    int32 partial sums, exact once summed.  The activations a are
    redistributed to what b's placements need (:func:`_a_placements`)."""
    a_q, b_q = _as_dtensors(a_q, b_q)
    want = _a_placements(a_q, b_q)
    if list(a_q.placements) != want:
        a_q = a_q.redistribute(placements=want)
    return dispatch.on_shards("int_matmul", [product_placements(a_q, b_q)],
                              a_q, b_q)


def quant_matmul_sharded(a_q, b_q, a_scale, b_scale,
                         out_dtype: torch.dtype = torch.float32):
    """The sharded ``int_matmul``, its partial sums reduced in int32
    (exact, so the dequantized product equals the one-process one), then
    the dequant on the shards."""
    from torch.distributed.tensor import Replicate
    acc = dispatch.launch("int_matmul", a_q, b_q)
    if any(p.is_partial() for p in acc.placements):
        acc = acc.redistribute(placements=[
            Replicate() if p.is_partial() else p for p in acc.placements])
    return _dequant(*_as_dtensors(acc, a_scale, b_scale), out_dtype)


dispatch.register_op("int_matmul", cuda=int_matmul_cuda,
                     plain=int_matmul_plain, cost=int_matmul_cost,
                     fake=int_matmul_fake, sharded=int_matmul_sharded)
dispatch.register_op("quant_matmul", cuda=quant_matmul_cuda,
                     plain=quant_matmul_plain, cost=quant_matmul_cost,
                     fake=quant_matmul_fake, sharded=quant_matmul_sharded)
