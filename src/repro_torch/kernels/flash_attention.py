"""Ops ``mha`` and ``mha_bwd``: batched GQA attention and its gradient
(the flash_attention family).

``dispatch.launch("mha", q, k, v, causal=..., q_offset=..., window=...)``:
q ``[B, Hq, Sq, D]``, k and v ``[B, Hkv, Skv, D]`` (``Hq`` a multiple of
``Hkv``; query head h reads kv head ``h // (Hq // Hkv)``), float32 or
bf16, -> ``[B, Hq, Sq, D]`` in q's dtype.  Softmax attention in float32
with scale ``1 / sqrt(D)``; query row i sits at absolute position
``q_offset + i`` (decode: ``Skv - Sq``); ``causal`` keeps keys at or
before it, ``window > 0`` only the last ``window`` of them.  A row with no
unmasked key is outside the contract.

  :func:`mha_cuda`   the hand-written kernels (``csrc/flash_attention.cu``,
                     port of ``repro/kernels/flash_attention/kernel.py``
                     ``flash_attention`` with ``ops.py`` ``_gqa_repeat``):
                     bf16 on the tensor cores, float32 on the CUDA cores
  :func:`mha_plain`  the plain PyTorch version (``ref.py::attention_ref``
                     after ``_gqa_repeat``)

With ``with_lse=True`` both also return each row's log-sum-exp, float32
``[B, Hq, Sq]`` in natural-log units.

``dispatch.launch("mha_bwd", q, k, v, out, dout, lse, causal=...,
q_offset=..., window=...)`` -> ``(dq, dk, dv)`` in q's dtype, dk and dv
summed over each kv head's query heads.  No Pallas kernel computes it: the
reference differentiates its XLA attention path with ``jax.grad``.

  :func:`mha_bwd_cuda`   the hand-written kernels
                         (``csrc/flash_attention_bwd.cu``), deterministic:
                         bf16 on the tensor cores, float32 on the CUDA
                         cores
  :func:`mha_bwd_plain`  the explicit formula in float32

:func:`mha` is the differentiable entry point: on a CUDA tensor that needs
a gradient it runs :class:`MhaFunction` (the forward kernel keeping lse,
the backward kernel for its gradient); otherwise the ``mha`` op, so
serving adds no autograd node and no lse.  On a CPU tensor autograd
differentiates the plain version.  Both ops declare their cost.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import build, dispatch

#: head dims the kernels take (float32: shared tiles padded to 32, 64, 96
#: or 128 columns; bf16: 64 or 128)
MAX_HEAD_DIM = 128
#: batch * query heads: the kernel grid's y axis
MAX_BATCH_HEADS = 65535


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, q_offset: int = 0,
        window: int = 0) -> torch.Tensor:
    """Attention on q's device: the kernel for CUDA tensors (through
    :class:`MhaFunction` when q, k or v needs a gradient), the plain
    version for CPU ones; fake tensors take :class:`MhaFunction` too, so
    the dry-run's backward is charged ``mha_bwd``."""
    if ((q.is_cuda or dispatch.is_fake(q)) and torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return MhaFunction.apply(q, k, v, causal, q_offset, window)
    return dispatch.launch("mha", q, k, v, causal=causal, q_offset=q_offset,
                           window=window)


class MhaFunction(torch.autograd.Function):
    """``mha`` with its gradient on the card: the forward kernel with lse
    kept, the ``mha_bwd`` kernel for the backward.  Nothing here runs the
    plain version."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, window):
        out, lse = dispatch.launch("mha", q, k, v, causal=causal,
                                   q_offset=q_offset, window=window,
                                   with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, q_offset, window)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, q_offset, window = ctx.mask
        dq, dk, dv = dispatch.launch("mha_bwd", q, k, v, out, dout, lse,
                                     causal=causal, q_offset=q_offset,
                                     window=window)
        return dq, dk, dv, None, None, None


def gqa_repeat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """k and v with each kv head repeated ``Hq // Hkv`` times
    (``ops.py::_gqa_repeat``)."""
    hq, hkv = q.shape[1], k.shape[1]
    if hq != hkv:
        if hq % hkv:
            raise ValueError(f"{hq} query heads over {hkv} kv heads")
        rep = hq // hkv
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    return k, v


def keep_mask(sq: int, skv: int, causal: bool, q_offset: int, window: int,
              device) -> Optional[torch.Tensor]:
    """[Sq, Skv] bool: the (query, key) pairs attention keeps, None when it
    keeps all."""
    if not (causal or window):
        return None
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(skv, device=device)[None, :]
    mask = qpos >= kpos if causal else torch.ones_like(qpos >= kpos)
    if window:
        mask &= (qpos - kpos) < window
    return mask


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset: int = 0, window: int = 0,
              with_lse: bool = False):
    """``ref.py::attention_ref`` after ``_gqa_repeat``: float32 scores,
    ``-inf`` where masked, a max-subtracted softmax whose sum is clamped
    at 1e-30.  With ``with_lse``: ``(out, lse)``."""
    k, v = gqa_repeat(q, k, v)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    mask = keep_mask(q.shape[2], k.shape[2], causal, q_offset, window,
                     q.device)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", p / denom,
                       v.to(torch.float32)).to(q.dtype)
    if with_lse:
        return out, (m + torch.log(denom))[..., 0]
    return out


def mha_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                  *, causal: bool = True, q_offset: int = 0,
                  window: int = 0):
    """The gradient of :func:`mha_plain`, written out in float32: ``delta =
    rowsum(dout * out)``, ``P = exp(S - lse)`` (0 where masked), ``dV =
    P^T dO``, ``dS = P (dO V^T - delta)``, ``dQ = dS K scale``, ``dK =
    dS^T Q scale``, the GQA groups summed into their kv head.  ->
    ``(dq, dk, dv)`` in q's dtype."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    kr, vr = gqa_repeat(q, k, v)
    f32 = torch.float32
    qf, kf, vf = q.to(f32), kr.to(f32), vr.to(f32)
    gf = dout.to(f32)
    scale = 1.0 / (d ** 0.5)
    p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
                  - lse.to(f32)[..., None])
    mask = keep_mask(sq, skv, causal, q_offset, window, q.device)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    delta = torch.sum(gf * out.to(f32), dim=-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", gf, vf) - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    group = hq // hkv
    dk = dk.reshape(b, hkv, group, skv, d).sum(2)
    dv = dv.reshape(b, hkv, group, skv, d).sum(2)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def kept_pairs(sq: int, skv: int, causal: bool, q_offset: int,
               window: int) -> int:
    """How many (query, key) pairs of one head the masks keep."""
    qpos = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(skv - 1, qpos) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, qpos - window + 1) if window > 0 else np.zeros(sq)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def _rate(dtype: torch.dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "fp32"


def mha_cost(q, k, v, *, causal: bool = True, q_offset: int = 0,
             window: int = 0, with_lse: bool = False) -> dispatch.KernelCost:
    """S = Q K^T and P V: 2 products of 2 D operations a kept pair; q, k,
    v read, out (and lse) written."""
    b, hq, sq, d = q.shape
    pairs = b * hq * kept_pairs(sq, k.shape[2], causal, q_offset, window)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    if with_lse:
        nbytes += b * hq * sq * 4
    return dispatch.KernelCost(ops=4.0 * d * pairs, bytes=float(nbytes),
                               rate=_rate(q.dtype))


def mha_bwd_cost(q, k, v, out, dout, lse, *, causal: bool = True,
                 q_offset: int = 0, window: int = 0) -> dispatch.KernelCost:
    """S, dP = dO V^T, dV, dK and dQ: 5 products of 2 D operations a kept
    pair; q, k, v, out, dout and lse read, dq, dk and dv written."""
    b, hq, sq, d = q.shape
    pairs = b * hq * kept_pairs(sq, k.shape[2], causal, q_offset, window)
    nbytes = ((3 * q.numel() + 2 * k.numel() + 2 * v.numel()
               + out.numel()) * q.element_size() + lse.numel() * 4)
    return dispatch.KernelCost(ops=10.0 * d * pairs, bytes=float(nbytes),
                               rate=_rate(q.dtype))


def tma_ready(t: torch.Tensor) -> bool:
    """Whether a [B, H, S, D] view can back a TMA tensor map as it lies:
    D contiguous, 16-byte aligned, every stride of a dim longer than 1 a
    multiple of 8 elements (16 bytes in bf16)."""
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(st % 8 == 0 for st, size in zip(t.stride()[:3],
                                                     t.shape[:3])
                    if size > 1))


def tma_views(*ts: torch.Tensor):
    """[B, H, S, D] views (q, k, v; the backward adds out and dout) as the
    bf16 kernels read them: each view as it lies when :func:`tma_ready`,
    otherwise a contiguous copy, with D of every view zero-padded to a
    multiple of 8 when a copy's rows would not be 16-byte multiples (zero
    columns add nothing to q . k or to dout . out, and the kernels keep D
    columns of their outputs, or the wrapper cuts them back)."""
    d = ts[0].shape[3]
    ready = [tma_ready(t) for t in ts]
    dt = d if all(ready) or d % 8 == 0 else -(-d // 8) * 8
    return tuple(t if ok and dt == d else
                 F.pad(t, (0, dt - d)) if dt != d else
                 t.clone(memory_format=torch.contiguous_format)
                 for t, ok in zip(ts, ready))


@functools.cache
def _bind():
    """The two C entry points, bound once: (float32, bf16)."""
    lib = build.load("flash_attention")
    ll = ctypes.c_longlong
    f32, bf16 = lib.flash_attention_f32_launch, lib.flash_attention_bf16_launch
    f32.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ll] * 9
                    + [ctypes.c_float] + [ctypes.c_int] * 3
                    + [ctypes.c_void_p] * 2)
    bf16.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ll] * 9
                     + [ctypes.c_float] + [ctypes.c_int] * 3
                     + [ctypes.c_void_p] * 2)
    f32.restype = bf16.restype = ctypes.c_int
    return f32, bf16


def _check_qkv(name: str, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, q_offset: int, window: int) -> None:
    """Raise on q, k, v the attention kernels do not take."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{name}: q, k, v must be on one CUDA device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"{name}: float32 or bf16 q, k, v of one dtype "
                        f"required, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} are not "
                         f"[B, Hq, Sq, D] and [B, Hkv, Skv, D]")
    b, hq, _, d = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not pair (Hq % Hkv == 0)")
    if not (1 <= d <= MAX_HEAD_DIM and b * hq <= MAX_BATCH_HEADS):
        raise ValueError(f"{name}: D={d} not in [1, {MAX_HEAD_DIM}] or "
                         f"B*Hq={b * hq} > {MAX_BATCH_HEADS}")
    if q_offset < 0 or window < 0:
        raise ValueError(f"{name}: q_offset={q_offset} and "
                         f"window={window} must be >= 0")


def _d_contiguous(*ts):
    """Each tensor as it lies when its last dim is contiguous, else a
    contiguous copy."""
    return tuple(t if t.stride(3) == 1 else t.contiguous() for t in ts)


def mha_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             causal: bool = True, q_offset: int = 0, window: int = 0,
             with_lse: bool = False):
    """Launch the attention kernel on the current stream; raises on
    anything it does not take and on a launch error.  q, k and v are read
    through their strides (``_project_qkv``'s transposed views need no
    copy); a view whose last dim is not contiguous is copied first.  With
    ``with_lse`` the kernel also writes each row's log-sum-exp:
    ``(out, lse)``."""
    _check_qkv("mha_cuda", q, k, v, q_offset, window)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    q, k, v = _d_contiguous(q, k, v)
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0 or skv == 0:    # no key: outside the contract
        if with_lse:
            return out.zero_(), lse.fill_(float("-inf"))
        return out.zero_()
    lse_ptr = lse.data_ptr() if with_lse else None
    f32, bf16 = _bind()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if q.dtype == torch.bfloat16:
            q, k, v = tma_views(q, k, v)
            err = bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), b, hq, hkv, sq, skv, q.shape[3], d,
                       *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                       1.0 / (d ** 0.5), int(causal), q_offset, window,
                       lse_ptr, stream)
        else:
            err = f32(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), b, hq, hkv, sq, skv, d,
                      *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                      1.0 / (d ** 0.5), int(causal), q_offset, window,
                      lse_ptr, stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: error "
                           f"{err} (CUDA error, or -1/-2: no TMA tensor "
                           f"map)")
    dispatch.count_launch("mha")
    return (out, lse) if with_lse else out


@functools.cache
def _bind_bwd():
    """The backward's C entry point, bound once."""
    fn = build.load("flash_attention_bwd").flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                   + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 15
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def mha_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                 *, causal: bool = True, q_offset: int = 0,
                 window: int = 0):
    """Launch the backward kernels (``csrc/flash_attention_bwd.cu``) on the
    current stream: ``(dq, dk, dv)``, contiguous, in q's dtype.  bf16 runs
    on the tensor cores, its inputs staged by :func:`tma_views` (D padded
    with zeros when a copy's rows would not be 16-byte multiples, the
    gradients cut back to D); float32 on the CUDA cores.  Inputs are read
    through their strides (a view whose last dim is not contiguous is
    copied first); raises on anything the kernels do not take and on a
    launch error."""
    _check_qkv("mha_bwd_cuda", q, k, v, q_offset, window)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"mha_bwd_cuda: {name} {tuple(t.shape)} "
                             f"{t.dtype} on {t.device} is not q's "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}")
    if (lse.shape != (b, hq, sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"mha_bwd_cuda: lse must be contiguous float32 "
                         f"{(b, hq, sq)} on {q.device}, got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")
    if sq == 0 or skv == 0:             # nothing attends: zero gradients
        return (q.new_zeros((b, hq, sq, d)), k.new_zeros((b, hkv, skv, d)),
                k.new_zeros((b, hkv, skv, d)))
    bf16 = q.dtype == torch.bfloat16
    q, k, v, out, dout = _d_contiguous(q, k, v, out, dout)
    if bf16:
        q, k, v, out, dout = tma_views(q, k, v, out, dout)
    dt = q.shape[3]                     # D, or D padded by tma_views
    dq = torch.empty((b, hq, sq, dt), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, hkv, skv, dt), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    fn = _bind_bwd()
    with torch.cuda.device(q.device):
        err = fn(int(bf16), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), b, hq, hkv, sq, skv, dt,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], *dout.stride()[:3], 1.0 / (d ** 0.5),
                 int(causal), q_offset, window,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                           f"error {err} (CUDA error, or -1/-2: no TMA "
                           f"tensor map)")
    dispatch.count_launch("mha_bwd")
    if dt != d:
        dq, dk, dv = (t[..., :d].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


def mha_fake(q, k, v, *, causal: bool = True, q_offset: int = 0,
             window: int = 0, with_lse: bool = False):
    out = q.new_empty(q.shape)
    if with_lse:
        return out, q.new_empty(q.shape[:3], dtype=torch.float32)
    return out


def mha_bwd_fake(q, k, v, out, dout, lse, *, causal: bool = True,
                 q_offset: int = 0, window: int = 0):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def on_head_shards(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` on each rank's local batch rows and heads
    of the DTensors ``args`` (each redistributed to the first's
    placements), each tensor it returns placed as the first."""
    from torch.distributed.tensor import DTensor
    pl = _head_placements(args[0])
    args = _to_placements(pl, *args)
    mesh = args[0].device_mesh
    out = fn(*(a.to_local() for a in args), **kwargs)
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(o, mesh, pl, run_check=False)
                     for o in out)
    return DTensor.from_local(out, mesh, pl, run_check=False)


def _head_placements(q) -> list:
    """q's placements, which attention keeps: each rank attends over its
    own batch rows and heads (``Shard(0)``, ``Shard(1)``; with GQA a
    rank's query heads read its own kv heads when both split evenly).
    The other operands are redistributed to them (activations only)."""
    for p in q.placements:
        if not (p.is_replicate() or p.is_shard(0) or p.is_shard(1)):
            raise ValueError(f"attention: no rule for q placed {p}")
    return list(q.placements)


def _to_placements(placements, *ts):
    from torch.distributed.tensor import DTensor
    return tuple(t.redistribute(placements=placements)
                 if isinstance(t, DTensor) and list(t.placements)
                 != placements else t for t in ts)


def mha_sharded(q, k, v, **kwargs):
    """``mha`` on each rank's batch rows and heads: in and out placed as
    q (heads ``Shard(1)`` over "model")."""
    return on_head_shards(functools.partial(dispatch.launch, "mha"),
                          q, k, v, **kwargs)


def mha_bwd_sharded(q, k, v, out, dout, lse, **kwargs):
    """``mha_bwd`` on each rank's batch rows and heads, placed as q."""
    return on_head_shards(functools.partial(dispatch.launch, "mha_bwd"),
                          q, k, v, out, dout, lse, **kwargs)


dispatch.register_op("mha", cuda=mha_cuda, plain=mha_plain, cost=mha_cost,
                     fake=mha_fake, sharded=mha_sharded)
dispatch.register_op("mha_bwd", cuda=mha_bwd_cuda, plain=mha_bwd_plain,
                     cost=mha_bwd_cost, fake=mha_bwd_fake,
                     sharded=mha_bwd_sharded)
