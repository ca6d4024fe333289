"""Op ``mha``: batched, GQA attention forward (the flash_attention family).

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
"""
from __future__ import annotations

import ctypes
import functools

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
    """Attention on q's device: the kernel for CUDA tensors, the plain
    version for CPU ones."""
    return dispatch.launch("mha", q, k, v, causal=causal, q_offset=q_offset,
                           window=window)


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


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset: int = 0,
              window: int = 0) -> torch.Tensor:
    """``ref.py::attention_ref`` after ``_gqa_repeat``: float32 scores,
    ``-inf`` where masked, a max-subtracted softmax whose sum is clamped
    at 1e-30."""
    k, v = gqa_repeat(q, k, v)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal or window:
        qpos = torch.arange(q.shape[2], device=q.device)[:, None] + q_offset
        kpos = torch.arange(k.shape[2], device=q.device)[None, :]
        mask = (qpos >= kpos if causal
                else torch.ones_like(qpos >= kpos))
        if window:
            mask &= (qpos - kpos) < window
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(torch.float32))
    return out.to(q.dtype)


def tma_ready(t: torch.Tensor) -> bool:
    """Whether a [B, H, S, D] view can back a TMA tensor map as it lies:
    D contiguous, 16-byte aligned, every stride of a dim longer than 1 a
    multiple of 8 elements (16 bytes in bf16)."""
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(st % 8 == 0 for st, size in zip(t.stride()[:3],
                                                     t.shape[:3])
                    if size > 1))


def tma_views(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q, k, v as the bf16 kernel reads them: each view as it lies when
    :func:`tma_ready`, otherwise a contiguous copy, with D zero-padded to
    a multiple of 8 when a copy's rows would not be 16-byte multiples
    (zero columns add nothing to q . k, and out keeps D columns)."""
    d = q.shape[3]
    ready = [tma_ready(t) for t in (q, k, v)]
    dt = d if all(ready) or d % 8 == 0 else -(-d // 8) * 8
    return tuple(t if ok and dt == d else
                 F.pad(t, (0, dt - d)) if dt != d else
                 t.clone(memory_format=torch.contiguous_format)
                 for t, ok in zip((q, k, v), ready))


@functools.cache
def _bind():
    """The two C entry points, bound once: (float32, bf16)."""
    lib = build.load("flash_attention")
    ll = ctypes.c_longlong
    f32, bf16 = lib.flash_attention_f32_launch, lib.flash_attention_bf16_launch
    f32.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ll] * 9
                    + [ctypes.c_float] + [ctypes.c_int] * 3
                    + [ctypes.c_void_p])
    bf16.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ll] * 9
                     + [ctypes.c_float] + [ctypes.c_int] * 3
                     + [ctypes.c_void_p])
    f32.restype = bf16.restype = ctypes.c_int
    return f32, bf16


def mha_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             causal: bool = True, q_offset: int = 0,
             window: int = 0) -> torch.Tensor:
    """Launch the attention kernel on the current stream; raises on
    anything it does not take and on a launch error.  q, k and v are read
    through their strides (``_project_qkv``'s transposed views need no
    copy); a view whose last dim is not contiguous is copied first."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"mha_cuda: q, k, v must be on one CUDA device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"mha_cuda: float32 or bf16 q, k, v of one dtype "
                        f"required, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"mha_cuda: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} are not "
                         f"[B, Hq, Sq, D] and [B, Hkv, Skv, D]")
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"mha_cuda: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not pair (Hq % Hkv == 0)")
    if not (1 <= d <= MAX_HEAD_DIM and b * hq <= MAX_BATCH_HEADS):
        raise ValueError(f"mha_cuda: D={d} not in [1, {MAX_HEAD_DIM}] or "
                         f"B*Hq={b * hq} > {MAX_BATCH_HEADS}")
    if q_offset < 0 or window < 0:
        raise ValueError(f"mha_cuda: q_offset={q_offset} and "
                         f"window={window} must be >= 0")
    q, k, v = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if skv == 0:
        return out.zero_()      # no key: outside the contract
    f32, bf16 = _bind()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if q.dtype == torch.bfloat16:
            q, k, v = tma_views(q, k, v)
            err = bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), b, hq, hkv, sq, skv, q.shape[3], d,
                       *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                       1.0 / (d ** 0.5), int(causal), q_offset, window,
                       stream)
        else:
            err = f32(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), b, hq, hkv, sq, skv, d,
                      *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                      1.0 / (d ** 0.5), int(causal), q_offset, window,
                      stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: error "
                           f"{err} (CUDA error, or -1/-2: no TMA tensor "
                           f"map)")
    dispatch.count_launch("mha")
    return out


dispatch.register_op("mha", cuda=mha_cuda, plain=mha_plain)
