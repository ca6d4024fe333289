"""PIM-quantized linear layers of the LM stack (port of
``repro.models.quantized``, serve path).

The paper's LIN-HYB insight, narrow native multiplies in place of wide
ones, maps to an int8 x int8 -> int32 product: int8 weights with one
symmetric scale per output column, activations quantized per tensor on
the fly (``kernels/quant_matmul.py::quant_dense``).  A float weight is
quantized on every call, as in the reference.  A gradient through
``pim_dense`` reaches the float weight only through its per-column scale
(the ``amax``), as ``jax.grad`` of the reference's: the int8 values and the
``int_matmul`` product carry none.  ``fake_quant_dense`` is the train-path
QAT linear with a straight-through estimator (public; the reference's
model does not call it).
"""
from __future__ import annotations

from typing import Union

import torch

from ..core.quantization import symmetric_quantize
from ..kernels.quant_matmul import quant_dense


def quantize_weight(w: torch.Tensor) -> dict:
    """float [K, N] -> {"q": int8 [K, N], "scale": f32 [1, N]}."""
    q, p = symmetric_quantize(w.to(torch.float32), bits=8, axis=w.dim() - 1)
    return {"q": q, "scale": p.scale}


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q" in w


def pim_dense(x: torch.Tensor, w: Union[dict, torch.Tensor]
              ) -> torch.Tensor:
    """Serve-path int8 dense: on a CUDA tensor the ``int_matmul`` kernel,
    on a CPU tensor its plain version."""
    if not is_quantized(w):
        w = quantize_weight(w)
    return quant_dense(x, w["q"], w["scale"])


def fake_quant_dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Train-path QAT: the forward sees the int8-quantized weight, the
    backward flows to the float weight (straight-through estimator)."""
    q, p = symmetric_quantize(w.to(torch.float32), bits=8, axis=w.dim() - 1)
    w_dq = q.to(torch.float32) * p.scale
    w_ste = w + (w_dq.to(w.dtype) - w).detach()
    return x @ w_ste.to(x.dtype)
