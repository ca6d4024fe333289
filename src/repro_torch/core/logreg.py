"""Logistic regression with gradient descent on the PIM system (paper §3.2).

Port of ``repro.core.logreg``.  Six versions, the paper's ladder:
  LOG-FP32            float32 + Taylor-series sigmoid (DPUs lack exp)
  LOG-INT32           Q(frac_bits) fixed point + fixed-point Taylor sigmoid
  LOG-INT32-LUT(MRAM) fixed point + LUT sigmoid, table in the DRAM bank
  LOG-INT32-LUT(WRAM) fixed point + LUT sigmoid, table in the scratchpad
  LOG-HYB-LUT         8-bit inputs x 16-bit weights + WRAM LUT
  LOG-BUI-LUT         LOG-HYB-LUT numerics (built-in multiply)

The INT32 versions' matvec is the ``fx_matvec`` kernel; every LUT
version's sigmoid is the ``lut_sigmoid`` kernel, in the placement the
version names: ``int32_lut_mram`` reads the table from global memory,
the others stage it in shared memory.  The values are identical.
``fuse_steps > 1`` runs fused chunks as LIN does (``linreg.fit_steps``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from ..kernels import dispatch
from ..systems import ChunkPipeline, ChunkTick, System, run_steps
from .fixed_point import _shift_round, fx_dot_hybrid
from .linreg import (GdConfig, GdResult, _matvec, _xt_err, carry_snapshot,
                     gd_boundaries, initial_carry, int_grad, lane_rows,
                     make_gd_step_fns)
from .lut import SigmoidLut, build_sigmoid_lut, taylor_sigmoid_fixed

VERSIONS = ("fp32", "int32", "int32_lut_mram", "int32_lut_wram",
            "hyb_lut", "bui_lut")


@dataclasses.dataclass
class LogRegConfig(GdConfig):
    version: str = "fp32"
    lr: float = 5.0              # logistic loss needs larger steps
    taylor_terms: int = 8
    lut_boundary: int = 20       # paper Fig. 4: boundary 20, 10 frac bits
    lut_frac_bits: int = 10


def _sigmoid_taylor_f32(z: torch.Tensor, terms: int) -> torch.Tensor:
    """Float Taylor sigmoid — the paper's LOG-FP32 path on DPUs:
    exp(-|z|) via range-reduced Taylor (m=3 halvings), then reflect."""
    a = torch.clamp(torch.abs(z), max=20.0)
    t = a / 8.0
    acc = torch.ones_like(t)
    for k in range(terms - 1, 0, -1):
        acc = 1.0 - acc * t / k
    e = acc * acc          # (exp(-t))**8 = exp(-a), by squaring as
    e = e * e              # jnp's integer_pow does
    e = e * e
    pos = 1.0 / (1.0 + e)
    return torch.where(z < 0, 1.0 - pos, pos)


def _gd_version_of(version: str) -> str:
    return {"fp32": "fp32", "int32": "int32", "int32_lut_mram": "int32",
            "int32_lut_wram": "int32", "hyb_lut": "hyb",
            "bui_lut": "bui"}[version]


def make_local_grad(cfg: LogRegConfig, lut: Optional[SigmoidLut],
                    exact_sigmoid: bool = False) -> Callable:
    """The batched per-core kernel for the configured version (with lane
    weights ``[K, F]`` it computes every lane, as ``linreg``'s kernels
    do).

    ``exact_sigmoid`` selects the native fp32 sigmoid a processor-centric
    system provides (the paper's MKL baseline, §5.4) instead of the DPU
    Taylor expansion; it only applies to the fp32 version."""
    f = cfg.frac_bits
    placement = "mram" if cfg.version == "int32_lut_mram" else "wram"

    if cfg.version == "fp32":
        if not exact_sigmoid:
            terms = cfg.taylor_terms

            def _local_fp32_taylor(Xc, yc, mask, w, b):
                yc, mask = lane_rows(w, yc, mask)
                p = _sigmoid_taylor_f32(_matvec(Xc, w) + b, terms)
                err = (p - yc) * mask
                return {"gw": _xt_err(Xc, err), "gb": err.sum(1)}
            return _local_fp32_taylor

        def _local_fp32_exact(Xc, yc, mask, w, b):
            yc, mask = lane_rows(w, yc, mask)
            err = (torch.sigmoid(_matvec(Xc, w) + b) - yc) * mask
            return {"gw": _xt_err(Xc, err), "gb": err.sum(1)}
        return _local_fp32_exact

    if cfg.version == "int32":
        terms = cfg.taylor_terms

        def _local_int32_taylor(Xq, yq, mask, wq, bq):
            z = dispatch.launch("fx_matvec", Xq.contiguous(), wq, f) + bq
            p = taylor_sigmoid_fixed(z, f, terms=terms)      # Q(f)
            yq, mask = lane_rows(wq, yq, mask)
            return int_grad(Xq, (p - yq) * mask, f)
        return _local_int32_taylor

    if lut is None:
        raise ValueError(f"version {cfg.version!r} needs a sigmoid LUT")

    if cfg.version in ("int32_lut_mram", "int32_lut_wram"):
        def _local_int32_lut(Xq, yq, mask, wq, bq):
            z = dispatch.launch("fx_matvec", Xq.contiguous(), wq, f) + bq
            p15 = dispatch.launch("lut_sigmoid", z, lut,
                                  placement=placement)     # Q(value_frac)
            p = _shift_round(p15, lut.value_frac - f)      # -> Q(f)
            yq, mask = lane_rows(wq, yq, mask)
            return int_grad(Xq, (p - yq) * mask, f)
        return _local_int32_lut

    # hyb_lut / bui_lut — identical numerics; the saturating 16-bit dot
    # stays inline (a sequential clip, no matmul), the sigmoid is the
    # kernel
    x8, w16 = cfg.x8_frac, cfg.w16_frac

    def _local_hyb_lut(Xq8, yq, mask, wq16, bq):
        xq8 = Xq8.unsqueeze(-2) if wq16.dim() == 2 else Xq8
        yq, mask = lane_rows(wq16, yq, mask)
        z = fx_dot_hybrid(xq8, wq16, x8, w16, f) + bq      # Q(f), 16-bit acc
        p15 = dispatch.launch("lut_sigmoid", z, lut, placement=placement)
        p = _shift_round(p15, lut.value_frac - f)
        return int_grad(Xq8, (p - yq) * mask, x8)
    return _local_hyb_lut


def grad_kernel_name(cfg: LogRegConfig, exact_sigmoid: bool = False) -> str:
    """Registry name encoding every parameter baked into the closure."""
    return (f"log.grad/{cfg.version}"
            + ("x" if exact_sigmoid else "")
            + f"/f{cfg.frac_bits}"
            f".x{cfg.x8_frac}.w{cfg.w16_frac}"
            f".t{cfg.taylor_terms}"
            f".lb{cfg.lut_boundary}.lf{cfg.lut_frac_bits}")


def build_local_grad(cfg: LogRegConfig, device: torch.device,
                     exact_sigmoid: bool = False) -> Callable:
    """The per-core kernel for ``cfg.version`` with its LUT built on
    ``device`` (unregistered): shared by the serial trainer and the fused
    gang step (``sched/gang.py``)."""
    lut = (build_sigmoid_lut(cfg.lut_boundary, cfg.lut_frac_bits,
                             device=device)
           if "lut" in cfg.version else None)
    return make_local_grad(cfg, lut, exact_sigmoid)


def _grad_kernel(system: System, cfg: LogRegConfig) -> str:
    """Named per-core kernel; the LUT is built once, on the system's
    device, inside the builder."""
    exact = cfg.version == "fp32" and system.exact_transcendentals
    return system.named_kernel(
        grad_kernel_name(cfg, exact),
        lambda: build_local_grad(cfg, system.device, exact))


def fit_steps(dataset, cfg: Optional[LogRegConfig] = None,
              eval_fn: Optional[Callable] = None, *,
              state: Optional[dict] = None):
    """Generator form of the LOG loop (GdResult on StopIteration); each
    ``next()`` runs one GD iteration and yields a
    :class:`~repro_torch.systems.base.ChunkTick` with a lazy carry
    snapshot; pass a snapshot (this package's or the reference's) back
    as ``state`` to resume exactly at that boundary."""
    cfg = cfg or LogRegConfig()
    if cfg.version not in VERSIONS:
        raise ValueError(f"unknown LOG version {cfg.version!r}; known: "
                         f"{VERSIONS}")
    system: System = dataset.system
    n, nf = dataset.n, dataset.n_features

    # reuse linreg's weight quantization via the base data version
    base_cfg = dataclasses.replace(cfg, version=_gd_version_of(cfg.version))
    Xs, ys, mask = dataset.gd_view(cfg.version, cfg.frac_bits, cfg.x8_frac)
    local = _grad_kernel(system, cfg)
    prepare, update = make_gd_step_fns(base_cfg)

    w, b, s, it_done, history = initial_carry(
        nf, cfg.lr * (1.0 / n), system.device, state)

    def record(it, wv, bv):
        if cfg.record_every and (it % cfg.record_every == 0
                                 or it == cfg.n_iters):
            metric = (eval_fn(wv.cpu().numpy(), float(bv)) if eval_fn
                      else None)
            history.append((it, metric))

    if cfg.fuse_steps > 1:
        exact = cfg.version == "fp32" and system.exact_transcendentals
        program = system.step_program(
            local, prepare, update,
            name=f"log.step/{grad_kernel_name(cfg, exact)}")
        pipe = ChunkPipeline(program, max(1, int(cfg.pipeline_depth)))
        try:
            for bnd in gd_boundaries(pipe, (w, b, s), (Xs, ys, mask), cfg,
                                     it_done):
                it_done = bnd.tag[0]
                (w, b, s), _ = bnd.host()
                record(it_done, w, b)
                yield ChunkTick(bnd.k, functools.partial(
                    carry_snapshot, w, b, s, it_done, history))
        finally:
            program.release()
    else:
        def _snapshot():
            return carry_snapshot(w, b, s, it_done, history)

        for it in range(it_done, cfg.n_iters):
            wq, bq = system.broadcast(prepare((w, b, s)))
            partial = system.map_reduce(local, (Xs, ys, mask), (wq, bq))
            (w, b, s), _ = update((w, b, s), partial)
            it_done = it + 1
            record(it_done, w, b)
            yield ChunkTick(1, _snapshot)
    return GdResult(w=w.cpu().numpy(), b=float(b), history=history,
                    n_iters=cfg.n_iters)


def fit(dataset, cfg: Optional[LogRegConfig] = None,
        eval_fn: Optional[Callable] = None) -> GdResult:
    """LOG training over a resident PimDataset; the data view is shared
    with LIN (same precision ladder)."""
    return run_steps(fit_steps(dataset, cfg, eval_fn))
