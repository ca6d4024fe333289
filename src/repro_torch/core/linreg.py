"""Linear regression with gradient descent on the PIM system (paper §3.1).

Port of ``repro.core.linreg``.  Four versions, the paper's ladder:
  LIN-FP32   32-bit float data and arithmetic
  LIN-INT32  32-bit fixed point Q(frac_bits); its matvec is the
             ``fx_matvec`` kernel
  LIN-HYB    8-bit inputs x 16-bit weights, 16-bit saturating dot
             products, 32-bit gradients
  LIN-BUI    LIN-HYB numerics (the built-in multiply only changes the
             DPU's instruction count)

Rows are partitioned across the simulated cores; each core computes
partial gradients over its resident shard — here one batched call over
the ``[C, n_pc, ...]`` shards; the host reduces the partials, updates w
in float32 and re-broadcasts it.  The integer versions' trajectories are
bit-identical to the reference's at the same core count; minibatch SGD
draws its offsets from the same numpy MT19937 stream.

``fuse_steps > 1`` runs k iterations per :class:`~repro_torch.systems.
base.StepProgram` chunk (one CUDA graph replay on a card), with
``pipeline_depth`` chunks in flight; a fused fit is bit-identical to the
serial one for the integer versions.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..elastic.state import pack_rng, unpack_rng
from ..kernels import dispatch
from ..systems import (ChunkPipeline, ChunkTick, System, chunk_schedule,
                       run_steps)
from .fixed_point import (_shift_round, from_fixed, fx_dot_hybrid,
                          mul_round_f32, to_fixed)

VERSIONS = ("fp32", "int32", "hyb", "bui")


@dataclasses.dataclass
class GdConfig:
    version: str = "fp32"
    n_iters: int = 500
    lr: float = 0.1
    frac_bits: int = 10      # Q format for INT32 data / all fixed-point grads
    x8_frac: int = 7         # Q format of 8-bit inputs (HYB/BUI)
    w16_frac: int = 8        # Q format of 16-bit weights (HYB/BUI)
    record_every: int = 0    # 0 = only final metrics
    minibatch: int = 0       # 0 = full-batch GD; >0 = SGD with per-core
    #                          minibatches of this size
    seed: int = 0
    #: step fusion: run this many GD iterations as one fused chunk (one
    #: CUDA graph replay on a card, a loop of the same steps on the CPU):
    #: the kernel -> reduce -> update -> re-quantize cycle stays on the
    #: device between chunk boundaries.  Minibatch SGD fuses too, its
    #: offsets drawn per chunk from the serial loop's rng stream.  Chunks
    #: are clipped so that record points land on boundaries.  1 = the
    #: host-orchestrated per-step loop.
    fuse_steps: int = 1
    #: fused chunks in flight before the host drains a boundary (record,
    #: snapshot): 2 overlaps chunk N+1 with the drain of boundary N, 1 is
    #: the serial cadence.  Only used when ``fuse_steps > 1``.
    pipeline_depth: int = 2


@dataclasses.dataclass
class GdResult:
    w: np.ndarray            # float32 [F]
    b: float
    history: list            # [(iter, metric)] if record_every else []
    n_iters: int = 0

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(X, np.float32) @ self.w + self.b


# ---------------------------------------------------------------------------
# Per-core kernels, batched over the leading cores axis: shards are
# [C, n, F] / [C, n], partials come back [C, F] / [C].  Given lane weights
# w [K, F] and b [K] (K models over the same shards: the fused sweep of
# sched/gang.py), the same kernels give [C, K, F] / [C, K], each lane
# what the serial kernel gives for that lane's weights.
# ---------------------------------------------------------------------------

def lane_rows(w: torch.Tensor, *rows: torch.Tensor) -> tuple:
    """Per-row operands (targets, mask: ``[C, n]``) as the kernel needs
    them for ``w``: unchanged for one model ``[F]``, ``[C, n, 1]`` for
    lane weights ``[K, F]``, so that the errors come out ``[C, n, K]``."""
    if w.dim() == 2:
        return tuple(r.unsqueeze(-1) for r in rows)
    return rows


def _matvec(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-core ``X @ w``: [C, n, F] @ [F] -> [C, n]; lanes -> [C, n, K]."""
    return torch.matmul(X, w.T if w.dim() == 2 else w)


def _xt_err(X: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
    """Per-core ``X.T @ err``: [C, n, F], [C, n] -> [C, F]; lane errors
    [C, n, K] -> [C, K, F]."""
    if err.dim() == X.dim():
        return torch.matmul(err.transpose(-1, -2), X)
    return torch.matmul(err.unsqueeze(-2), X).squeeze(-2)


def _local_grad_fp32(Xc, yc, mask, w, b):
    yc, mask = lane_rows(w, yc, mask)
    err = (_matvec(Xc, w) + b - yc) * mask
    return {"gw": _xt_err(Xc, err), "gb": err.sum(1)}


def int_grad(Xq: torch.Tensor, err: torch.Tensor, shift: int) -> dict:
    """Per-core fixed-point gradient sums over the rows, kept int32 like
    ``jnp.sum``: errors [C, n] give [C, F] / [C], lane errors [C, n, K]
    give [C, K, F] / [C, K] (a [C, n, K, F] product)."""
    x = Xq.to(torch.int32)
    if err.dim() == x.dim():                  # lanes
        x = x.unsqueeze(-2)
    prod = err.unsqueeze(-1) * x
    return {"gw": torch.sum(_shift_round(prod, shift), dim=1,
                            dtype=torch.int32),
            "gb": torch.sum(err, dim=1, dtype=torch.int32)}


def make_local_grad_int32(frac_bits: int):
    def _local(Xq, yq, mask, wq, bq):
        # the Q-format matvec: the fx_matvec kernel on a CUDA device, one
        # launch for every lane
        dot = dispatch.launch("fx_matvec", Xq.contiguous(), wq,
                              frac_bits) + bq             # Q(f)
        yq, mask = lane_rows(wq, yq, mask)
        err = (dot - yq) * mask                           # Q(f)
        return int_grad(Xq, err, frac_bits)
    return _local


def make_local_grad_hyb(x8_frac: int, w16_frac: int, out_frac: int):
    def _local(Xq8, yq, mask, wq16, bq):
        xq8 = Xq8.unsqueeze(-2) if wq16.dim() == 2 else Xq8
        yq, mask = lane_rows(wq16, yq, mask)
        # 16-bit saturating dot product (the paper's stated precision)
        dot = fx_dot_hybrid(xq8, wq16, x8_frac, w16_frac, out_frac) + bq
        err = (dot - yq) * mask                           # Q(out_frac)
        return int_grad(Xq8, err, x8_frac)
    return _local


# ---------------------------------------------------------------------------
# Host-orchestrated training loop (paper §3.1 flow).
# ---------------------------------------------------------------------------

def _quantize_weights(cfg: GdConfig, w: torch.Tensor, b: torch.Tensor):
    if cfg.version == "int32":
        return to_fixed(w, cfg.frac_bits), to_fixed(b, cfg.frac_bits)
    return (to_fixed(w, cfg.w16_frac, dtype=torch.int16),
            to_fixed(b, cfg.frac_bits))


_NUMPY_DTYPE = {torch.int32: np.int32, torch.float32: np.float32}


def _reduced(v, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A reduced gradient on the device in ``dtype``.  Host-strategy
    reduces arrive as numpy int64/float64 and are demoted (int64 ->
    int32 wraps), as the reference's ``jnp.asarray`` demotes them."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype)
    return torch.from_numpy(np.array(v, _NUMPY_DTYPE[dtype])).to(device)


def make_gd_step_fns(quant_cfg: GdConfig):
    """The (prepare, update) pair of one GD step.

    ``prepare(carry) -> (wq, bq)`` quantizes the float32 carry for the
    broadcast; ``update(carry, reduced) -> (carry, None)`` dequantizes
    the reduced gradient and applies ``w -= scale_f32 * gw`` with two
    roundings (``mul_round_f32``).  The carry is ``(w, b, s)``.
    ``quant_cfg`` is the weight-quantization config (LOG's LUT versions
    pass their collapsed int32/hyb base)."""
    f = quant_cfg.frac_bits

    def apply(w, b, s, gw, gb):
        return w - mul_round_f32(s, gw), b - mul_round_f32(s, gb), s

    if quant_cfg.version == "fp32":
        def prepare(carry):
            return carry[0], carry[1]

        def update(carry, reduced):
            w, b, s = carry
            gw = _reduced(reduced["gw"], torch.float32, w.device)
            gb = _reduced(reduced["gb"], torch.float32, w.device)
            return apply(w, b, s, gw, gb), None
        return prepare, update

    def prepare(carry):
        w, b, _ = carry
        return _quantize_weights(quant_cfg, w, b)

    def update(carry, reduced):
        w, b, s = carry
        gw = from_fixed(_reduced(reduced["gw"], torch.int32, w.device), f)
        gb = from_fixed(_reduced(reduced["gb"], torch.int32, w.device), f)
        return apply(w, b, s, gw, gb), None
    return prepare, update


def build_local_grad(cfg: GdConfig) -> Callable:
    """The batched per-core gradient kernel for ``cfg.version``."""
    if cfg.version == "fp32":
        return _local_grad_fp32
    if cfg.version == "int32":
        return make_local_grad_int32(cfg.frac_bits)
    return make_local_grad_hyb(cfg.x8_frac, cfg.w16_frac, cfg.frac_bits)


def grad_kernel_name(cfg: GdConfig) -> str:
    """Registry name encoding every parameter baked into the kernel."""
    if cfg.version == "fp32":
        return "lin.grad/fp32"
    if cfg.version == "int32":
        return f"lin.grad/int32/f{cfg.frac_bits}"
    return f"lin.grad/hyb/x{cfg.x8_frac}.w{cfg.w16_frac}.f{cfg.frac_bits}"


def initial_carry(nf: int, s: float, device: torch.device,
                  state: Optional[dict]):
    """``(w, b, s, iters_done, history)``: zeros, or a snapshot's carry."""
    w = torch.zeros(nf, dtype=torch.float32, device=device)
    b = torch.zeros((), dtype=torch.float32, device=device)
    s = torch.tensor(np.float32(s), device=device)
    if state is None:
        return w, b, s, 0, []
    arrays, meta = state["arrays"], state["meta"]

    def dev(a):
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(device)
    return (dev(arrays["w"]), dev(arrays["b"]), dev(arrays["s"]),
            int(meta["iters"]), [tuple(h) for h in meta.get("history", [])])


def carry_snapshot(w, b, s, it: int, history: list) -> dict:
    """The chunk-boundary snapshot dict, in the reference's schema."""
    return {"arrays": {"w": w.cpu().numpy().astype(np.float32),
                       "b": b.cpu().numpy().astype(np.float32),
                       "s": s.cpu().numpy().astype(np.float32)},
            "meta": {"iters": int(it),
                     "history": [[int(i), None if m is None else float(m)]
                                 for i, m in history]}}


def gd_boundaries(pipe: ChunkPipeline, carry, sharded: tuple, cfg,
                  it_done: int, draw_xs: Optional[Callable] = None,
                  rng: Optional[np.random.RandomState] = None):
    """Dispatch the fused chunks of a GD fit from iteration ``it_done``
    through ``pipe`` and yield each boundary as it drains.  A boundary's
    tag is ``(iterations done, rng arrays, rng meta)``, the rng packed
    after the chunk's own draws (``draw_xs(k)``), so restoring boundary N
    replays chunk N+1's minibatch offsets exactly."""
    it_disp = it_done
    for k in chunk_schedule(cfg.n_iters, cfg.fuse_steps, cfg.record_every,
                            start=it_done):
        xs = draw_xs(k) if draw_xs is not None else None
        it_disp += k
        ra, rm = pack_rng(rng) if rng is not None else ({}, {})
        carry, drained = pipe.dispatch(carry, sharded, k, xs=xs,
                                       tag=(it_disp, ra, rm))
        yield from drained
    yield from pipe.flush()


def fit_steps(dataset, cfg: Optional[GdConfig] = None,
              eval_fn: Optional[Callable] = None, *,
              state: Optional[dict] = None):
    """Generator form of the training loop; the GdResult travels on
    StopIteration.  Each ``next()`` runs one GD iteration (``fuse_steps``
    1) or one fused chunk and yields a
    :class:`~repro_torch.systems.base.ChunkTick` whose ``snapshot()`` is
    the carry, history and MT19937 state at that boundary.  Passing a
    snapshot back as ``state`` — one of this package's or one the
    reference's ``fit_steps`` produced, serial or fused — resumes the fit
    exactly there."""
    cfg = cfg or GdConfig()
    if cfg.version not in VERSIONS:
        raise ValueError(f"unknown LIN version {cfg.version!r}; known: "
                         f"{VERSIONS}")
    system: System = dataset.system
    n, nf = dataset.n, dataset.n_features
    Xs, ys, mask = dataset.gd_view(cfg.version, cfg.frac_bits, cfg.x8_frac)
    local = system.named_kernel(grad_kernel_name(cfg),
                                lambda: build_local_grad(cfg))

    n_pc = Xs.shape[1]
    minibatch = bool(cfg.minibatch and cfg.minibatch < n_pc)
    # per-shard minibatches: n_shards == n_cores on PIM, 1 on a host
    n_eff = cfg.minibatch * system.n_shards if minibatch else n
    prepare, update = make_gd_step_fns(cfg)

    # the f32 update scale is computed in Python double, then cast
    w, b, s, it_done, history = initial_carry(
        nf, cfg.lr * (2.0 / n_eff), system.device, state)
    rng = np.random.RandomState(cfg.seed)
    if state is not None:
        rng = unpack_rng(state["arrays"], state["meta"]) or rng

    def record(it, wv, bv):
        if cfg.record_every and (it % cfg.record_every == 0
                                 or it == cfg.n_iters):
            metric = (eval_fn(wv.cpu().numpy(), float(bv)) if eval_fn
                      else None)
            history.append((it, metric))

    def snapshot_at(wv, bv, sv, it, ra, rm):
        """A snapshot bound to one boundary's state (under pipelining the
        live carry and rng have moved past it by drain time)."""
        def _snap():
            snap = carry_snapshot(wv, bv, sv, it, history)
            snap["arrays"].update(ra)
            snap["meta"].update(rm)
            return snap
        return _snap

    if cfg.fuse_steps > 1:
        select = draw_xs = None
        if minibatch:
            # each step's batch window starts at an offset the host drew
            # for the chunk from the serial loop's rng stream; the offset
            # is a device tensor, so one captured graph serves them all
            mb = cfg.minibatch

            def select(shards, off):
                window = off + torch.arange(mb, device=off.device)
                return tuple(torch.index_select(a, 1, window)
                             for a in shards)

            def draw_xs(k):
                return torch.tensor(
                    [rng.randint(0, n_pc - mb + 1) for _ in range(k)],
                    dtype=torch.int32).to(system.device)
        program = system.step_program(
            local, prepare, update,
            name=(f"lin.step/{grad_kernel_name(cfg)}"
                  + (f"/mb{cfg.minibatch}" if minibatch else "")),
            select=select)
        pipe = ChunkPipeline(program, max(1, int(cfg.pipeline_depth)))
        try:
            for bnd in gd_boundaries(pipe, (w, b, s), (Xs, ys, mask), cfg,
                                     it_done, draw_xs, rng):
                it_done, ra, rm = bnd.tag
                (w, b, s), _ = bnd.host()
                record(it_done, w, b)
                yield ChunkTick(bnd.k,
                                snapshot_at(w, b, s, it_done, ra, rm))
        finally:
            program.release()
    else:
        def _snapshot():
            return snapshot_at(w, b, s, it_done, *pack_rng(rng))()

        for it in range(it_done, cfg.n_iters):
            wq, bq = system.broadcast(prepare((w, b, s)))
            if minibatch:
                # SGD: every core samples the same per-core slice offset
                start = int(rng.randint(0, n_pc - cfg.minibatch + 1))
                sl = slice(start, start + cfg.minibatch)
                args = (Xs[:, sl], ys[:, sl], mask[:, sl])
            else:
                args = (Xs, ys, mask)
            partial = system.map_reduce(local, args, (wq, bq))
            (w, b, s), _ = update((w, b, s), partial)
            it_done = it + 1
            record(it_done, w, b)
            yield ChunkTick(1, _snapshot)
    return GdResult(w=w.cpu().numpy().astype(np.float32), b=float(b),
                    history=history, n_iters=cfg.n_iters)


def fit(dataset, cfg: Optional[GdConfig] = None,
        eval_fn: Optional[Callable] = None) -> GdResult:
    """Full training loop over a resident PimDataset: iterate (kernel ->
    reduce -> host update -> broadcast) until ``cfg.n_iters``."""
    return run_steps(fit_steps(dataset, cfg, eval_fn))
