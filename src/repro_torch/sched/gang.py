"""Fused gang stepping: K same-shape GD jobs in one kernel launch a step.

Port of ``repro.sched.gang``.  Gradient-descent jobs (LIN/LOG) that
share a dataset, a version and every shape-determining hyperparameter
differ only in their host-side update (the learning rate), so their
per-core gradients can be computed for all K lanes by one launch: the
whole gang advances with ONE ``map_reduce`` a step.  An 8-point
learning-rate sweep becomes one batched launch instead of eight, and on
a card the ``fx_matvec`` kernel reads the resident shards once for all
eight lanes (``kernels/quant_matmul.py``).

The reference vmaps the serial per-core function over a job axis.  The
port's serial kernels (``linreg.build_local_grad``,
``logreg.build_local_grad``) take lane weights ``[K, F]`` as they are and
return the partials with the cores axis first, ``{"gw": [C, K, F], "gb":
[C, K]}``, so ``map_reduce`` reduces over the cores as for a serial fit.
Each lane's gradient is what the serial kernel gives for that lane's
weights, and the lane update is the serial trainers' (two roundings,
``mul_round_f32``), so for the integer versions every lane is
bit-identical to a serial fit at its learning rate.

Step fusion composes with lane fusion: with ``fuse_steps > 1`` the gang
runs as a :class:`~repro_torch.systems.base.StepProgram` (one CUDA graph
replay a chunk on a card) whose carry is the lane weights, biases, the
active mask and the per-lane scales; the mask and the scales are copied
into the graph's static inputs at every replay, so a lane cancelled
between chunks freezes in the next one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..api.registry import FitResult, TrainerSpec, Workload
from ..core import linreg, logreg
from ..core.fixed_point import from_fixed, mul_round_f32
from ..core.linreg import GdResult, _quantize_weights, _reduced
from ..core.logreg import _gd_version_of


@dataclasses.dataclass(frozen=True)
class _GdFamily:
    """How one workload plugs into the fused step."""

    build_local: Callable          # (cfg, device) -> per-core kernel
    kernel_name: Callable          # cfg -> registry name
    grad_scale: Callable           # n_samples -> host update scale
    base_version: Callable         # version -> weight-quantization version


#: workloads eligible for fusion: the workload's registry name -> its GD
#: family.  LIN's update uses the 2/n MSE gradient scale, LOG's the 1/n
#: logistic scale (as their fit loops).  LOG's gang keeps the DPU Taylor
#: sigmoid for fp32 on every target, as the reference's does.
FUSABLE_WORKLOADS = {
    "linreg": _GdFamily(
        build_local=lambda cfg, device: linreg.build_local_grad(cfg),
        kernel_name=linreg.grad_kernel_name,
        grad_scale=lambda n: 2.0 / n,
        base_version=lambda v: v),
    "logreg": _GdFamily(
        build_local=logreg.build_local_grad,
        kernel_name=logreg.grad_kernel_name,
        grad_scale=lambda n: 1.0 / n,
        base_version=_gd_version_of),
}

#: spec params that may differ between fused lanes: the learning rate is
#: the sweep axis (host-side update only); the seed never reaches the
#: device for full-batch GD.
_LANE_LOCAL_PARAMS = ("lr", "seed")


def fuse_key(workload: Workload, spec: TrainerSpec):
    """Hashable fusion-eligibility key, or None when ``spec`` cannot fuse.

    Jobs fuse iff their keys are equal: same workload, version, and every
    shape/kernel-determining hyperparameter.  Minibatch SGD and history
    recording are excluded: per-lane minibatch offsets would need
    per-lane shard slices (no longer one batched launch), and history
    hooks run per lane anyway.
    """
    if workload.name not in FUSABLE_WORKLOADS:
        return None
    p = dict(spec.params)
    if p.get("minibatch") or p.get("record_every"):
        return None
    shared = tuple(sorted((k, v) for k, v in p.items()
                          if k not in _LANE_LOCAL_PARAMS))
    return (workload.name, spec.version, shared)


class FusedGdSweep:
    """K gradient-descent jobs advanced by one batched launch per step.

    The lane state lives on the system's device: weights ``W [K, F]``,
    biases ``B [K]`` (float32, as the serial trainers' carry), the active
    mask and the per-lane float32 update scales.  Per step the lanes'
    quantized weights are broadcast once and the per-core kernel produces
    every lane's gradient in a single ``map_reduce``.
    """

    def __init__(self, workload: Workload, specs: Sequence[TrainerSpec],
                 dataset):
        keys = {fuse_key(workload, s) for s in specs}
        if len(keys) != 1 or None in keys:
            raise ValueError(
                f"specs are not fusable together (keys {keys}); fuse "
                f"only jobs with identical fuse_key")
        self.workload = workload
        self.specs = list(specs)
        self.dataset = dataset
        self.system = dataset.system
        family = FUSABLE_WORKLOADS[workload.name]
        self.cfgs = [workload._config(s) for s in self.specs]
        cfg0 = self.cfgs[0]
        # weight quantization runs at the collapsed data precision, as in
        # logreg.fit (LUT variants quantize like their int32/hyb base)
        self.base_cfg = dataclasses.replace(
            cfg0, version=family.base_version(cfg0.version))
        self.scale = family.grad_scale(dataset.n)
        self.n_iters = cfg0.n_iters
        self.it = 0
        self.k = len(self.specs)
        dev = self.system.device
        self.W = torch.zeros((self.k, dataset.n_features),
                             dtype=torch.float32, device=dev)
        self.B = torch.zeros(self.k, dtype=torch.float32, device=dev)
        self.active = [True] * self.k
        self._act = torch.ones(self.k, dtype=torch.bool, device=dev)
        #: per-lane float32 update scale, the float64 product rounded
        #: once, exactly as the serial trainers round theirs
        self._lane_scale = torch.from_numpy(np.asarray(
            [c.lr * self.scale for c in self.cfgs], np.float32)).to(dev)

        self.view = dataset.gd_view(cfg0.version, cfg0.frac_bits,
                                    cfg0.x8_frac)
        self.kernel = self.system.named_kernel(
            f"sched.fused/K{self.k}/{family.kernel_name(cfg0)}",
            lambda: family.build_local(cfg0, dev))
        self._prepare, self._update = self._lane_step_fns()

        # step fusion x lane fusion: one chunk advances all K lanes k
        # iterations
        self.fuse_steps = max(1, int(getattr(cfg0, "fuse_steps", 1)))
        self._program = None
        if self.fuse_steps > 1:
            lrs = ",".join(repr(c.lr) for c in self.cfgs)
            self._program = self.system.step_program(
                self.kernel, self._prepare, self._update,
                name=(f"sched.fusedstep/K{self.k}"
                      f"/{family.kernel_name(cfg0)}/lr{lrs}"
                      f"/n{dataset.n}"))

    @property
    def done(self) -> bool:
        return self.it >= self.n_iters or not any(self.active)

    def _lane_step_fns(self):
        """The lane-batched (prepare, update) pair: each lane's row is the
        serial trainers' step (``linreg.make_gd_step_fns``): the same
        elementwise quantize and dequantize, the same two-rounding update;
        an inactive lane keeps its weights."""
        cfg = self.base_cfg
        f = cfg.frac_bits
        fp32 = cfg.version == "fp32"

        def prepare(carry):
            W, B, _, _ = carry
            return (W, B) if fp32 else _quantize_weights(cfg, W, B)

        def update(carry, reduced):
            W, B, act, ls = carry
            if fp32:
                GW = _reduced(reduced["gw"], torch.float32, W.device)
                GB = _reduced(reduced["gb"], torch.float32, W.device)
            else:
                GW = from_fixed(_reduced(reduced["gw"], torch.int32,
                                         W.device), f)
                GB = from_fixed(_reduced(reduced["gb"], torch.int32,
                                         W.device), f)
            W = torch.where(act[:, None], W - mul_round_f32(ls[:, None], GW),
                            W)
            B = torch.where(act, B - mul_round_f32(ls, GB), B)
            return (W, B, act, ls), None
        return prepare, update

    def step(self) -> bool:
        """Advance every active lane one GD iteration (or, with
        ``fuse_steps`` set, one chunk of iterations in one launch); True
        when done."""
        if self.done:
            return True
        sharded = tuple(self.view)
        # the gang's own mask and scales each step: a replay copies them
        # into the graph's static inputs, so a cancellation reaches it
        carry = (self.W, self.B, self._act, self._lane_scale)
        if self._program is not None:
            k = min(self.fuse_steps, self.n_iters - self.it)
            (W, B, _, _), _ = self._program.run(carry, sharded, k)
        else:
            k = 1
            replicated = self.system.broadcast(self._prepare(carry))
            partial = self.system.map_reduce(self.kernel, sharded,
                                             tuple(replicated))
            (W, B, _, _), _ = self._update(carry, partial)
        self.it += k
        if self._program is not None and self.done:
            # the last chunk's carry is the graph's output: keep copies
            # and drop the program's graphs, as a fused fit does
            W, B = W.clone(), B.clone()
            self._program.release()
        self.W, self.B = W, B
        return self.done

    def deactivate(self, lane: int) -> None:
        """Stop updating a cancelled lane (the batched kernel still
        computes its gradient, since one launch is all-or-nothing, but
        the lane's weights freeze and it reports no result)."""
        self.active[lane] = False
        self._act[lane] = False

    def lane_state(self, lane: int) -> dict:
        """One lane's chunk-boundary snapshot, in the schema the serial GD
        trainers' ``ChunkTick``s emit, so a preempted lane resumes as an
        ordinary job through ``fit_steps(state=...)``; lanes are
        bit-identical to serial fits, so the resumed trajectory is too.
        Fused specs never record history or draw minibatches, so the
        snapshot carries neither."""
        return {"arrays": {"w": self.W[lane].cpu().numpy().copy(),
                           "b": self.B[lane].cpu().numpy().copy(),
                           "s": self._lane_scale[lane].cpu().numpy().copy()},
                "meta": {"iters": int(self.it), "history": []}}

    def result(self, lane: int) -> Optional[FitResult]:
        if not self.active[lane]:
            return None
        r = GdResult(w=self.W[lane].cpu().numpy().copy(),
                     b=float(self.B[lane]), history=[], n_iters=self.it)
        return FitResult(self.specs[lane], r,
                         {"coef_": r.w, "intercept_": r.b})


def plan_fusion(workload: Workload, specs: Sequence[TrainerSpec]
                ) -> List[List[int]]:
    """Partition spec indices into fusable gangs (singletons stay solo).

    Grouping preserves submission order inside each gang; specs whose
    ``fuse_key`` is None each get their own group.
    """
    groups: dict = {}
    order: List[List[int]] = []
    for i, spec in enumerate(specs):
        key = fuse_key(workload, spec)
        if key is None:
            order.append([i])
            continue
        if key not in groups:
            groups[key] = []
            order.append(groups[key])
        groups[key].append(i)
    return order
