"""Rank bodies of the port's distributed tests, run by
``repro_torch.launch.mesh.spawn_ranks``.

A spawned rank imports the module that holds its body; this one imports
neither JAX nor the JAX package, so no rank does.  Each body takes numpy
inputs that the test's main process made and returns numpy results (or
plain Python values) for the main process to hold against the reference.
"""
import dataclasses
import hashlib
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import collectives
from repro_torch.distributed.act_sharding import constrain, use_mesh
from repro_torch.distributed.pipeline import pipeline_apply
from repro_torch.distributed.sharding import place
from repro_torch.launch.mesh import describe, make_mesh
from repro_torch.optim.grad_compression import (compress_decompress_psum,
                                                ef_compress_psum,
                                                init_error_buffers)

#: the pipeline oracle's stage count (tests/test_pipeline.py)
PIPE_STAGES = 4


def _np(t: torch.Tensor) -> np.ndarray:
    """A host copy; bf16 as float32 (numpy has no bfloat16)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _tensor(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device=device,
                                            dtype=getattr(torch, dtype))


def compress_cases(cases: dict, group, index: int, world: int,
                   device="cpu") -> dict:
    """Each case ``(g [W, ...], err [W, ...], dtype)`` through both
    compress collectives on this rank's row ``index``."""
    out = {}
    for name, (g, err, dtype) in cases.items():
        tg = _tensor(g[index], dtype, device)
        total = compress_decompress_psum(tg, group)
        mean, new_err = ef_compress_psum(
            tg, _tensor(err[index], "float32", device), group, world)
        out[name] = {"psum": _np(total), "mean": _np(mean),
                     "err": _np(new_err)}
    return out


def distributed_body(rank: int, inputs: dict) -> dict:
    """The collectives, placements and pipeline on 8 ranks: a (2, 4)
    ("pod", "data") mesh, a (2, 2, 2) ("pod", "data", "model") mesh, its
    (2, 2) ("data", "model") submeshes and the world."""
    pod4 = make_mesh((2, 4), ("pod", "data"), "cpu")
    cube = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    coord = dict(zip(pod4.mesh_dim_names, pod4.get_coordinate()))
    res = {"describe": [describe(pod4), describe(cube)],
           "coord": cube.get_coordinate(), "jax": "jax" in sys.modules}

    # compression over a 4-rank "data" group (each pod one group on the
    # same rows) and over all 8 ranks
    res["compress4"] = compress_cases(inputs["compress4"],
                                      pod4.get_group("data"),
                                      coord["data"], 4)
    res["compress8"] = compress_cases(inputs["compress8"], None, rank, 8)

    # the hierarchical sum on (2, 4): rank r holds rows [4r, 4r + 4)
    collectives.reset_traffic()
    for name, x in inputs["hier"].items():
        local = torch.from_numpy(x[rank])
        res[f"hier_{name}"] = _np(collectives.hierarchical_psum(local, pod4))
        res[f"hmean_{name}"] = _np(collectives.hierarchical_pmean(local,
                                                                  pod4))
    res["traffic"] = dict(collectives.traffic)

    # placements on (2, 2, 2) and on its (2, 2) ("data", "model") submesh
    full = torch.from_numpy(inputs["place"])
    res["placed"] = [_np(place(full, cube, spec).to_local())
                     for spec in inputs["place_specs"]]
    square = cube["data", "model"]
    res["square_coord"] = square.get_coordinate()
    res["square_placed"] = [_np(place(full, square, spec).to_local())
                            for spec in inputs["square_specs"]]
    with use_mesh(cube):
        replicated = place(full, cube, ())
        res["constrained"] = _np(constrain(replicated, "btd").to_local())
        res["plain_unchanged"] = constrain(full, "btd") is full
    res["no_mesh_unchanged"] = constrain(replicated, "btd") is replicated

    # the pipeline: 4 stages along "data", one pipeline a pod
    pipe = inputs["pipe"]
    stage, per = coord["data"], pipe["w"].shape[0] // PIPE_STAGES
    params = {k: torch.from_numpy(pipe[k][stage * per:(stage + 1) * per])
              .requires_grad_() for k in ("w", "b")}

    def block_fn(p, h):
        for w, b in zip(p["w"], p["b"]):
            h = torch.tanh(h @ w + b)
        return h
    xs = torch.from_numpy(pipe["xs"])
    out = pipeline_apply(pod4, "data", block_fn, params, xs)
    (out ** 2).sum().backward()
    res["pipe_out"] = _np(out)
    res["pipe_grads"] = {k: _np(p.grad) for k, p in params.items()}
    with torch.no_grad():
        res["pipe_out_no_grad"] = _np(pipeline_apply(pod4, "data", block_fn,
                                                     params, xs))
    return res


def failing_body(rank: int) -> None:
    """Rank 1 raises while rank 0 waits for it in an all-reduce."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    time.sleep(0.5)
    dist.all_reduce(torch.ones(4))


def sleeping_body(rank: int) -> None:
    time.sleep(600)


# -- the data-parallel trainer ------------------------------------------------

def _digest(params) -> str:
    h = hashlib.sha256()
    for name, p in params.named_parameters():
        h.update(name.encode())
        h.update(p.detach().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _scales(model, params, err: dict, batch: dict, mesh) -> dict:
    """Each leaf's compress scale for this step: max |g + err| over its
    reference leaf's layers and every rank, over 127."""
    from repro_torch.models.api import stacked_groups
    from repro_torch.train import loop
    _, raw = loop.value_and_grad(model, params, loop.local_rows(batch, mesh))
    scales = {}
    for names in stacked_groups(model.cfg, raw):
        amax = max(torch.max(torch.abs(raw[n].float() + err[n]))
                   for n in names)
        collectives.all_reduce(amax, op=dist.ReduceOp.MAX)
        scales.update(dict.fromkeys(
            names, float(torch.clamp(amax, min=1e-12)) / 127.0))
    return scales


def dp_train_body(rank: int, arch: str, ref_params: dict, runs: dict,
                  batch: int, seq: int, steps: int, lr: float) -> dict:
    """The port's ``make_dp_train_step`` on 4 ranks, from the reference's
    parameters: each run ``name: (mesh shape, axes, compress)`` takes
    ``steps`` steps on fresh seeded MarkovCorpus batches.  Returns each
    run's losses, grad norms, a digest of the params after every step
    (equal on every rank), final params, what the last step handed to
    collectives, and the compressed run's step-1 gradients, scales and
    error buffers."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.tokens import MarkovCorpus
    from repro_torch.models.api import Model, params_from_jax
    from repro_torch.optim.adam import AdamW
    from repro_torch.train import loop

    cfg = get_config(arch).reduced()
    model = Model(cfg, device="cpu")
    out = {"jax": "jax" in sys.modules}
    for name, (shape, axes, compress) in runs.items():
        mesh = make_mesh(shape, axes, "cpu")
        params = params_from_jax(cfg, ref_params, device="cpu").trainable_()
        opt = AdamW(lr=lr)
        opt_state, err = opt.init(params), init_error_buffers(params)
        corpus = MarkovCorpus(cfg.vocab_size, seed=0)
        step = loop.make_dp_train_step(model, opt, mesh, compress=compress)
        run = {"loss": [], "grad_norm": [], "digest": []}
        for i in range(steps):
            b = corpus.batch(batch, seq)
            if compress and i == 0:
                (_, grads), _ = loop._dp_call(mesh, model, params, err, b,
                                              True)
                run["step1_grads"] = {n: _np(g) for n, g in grads.items()}
                run["step1_scales"] = _scales(model, params, err, b, mesh)
            collectives.reset_traffic()
            params, opt_state, err, m = step(params, opt_state, err, b)
            run["traffic"] = dict(collectives.traffic)
            if compress and i == 0:
                run["err1"] = {n: _np(e) for n, e in err.items()}
            run["loss"].append(float(m["loss"]))
            run["grad_norm"].append(float(m["grad_norm"]))
            run["digest"].append(_digest(params))
        run["params"] = {n: _np(p) for n, p in params.named_parameters()}
        out[name] = run
    return out


# -- on the card: two gloo ranks sharing it --------------------------------------

def card_compress_body(rank: int, cases: dict) -> dict:
    """Both compress collectives on CUDA tensors, then on CPU tensors, in
    one gloo group."""
    world = dist.get_world_size()
    return {device: compress_cases(cases, None, rank, world, device)
            for device in ("cuda", "cpu")}


def card_dp_step_body(rank: int, arch: str, batch: int, seq: int) -> dict:
    """One flat ``make_dp_train_step`` step (SGD, so params move by the
    reduced gradient) of reduced ``arch`` with remat on, exact and
    compressed, on the card and on the CPU from the same weights; the
    compress scales, and the card's launch counts (of the step alone)."""
    import copy
    from repro_torch.configs.base import get_config
    from repro_torch.data.tokens import MarkovCorpus
    from repro_torch.kernels import dispatch
    from repro_torch.models.api import Model
    from repro_torch.optim.adam import SGD
    from repro_torch.train import loop

    cfg = get_config(arch).reduced(remat="full")
    weights = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    b = MarkovCorpus(cfg.vocab_size, seed=0).batch(batch, seq)
    out = {}
    for device in ("cuda", "cpu"):
        mesh = make_mesh((dist.get_world_size(),), ("data",), device)
        model = Model(cfg, device=device)
        for compress in (False, True):
            params = copy.deepcopy(weights).to(device).trainable_()
            opt = SGD(lr=0.1)
            err = init_error_buffers(params)
            scales = _scales(model, params, err, b, mesh)
            dispatch.reset_launch_counts()
            params, _, err, m = loop.make_dp_train_step(
                model, opt, mesh, compress=compress)(
                    params, opt.init(params), err, b)
            out[device, compress] = {
                "scales": scales,
                "loss": float(m["loss"]),
                "params": {n: _np(p) for n, p in params.named_parameters()},
                "err": {n: _np(e) for n, e in err.items()},
                "counts": dict(dispatch.launch_counts),
                "digest": _digest(params.to("cpu"))}
    return out


# -- the PIM system over ranks (PimConfig(backend="shard_map")) ----------------

def _state_digest(arrays: dict) -> str:
    """A digest of a model state's host arrays (sorted by name)."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        a = np.ascontiguousarray(np.asarray(arrays[name]))
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _innermost(gen):
    while getattr(gen, "gi_yieldfrom", None) is not None:
        gen = gen.gi_yieldfrom
    return gen


def _step_state(gen, tick) -> dict:
    """The model state a fit holds after a step: its snapshot's arrays,
    or, for a tree (not resumable), the arrays of the tree grown so far."""
    if getattr(tick, "resumable", False):
        return tick.snapshot()["arrays"]
    local = _innermost(gen).gi_frame.f_locals
    return {k: local[k] for k in ("feature", "threshold", "left", "right",
                                  "leaf_class", "depth")}


def pim_fit(system, data: dict, case: dict, state=None, stop_after=None):
    """One fit of ``case`` (workload, version, data key, params) on
    ``system`` through its workload's ``fit_steps``, the digest of the
    model state after every step, and its result; ``stop_after`` steps
    ends it early with the snapshot there instead."""
    from repro_torch.api import get_workload
    X, y = data[case["data"]]
    wl = get_workload(case["workload"])
    gen = wl.fit_steps(system.put(X, y),
                       wl.spec(case["version"], **case["params"]),
                       **({} if state is None else {"state": state}))
    digests, steps = [], 0
    while True:
        try:
            tick = next(gen)
        except StopIteration as stop:
            res = stop.value
            return {"model": res.model, "digests": digests}
        steps += int(tick)
        digests.append(_state_digest(_step_state(gen, tick)))
        if stop_after is not None and steps >= stop_after:
            snap = tick.snapshot()
            gen.close()
            return {"snapshot": snap, "digests": digests}


def _job_sig(h) -> dict:
    """A job handle's wall-clock-free record (and its result's model)."""
    return {"name": h.name, "workload": h.workload.name,
            "version": h.spec.version, "state": h.state.value,
            "steps": h.steps, "iters": h.iters, "cores": h.n_cores,
            "lease": None if h.lease is None else (h.lease.start,
                                                   h.lease.n_cores),
            "transfer": (None if h.transfer is None
                         else dataclasses.asdict(h.transfer)),
            "modeled_seconds": h.modeled_seconds,
            "has_deadline": h.deadline is not None,
            "deadline_missed": h.deadline_missed,
            "model": None if h.result is None else h.result.model}


def pim_body(rank: int, data: dict, cases: dict, device: str = "cpu"
             ) -> dict:
    """Every case of ``cases`` on this rank, on ``device``, in order; each
    returns host data, with the kernel launches and chunk-graph replays
    it made.  A case is one of:

    * ``{"kind": "fit", "n_cores", "reduce", ...}``: a fit on a
      ``backend="shard_map"`` system (its result, per-step digests,
      ``TransferStats``; with ``"state"`` it resumes from a snapshot,
      with ``"stop_after"`` it returns the snapshot at that step);
    * ``{"kind": "slice", "n_cores", "lease": (start, n), "fits"}``: the
      fits on a slice of such a system, with the slice's and the parent's
      ``TransferStats``;
    * ``{"kind": "manifest", "doc"}``: ``run_manifest``, each job's
      record;
    * ``{"kind": "program", "n_cores", "k"}``: one k-step chunk of a
      ``StepProgram`` that sums every core's rows into an int32 carry
      (the carry and the program's ``counts``; ``"backend": "vmap"``
      runs it in one process).
    """
    from repro_torch.api import make_system
    from repro_torch.kernels import dispatch
    from repro_torch.sched.allocator import BankLease
    from repro_torch.sched.manifest import run_manifest

    out = {"jax": "jax" in sys.modules}
    for name, case in cases.items():
        collectives.reset_traffic()
        dispatch.reset_launch_counts()
        if case["kind"] == "fit":
            system = make_system("pim", n_cores=case["n_cores"],
                                 reduce=case["reduce"], device=device,
                                 backend="shard_map")
            rec = pim_fit(system, data, case, case.get("state"),
                          case.get("stop_after"))
            rec["stats"] = dataclasses.asdict(system.stats)
            rec["block"] = (system.ranks.start, system.ranks.stop)
        elif case["kind"] == "slice":
            parent = make_system("pim", n_cores=case["n_cores"],
                                 device=device, backend="shard_map")
            sl = parent.slice(BankLease(*case["lease"]))
            rec = {"fits": {k: pim_fit(sl, data, c)
                            for k, c in case["fits"].items()},
                   "block": (sl.ranks.start, sl.ranks.stop),
                   "stats": dataclasses.asdict(sl.stats),
                   "parent_stats": dataclasses.asdict(parent.stats)}
        elif case["kind"] == "program":
            system = make_system("pim", n_cores=case["n_cores"],
                                 device=device,
                                 backend=case.get("backend", "shard_map"))
            rows = system.shard_rows(np.arange(
                4 * case["n_cores"], dtype=np.int32).reshape(-1, 2))
            program = system.step_program(
                lambda x: {"s": torch.sum(x, dim=1, dtype=torch.int32)},
                lambda carry: (),
                lambda carry, red: (carry * 3 + red["s"], None),
                name="sum-rows")
            carry, _ = program.run(
                torch.zeros(2, dtype=torch.int32, device=system.device),
                (rows,), case["k"])
            rec = {"carry": carry.cpu().numpy(),
                   "counts": dict(program.counts),
                   "stats": dataclasses.asdict(system.stats)}
        else:
            sched, handles = run_manifest(case["doc"], device=device)
            rec = {"jobs": [_job_sig(h) for h in handles],
                   "backend": sched.system.config.backend,
                   "block": (sched.system.ranks.start,
                             sched.system.ranks.stop)}
        rec["traffic"] = dict(collectives.traffic)
        rec["launches"] = dict(dispatch.launch_counts)
        rec["replays"] = dict(dispatch.graph_replays)
        out[name] = rec
    return out


# -- the dense LM on sharded parameters (tests/test_torch_tp.py) --------------

def _full(t) -> np.ndarray:
    """A copy of a DTensor's whole value (its partial sums reduced) on
    the host (a replicated one's full_tensor is its local shard)."""
    from repro_torch.distributed.tp import full_tensor
    return np.array(_np(full_tensor(t)))


class QuantRecorder:
    """Wraps ``models.quantized.quant_dense`` to keep, for its first
    ``keep`` calls, the int8 activations and the int32 ``int_matmul``
    product, whole (``calls``), and the float input and int8 weight,
    whole (``inputs``)."""

    def __init__(self, keep: int = 6):
        from repro_torch.models import quantized
        self.module, self.orig, self.keep = quantized, quantized.quant_dense, keep
        self.calls: list = []
        self.inputs: list = []

    def __enter__(self):
        self.module.quant_dense = self
        return self

    def __exit__(self, *exc):
        self.module.quant_dense = self.orig

    def __call__(self, x, w_q, w_scale):
        from repro_torch.core.quantization import symmetric_quantize
        from repro_torch.kernels import dispatch
        if len(self.calls) < self.keep:
            x_q, _ = symmetric_quantize(x.reshape(-1, x.shape[-1]), bits=8)
            acc = dispatch.launch("int_matmul", x_q, w_q)
            self.calls.append((_full(x_q), _full(acc)))
            self.inputs.append((_full(x.reshape(-1, x.shape[-1])),
                                _full(w_q)))
        return self.orig(x, w_q, w_scale)


def lm_serve_outputs(model, params, toks: np.ndarray, prompt: int,
                     max_seq: int, extras=None) -> dict:
    """The forward's logits over ``toks``, prefill's over its first
    ``prompt`` tokens and one decode step for each later token, whole,
    and the int8 pieces of the quantized linears' first calls; the
    forward's and prefill's batches hold ``extras`` beside the tokens
    (the VLM's vision states, whisper's frames)."""
    out, extras = {}, extras or {}
    with torch.no_grad(), QuantRecorder() as rec:
        out["forward"] = _full(model.forward(params, {"tokens": toks,
                                                      **extras}))
        logits, cache = model.prefill(
            params, {"tokens": toks[:, :prompt], **extras}, max_seq=max_seq)
        out["prefill"] = _full(logits)
        for i in range(prompt, toks.shape[1]):
            logits, cache = model.decode_step(params, toks[:, i:i + 1],
                                              cache)
            out[f"decode{i - prompt}"] = _full(logits)
    out["quant"], out["quant_inputs"] = rec.calls, rec.inputs
    return out


def lm_train_outputs(model, params, batch: dict, steps: int, lr: float,
                     mesh=None) -> dict:
    """``steps`` AdamW steps (``make_train_step``) on ``batch``: losses,
    grad norms; with a mesh the moments laid out by ZeRO-1."""
    from repro_torch.distributed.sharding import (opt_state_shardings,
                                                  place_opt_state)
    from repro_torch.optim.adam import AdamW
    from repro_torch.train.loop import make_train_step
    params.trainable_()
    opt = AdamW(lr=lr)
    state = opt.init(params)
    if mesh is not None:
        state = place_opt_state(state, mesh, opt_state_shardings(mesh,
                                                                 params))
    step = make_train_step(model, opt)
    losses, norms = [], []
    for _ in range(steps):
        params, state, m = step(params, state, batch)
        losses.append(float(_full(m["loss"])))
        norms.append(float(_full(m["grad_norm"])))
    return {"loss": losses, "grad_norm": norms,
            "m_placements": [str(p) for p in next(iter(
                state.m.values())).placements] if mesh is not None else []}


def tp_body(rank: int, arch: str, tree: dict, shape: tuple, toks, prompt,
            max_seq, train_batch, steps, lr, serve=True, save_dir=None,
            restore_dir=None) -> dict:
    """The dense LM of ``arch`` (reduced) from the reference's ``tree`` on
    a ``shape`` ("data", "model") mesh of gloo ranks: with ``serve`` the
    serving outputs with quantize_dense off and on; ``steps`` train steps;
    with ``save_dir`` the trained params saved (as step 1); with
    ``restore_dir`` that step's params restored onto this mesh, then one
    more step."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import Model, params_from_jax
    from repro_torch.train import checkpoint
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    res = {"jax": "jax" in sys.modules}
    with use_mesh(mesh):
        for quant in ((False, True) if serve else ()):
            cfg = get_config(arch).reduced(quantize_dense=quant)
            model = Model(cfg, "cpu")
            params = model.place(params_from_jax(cfg, tree, "cpu"), mesh)
            res[f"serve/{quant}"] = lm_serve_outputs(model, params, toks,
                                                     prompt, max_seq)
            res["up_local"] = tuple(
                params["layers"][0]["mlp"]["up"].to_local().shape)
        cfg = get_config(arch).reduced()
        model = Model(cfg, "cpu")
        params = model.place(params_from_jax(cfg, tree, "cpu"), mesh)
        res["train"] = lm_train_outputs(model, params, train_batch, steps,
                                        lr, mesh)
        if save_dir is not None:
            checkpoint.save(save_dir, 1, params)
            res["saved"] = {n: _full(p) for n, p in params.named_parameters()}
        if restore_dir is not None:
            params.load_(checkpoint.restore(restore_dir, 1, params))
            res["restored"] = {n: _full(p)
                               for n, p in params.named_parameters()}
            res["after_restore"] = lm_train_outputs(model, params,
                                                    train_batch, 1, lr, mesh)
    return res


def card_tp_kernels_body(rank: int) -> dict:
    """``mha`` (bf16 and float32) and ``int_matmul`` (column- and
    row-parallel) on DTensor shards of a (1, 2) mesh on the card, whole
    again, against the plain versions and the kernels on the whole
    operands; the launches counted and the local shapes they ran at."""
    from repro_torch.distributed.tp import full_tensor
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import mha_cuda, mha_plain
    from repro_torch.kernels.quant_matmul import (int_matmul_cuda,
                                                  int_matmul_plain)
    mesh = make_mesh((1, 2), ("data", "model"), "cuda")
    rng = np.random.RandomState(0)
    heads = (None, "model", None, None)
    out = {}
    for dtype in ("bfloat16", "float32"):
        q, k, v = (_tensor(rng.normal(0, 1, (2, h, 96, 64)), dtype, "cuda")
                   for h in (16, 8, 8))
        dispatch.reset_launch_counts()
        got = dispatch.launch("mha", *(place(t, mesh, heads)
                                       for t in (q, k, v)), causal=True)
        out[f"mha/{dtype}/counts"] = dict(dispatch.launch_counts)
        out[f"mha/{dtype}/placements"] = [str(p) for p in got.placements]
        got = full_tensor(got)
        out[f"mha/{dtype}/kernel_err"] = float(
            (got.float() - mha_cuda(q, k, v, causal=True).float())
            .abs().max())
        out[f"mha/{dtype}/plain_err"] = float(
            (got.float() - mha_plain(q.cpu(), k.cpu(), v.cpu(), causal=True)
             .float().cuda()).abs().max())
    a = torch.from_numpy(rng.randint(-128, 128, (40, 512), dtype=np.int8))
    b = torch.from_numpy(rng.randint(-128, 128, (512, 256), dtype=np.int8))
    want = int_matmul_plain(a, b)
    a, b = a.cuda(), b.cuda()
    for name, sa, sb in (("column", (None, None), (None, "model")),
                         ("row", (None, "model"), ("model", None))):
        dispatch.reset_launch_counts()
        got = dispatch.launch("int_matmul", place(a, mesh, sa),
                              place(b, mesh, sb))
        out[f"int_matmul/{name}/counts"] = dict(dispatch.launch_counts)
        out[f"int_matmul/{name}/local"] = tuple(got.to_local().shape)
        got = full_tensor(got).cpu()
        out[f"int_matmul/{name}/equal"] = bool(torch.equal(got, want))
        out[f"int_matmul/{name}/kernel_equal"] = bool(torch.equal(
            got, int_matmul_cuda(a, b).cpu()))
    return out


# -- the MoE on sharded parameters (tests/test_torch_moe_tp.py) ---------------

class RouteRecorder:
    """Wraps the MoE routers (one process's ``moe._route``, a rank's
    ``moe._route_sharded``) to keep, for every call, the expert ids
    ``[tokens, k]`` of the tokens it routes and which (token, slot) pairs
    its capacity keeps (a rank: its own rows')."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.calls = moe, []

    def __enter__(self):
        self.orig = (self.moe._route, self.moe._route_sharded)

        def one(params, spec, xg):
            out = self.orig[0](params, spec, xg)
            cap = self.moe._capacity(spec, xg.shape[0] * xg.shape[1])[2]
            self.keep(out[1], out[2] < cap)
            return out

        def ranks(params, spec, x, sp):
            out = self.orig[1](params, spec, x, sp)
            self.keep(out[1], (out[2] >= 0) & (out[2] < sp.cap))
            return out
        self.moe._route, self.moe._route_sharded = one, ranks
        return self

    def __exit__(self, *exc):
        self.moe._route, self.moe._route_sharded = self.orig

    def keep(self, gidx, kept) -> None:
        k = gidx.shape[-1]
        self.calls.append((_np(gidx.reshape(-1, k)),
                           _np(kept.reshape(-1, k))))


def moe_serve_outputs(model, params, toks: np.ndarray, prompt: int,
                      max_seq: int) -> dict:
    """:func:`lm_serve_outputs` and the forward's aux loss."""
    from repro_torch.models.transformer import lm_forward
    out = lm_serve_outputs(model, params, toks, prompt, max_seq)
    with torch.no_grad():
        _, aux = lm_forward(model.cfg, params, model._on_device(toks))
    out["aux"] = float(_np(aux))
    return out


def moe_routes(model, params, toks: np.ndarray, prompt: int,
               max_seq: int) -> list:
    """The routers' calls of a prefill over ``toks[:, :prompt]`` and one
    decode step a later token."""
    with torch.no_grad(), RouteRecorder() as rec:
        _, cache = model.prefill(params, {"tokens": toks[:, :prompt]},
                                 max_seq=max_seq)
        for i in range(prompt, toks.shape[1]):
            _, cache = model.decode_step(params, toks[:, i:i + 1], cache)
    return rec.calls


def moe_tp_body(rank: int, cases: dict, shape: tuple, toks, prompt, max_seq,
                train_batch, steps, lr, save_dir=None,
                restore_dir=None, timeout: float = 300.0) -> dict:
    """Each MoE arch of ``cases`` (name -> (reduced overrides, the
    reference's tree, quantize_dense modes, drop-case overrides)) on a
    ``shape`` ("data", "model") mesh of gloo ranks: serving in each mode,
    the routers' keep sets at the drop case's capacity, ``steps`` AdamW
    steps; with ``save_dir`` the trained params saved under the arch's
    name (as step 1); with ``restore_dir`` that step restored onto this
    mesh, once another group has published it (``timeout`` seconds)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import Model, params_from_jax
    from repro_torch.train import checkpoint
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    res = {"jax": "jax" in sys.modules}
    with use_mesh(mesh):
        for arch, (over, tree, quants, drop) in cases.items():
            out = res[arch] = {}
            for quant in quants:
                cfg = get_config(arch).reduced(quantize_dense=quant, **over)
                model = Model(cfg, "cpu")
                params = model.place(params_from_jax(cfg, tree, "cpu"), mesh)
                out[f"serve/{quant}"] = moe_serve_outputs(
                    model, params, toks, prompt, max_seq)
            gen = torch.Generator().manual_seed(3)
            drawn = model.place(model.init(gen), mesh)
            placed = dict(model.init_placed(
                mesh, torch.Generator().manual_seed(3)).named_parameters())
            out["init_placed"] = [
                n for n, p in drawn.named_parameters()
                if p.placements != placed[n].placements
                or not torch.equal(p.to_local(), placed[n].to_local())]
            moe = params["layers"][0]["moe"]
            out["local"] = {n: (tuple(moe[n].to_local().shape),
                                [str(p) for p in moe[n].placements])
                            for n in ("router", "w_gate", "w_down")}
            cfg = get_config(arch).reduced(**over, **drop)
            model = Model(cfg, "cpu")
            params = model.place(params_from_jax(cfg, tree, "cpu"), mesh)
            out["routes"] = moe_routes(model, params, toks, prompt, max_seq)
            cfg = get_config(arch).reduced(**over)
            model = Model(cfg, "cpu")
            params = model.place(params_from_jax(cfg, tree, "cpu"), mesh)
            out["train"] = lm_train_outputs(model, params, train_batch,
                                            steps, lr, mesh)
            path = None if save_dir is None else f"{save_dir}/{arch}"
            if path is not None:
                checkpoint.save(path, 1, params)
                out["saved"] = {n: _full(p)
                                for n, p in params.named_parameters()}
            if restore_dir is not None:
                path = f"{restore_dir}/{arch}"
                deadline = time.monotonic() + timeout
                while checkpoint.latest_step(path) != 1:
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"no checkpoint under {path}")
                    time.sleep(0.2)
                params.load_(checkpoint.restore(path, 1, params))
                out["restored"] = {n: _full(p)
                                   for n, p in params.named_parameters()}
                out["restored_placements"] = {
                    n: [str(q) for q in p.placements]
                    for n, p in params.named_parameters()}
    return res


def card_moe_body(rank: int) -> dict:
    """The expert-parallel product (``tp.ExpertMatmul``: experts over
    "model" on a (1, 2) mesh, rows over "data" on a (2, 1) one) and the
    FSDP gather (``tp.FsdpGather``, a weight split over "data"), forward
    and backward, on CUDA tensors and on the same ranks' CPU tensors: the
    outputs and gradients whole, on the host."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from repro_torch.distributed.tp import ExpertMatmul, FsdpGather
    rng = np.random.RandomState(1)
    x = rng.normal(0, 1, (8, 96, 64)).astype(np.float32)   # [E, T, d]
    w = rng.normal(0, 1, (8, 64, 32)).astype(np.float32)   # [E, d, f]
    gy = rng.normal(0, 1, (8, 96, 32)).astype(np.float32)
    out = {}
    for device in ("cuda", "cpu"):
        for name, shape, xs, ws in (
                ("ep", (1, 2), ("model", None, None), ("model", None, None)),
                ("rows", (2, 1), (None, "data", None), ())):
            mesh = make_mesh(shape, ("data", "model"), device)
            xd = place(torch.from_numpy(x).to(device), mesh, xs)
            wd = place(torch.from_numpy(w).to(device), mesh, ws) \
                .requires_grad_(True)
            xd.requires_grad_(True)
            y = ExpertMatmul.apply(xd, wd)
            y.backward(DTensor.from_local(
                torch.from_numpy(gy).to(device), mesh, [Replicate()] * 2,
                run_check=False).redistribute(placements=y.placements))
            out[name, device] = {
                "y": _full(y), "gx": _full(xd.grad), "gw": _full(wd.grad),
                "gw_placements": [str(p) for p in wd.grad.placements],
                "local": tuple(y.to_local().shape)}
        mesh = make_mesh((2, 1), ("data", "model"), device)
        wd = place(torch.from_numpy(w).to(device), mesh,
                   (None, None, "data")).requires_grad_(True)
        full = FsdpGather.apply(wd)
        # each data rank's own gradient of the whole weight: partial sums
        g = torch.from_numpy(gy[:, :64] * (rank + 1)).to(device)
        (full.to_local(grad_placements=[Partial(), Replicate()]) * g) \
            .sum().backward()
        out["fsdp", device] = {
            "full": _np(full.to_local()),
            "placements": [str(p) for p in full.placements],
            "gw": _np(wd.grad.to_local()),
            "gw_placements": [str(p) for p in wd.grad.placements],
            "staged": dict(collectives.traffic),
            "want_gw": 3 * gy[:, :64][..., rank * 16:(rank + 1) * 16]}
        collectives.reset_traffic()
    return out


# -- the recurrent families on sharded parameters (tests/test_torch_ssm_tp.py)

def grad_step(model, params, batch: dict, lr: float, mesh=None) -> dict:
    """One AdamW step (``make_train_step``'s parts): the loss, every
    gradient leaf laid out as its parameter and then whole, the grad norm
    and what the update moved every parameter by, whole."""
    from repro_torch.distributed.sharding import (opt_state_shardings,
                                                  place_opt_state)
    from repro_torch.optim.adam import AdamW
    from repro_torch.train import loop
    params.trainable_()
    opt = AdamW(lr=lr)
    state = opt.init(params)
    if mesh is not None:
        state = place_opt_state(state, mesh, opt_state_shardings(mesh,
                                                                 params))
    loss, grads = loop.value_and_grad(model, params, batch)
    grads = loop.to_param_layout(grads, params)
    out = {"loss": float(_full(loss)),
           "grads": {n: _full(g) for n, g in grads.items()}}
    before = {n: _full(p) for n, p in params.named_parameters()}
    params, _, gnorm = opt.update(grads, state, params)
    out["grad_norm"] = float(_full(gnorm))
    out["update"] = {n: _full(p) - before[n]
                     for n, p in params.named_parameters()}
    return out


def _layouts(cache) -> list:
    """Each layer's cache as {group: {field: (placements, local shape)}}
    (plain tensors: "plain")."""
    out = []
    for layer in cache:
        entry = {}
        for group, value in layer.items():
            entry[group] = {
                f: ([str(p) for p in t.placements],
                    tuple(t.to_local().shape)) if hasattr(t, "placements")
                else "plain"
                for f, t in zip(value._fields, value)
                if isinstance(t, torch.Tensor)}
        out.append(entry)
    return out


def ssm_tp_body(rank: int, cases: dict, shape: tuple, batch: dict,
                lr: float) -> dict:
    """Each case of ``cases`` (name -> (arch, reduced overrides, the
    reference's tree, tokens, prompt, max_seq, quantize_dense modes to
    serve, whether to train)) on a ``shape`` ("data", "model") mesh of
    gloo ranks: serving (:func:`lm_serve_outputs`) in each mode, with the
    layouts of ``init_cache``'s states, of prefill's and of
    ``cache_shardings``' specs; one AdamW step (:func:`grad_step`)."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.sharding import cache_shardings, placements
    from repro_torch.models.api import Model, params_from_jax
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    res = {"jax": "jax" in sys.modules}
    with use_mesh(mesh):
        for name, (arch, over, tree, toks, prompt, max_seq, quants,
                   train) in cases.items():
            out = res[name] = {}
            for quant in quants:
                cfg = get_config(arch).reduced(quantize_dense=quant, **over)
                model = Model(cfg, "cpu")
                params = model.place(params_from_jax(cfg, tree, "cpu"), mesh)
                out[f"serve/{quant}"] = lm_serve_outputs(
                    model, params, toks, prompt, max_seq)
            if quants:
                with torch.no_grad():
                    _, cache = model.prefill(
                        params, {"tokens": toks[:, :prompt]},
                        max_seq=max_seq)
                    empty = model.init_cache(toks.shape[0], max_seq)
                out["layouts"] = {
                    "prefill": _layouts(cache), "init": _layouts(empty),
                    "specs": [{g: {f: [str(p) for p in placements(s, mesh)]
                                   for f, s in specs.items()}
                               for g, specs in layer.items()}
                              for layer in cache_shardings(mesh, cache)]}
                out["local"] = {
                    n: (tuple(p.to_local().shape),
                        [str(q) for q in p.placements])
                    for n, p in params.named_parameters()
                    if n.startswith(("layers.0.", "layers.7."))}
            if train:
                cfg = get_config(arch).reduced(**over)
                model = Model(cfg, "cpu")
                params = model.place(params_from_jax(cfg, tree, "cpu"), mesh)
                out["train"] = grad_step(model, params, batch, lr, mesh)
    return res


# -- the VLM and audio families on sharded parameters
# (tests/test_torch_vlm_audio_tp.py)

def _placed(t) -> tuple:
    """A cache tensor's (placements, local shape); "plain" for a tensor
    not on the mesh."""
    if not hasattr(t, "placements"):
        return "plain"
    return [str(p) for p in t.placements], tuple(t.to_local().shape)


def x_layouts(cache) -> dict:
    """The attention caches' layouts: ``{(layer, name): (placements,
    local shape)}`` of a decoder LM's per-layer ``kv`` (``k``, ``v``) and
    cross blocks' ``ck`` and ``cv``, or of the encoder-decoder's per-layer
    lists."""
    if isinstance(cache, dict):
        return {(i, name): _placed(t) for name in ("k", "v", "ck", "cv")
                for i, t in enumerate(cache[name])}
    out = {}
    for i, layer in enumerate(cache):
        for group, value in layer.items():
            if group == "kv":
                out.update({(i, f): _placed(getattr(value, f))
                            for f in ("k", "v")})
            else:
                out[i, group] = _placed(value)
    return out


def x_spec_layouts(specs, mesh) -> dict:
    """:func:`x_layouts`' keys of ``cache_shardings``' specs, as
    placements."""
    from repro_torch.distributed.sharding import placements

    def pl(spec):
        return [str(p) for p in placements(spec, mesh)]
    if isinstance(specs, dict):
        return {(i, name): pl(s) for name in ("k", "v", "ck", "cv")
                for i, s in enumerate(specs[name])}
    out = {}
    for i, layer in enumerate(specs):
        for group, value in layer.items():
            if group == "kv":
                out.update({(i, f): pl(value[f]) for f in ("k", "v")})
            else:
                out[i, group] = pl(value)
    return out


def x_collectives(model, params, toks: np.ndarray, prompt: int,
                  max_seq: int, extras: dict) -> dict:
    """The collectives one rank runs in a forward, a prefill and one
    decode step (``OpTrace``'s counts by kind, and the port's own
    collectives' calls), and whether ``tok_emb`` kept its layout."""
    from repro_torch.launch.hlo_analysis import OpTrace
    out = {}
    tok_emb = params["tok_emb"]
    before = ([str(p) for p in tok_emb.placements],
              tok_emb.to_local().data_ptr())
    with torch.no_grad():
        for name in ("forward", "prefill", "decode"):
            collectives.reset_traffic()
            with OpTrace() as trace:
                if name == "forward":
                    model.forward(params, {"tokens": toks, **extras})
                elif name == "prefill":
                    _, cache = model.prefill(
                        params, {"tokens": toks[:, :prompt], **extras},
                        max_seq=max_seq)
                else:
                    model.decode_step(params, toks[:, prompt:prompt + 1],
                                      cache)
            out[name] = dict(trace.totals()["collective_counts"])
            out[name + "/port"] = collectives.traffic["calls"]
    out["tok_emb_kept"] = before == (
        [str(p) for p in tok_emb.placements], tok_emb.to_local().data_ptr())
    return out


def vlm_audio_tp_body(rank: int, cases: dict, shape: tuple,
                      lr: float) -> dict:
    """Each case (name -> (arch, the reference's tree, tokens, prompt,
    max_seq, extras, the training batch, quantize_dense modes to serve))
    on a ``shape`` ("data", "model") mesh of gloo ranks: serving
    (:func:`lm_serve_outputs`) in each mode; the collectives of a
    forward, a prefill and a decode step; the layouts of ``init_cache``'s,
    prefill's and ``cache_shardings``' attention caches; one AdamW step
    (:func:`grad_step`)."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.sharding import cache_shardings
    from repro_torch.models.api import Model, params_from_jax
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    res = {"jax": "jax" in sys.modules}
    with use_mesh(mesh):
        for name, (arch, tree, toks, prompt, max_seq, extras, batch,
                   quants) in cases.items():
            out = res[name] = {}
            for quant in quants:
                cfg = get_config(arch).reduced(quantize_dense=quant)
                model = Model(cfg, "cpu")
                params = model.place(params_from_jax(cfg, tree, "cpu"), mesh)
                out[f"serve/{quant}"] = lm_serve_outputs(
                    model, params, toks, prompt, max_seq, extras)
            cfg = get_config(arch).reduced()
            model = Model(cfg, "cpu")
            params = model.place(params_from_jax(cfg, tree, "cpu"), mesh)
            out["collectives"] = x_collectives(model, params, toks, prompt,
                                               max_seq, extras)
            with torch.no_grad():
                _, cache = model.prefill(
                    params, {"tokens": toks[:, :prompt], **extras},
                    max_seq=max_seq)
            out["layouts"] = {
                "prefill": x_layouts(cache),
                "init": x_layouts(model.init_cache(toks.shape[0], max_seq)),
                "specs": x_spec_layouts(cache_shardings(mesh, cache), mesh)}
            out["local"] = {n: (tuple(p.to_local().shape),
                                [str(q) for q in p.placements])
                            for n, p in params.named_parameters()}
            out["train"] = grad_step(model, params, batch, lr, mesh)
    return res


class LaunchChecks:
    """Wraps the CUDA wrappers of ``ops`` in the kernel registry: every
    launch is held against the op's plain version on the same operands
    (the rank's own shards; a plain version counts no launch):
    ``int_matmul`` by its largest absolute difference, ``mha`` by its
    largest over max |plain|."""

    def __init__(self, ops=("int_matmul", "mha")):
        from repro_torch.kernels import dispatch
        self.dispatch, self.ops = dispatch, ops
        self.errs, self.checked, self.shapes = {}, {}, {}

    def __enter__(self):
        self.saved = {op: self.dispatch.get_op(op) for op in self.ops}
        for op, entry in self.saved.items():
            def wrapped(*args, _entry=entry, _op=op, **kwargs):
                out = _entry.cuda(*args, **kwargs)
                with torch.no_grad():
                    want = _entry.plain(*args, **kwargs)
                    got, want = (t[0] if isinstance(t, tuple) else t
                                 for t in (out, want))
                    err = float((got.double() - want.double()).abs().max())
                    if _op != "int_matmul":
                        err /= max(float(want.double().abs().max()), 1e-30)
                self.errs[_op] = max(self.errs.get(_op, 0.0), err)
                self.checked[_op] = self.checked.get(_op, 0) + 1
                self.shapes.setdefault(_op, set()).add(
                    tuple(tuple(a.shape) for a in args[:2]))
                return out
            self.dispatch._OPS[op] = dataclasses.replace(entry, cuda=wrapped)
        return self

    def __exit__(self, *exc):
        self.dispatch._OPS.update(self.saved)


def _card_serve(model, params, toks, prompt: int, extras=None) -> dict:
    """Forward, prefill and teacher-forced decode logits (whole, float32)
    and the launches they made; the forward's and prefill's batches hold
    ``extras`` beside the tokens (on the model's device)."""
    from repro_torch.kernels import dispatch
    dispatch.reset_launch_counts()
    out, extras = {}, extras or {}
    with torch.no_grad():
        out["forward"] = _full(model.forward(params, {"tokens": toks,
                                                      **extras}))
        logits, cache = model.prefill(
            params, {"tokens": toks[:, :prompt], **extras},
            max_seq=toks.shape[1] + 1)
        out["prefill"] = _full(logits)
        for i in range(prompt, toks.shape[1]):
            logits, cache = model.decode_step(params, toks[:, i:i + 1],
                                              cache)
            out[f"decode{i - prompt}"] = _full(logits)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    return {"logits": out, "counts": dict(dispatch.launch_counts)}


def card_ssm_tp_body(rank: int, cases: dict, toks: np.ndarray,
                     prompt: int) -> dict:
    """Each case (name -> (arch, reduced overrides)) in bf16 on the card:
    one process on its own (seeded weights), then on a (1, 2) ("data",
    "model") mesh of the two ranks (``Model.init_placed``, the same
    weights): their logits, launches, and every ``int_matmul`` and ``mha``
    launch held against its plain version (:class:`LaunchChecks`)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import Model
    mesh = make_mesh((1, 2), ("data", "model"), "cuda")
    out = {"jax": "jax" in sys.modules}
    for name, (arch, over) in cases.items():
        cfg = get_config(arch).reduced(dtype="bfloat16", **over)
        model = Model(cfg, "cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        with LaunchChecks() as one_checks:
            one = _card_serve(model, params, toks, prompt)
        del params
        with use_mesh(mesh):
            params = model.init_placed(mesh, torch.Generator(
                device="cuda").manual_seed(0))
            with LaunchChecks() as checks:
                got = _card_serve(model, params, toks, prompt)
        out[name] = {"one": one, "ranks": got, "errs": checks.errs,
                     "checked": checks.checked, "one_errs": one_checks.errs,
                     "shapes": {op: sorted(s)
                                for op, s in checks.shapes.items()}}
    return out


def card_vlm_audio_tp_body(rank: int, cases: dict, toks: np.ndarray,
                           prompt: int, gates: dict) -> dict:
    """Each case (name -> (arch, dtype)) reduced, its weights drawn on the
    CPU from one seed and every cross block's gates at ``gates``: one
    process on the CPU in float32 (the "cpu" run), one process on the card
    in ``dtype``, then the two ranks on a (1, 2) ("data", "model") mesh on
    the card (``Model.place``, the same weights): their logits, launches,
    and every ``int_matmul`` and ``mha`` launch on a rank held against its
    plain version (:class:`LaunchChecks`)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.api import Model
    mesh = make_mesh((1, 2), ("data", "model"), "cuda")
    out = {"jax": "jax" in sys.modules}
    for name, (arch, dtype) in cases.items():
        cfg = get_config(arch).reduced()
        params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
        with torch.no_grad():
            for n, p in params.named_parameters():
                if n.rsplit(".", 1)[-1] in gates:
                    p.fill_(gates[n.rsplit(".", 1)[-1]])
        rng = np.random.RandomState(5)
        if cfg.family == "vlm":
            key, shape = "vision", (toks.shape[0], cfg.vision_tokens,
                                    cfg.vision_dim)
        else:
            key, shape = "frames", (toks.shape[0], cfg.encoder_seq,
                                    cfg.d_model)
        states = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
        cpu = _card_serve(Model(cfg, "cpu"), params, toks, prompt,
                          {key: states})
        card_cfg = dataclasses.replace(cfg, dtype=dtype)
        model = Model(card_cfg, "cuda")
        params = params.to(device="cuda", dtype=getattr(torch, dtype))
        extras = {key: states.to("cuda", getattr(torch, dtype))}
        with LaunchChecks():
            one = _card_serve(model, params, toks, prompt, extras)
        with use_mesh(mesh):
            placed = model.place(params, mesh)
            with LaunchChecks() as checks:
                got = _card_serve(model, placed, toks, prompt, extras)
        out[name] = {"cpu": cpu, "one": one, "ranks": got,
                     "errs": checks.errs, "checked": checks.checked,
                     "shapes": {op: sorted(s)
                                for op, s in checks.shapes.items()}}
    return out
