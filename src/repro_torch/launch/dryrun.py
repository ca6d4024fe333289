"""Multi-pod dry-run (port of ``repro.launch.dryrun``).

Traces every (architecture x input-shape) cell's step on the single-pod
(16 data x 16 model = 256 ranks) and multi-pod (2 pod x 16 x 16 = 512)
meshes, one rank's program, and records its memory, flops and collective
bytes; results go to ``build/dryrun/dryrun_results.json`` (resumable:
done cells are skipped on re-run).

The reference lowers and compiles each cell with XLA over forced host
devices.  The port runs the step itself, eagerly, in a process that owns
a fake process group of 256 or 512 ranks (``FakeStore``, backend
"fake": collectives return at once) under ``FakeTensorMode``: every
tensor is a shape, nothing is allocated and no kernel runs (the kernel
ops return shape-only results and are charged their declared costs).
The parameters are placed as on the real mesh (``Model.place``), the
AdamW moments by ZeRO-1 (``opt_state_shardings``), the batch over the
data axes; the trace counts what rank 0 runs (``launch/hlo_analysis.py``)
and ``MemTracker`` the peak of its live storages.

Cells are checked with ``supports`` first, as in the reference: a
full-attention arch's ``long_500k`` is ``skipped``; every other cell of
every family is traced.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
      --shape train_4k --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from ..configs.base import ARCH_IDS, get_config
from ..configs.shapes import SHAPES, shape_for, supports
from ..distributed.act_sharding import use_mesh
from ..distributed.sharding import (opt_state_shardings, place_batch,
                                    place_opt_state)
from ..models.api import Model, input_specs
from ..optim.adam import AdamW
from ..train.loop import make_train_step
from .analytic import model_flops
from .hlo_analysis import OpTrace
from .mesh import describe, make_mesh, make_production_mesh

RESULTS_PATH = "build/dryrun/dryrun_results.json"


def _result_key(arch, shape, multi_pod):
    return f"{arch}|{shape}|{'2pod' if multi_pod else '1pod'}"


def load_results(path=RESULTS_PATH) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return {}


def save_results(results: dict, path=RESULTS_PATH):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


@contextlib.contextmanager
def fake_world(world: int):
    """A fake default process group of ``world`` ranks, this process rank
    0, destroyed on exit (it is process-global: run the dry-run in a
    process of its own, never beside real ranks)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run needs a process without a default "
                           "process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor in ``tree``."""
    from torch.utils._pytree import tree_flatten
    total = 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            t = getattr(t, "_local_tensor", t)
            total += t.numel() * t.element_size()
        elif hasattr(t, "named_parameters"):
            total += _local_bytes([p for _, p in t.named_parameters()])
    return total


def build_step(arch: str, shape_name: str, mesh, cfg_overrides=None,
               device="cuda"):
    """``(fn, args)``: the cell's step and its inputs, fake DTensors laid
    out on ``mesh`` (call under ``FakeTensorMode`` and ``use_mesh``)."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    model = Model(cfg, device)
    shape = shape_for(cfg, shape_name)
    b, s = shape.global_batch, shape.seq_len
    params = model.place(model.init(torch.Generator(device=device)), mesh)
    specs = input_specs(cfg, shape)
    batch = place_batch({k: torch.zeros(v.shape, dtype=v.dtype,
                                        device=device)
                         for k, v in specs.items() if k != "cache"}, mesh)

    if shape.kind == "train":
        params.trainable_()
        opt = AdamW(lr=3e-4)
        ostate = place_opt_state(opt.init(params), mesh,
                                 opt_state_shardings(mesh, params))
        step = make_train_step(model, opt, microbatches=shape.microbatches)
        return step, (params, ostate, batch)

    if shape.kind == "prefill":
        def prefill_fn(params, batch):
            with torch.no_grad():
                return model.prefill(params, batch, max_seq=s)
        return prefill_fn, (params, batch)

    # decode: one new token against a full seq_len KV cache
    cache = model.init_cache(b, s)
    if isinstance(cache, dict):          # the encoder-decoder's
        cache["length"] = s - 1
    else:
        cache = [{**c, "kv": c["kv"]._replace(length=s - 1)} if "kv" in c
                 else c for c in cache]

    def serve_step(params, toks, cache):
        with torch.no_grad():
            return model.decode_step(params, toks, cache)
    return serve_step, (params, batch["tokens"], cache)


def trace_cell(arch: str, shape_name: str, mesh, device="cuda",
               reduced: bool = False) -> dict:
    """Trace one cell's step on ``mesh`` (inside a fake world of its
    size): its per-rank memory, op totals and timing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    t0 = time.perf_counter()
    with FakeTensorMode(), use_mesh(mesh):
        overrides = (dataclasses.asdict(get_config(arch).reduced())
                     if reduced else None)
        fn, args = build_step(arch, shape_name, mesh, overrides, device)
        arg_bytes = _local_bytes(args)
        param_bytes = _local_bytes(args[0])
        tracker = MemTracker()
        tracker.track_external(*_tracked(args))
        trace = OpTrace()
        with tracker, trace:
            out = fn(*args)
        peak = peak_bytes(tracker)
        out_bytes = _local_bytes(out)
    return {"trace_s": round(time.perf_counter() - t0, 1),
            "argument_bytes": arg_bytes, "param_bytes": param_bytes,
            "output_bytes": out_bytes,
            "peak_bytes": peak, "temp_bytes": max(peak - arg_bytes, 0),
            "corrected": trace.totals(), "ops": trace.n_ops}


def _tracked(args) -> list:
    """The inputs MemTracker counts as live from the start: modules and
    tensors (DTensors by their local shards)."""
    from torch.utils._pytree import tree_flatten
    out = []
    for a in tree_flatten(args)[0]:
        if isinstance(a, torch.nn.Module):
            out.append(a)
        elif isinstance(a, torch.Tensor):
            out.append(getattr(a, "_local_tensor", a))
    return out


def peak_bytes(tracker) -> int:
    """The peak of live storages ``MemTracker`` saw, over its devices
    (``get_tracker_snapshot("peak")[device]["Total"]``; a private API,
    held by ``tests/test_torch_dryrun.py``)."""
    snap = tracker.get_tracker_snapshot("peak")
    return int(sum(v["Total"] for v in snap.values()))


def cell_status(arch: str, shape_name: str):
    """The entry of a cell that is not traced: ``skipped`` where
    ``supports`` says so, as the reference does; None for a cell to
    trace."""
    ok, reason = supports(get_config(arch), shape_name)
    return None if ok else {"status": "skipped", "reason": reason}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             results: dict, verbose: bool = True,
             mesh_shape: tuple = (), device="cuda",
             path: str = RESULTS_PATH, reduced: bool = False) -> dict:
    """mesh_shape: optional (data, model) override; the production
    meshes otherwise.  ``reduced``: the arch's ``reduced()`` config (a
    smoke run of the tracer; the shapes stay the cell's)."""
    key = _result_key(arch, shape_name, multi_pod)
    if mesh_shape:
        key += f"|mesh{mesh_shape[0]}x{mesh_shape[1]}"
    entry = cell_status(arch, shape_name) or _traced(
        arch, shape_name, multi_pod, mesh_shape, device, reduced)
    if verbose:
        if entry["status"] == "ok":
            c = entry["corrected"]
            print(f"[OK] {key}: trace={entry['trace_s']:.1f}s "
                  f"flops={c['flops']:.3e} "
                  f"(model {entry['analytic']['model_flops']:.3e}) "
                  f"coll={c['collective_bytes']:.3e}B "
                  f"args={entry['argument_bytes'] / 2 ** 30:.2f}GiB "
                  f"peak={entry['peak_bytes'] / 2 ** 30:.2f}GiB")
        else:
            print(f"[{entry['status']}] {key}: "
                  f"{entry.get('reason') or entry.get('error')}")
    results[key] = entry
    save_results(results, path)
    return entry


def _traced(arch, shape_name, multi_pod, mesh_shape, device,
            reduced) -> dict:
    dims = (tuple(mesh_shape) if mesh_shape
            else (2, 16, 16) if multi_pod else (16, 16))
    try:
        with fake_world(math.prod(dims)):
            mesh = (make_mesh(mesh_shape, ("data", "model"), device)
                    if mesh_shape else
                    make_production_mesh(multi_pod=multi_pod,
                                         device=device))
            traced = trace_cell(arch, shape_name, mesh, device, reduced)
            n = mesh.size()
            desc = describe(mesh)
    except Exception as e:  # noqa: BLE001 — failures are data here
        return {"status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}
    cfg = get_config(arch).reduced() if reduced else get_config(arch)
    c = traced["corrected"]
    return {"status": "ok", "mesh": desc, "n_devices": n,
            "trace_s": traced["trace_s"],
            "flops": c["flops"], "bytes_accessed": c["traffic_bytes"],
            "argument_bytes": traced["argument_bytes"],
            "param_bytes": traced["param_bytes"],
            "output_bytes": traced["output_bytes"],
            "temp_bytes": traced["temp_bytes"],
            "peak_bytes": traced["peak_bytes"],
            "collectives": {"bytes_by_kind": c["collectives"],
                            "counts": c["collective_counts"],
                            "total_bytes": c["collective_bytes"]},
            "corrected": c,
            "analytic": model_flops(cfg, shape_for(cfg, shape_name)),
            "hlo_ops": traced["ops"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--force", action="store_true",
                    help="re-run cells that already have results")
    ap.add_argument("--mesh-shape", default="",
                    help="logical (data,model) override, e.g. 64,4")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (cpu where torch has no "
                         "CUDA)")
    ap.add_argument("--results", default=RESULTS_PATH)
    ap.add_argument("--reduced", action="store_true",
                    help="trace each arch's reduced() config (a smoke run)")
    args = ap.parse_args(argv)
    mesh_shape = tuple(int(x) for x in args.mesh_shape.split(",")) \
        if args.mesh_shape else ()

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    pods = [False, True]
    if args.multi_pod_only:
        pods = [True]
    if args.single_pod_only:
        pods = [False]

    results = load_results(args.results)
    counts = {"ok": 0, "error": 0, "skipped": 0}
    for multi_pod in pods:
        for arch in archs:
            for shape in shapes:
                key = _result_key(arch, shape, multi_pod)
                if mesh_shape:
                    key += f"|mesh{mesh_shape[0]}x{mesh_shape[1]}"
                if not args.force and results.get(key, {}).get(
                        "status") in ("ok", "skipped"):
                    print(f"[cached] {key}: {results[key]['status']}")
                    counts[results[key]["status"]] += 1
                    continue
                entry = run_cell(arch, shape, multi_pod, results,
                                 mesh_shape=mesh_shape, device=args.device,
                                 path=args.results, reduced=args.reduced)
                counts[entry["status"]] += 1
    print(f"\ndone: {counts['ok']} ok, {counts['error']} failed, "
          f"{counts['skipped']} skipped (results in {args.results})")
    return counts


if __name__ == "__main__":
    main()
