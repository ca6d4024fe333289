"""Device meshes over ``torch.distributed`` ranks (port of
``repro.launch.mesh``), and :func:`spawn_ranks`, which starts the ranks of
one machine.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` whose
``mesh_dim_names`` are the reference's axis names; building one needs the
default process group, which every rank of :func:`spawn_ranks` has.  The
reference forces host devices (``--xla_force_host_platform_device_count``)
to get a mesh on one machine; the port starts one process a rank instead
(or runs under ``torchrun``: :func:`init_from_env`).
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from typing import Callable, Union

import torch
import torch.distributed as dist

#: seconds a rank group may take, start-up included; also each rank's
#: ``init_process_group`` timeout, which bounds every collective
DEFAULT_TIMEOUT = 300.0
#: seconds the other ranks get to exit after one fails, before SIGTERM
GRACE_SECONDS = 5.0


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """16x16 = 256 ranks a pod; 2 pods = 512 ranks with a leading "pod"
    axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_mesh(shape: tuple, axes: tuple, device="cuda"):
    """A mesh of ``shape`` over the default group's ranks, row-major, with
    ``axes`` as its dim names (every rank calls it)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(torch.device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def describe(mesh) -> str:
    return " x ".join(f"{a}={n}" for a, n in zip(mesh.mesh_dim_names,
                                                  mesh.shape))


def backend_for(device: Union[str, torch.device], world: int) -> str:
    """NCCL when each of ``world`` ranks owns a GPU; gloo on the CPU and
    when ranks share a GPU (NCCL refuses two ranks on one device)."""
    if torch.device(device).type == "cuda" and \
            torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def init_from_env(device: Union[str, torch.device] = "cuda") -> bool:
    """Initialise the default process group from ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) when it names one and no group exists yet, with the
    backend of :func:`backend_for`; on ``"cuda"`` the rank takes GPU
    ``LOCAL_RANK % device_count``.  Returns whether a default group is
    initialised afterwards."""
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    dev, world = torch.device(device), int(os.environ["WORLD_SIZE"])
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
    dist.init_process_group(
        backend_for(dev, world), init_method="env://",
        timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT))
    return True


def _rank_main(rank: int, world: int, fn: Callable, args: tuple,
               device_type: str, backend: str, tmp: str,
               timeout: float) -> None:
    torch.set_num_threads(1)
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"file://{tmp}/rendezvous", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout))
    result = fn(rank, *args)
    part = os.path.join(tmp, f"result-{rank}.part")
    with open(part, "wb") as f:
        pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(part, os.path.join(tmp, f"result-{rank}.pkl"))
    dist.barrier()
    dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, *, args: tuple = (),
                device: Union[str, torch.device] = "cuda",
                timeout: float = DEFAULT_TIMEOUT) -> list:
    """Run ``fn(rank, *args)`` in ``world`` fresh processes (the ``spawn``
    start method: CUDA forbids ``fork``), each a rank of one default
    process group, and return their results in rank order.

    The ranks meet at a ``file://`` rendezvous in a temporary directory
    (no TCP port, so concurrent groups never collide), with
    ``init_process_group``'s timeout set to ``timeout``, one intra-op
    thread each, and the backend of :func:`backend_for`; on ``"cuda"``
    (unless the caller asks for ``"cpu"``) rank r uses GPU ``r %
    device_count``.  ``fn`` must be importable by name and its result
    picklable (return host data: numpy arrays or CPU tensors).  When a
    rank raises or dies, the others are stopped and the failing rank's
    traceback is raised; past ``timeout`` seconds every rank is killed and
    ``TimeoutError`` raised."""
    dev = torch.device(device)
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(world, fn, tuple(args), dev.type,
                              backend_for(dev, world), tmp, timeout),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic()),
                               grace_period=GRACE_SECONDS):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{world} ranks of {getattr(fn, '__name__', fn)} did "
                        f"not finish in {timeout:g} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join()
        results = []
        for rank in range(world):
            with open(os.path.join(tmp, f"result-{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
