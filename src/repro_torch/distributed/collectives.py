"""Collectives over ``torch.distributed`` ranks, and the hierarchical
all-reduce of the multi-pod mesh (port of ``repro.distributed.collectives``,
DESIGN.md §5).

Cross-pod links are slower than intra-pod links, so the flat all-reduce
over ("pod", "data") is decomposed into:

  1. reduce-scatter within the pod  (fast links carry the bulk)
  2. all-reduce of the scattered shards across pods
     (slow links carry 1/pod_size of the bytes)
  3. all-gather within the pod

The reference runs these under ``shard_map`` on named mesh axes; the port
runs them on the process groups of a ``DeviceMesh``'s axes.

Every collective of the port goes through the wrappers below.  They count
what they move in :data:`traffic` (per process: the payload bytes handed
to each collective, as ``tensor.numel() * element_size()``, and the bytes
copied through host memory), and they choose up front, by backend and
device, whether a collective runs on the tensor or on a host copy of it
(:func:`staged`).  PyTorch's backend table gives gloo only all-reduce and
broadcast on CUDA tensors (gloo copies those through host memory
itself), so the port copies for gloo's reduce-scatter, all-gather, send
and recv on CUDA tensors.  On torch 2.11 (an H100 machine) gloo also ran
reduce-scatter and all-gather on CUDA tensors and aborted the process on
a send; the table keeps the documented pair.  A collective that fails
raises; nothing falls back.
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist

#: the collectives a backend runs on host tensors only
HOST_ONLY = {"gloo": frozenset({"reduce_scatter", "all_gather", "send",
                                "recv"})}

#: the tensor forms of reduce-scatter and all-gather (``*_single`` since
#: torch 2.10, where the ``*_tensor`` names warn)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)
_ALL_GATHER = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)

#: this process's counts: payload bytes by collective, "staged" bytes
#: copied device -> host -> device, "calls"
traffic: collections.Counter = collections.Counter()


def reset_traffic() -> None:
    traffic.clear()


def staged(op: str, tensor: torch.Tensor, group=None) -> bool:
    """Whether collective ``op`` on ``tensor`` copies through host memory:
    a CUDA tensor under a backend that runs ``op`` on host tensors only."""
    return tensor.device.type == "cuda" and \
        op in HOST_ONLY.get(dist.get_backend(group), ())


def _count(op: str, tensor: torch.Tensor) -> None:
    traffic[op] += tensor.numel() * tensor.element_size()
    traffic["calls"] += 1


#: staged tensors of at least this many bytes go through page-locked
#: host memory (the caching host allocator keeps the blocks): a pageable
#: copy of an FSDP layer's weights ran at ~2-3 GB/s on the H100's host
PINNED_BYTES = 1 << 20


def _to_host(tensor: torch.Tensor) -> torch.Tensor:
    nbytes = tensor.numel() * tensor.element_size()
    traffic["staged"] += nbytes
    return torch.empty(tensor.shape, dtype=tensor.dtype,
                       pin_memory=nbytes >= PINNED_BYTES).copy_(tensor)


def _from_host(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    traffic["staged"] += host.numel() * host.element_size()
    return host.to(like.device)


def _empty_like_src(src: torch.Tensor, shape) -> torch.Tensor:
    """A collective's output beside its input ``src``: page-locked where
    ``src`` is (a staged copy)."""
    if src.device.type == "cpu" and src.is_pinned():
        return torch.empty(shape, dtype=src.dtype, pin_memory=True)
    return src.new_empty(shape)


def divide(x: torch.Tensor, n) -> torch.Tensor:
    """``x / n`` as a true division on every device (on CUDA, a tensor
    divided by a Python number multiplies by its reciprocal)."""
    return x / torch.full((), n, dtype=x.dtype, device=x.device)


#: the reduce ops by name
REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
              "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, op=dist.ReduceOp.SUM, group=None
               ) -> torch.Tensor:
    """Reduce ``x`` in place over ``group`` with ``op`` (a ``ReduceOp``
    or one of ``REDUCE_OPS``' names); returns ``x``."""
    _count("all_reduce", x)
    dist.all_reduce(x, op=REDUCE_OPS.get(op, op), group=group)
    return x


def broadcast(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Overwrite ``x`` with global rank ``src``'s; returns ``x``."""
    _count("broadcast", x)
    dist.broadcast(x, src=src, group=group)
    return x


def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ``group`` of ``x``'s leading-dim block this rank owns
    (``x.shape[0]`` divisible by the group's size)."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    _count("reduce_scatter", x)
    src = _to_host(x) if staged("reduce_scatter", x, group) else x
    out = _empty_like_src(src, (x.shape[0] // n, *x.shape[1:]))
    _REDUCE_SCATTER(out, src, group=group)
    return _from_host(out, x) if src is not x else out


def all_gather(shard: torch.Tensor, group=None) -> torch.Tensor:
    """The group's shards concatenated along the leading dim."""
    n = dist.get_world_size(group)
    shard = shard.contiguous()
    _count("all_gather", shard)
    src = _to_host(shard) if staged("all_gather", shard, group) else shard
    out = _empty_like_src(src, (n * shard.shape[0], *shard.shape[1:]))
    _ALL_GATHER(out, src, group=group)
    return _from_host(out, shard) if src is not shard else out


def all_gather_blocks(block: torch.Tensor, sizes, group=None
                      ) -> torch.Tensor:
    """Every rank's ``block`` concatenated along the leading dim in rank
    order, where rank r's block has ``sizes[r]`` rows (sizes may differ,
    and be 0) and the same trailing shape and dtype on every rank.  Each
    block is padded to the largest size for one :func:`all_gather`."""
    sizes = [int(s) for s in sizes]
    rank = dist.get_rank(group)
    if block.shape[0] != sizes[rank]:
        raise ValueError(f"rank {rank}'s block has {block.shape[0]} rows, "
                         f"its size says {sizes[rank]}")
    width = max(sizes)
    if width == 0:
        return block
    if block.shape[0] < width:
        block = torch.cat([block, block.new_zeros(
            (width - block.shape[0], *block.shape[1:]))])
    full = all_gather(block, group)
    return torch.cat([full[r * width:r * width + n]
                      for r, n in enumerate(sizes)])


def send(x: torch.Tensor, dst: int, group=None) -> None:
    """Send ``x`` to global rank ``dst`` (blocking)."""
    x = x.contiguous()
    _count("send", x)
    dist.send(_to_host(x) if staged("send", x, group) else x, dst=dst,
              group=group)


def recv(like: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Receive a tensor of ``like``'s shape, dtype and device from global
    rank ``src`` (blocking)."""
    out = torch.empty_like(like, memory_format=torch.contiguous_format)
    _count("recv", out)
    if staged("recv", out, group):
        host = torch.empty(out.shape, dtype=out.dtype)
        dist.recv(host, src=src, group=group)
        return _from_host(host, out)
    dist.recv(out, src=src, group=group)
    return out


def group_over(mesh, axes: tuple):
    """The process group spanning ``axes`` of ``mesh``: one axis's group,
    or the default group for a mesh that has just these axes and every
    rank."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if tuple(mesh.mesh_dim_names) == tuple(axes) and \
            mesh.size() == dist.get_world_size():
        return dist.group.WORLD
    raise ValueError(f"no group over axes {axes} of a mesh with axes "
                     f"{mesh.mesh_dim_names} on {mesh.size()} of "
                     f"{dist.get_world_size()} ranks")


def hierarchical_psum(x: torch.Tensor, mesh, *, intra_axis: str = "data",
                      inter_axis: str = "pod") -> torch.Tensor:
    """Sum over (inter_axis x intra_axis) via RS -> inter-AR -> AG.

    Requires the leading dim of ``x`` to be divisible by the intra-axis
    size; otherwise falls back to the flat sum (an all-reduce within the
    pod, then across pods).  Returns a new tensor."""
    intra, inter = mesh.get_group(intra_axis), mesh.get_group(inter_axis)
    if x.shape[0] % dist.get_world_size(intra):
        return all_reduce(all_reduce(x.clone(), group=intra), group=inter)
    # 1. reduce-scatter within the pod over the leading dim
    shard = reduce_scatter(x, intra)
    # 2. all-reduce the shard across pods (1/n_intra of the bytes)
    all_reduce(shard, group=inter)
    # 3. all-gather within the pod
    return all_gather(shard, intra)


def hierarchical_pmean(x: torch.Tensor, mesh, *, intra_axis: str = "data",
                       inter_axis: str = "pod") -> torch.Tensor:
    total = (dist.get_world_size(mesh.get_group(intra_axis))
             * dist.get_world_size(mesh.get_group(inter_axis)))
    return divide(hierarchical_psum(x, mesh, intra_axis=intra_axis,
                                    inter_axis=inter_axis), total)


def cross_pod_bytes(n_bytes: int, pod_size: int) -> tuple[int, int]:
    """(flat slow-link bytes, hierarchical slow-link bytes) per device —
    the napkin justification: hierarchical moves 1/pod_size as much over
    the slow links."""
    return n_bytes, n_bytes // pod_size


def reduce_over(tensor: torch.Tensor, op: str, groups: list
                ) -> torch.Tensor:
    """``tensor`` all-reduced by ``op`` ("sum" or "max") over each of
    ``groups`` in turn, as functional collectives (DTensor's; the
    dry-run's trace counts them).  gloo runs both on CUDA tensors (a
    probe on torch 2.11: float32 and bf16, a one-rank group too)."""
    from torch.distributed import _functional_collectives as funcol
    for group in groups:
        tensor = funcol.all_reduce(tensor, op, group)
    return tensor


def _funcol(name: str, old: str):
    """A functional collective by its name since torch 2.10 (``*_single``),
    or by its older one (which warns where the new one exists)."""
    from torch.distributed import _functional_collectives as funcol
    return getattr(funcol, name, None) or getattr(funcol, old)


def gather_over(tensor: torch.Tensor, dim: int, groups: list
                ) -> torch.Tensor:
    """Each group's shards of ``tensor`` concatenated along ``dim``, the
    groups in turn (pass the innermost mesh dim's first), as functional
    collectives (the dry-run's trace counts them), or staged through
    (page-locked) host memory by :func:`all_gather` where the backend
    needs it."""
    gather = _funcol("all_gather_single", "all_gather_tensor")
    dim %= tensor.ndim        # the functional gather's reshape needs dim >= 0
    for group in groups:
        if staged("all_gather", tensor, group):
            tensor = all_gather(tensor.movedim(dim, 0), group).movedim(0, dim)
            continue
        tensor = tensor.contiguous()
        _count("all_gather", tensor)
        tensor = gather(tensor, dim, group)
    return tensor.contiguous()


def reduce_scatter_over(tensor: torch.Tensor, dim: int, groups: list
                        ) -> torch.Tensor:
    """The sum over each group of ``tensor``'s block along ``dim`` this
    rank owns, the groups in turn (pass the outermost mesh dim's first;
    ``dim`` divisible by each group's size), as functional collectives,
    or staged by :func:`reduce_scatter` where the backend needs it."""
    scatter = _funcol("reduce_scatter_single", "reduce_scatter_tensor")
    dim %= tensor.ndim
    for group in groups:
        if staged("reduce_scatter", tensor, group):
            tensor = reduce_scatter(tensor.movedim(dim, 0), group) \
                .movedim(0, dim)
            continue
        tensor = tensor.contiguous()
        _count("reduce_scatter", tensor)
        tensor = scatter(tensor, "sum", dim, group)
    return tensor.contiguous()
