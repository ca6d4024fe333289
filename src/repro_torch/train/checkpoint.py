"""Atomic, versioned checkpoints in the reference's on-disk format.

Port of ``repro.train.checkpoint``.  Layout::

    <dir>/step_<N:08d>/arrays.npz + manifest.json

written into ``step_<N>.tmp`` and renamed into place, so a crashed save
never shadows a good checkpoint; ``keep_last`` pruning.  The manifest
keys (``exotic_dtypes``, ``step``, ``time``, ``n_arrays``,
``total_bytes``, ``keys_checksum`` and any ``extra_meta``) and the array
names are the reference's, so a checkpoint written by either package
loads in the other.

A state is a tree of dicts, lists and tuples whose leaves are tensors,
numpy arrays or scalars.  It is flattened by ``/``-joined key, dict keys
sorted and sequence items named ``[i]``, as ``jax.tree_util`` names
them.  Tensors are copied to the host.  A dtype npz cannot store
(bfloat16, the float8 types) is saved as a bit view of the same width,
its true name recorded in ``exotic_dtypes``, and comes back as a tensor
of that dtype.  A module (a ``Params`` tree) is its ``named_parameters()``.

A sharded state (DTensor leaves, the model on a mesh) is saved whole:
every rank gathers each leaf in the flattened order, rank 0 writes, and
the others wait for the write.  :func:`restore` lays each leaf out as the
target's DTensor leaf, which may sit on another mesh (the elastic
rescale, ``train/fault_tolerance.py::plan_rescale``), each rank keeping
its own slice of the saved tensor.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from ..distributed.sharding import local_like
from ..distributed.tp import full_tensor
from ..kernels.dispatch import is_dtensor

#: dtypes numpy cannot hold, by the name the manifest records (the
#: reference's ml_dtypes names), and the integer type of their bit view
_EXOTIC = {torch.bfloat16: ("bfloat16", torch.int16),
           torch.float8_e4m3fn: ("float8_e4m3fn", torch.int8),
           torch.float8_e5m2: ("float8_e5m2", torch.int8)}
_EXOTIC_BY_NAME = {name: dtype for dtype, (name, _) in _EXOTIC.items()}


def _flatten_with_names(tree, prefix: str = "") -> dict:
    """``{"a/b/[0]": leaf}`` in ``jax.tree_util``'s leaf order."""
    def key(part: str) -> str:
        return f"{prefix}/{part}" if prefix else part
    if hasattr(tree, "named_parameters"):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten_with_names(tree[k], key(str(k))))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten_with_names(v, key(f"[{i}]")))
        return out
    return {prefix: tree}


def _host_leaf(v) -> tuple[np.ndarray, Optional[str]]:
    """A leaf as a storable host array, and its exotic dtype name (None
    for a dtype npz stores as is)."""
    if isinstance(v, torch.Tensor):
        t = full_tensor(v.detach()).cpu()
        if t.dtype in _EXOTIC:
            name, bits = _EXOTIC[t.dtype]
            return t.view(bits).numpy().view(
                np.uint16 if t.element_size() == 2 else np.uint8), name
        return t.numpy(), None
    a = np.asarray(v)
    if a.dtype.kind == "V" or a.dtype.name not in np.sctypeDict:
        return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint8), \
            a.dtype.name
    return a, None


def save(ckpt_dir: str, step: int, state: Any, *, keep_last: int = 3,
         extra_meta: Optional[dict] = None) -> str:
    """Atomic save of ``state``; returns the checkpoint path.  With
    DTensor leaves every rank of the default group calls it: each gathers
    the leaves, rank 0 writes."""
    leaves = _flatten_with_names(state)
    host = {k: _host_leaf(v) for k, v in leaves.items()}
    if not any(map(is_dtensor, leaves.values())):
        return _write(ckpt_dir, step, host, keep_last, extra_meta)
    import torch.distributed as dist
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if dist.get_rank() == 0:
        _write(ckpt_dir, step, host, keep_last, extra_meta)
    dist.barrier()
    return path


def _write(ckpt_dir: str, step: int, host: dict, keep_last: int,
           extra_meta: Optional[dict]) -> str:
    """Write ``host`` (key -> (array, exotic dtype name or None))."""
    os.makedirs(ckpt_dir, exist_ok=True)
    # taken BEFORE this save publishes: the newest checkpoint a
    # concurrent reader could have selected via latest_step(), which
    # pruning must never delete (see _prune)
    durable_before = latest_step(ckpt_dir)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays = {k: a for k, (a, _) in host.items()}
    exotic = {k: name for k, (_, name) in host.items() if name is not None}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "exotic_dtypes": exotic,
        "step": step,
        "time": time.time(),
        "n_arrays": len(arrays),
        "total_bytes": int(sum(a.nbytes for a in arrays.values())),
        "keys_checksum": _keys_checksum(arrays),
        **(extra_meta or {}),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic publish
    _prune(ckpt_dir, keep_last, durable_before)
    return final


def _keys_checksum(arrays: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(str(arrays[k].shape).encode())
        h.update(str(arrays[k].dtype).encode())
    return h.hexdigest()[:16]


def _prune(ckpt_dir: str, keep_last: int,
           durable_before: Optional[int] = None) -> None:
    """Remove old checkpoints, keeping the newest ``keep_last``.

    ``durable_before`` is the latest step that was durable BEFORE the
    save that triggered this prune.  A concurrent restore picks its
    checkpoint through ``latest_step()``, which can only have returned
    that step or an older one, so only checkpoints *strictly older* than
    it are pruned: the previously newest survives one more save and is
    reclaimed by the next prune.
    """
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep_last]:
        if durable_before is not None \
                and int(d.split("_")[1]) >= durable_before:
            continue
        shutil.rmtree(os.path.join(ckpt_dir, d))


class AsyncCheckpointer:
    """Background-thread checkpoint writer: ``save`` copies the state to
    host memory on the caller's thread (so the copy cannot race the next
    step's writes into the same buffers) and writes it to disk on
    another; ``wait()`` joins the write in flight."""

    def __init__(self, ckpt_dir: str, keep_last: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, state: Any) -> None:
        self.wait()
        host_state = {}
        for k, v in _flatten_with_names(state).items():
            host_state[k] = (v.detach().to("cpu", copy=True)
                             if isinstance(v, torch.Tensor)
                             else np.array(v, copy=True))
        t = threading.Thread(
            target=save, args=(self.ckpt_dir, step, host_state),
            kwargs={"keep_last": self.keep_last}, daemon=True)
        t.start()
        self._thread = t

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore_raw(ckpt_dir: str, step: int) -> tuple:
    """Load a checkpoint without a target tree: ``(arrays, manifest)``,
    ``arrays`` a flat ``{key: ndarray}`` dict (a tensor for an exotic
    dtype) and ``manifest`` the saved metadata, ``extra_meta`` included.
    The restore path of state whose shape the checkpoint itself names:
    the elastic runtime's carry snapshots."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    exotic = manifest.get("exotic_dtypes", {})
    arrays = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key in data.files:
            arr = data[key]
            if key in exotic:
                dtype = _EXOTIC_BY_NAME.get(exotic[key])
                if dtype is None:
                    raise ValueError(
                        f"checkpoint array {key!r} has dtype "
                        f"{exotic[key]!r}, which torch does not hold")
                _, bits = _EXOTIC[dtype]
                arr = torch.from_numpy(arr.view(
                    np.int16 if bits == torch.int16 else np.int8)
                    .copy()).view(dtype)
            arrays[key] = arr
    return arrays, manifest


def restore(ckpt_dir: str, step: int, target_tree: Any,
            device: Optional[torch.device] = None) -> Any:
    """Restore into the structure of ``target_tree`` (a module: a dict of
    its ``named_parameters()``), checking every leaf's shape.  A tensor
    leaf comes back as a tensor on ``device`` (default: the target leaf's
    device), a DTensor leaf as a DTensor laid out as the target's, any
    other leaf as a numpy array."""
    arrays, manifest = restore_raw(ckpt_dir, step)
    named = _flatten_with_names(target_tree)
    if manifest["n_arrays"] != len(named):
        raise ValueError(f"checkpoint holds {manifest['n_arrays']} arrays, "
                         f"the target tree {len(named)}")

    def leaf(key: str, tgt):
        arr = arrays[key]
        if tuple(arr.shape) != tuple(np.shape(tgt)):
            raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)} "
                             f"!= target shape {tuple(np.shape(tgt))}")
        if isinstance(tgt, torch.Tensor):
            t = arr if isinstance(arr, torch.Tensor) \
                else torch.from_numpy(np.array(arr))
            if is_dtensor(tgt):
                local = tgt.to_local()
                return local_like(t.to(local.device), tgt)
            return t.to(device if device is not None else tgt.device)
        return arr

    def rebuild(tree, prefix: str = ""):
        def key(part: str) -> str:
            return f"{prefix}/{part}" if prefix else part
        if hasattr(tree, "named_parameters"):
            tree = dict(tree.named_parameters())
        if isinstance(tree, dict):
            return {k: rebuild(v, key(str(k))) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, key(f"[{i}]"))
                              for i, v in enumerate(tree))
        return leaf(prefix, tree)
    return rebuild(target_tree)
