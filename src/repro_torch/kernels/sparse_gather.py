"""Ops ``emb_gather`` and ``emb_scatter_add``: the sparse row access of EMB.

Both run against a row-sharded embedding table: core ``c`` holds rows
``table[c, r]`` whose global row ids are ``ids[c, r]`` (``ROW_PAD_ID``
marks the slots past the vocabulary tail).  One launch covers every core.

``dispatch.launch("emb_gather", table, ids, idx, index)``: table ``[C, R,
D]`` (int32 Q(f) or float32), ids int32 ``[C, R]``, lookups int32 ``[B]``
-> ``[C, B, D]`` with ``out[c, b] = table[c, r]`` where ``ids[c, r] ==
idx[b]``, zeros where core ``c`` does not own ``idx[b]`` (summing the
cores' partials, the fabric reduce, rebuilds the looked-up rows).
``index`` is :func:`gather_index` of ``ids``, built once per placement
(``ShardedTable.gather_index``): the kernel searches it; the plain
version ignores it.

``dispatch.launch("emb_scatter_add", table, ids, idx, upd)``: table
``[C, R, D]``, ids ``[C, R]``, idx int32 ``[B]``, update rows ``[B, D]``
-> a new table ``[C, R, D]`` with ``out[c, r] = table[c, r] +
sum_b [ids[c, r] == idx[b]] upd[b]``: duplicate ids accumulate, summed
in batch order from zero and added to the row once, the order of the
reference's one dot over the batch axis.  The input table is never
written.

Integer arithmetic wraps in int32 as the reference's does.  The two
sentinels never match a real id (those are >= 0) nor each other.

  :func:`emb_gather_cuda`, :func:`emb_scatter_add_cuda`
      the hand-written kernels (``csrc/emb_gather.cu``,
      ``csrc/emb_scatter_add.cu``, ports of
      ``repro/kernels/sparse_gather/kernel.py`` ``emb_gather`` and
      ``emb_scatter_add``)
  :func:`emb_gather_plain`, :func:`emb_scatter_add_plain`
      the plain PyTorch versions (follow
      ``repro/kernels/sparse_gather/ref.py``)
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import build, dispatch

#: global-id sentinel for padded table slots (vocabulary tail rounded up
#: to the shard grid); never matches a real lookup id (those are >= 0)
ROW_PAD_ID = -1
#: lookup-id sentinel for padded batch slots; distinct from ROW_PAD_ID so
#: a padded lookup cannot hit a padded row
IDX_PAD = -2

#: one launch covers every core on the grid's y (gather) axis
MAX_CORES = 65535
#: the scatter stages update rows in 48 KB of shared memory, one at least
MAX_SCATTER_DIM = 8192
#: the plain versions materialize a [chunk, R, D] product per step; this
#: many elements at most
_PLAIN_CHUNK_ELEMS = 1 << 26


def _check_table(name: str, table: torch.Tensor, ids: torch.Tensor) -> None:
    if table.dim() != 3 or ids.shape != table.shape[:2]:
        raise ValueError(f"{name}: table {tuple(table.shape)} and ids "
                         f"{tuple(ids.shape)} do not form [C, R, D] and "
                         f"[C, R]")


class GatherIndex(NamedTuple):
    """The gather's index of a placement map ``ids [C, R]``: per core the
    ids sorted ascending and the row each came from, ``[C, R]`` int32
    each, equal ids (``ROW_PAD_ID`` slots) in ascending row order."""

    ids: torch.Tensor
    rows: torch.Tensor


def gather_index(ids: torch.Tensor) -> GatherIndex:
    """Build the gather's index of ``ids [C, R]`` on their device; raises
    on an id that repeats within one core (``ROW_PAD_ID`` excepted)."""
    if ids.dim() != 2 or ids.dtype != torch.int32:
        raise ValueError(f"gather_index: ids must be int32 [C, R], got "
                         f"{ids.dtype} {tuple(ids.shape)}")
    keys, rows = torch.sort(ids, dim=1, stable=True)
    repeat = (keys[:, 1:] == keys[:, :-1]) & (keys[:, 1:] != ROW_PAD_ID)
    if bool(repeat.any()):
        c, r = (int(v) for v in torch.nonzero(repeat)[0])
        raise ValueError(f"gather_index: id {int(keys[c, r])} repeats on "
                         f"core {c}")
    return GatherIndex(keys.contiguous(), rows.to(torch.int32).contiguous())


def emb_gather_plain(table: torch.Tensor, ids: torch.Tensor,
                     idx: torch.Tensor,
                     index: Optional[GatherIndex] = None) -> torch.Tensor:
    """Masked product-and-sum over the rows, as the reference's one-hot
    dot: each lookup matches at most one row of a shard, so the sum is a
    selection, exact in every dtype.  ``index`` is not used."""
    _check_table("emb_gather", table, ids)
    n_cores, n_rows, dim = table.shape
    out = torch.zeros((n_cores, idx.shape[0], dim), dtype=table.dtype,
                      device=table.device)
    if out.numel() == 0 or n_rows == 0:
        return out
    step = max(1, _PLAIN_CHUNK_ELEMS // (idx.shape[0] * n_rows * dim))
    for c0 in range(0, n_cores, step):
        tab, key = table[c0:c0 + step], ids[c0:c0 + step]
        hit = (key[:, None, :] == idx[None, :, None]).to(table.dtype)
        out[c0:c0 + step] = torch.sum(hit[..., None] * tab[:, None],
                                      dim=2, dtype=table.dtype)
    return out


def emb_scatter_add_plain(table: torch.Tensor, ids: torch.Tensor,
                          idx: torch.Tensor,
                          upd: torch.Tensor) -> torch.Tensor:
    """The masked update rows summed in batch order into an accumulator
    that starts at zero, then added to the table once."""
    _check_table("emb_scatter_add", table, ids)
    upd = upd.to(table.dtype)
    acc = torch.zeros_like(table)
    for b in range(idx.shape[0]):
        hit = (ids == idx[b]).to(table.dtype)
        acc = acc + hit[..., None] * upd[b]
    return table + acc


_P, _I = ctypes.c_void_p, ctypes.c_int
#: the C entry points' arguments (the last one is the stream)
_ARGTYPES = {
    "emb_gather": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "emb_scatter_add": [_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I,
                        _I, _P],
}


@functools.cache
def _bind(name: str):
    """The C entry point ``<name>_launch`` of ``csrc/<name>.cu``, bound
    once."""
    fn = getattr(build.load(name), f"{name}_launch")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(name: str, table: torch.Tensor, ids: torch.Tensor,
                idx: torch.Tensor, *rest: torch.Tensor) -> None:
    tensors = (table, ids, idx, *rest)
    if not (table.is_cuda and all(t.device == table.device
                                  for t in tensors)):
        raise ValueError(f"{name}_cuda: operands must be on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if table.dtype not in (torch.int32, torch.float32):
        raise TypeError(f"{name}_cuda: int32 or float32 table required, got "
                        f"{table.dtype}")
    if ids.dtype != torch.int32 or idx.dtype != torch.int32:
        raise TypeError(f"{name}_cuda: int32 ids and lookups required, got "
                        f"{ids.dtype} and {idx.dtype}")
    _check_table(name, table, ids)
    if idx.dim() != 1:
        raise ValueError(f"{name}_cuda: lookups must be [B], got "
                         f"{tuple(idx.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}_cuda: operands must be contiguous")


def _count_or_raise(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    dispatch.count_launch(name)


def emb_gather_cuda(table: torch.Tensor, ids: torch.Tensor,
                    idx: torch.Tensor,
                    index: Optional[GatherIndex] = None) -> torch.Tensor:
    """Launch the gather kernel on the current stream; raises on anything
    it does not take and on a launch error.  ``index`` must be
    :func:`gather_index` of ``ids`` (it is not rebuilt here).  An empty
    batch or table launches nothing."""
    _check_cuda("emb_gather", table, ids, idx)
    if index is None:
        raise ValueError("emb_gather_cuda: the table's gather index is "
                         "required (gather_index(ids), built once per "
                         "placement)")
    keys, rows = index
    if not all(t.shape == ids.shape and t.dtype == torch.int32
               and t.device == ids.device and t.is_contiguous()
               for t in (keys, rows)):
        raise ValueError("emb_gather_cuda: the gather index must be two "
                         "contiguous int32 [C, R] tensors on the ids' device")
    n_cores, n_rows, dim = table.shape
    n_idx = idx.shape[0]
    if n_cores > MAX_CORES:
        raise ValueError(f"emb_gather_cuda: C={n_cores} > {MAX_CORES}")
    if n_idx * dim >= 2 ** 31:
        raise ValueError(f"emb_gather_cuda: B*D={n_idx * dim} >= 2^31")
    out = torch.empty((n_cores, n_idx, dim), dtype=table.dtype,
                      device=table.device)
    if out.numel() == 0:
        return out
    if n_rows == 0:
        return out.zero_()
    launch = _bind("emb_gather")
    with torch.cuda.device(table.device):
        err = launch(
            table.data_ptr(), keys.data_ptr(), rows.data_ptr(),
            idx.data_ptr(), out.data_ptr(), n_cores, n_rows, dim, n_idx,
            int(table.dtype == torch.float32),
            torch.cuda.current_stream().cuda_stream)
    _count_or_raise("emb_gather", err)
    return out


def emb_scatter_add_cuda(table: torch.Tensor, ids: torch.Tensor,
                         idx: torch.Tensor,
                         upd: torch.Tensor) -> torch.Tensor:
    """Launch the scatter-add kernels (the batch's ids sorted with their
    per-id sums, then the pass over the table) on the current stream into
    a new table; one op, counted once.  Raises on anything it does not
    take and on a launch error.  An empty batch returns a copy of the
    table and launches nothing."""
    upd = upd.to(table.dtype)
    _check_cuda("emb_scatter_add", table, ids, idx, upd)
    n_cores, n_rows, dim = table.shape
    n_idx = idx.shape[0]
    if upd.shape != (n_idx, dim):
        raise ValueError(f"emb_scatter_add_cuda: upd {tuple(upd.shape)} is "
                         f"not [B, D] = {(n_idx, dim)}")
    if dim > MAX_SCATTER_DIM:
        raise ValueError(f"emb_scatter_add_cuda: D={dim} > "
                         f"{MAX_SCATTER_DIM}")
    if n_idx == 0 or table.numel() == 0:
        return table.clone()
    out = torch.empty_like(table)
    # the batch's sorted ids, then (16-byte aligned) its per-id sums
    scratch = torch.empty(n_idx + 3 + n_idx * dim, dtype=torch.int32,
                          device=table.device)
    launch = _bind("emb_scatter_add")
    with torch.cuda.device(table.device):
        err = launch(
            table.data_ptr(), ids.data_ptr(), idx.data_ptr(), upd.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), n_cores * n_rows, dim, n_idx,
            int(table.dtype == torch.float32),
            torch.cuda.current_stream().cuda_stream)
    _count_or_raise("emb_scatter_add", err)
    return out


def emb_gather_cost(table: torch.Tensor, ids: torch.Tensor,
                    idx: torch.Tensor,
                    index: Optional[GatherIndex] = None
                    ) -> dispatch.KernelCost:
    """What the function moves: the ``[C, B, D]`` partials written, the B
    rows it looks up and idx read; no arithmetic."""
    n_cores, _, dim = table.shape
    b, es = idx.numel(), table.element_size()
    return dispatch.KernelCost(
        ops=0, bytes=n_cores * b * dim * es + b * dim * es + b * 4,
        rate="int32")


def emb_scatter_add_cost(table: torch.Tensor, ids: torch.Tensor,
                         idx: torch.Tensor,
                         upd: torch.Tensor) -> dispatch.KernelCost:
    """The table read and the new table written, the ids, idx and the
    updates read; one id compare per (row, lookup)."""
    n_cores, n_rows, dim = table.shape
    b, es = idx.numel(), table.element_size()
    return dispatch.KernelCost(
        ops=n_cores * n_rows * b,
        bytes=2 * n_cores * n_rows * dim * es + n_cores * n_rows * 4
        + b * 4 + b * dim * es,
        rate="int32")


dispatch.register_op("emb_gather", cuda=emb_gather_cuda,
                     plain=emb_gather_plain, cost=emb_gather_cost)
dispatch.register_op("emb_scatter_add", cuda=emb_scatter_add_cuda,
                     plain=emb_scatter_add_plain, cost=emb_scatter_add_cost)
