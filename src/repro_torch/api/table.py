"""Bank-sharded embedding tables.

Port of ``repro.api.table``.  A :class:`ShardedTable` is the
:class:`~repro_torch.api.dataset.PimDataset` sibling for model state that
is too large to broadcast: an embedding table is row-sharded across the
system's shards ONCE (``System.put_table``), each shard keeping its slice
of the placement map (the global row ids it owns), and only sparse
lookups and sparse update rows cross the host boundary per step.

Placement maps (``placement=``), identical to the reference's:

``"mod"``   shard ``v % S`` owns global row ``v`` at slot ``v // S``:
            round-robin, which spreads Zipf-skewed hot ids over shards.
``"hash"``  a seeded permutation first, then round-robin.

Both pad the vocabulary tail up to ``S x R`` slots; padded slots carry
the ``ROW_PAD_ID`` sentinel in the id map and never match a lookup.

The table also keeps the host-side staging ledger of deferred updates:
``stage()`` appends one minibatch's sparse update rows, ``drain()`` hands
back the pending rows (optionally deduplicated with ``np.unique`` +
``np.add.at``) for one batched scatter-add flush.  The ledger is plain
host state and travels in snapshots.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.fixed_point import to_fixed
from ..kernels.sparse_gather import ROW_PAD_ID, GatherIndex, gather_index

#: table storage precisions (version -> dtype of the device shards)
TABLE_VERSIONS = ("fp32", "int32")

PLACEMENTS = ("mod", "hash")


class ShardedTable:
    """Handle to an embedding table row-sharded across a system's shards."""

    def __init__(self, system, weights, *, placement: str = "mod",
                 seed: int = 0):
        if placement not in PLACEMENTS:
            raise ValueError(f"unknown placement {placement!r}; "
                             f"known: {PLACEMENTS}")
        W = np.asarray(weights, np.float32)
        if W.ndim != 2:
            raise ValueError(f"table weights must be 2-D (rows, dim), "
                             f"got shape {W.shape}")
        self.system = system
        self.host = W                       # master f32 copy (init values)
        self.n_rows = int(W.shape[0])
        self.dim = int(W.shape[1])
        self.placement = placement
        self.seed = int(seed)

        S = system.n_shards
        self.n_shards = S
        self.rows_per_shard = -(-self.n_rows // S)          # R
        order = np.arange(self.n_rows, dtype=np.int32)
        if placement == "hash":
            order = np.random.RandomState(self.seed).permutation(
                self.n_rows).astype(np.int32)
        # round-robin: flat grid position p = r*S + s  <- order[p]; slot
        # (s, r) of the (S, R) map owns global row ids[s, r]
        grid = np.full(S * self.rows_per_shard, ROW_PAD_ID, np.int32)
        grid[:self.n_rows] = order
        self._ids = np.ascontiguousarray(
            grid.reshape(self.rows_per_shard, S).T)         # (S, R) int32
        self._views: Dict[tuple, Any] = {}
        self._ids_dev: Optional[torch.Tensor] = None
        self._index: Optional[GatherIndex] = None
        #: per-shard materialization accounting (rows owned is fixed by
        #: the placement; bytes accrue per materialized view)
        self.shard_stats: List[dict] = [
            {"shard": s, "rows": int((self._ids[s] >= 0).sum()), "bytes": 0}
            for s in range(S)]
        # deferred-update staging ledger: per-minibatch sparse update rows
        self._pending_idx: List[np.ndarray] = []
        self._pending_upd: List[np.ndarray] = []
        self.pending_batches = 0

    # -- placement map -------------------------------------------------------

    @property
    def ids(self) -> np.ndarray:
        """(S, R) int32 placement map (ROW_PAD_ID marks padding)."""
        return self._ids

    def lookup_shard(self, v: int) -> tuple:
        """(shard, slot) owning global row ``v``."""
        s, r = np.nonzero(self._ids == int(v))
        if len(s) == 0:
            raise KeyError(f"row {v} not in table of {self.n_rows} rows")
        return int(s[0]), int(r[0])

    def _charge_shards(self, nbytes: int) -> None:
        for st in self.shard_stats:
            st["bytes"] += nbytes // self.n_shards

    def ids_device(self) -> torch.Tensor:
        """(S, R) int32 placement map resident on the device (cached)."""
        if self._ids_dev is None:
            self._ids_dev = self.system.shard_rows(
                self._ids.reshape(-1), pad_value=ROW_PAD_ID)
            self._charge_shards(self._ids.nbytes)
        return self._ids_dev

    def gather_index(self) -> GatherIndex:
        """The gather's index of the device placement map (cached; built
        on the device, so nothing crosses the host boundary)."""
        if self._index is None:
            self._index = gather_index(self.ids_device())
        return self._index

    # -- sharded views -------------------------------------------------------

    def view(self, version: str = "fp32", frac_bits: int = 10) -> tuple:
        """(shards [S, R, D], ids [S, R]) device view, cached per
        precision.  ``"int32"`` stores Q(frac_bits) fixed point (the PIM
        version); ``"fp32"`` is the float baseline.  The cached shards are
        never written: the scatter-add returns a new table."""
        if version not in TABLE_VERSIONS:
            raise ValueError(f"unknown table version {version!r}; "
                             f"known: {TABLE_VERSIONS}")
        key = (version, frac_bits if version == "int32" else None)
        view = self._views.get(key)
        if view is None:
            if version == "int32":
                rows = to_fixed(torch.from_numpy(self.host), frac_bits).numpy()
            else:
                rows = self.host
            view = (self.place_rows(rows), self.ids_device())
            self._views[key] = view
        return view

    @property
    def n_views(self) -> int:
        """Materialized (transferred) table views."""
        return len(self._views)

    def place_rows(self, rows) -> torch.Tensor:
        """Shard raw (V, D) storage rows through this table's placement,
        zeros in the pad slots (uncached: the restore path, where a
        snapshot's size-independent (V, D) rows are placed on whatever
        system resumes the fit).  Inverse of :meth:`unshard`."""
        rows = np.asarray(rows)
        if rows.shape != (self.n_rows, self.dim):
            raise ValueError(f"rows {rows.shape} are not the table's "
                             f"{(self.n_rows, self.dim)}")
        grid = np.zeros((self.n_shards, self.rows_per_shard, self.dim),
                        rows.dtype)
        owned = self._ids >= 0
        grid[owned] = rows[self._ids[owned]]
        shards = self.system.shard_rows(grid.reshape(-1, self.dim))
        self._charge_shards(grid.nbytes)
        return shards

    def unshard(self, shards) -> np.ndarray:
        """Reassemble (V, D) host rows from an (S, R, D) shard grid (e.g.
        the trainer's updated tables), inverting the placement, in the
        shards' own storage dtype.  A resident tensor is gathered whole
        first (over ranks it holds the rank's block of shards)."""
        if isinstance(shards, torch.Tensor):
            shards = self.system.gather_cores(shards).cpu()
        shards = np.asarray(shards)
        out = np.zeros((self.n_rows, self.dim), shards.dtype)
        owned = self._ids >= 0
        out[self._ids[owned]] = shards[owned]
        return out

    # -- deferred-update staging ledger --------------------------------------

    def stage(self, idx, upd) -> None:
        """Append one minibatch of sparse update rows to the ledger."""
        idx = np.asarray(idx, np.int32)
        upd = np.asarray(upd)
        if idx.shape[0] != upd.shape[0]:
            raise ValueError(f"{idx.shape[0]} ids for {upd.shape[0]} "
                             f"update rows")
        self._pending_idx.append(idx)
        self._pending_upd.append(upd)
        self.pending_batches += 1

    @property
    def pending_rows(self) -> int:
        return sum(int(v.shape[0]) for v in self._pending_idx)

    def drain(self, dedup: bool = True) -> tuple:
        """Pop the ledger as one ``(idx, upd)`` flush batch.

        ``dedup=True`` segment-sums duplicate ids on the host
        (``np.unique`` + ``np.add.at``, integers in an int64 accumulator)
        so each touched row ships ONCE; ``dedup=False`` concatenates
        verbatim (a single staged batch then flushes exactly as the eager
        apply would)."""
        idx, upd = self.pending_arrays()
        if not self._pending_idx:
            return idx, upd
        self.clear_pending()
        if not dedup:
            return idx, upd
        uniq, inv = np.unique(idx, return_inverse=True)
        if np.issubdtype(upd.dtype, np.integer):
            acc = np.zeros((uniq.shape[0], upd.shape[1]), np.int64)
            np.add.at(acc, inv, upd.astype(np.int64))
            acc = acc.astype(upd.dtype)
        else:
            acc = np.zeros((uniq.shape[0], upd.shape[1]), upd.dtype)
            np.add.at(acc, inv, upd)
        return uniq.astype(np.int32), acc

    def pending_arrays(self) -> tuple:
        """Ledger contents for snapshots (concatenated, not popped)."""
        if not self._pending_idx:
            return (np.zeros((0,), np.int32),
                    np.zeros((0, self.dim), np.float32))
        return (np.concatenate(self._pending_idx),
                np.concatenate(self._pending_upd))

    def restore_pending(self, idx, upd, batches: int = 0) -> None:
        """Restore a snapshot's ledger (inverse of pending_arrays)."""
        self.clear_pending()
        idx = np.asarray(idx, np.int32)
        if idx.size:
            self._pending_idx.append(idx)
            self._pending_upd.append(np.asarray(upd))
        self.pending_batches = int(batches)

    def clear_pending(self) -> None:
        self._pending_idx = []
        self._pending_upd = []
        self.pending_batches = 0

    def __repr__(self) -> str:
        return (f"ShardedTable({self.n_rows}x{self.dim}, "
                f"{self.placement!r}, shards={self.n_shards}, "
                f"views={self.n_views})")
