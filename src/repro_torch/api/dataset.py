"""Bank-resident dataset handles.

A :class:`PimDataset` is created by ``System.put(X, y)`` and owns the
host-side arrays, the row-validity mask, and the quantized, sharded
device views of the workloads (gradient descent, tree, K-Means) — built
lazily and cached under the same keys as ``repro.api.dataset.PimDataset``,
so repeated fits, restarts and sweeps reuse one CPU->PIM transfer per
view.  The host quantizes once (on the CPU) and ships the shards.  EMB's
index pairs stay on the host (:meth:`PimDataset.emb_view`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.fixed_point import to_fixed
# 12-bit symmetric range stored in int16; single source of truth in
# core/kmeans.py
from ..core.kmeans import QUANT_RANGE as KMEANS_QUANT_RANGE
from ..obs.trace import TRACER

_GD_DATA_VERSION = {
    "fp32": "fp32", "int32": "int32", "hyb": "hyb", "bui": "hyb",
    "int32_lut_mram": "int32", "int32_lut_wram": "int32",
    "hyb_lut": "hyb", "bui_lut": "hyb",
}


def gd_data_version(version: str) -> str:
    """Collapse a LIN/LOG version name to its on-bank data precision."""
    try:
        return _GD_DATA_VERSION[version]
    except KeyError:
        raise ValueError(f"unknown workload version {version!r}") from None


@dataclasses.dataclass(frozen=True)
class KMeansView:
    """K-Means view: device shards + host copy for centroid init."""

    shards: torch.Tensor     # (n_shards, n_pc, F) int16 or float32
    mask: torch.Tensor       # (n_shards, n_pc) bool
    host_q: np.ndarray       # (n, F) — centroid init draws from it
    scale: np.float32        # dequantization scale


class PimDataset:
    """Handle to a dataset partitioned once across the simulated banks."""

    def __init__(self, system, X, y=None):
        X = np.asarray(X)
        if X.ndim == 1:
            X = X[:, None]
        self.system = system
        self.X = X
        self.y = None if y is None else np.asarray(y)
        self.n = int(X.shape[0])
        self.n_features = int(X.shape[1])
        self._views: dict[tuple, Any] = {}

    def _cached(self, key: tuple, builder):
        view = self._views.get(key)
        if view is None:
            if TRACER.enabled:
                track = getattr(self.system, "_trace_track", "system:?")
                with TRACER.span(f"shard:{key[0]}", track, "transfer"):
                    view = builder()
            else:
                view = builder()
            self._views[key] = view
        return view

    @property
    def n_views(self) -> int:
        """Number of materialized (transferred) views — diagnostics."""
        return sum(1 for k in self._views if k[0] != "mask")

    def _require_y(self, who: str) -> np.ndarray:
        if self.y is None:
            raise ValueError(f"{who} needs labels/targets; create the "
                             f"dataset with System.put(X, y)")
        return self.y

    def mask(self, dtype: torch.dtype | None = None) -> torch.Tensor:
        """Row-validity mask, optionally cast (cached per dtype)."""
        key = ("mask", None if dtype is None else str(dtype).split(".")[-1])
        return self._cached(key, lambda: (
            self.system.row_validity_mask(self.n) if dtype is None
            else self.system.row_validity_mask(self.n).to(dtype)))

    def gd_view(self, version: str, frac_bits: int = 10, x8_frac: int = 7):
        """(Xs, ys, mask) for the gradient-descent workloads (LIN/LOG).

        ``version`` collapses to its data precision, so HYB and BUI share
        one transfer, as do the LUT placement variants."""
        y = self._require_y("gd_view")
        data_ver = gd_data_version(version)

        if data_ver == "fp32":
            key = ("gd", "fp32")

            def build():
                return (self.system.shard_rows(self.X.astype(np.float32)),
                        self.system.shard_rows(y.astype(np.float32)),
                        self.mask(torch.float32))
        elif data_ver == "int32":
            key = ("gd", "int32", frac_bits)

            def build():
                Xq = to_fixed(torch.from_numpy(self.X), frac_bits).numpy()
                yq = to_fixed(torch.from_numpy(y), frac_bits).numpy()
                return (self.system.shard_rows(Xq),
                        self.system.shard_rows(yq),
                        self.mask(torch.int32))
        else:  # hyb: int8 inputs, fixed-point targets at frac_bits
            key = ("gd", "hyb", x8_frac, frac_bits)

            def build():
                Xq8 = to_fixed(torch.from_numpy(self.X), x8_frac,
                               dtype=torch.int8).numpy()
                yq = to_fixed(torch.from_numpy(y), frac_bits).numpy()
                return (self.system.shard_rows(Xq8),
                        self.system.shard_rows(yq),
                        self.mask(torch.int32))
        return self._cached(key, build)

    def tree_view(self):
        """(Xs, ys, mask) for the decision-tree workload (float32/int32)."""
        y = self._require_y("tree_view")

        def build():
            return (self.system.shard_rows(self.X.astype(np.float32)),
                    self.system.shard_rows(y.astype(np.int32)),
                    self.mask())
        return self._cached(("tree",), build)

    def emb_view(self) -> tuple:
        """(pairs, targets) for the EMB workload: host-side ``(n, 2)``
        int32 (user, item) index pairs plus float32 ratings.

        EMB keeps the dataset on the host: each step's minibatch of
        index pairs is broadcast to the shards, while the sharded state
        is the embedding TABLE (``System.put_table``)."""
        y = self._require_y("emb_view")
        if self.n_features != 2:
            raise ValueError(
                f"emb_view needs (n, 2) (user, item) index pairs, got "
                f"{self.n_features} columns")

        def build():
            X = self.X
            if not np.issubdtype(X.dtype, np.integer):
                if not np.all(X == np.round(X)):
                    raise ValueError("emb_view indices must be integral")
            Xi = X.astype(np.int32)
            if Xi.size and Xi.min() < 0:
                raise ValueError("emb_view indices must be non-negative")
            return Xi, y.astype(np.float32)
        return self._cached(("emb",), build)

    def kmeans_view(self, version: str = "int16") -> KMeansView:
        """K-Means data view, cached per precision.

        ``"int16"``: symmetric quantization to +-KMEANS_QUANT_RANGE
        (the paper's PIM version).  ``"fp32"``: un-quantized float32 —
        the processor-centric baseline precision (scale 1.0)."""
        if version == "fp32":
            def build():
                Xf = np.asarray(self.X, np.float32)
                return KMeansView(shards=self.system.shard_rows(Xf),
                                  mask=self.mask(),
                                  host_q=Xf,
                                  scale=np.float32(1.0))
            return self._cached(("kmeans", "fp32"), build)
        if version != "int16":
            raise ValueError(f"unknown kmeans view precision {version!r}; "
                             f"known: ('int16', 'fp32')")

        def build():
            X = np.asarray(self.X, np.float32)
            amax = float(np.abs(X).max())
            scale = max(amax, 1e-12) / KMEANS_QUANT_RANGE
            Xq = np.clip(np.round(X / scale),
                         -KMEANS_QUANT_RANGE, KMEANS_QUANT_RANGE)
            Xq = Xq.astype(np.int16)
            return KMeansView(shards=self.system.shard_rows(Xq),
                              mask=self.mask(),
                              host_q=Xq,
                              scale=np.float32(scale))
        return self._cached(("kmeans", "int16"), build)
