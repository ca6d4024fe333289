"""Decision tree training on the PIM system (paper §3.3).

Port of ``repro.core.dtree``.  Extremely randomized trees [Geurts'06]
for classification: at each step one uniform-random threshold per
feature is drawn inside the leaf's [min, max], and the best (feature,
threshold) pair by Gini impurity makes the split.

The host owns the tree, the active frontier and the splitting decisions
and issues three commands to the cores, each one batched call over the
``[C, n_pc, ...]`` shards:

  min-max         per (leaf, feature) extrema, to draw the thresholds
  split-evaluate  per (leaf, class, feature) below-threshold counts —
                  the ``gini_split`` op (the CUDA kernel on a card)
  split-commit    every point moves to its child leaf

The cores own immutable shards of the points plus a per-point
``leaf_id``.  The threshold draws come from the same numpy MT19937
stream as the reference and the counts are integers, so the tree is
identical to the reference's at the same core count.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kernels import dispatch
from ..systems import host_array, run_steps


@dataclasses.dataclass
class TreeConfig:
    max_depth: int = 10
    n_classes: int = 2
    min_samples_split: int = 2
    seed: int = 0


@dataclasses.dataclass
class Tree:
    """Array-encoded binary tree (host-side)."""

    feature: np.ndarray    # int32 [max_nodes], -1 = leaf
    threshold: np.ndarray  # float32 [max_nodes]
    left: np.ndarray       # int32 [max_nodes]
    right: np.ndarray      # int32 [max_nodes]
    leaf_class: np.ndarray  # int32 [max_nodes]
    depth: np.ndarray      # int32 [max_nodes]
    n_nodes: int

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Vectorized host-side inference."""
        X = np.asarray(X, np.float32)
        node = np.zeros(X.shape[0], np.int32)
        for _ in range(int(self.depth.max()) + 1):
            f = self.feature[node]
            is_split = f >= 0
            if not is_split.any():
                break
            fx = X[np.arange(X.shape[0]), np.maximum(f, 0)]
            go_left = fx <= self.threshold[node]
            nxt = np.where(go_left, self.left[node], self.right[node])
            node = np.where(is_split, nxt, node)
        return self.leaf_class[node]


# ---------------------------------------------------------------------------
# Per-core kernels, batched over the leading cores axis.
# ---------------------------------------------------------------------------

_BIG = np.float32(3.4e38)  # sentinel larger than any real feature value


def make_minmax_kernel(max_nodes: int):
    """Per-core per-leaf min/max of every feature (min-max command).

    Invalid rows go to leaf ``max_nodes - 1`` carrying ``+-BIG``; a leaf
    no row reaches keeps the reductions' identities ``+-inf``, as the
    reference's segment min/max do.  The cores axis is reduced with
    min/max by ``map_reduce_custom``."""
    def _kernel(Xc, leaf_id, valid, _dummy):
        lid = torch.where(valid, leaf_id, max_nodes - 1).long()
        idx = lid.unsqueeze(-1).expand_as(Xc)
        vmask = valid.unsqueeze(-1)

        def reduce(big, op):
            out = torch.full((Xc.shape[0], max_nodes, Xc.shape[2]),
                             big * float("inf"), dtype=Xc.dtype,
                             device=Xc.device)
            return out.scatter_reduce_(
                1, idx, torch.where(vmask, Xc, big * float(_BIG)), op,
                include_self=True)
        mins, maxs = reduce(1.0, "amin"), reduce(-1.0, "amax")
        return {"min": mins, "max": maxs}
    return _kernel


def make_split_eval_kernel(max_nodes: int, n_classes: int):
    """split-evaluate: per (leaf, class, feature) below-threshold counts
    and per (leaf, class) totals, for one random threshold per feature.

    The ``gini_split`` op counts no row whose leaf is outside
    ``[0, max_nodes)``, so invalid rows go to leaf -1 and the points and
    classes pass through uncopied."""
    def _kernel(Xc, yc, leaf_id, valid, thresholds):
        leaf = torch.where(valid, leaf_id, -1)
        below, total = dispatch.launch("gini_split", Xc, yc, leaf,
                                       thresholds, n_classes)
        return {"below": below, "total": total}
    return _kernel


def _commit_kernel(Xc, leaf_id, split_feature, split_thresh, left_id,
                   right_id):
    """split-commit: reassign each point to its child leaf (the paper's
    reorder, realized as a leaf_id rewrite)."""
    lid = leaf_id.long()
    f = split_feature[lid]                              # [C, n]
    has_split = f >= 0
    fx = torch.gather(Xc, -1, f.clamp(min=0).long().unsqueeze(-1))[..., 0]
    go_left = fx <= split_thresh[lid]
    child = torch.where(go_left, left_id[lid], right_id[lid])
    return torch.where(has_split, child, leaf_id)


# ---------------------------------------------------------------------------
# Host-side Gini arithmetic.
# ---------------------------------------------------------------------------

def gini_score(below: np.ndarray, total: np.ndarray) -> np.ndarray:
    """Weighted Gini impurity of candidate splits.

    below: (L, C, F) class counts on the left side; total: (L, C).
    Returns (L, F) score (lower is better).
    """
    below = below.astype(np.float64)
    total = total.astype(np.float64)[:, :, None]       # (L, C, 1)
    above = total - below
    nl = below.sum(axis=1)                             # (L, F)
    nr = above.sum(axis=1)
    n = np.maximum(nl + nr, 1e-9)

    def side_gini(counts, m):
        m_safe = np.maximum(m, 1e-9)[:, None, :]
        p = counts / m_safe
        return 1.0 - (p * p).sum(axis=1)               # (L, F)

    gl = side_gini(below, nl)
    gr = side_gini(above, nr)
    return (nl * gl + nr * gr) / n


def fit_steps(dataset, cfg: Optional[TreeConfig] = None):
    """Generator form of tree growth: one frontier round (min-max ->
    split-evaluate -> commit) per ``next()``, the Tree on StopIteration."""
    cfg = cfg or TreeConfig()
    system = dataset.system
    dev = system.device
    rng = np.random.RandomState(cfg.seed)
    nf = dataset.n_features
    max_nodes = 2 ** (cfg.max_depth + 2)

    Xs, ys, valid = dataset.tree_view()
    leaf_id = torch.zeros(valid.shape, dtype=torch.int32, device=dev)

    feature = np.full(max_nodes, -1, np.int32)
    threshold = np.zeros(max_nodes, np.float32)
    left = np.zeros(max_nodes, np.int32)
    right = np.zeros(max_nodes, np.int32)
    leaf_class = np.zeros(max_nodes, np.int32)
    depth = np.zeros(max_nodes, np.int32)
    n_nodes = 1
    frontier = [0]

    minmax_k = system.named_kernel(
        f"dtr.minmax/m{max_nodes}", lambda: make_minmax_kernel(max_nodes))
    eval_k = system.named_kernel(
        f"dtr.eval/m{max_nodes}.c{cfg.n_classes}",
        lambda: make_split_eval_kernel(max_nodes, cfg.n_classes))
    commit_k = system.named_kernel("dtr.commit", lambda: _commit_kernel)

    def dev_array(a):
        return torch.from_numpy(a).to(dev)

    while frontier:
        # ---- min-max command (host draws ERT thresholds) -----------------
        mm = system.map_reduce_custom(
            minmax_k, (Xs, leaf_id, valid),
            (torch.zeros((), dtype=torch.int32, device=dev),),
            reduce={"min": "min", "max": "max"})
        mins, maxs = host_array(mm["min"]), host_array(mm["max"])
        ok = mins <= maxs  # leaves that actually contain points
        span = np.where(ok, maxs - mins, 0.0)
        base = np.where(ok, mins, 0.0)
        thresholds = np.asarray(
            rng.uniform(0.0, 1.0, size=(max_nodes, nf)), np.float32)
        thresholds = (base + thresholds * span).astype(np.float32)

        # ---- split-evaluate command --------------------------------------
        part = system.map_reduce(eval_k, (Xs, ys, leaf_id, valid),
                                 (dev_array(thresholds),))
        below = host_array(part["below"])        # (L, C, F)
        total = host_array(part["total"])        # (L, C)
        score = gini_score(below, total)    # (L, F)

        # ---- host decides splits ----------------------------------------
        split_feature = np.full(max_nodes, -1, np.int32)
        split_thresh = np.zeros(max_nodes, np.float32)
        left_id = np.zeros(max_nodes, np.int32)
        right_id = np.zeros(max_nodes, np.int32)
        new_frontier = []
        for leaf in frontier:
            counts = total[leaf]
            n_leaf = int(counts.sum())
            leaf_class[leaf] = int(counts.argmax())
            if (n_leaf < cfg.min_samples_split
                    or (counts > 0).sum() <= 1
                    or depth[leaf] >= cfg.max_depth
                    or n_nodes + 2 > max_nodes):
                continue
            best_f = int(score[leaf].argmin())
            nl = int(below[leaf, :, best_f].sum())
            if nl == 0 or nl == n_leaf:      # degenerate threshold
                continue
            li, ri = n_nodes, n_nodes + 1
            n_nodes += 2
            feature[leaf] = best_f
            threshold[leaf] = thresholds[leaf, best_f]
            left[leaf], right[leaf] = li, ri
            depth[li] = depth[ri] = depth[leaf] + 1
            # children inherit majority class until refined
            leaf_class[li] = leaf_class[ri] = leaf_class[leaf]
            split_feature[leaf] = best_f
            split_thresh[leaf] = thresholds[leaf, best_f]
            left_id[leaf], right_id[leaf] = li, ri
            new_frontier += [li, ri]

        if not new_frontier:
            break

        # ---- split-commit command ----------------------------------------
        leaf_id = system.map_elementwise(
            commit_k, (Xs, leaf_id),
            (dev_array(split_feature), dev_array(split_thresh),
             dev_array(left_id), dev_array(right_id)))
        frontier = new_frontier
        yield 1      # one frontier round per scheduling turn

    return Tree(feature, threshold, left, right, leaf_class, depth, n_nodes)


def fit(dataset, cfg: Optional[TreeConfig] = None) -> Tree:
    """Grow one extremely randomized tree over a resident PimDataset.

    The float32 point shards stay resident; per round only the command
    arguments (thresholds, split decisions) cross the host<->PIM
    boundary, the paper's three-command protocol."""
    return run_steps(fit_steps(dataset, cfg))
