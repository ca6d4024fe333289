"""Quality metrics of the paper's evaluation (§4.1), numpy only.

- training error rate (%) for LIN/LOG (thresholded prediction errors)
- accuracy (LOG's and DTR's estimator score)
- adjusted Rand index (KME clustering agreement)
- relative Frobenius shift (KME convergence criterion)
"""
from __future__ import annotations

import numpy as np


def training_error_rate(pred: np.ndarray, y: np.ndarray,
                        threshold: float = 0.5) -> float:
    """% of thresholded prediction errors (paper's LIN/LOG quality metric)."""
    cls = (np.asarray(pred) > threshold).astype(np.int32)
    return float(np.mean(cls != (np.asarray(y) > threshold))) * 100.0


def accuracy(pred_labels: np.ndarray, y: np.ndarray) -> float:
    return float(np.mean(np.asarray(pred_labels) == np.asarray(y)))


def adjusted_rand_index(a: np.ndarray, b: np.ndarray) -> float:
    """ARI [238]; 1.0 = identical partitions (up to relabeling)."""
    a = np.asarray(a)
    b = np.asarray(b)
    n = a.size
    ua, ia = np.unique(a, return_inverse=True)
    ub, ib = np.unique(b, return_inverse=True)
    cont = np.zeros((ua.size, ub.size), np.int64)
    np.add.at(cont, (ia, ib), 1)

    def comb2(x):
        x = x.astype(np.float64)
        return x * (x - 1.0) / 2.0

    sum_ij = comb2(cont).sum()
    sum_a = comb2(cont.sum(axis=1)).sum()
    sum_b = comb2(cont.sum(axis=0)).sum()
    total = comb2(np.array([n]))[0]
    expected = sum_a * sum_b / total
    max_index = 0.5 * (sum_a + sum_b)
    if max_index == expected:
        return 1.0
    return float((sum_ij - expected) / (max_index - expected))


def frobenius_shift(old: np.ndarray, new: np.ndarray) -> float:
    """Relative Frobenius norm between consecutive centroid sets (KME
    convergence criterion, paper §3.4 / §5.1.4)."""
    denom = max(float(np.linalg.norm(old)), 1e-12)
    return float(np.linalg.norm(new - old)) / denom
