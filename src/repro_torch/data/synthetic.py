"""Synthetic dataset generators (paper §4, Table 3) for LIN/LOG/DTR/KME,
and the recommender triples of EMB.

A numpy-only copy of the generators of ``repro.data.synthetic``:
the same seeds give the same arrays as the reference.

The paper evaluates training quality on synthetic datasets with uniformly
distributed random samples (values with 4 decimal digits for LIN/LOG).
``make_classification`` (informative/redundant/random attributes) gives
the LOG runs a harder, unquantized-looking dataset.
"""
from __future__ import annotations

import numpy as np


def round_decimals(x: np.ndarray, decimals: int) -> np.ndarray:
    """Paper §4.1: samples have a fixed number of decimal digits."""
    return np.round(x, decimals).astype(np.float32)


def make_linear_dataset(n_samples: int = 8192, n_features: int = 16,
                        decimals: int = 4, seed: int = 0,
                        task: str = "classification",
                        noise: float = 0.0):
    """Uniform random samples + ground-truth linear model (LIN/LOG quality).

    ``task="classification"`` binarizes the linear response at its median —
    the paper's "training error rate" for LIN/LOG counts thresholded
    prediction errors on the training set (their real datasets, SUSY/Skin,
    are binary classification).
    Returns (X float32 [n, f], y float32 [n], w_true float32 [f+1]).
    """
    rng = np.random.RandomState(seed)
    X = rng.uniform(0.0, 1.0, size=(n_samples, n_features))
    X = round_decimals(X, decimals)
    w = rng.uniform(-1.0, 1.0, size=n_features).astype(np.float32)
    b = np.float32(rng.uniform(-0.5, 0.5))
    resp = X @ w + b
    if noise:
        resp = resp + rng.normal(0.0, noise, size=n_samples)
    if task == "classification":
        y = (resp > np.median(resp)).astype(np.float32)
    else:
        y = resp.astype(np.float32)
    return X.astype(np.float32), y, np.concatenate([w, [b]]).astype(np.float32)


def make_classification(n_samples: int = 600_000, n_features: int = 16,
                        n_informative: int = 4, n_redundant: int = 4,
                        n_classes: int = 2, class_sep: float = 1.0,
                        seed: int = 0):
    """DTR quality dataset (paper §4.1): 4 informative + 4 redundant
    (random linear combination of the informative) + 8 random attributes,
    float32, *not* quantized.  Follows the make_classification recipe:
    class clusters at hypercube vertices in informative subspace."""
    rng = np.random.RandomState(seed)
    n_random = n_features - n_informative - n_redundant
    assert n_random >= 0
    # class centroids: distinct +-class_sep hypercube corners
    centroids = np.zeros((n_classes, n_informative))
    for c in range(n_classes):
        bits = [(c >> i) & 1 for i in range(n_informative)]
        centroids[c] = (2.0 * np.array(bits) - 1.0) * class_sep
    y = rng.randint(0, n_classes, size=n_samples)
    X_inf = centroids[y] + rng.normal(0, 1.0, size=(n_samples, n_informative))
    A = rng.normal(0, 1.0, size=(n_informative, n_redundant))
    X_red = X_inf @ A
    X_rand = rng.normal(0, 1.0, size=(n_samples, n_random))
    X = np.concatenate([X_inf, X_red, X_rand], axis=1)
    perm = rng.permutation(n_features)
    return X[:, perm].astype(np.float32), y.astype(np.int32)


def make_blobs(n_samples: int = 100_000, n_features: int = 16,
               centers: int = 16, cluster_std: float = 1.0,
               center_box: tuple = (-10.0, 10.0), seed: int = 0):
    """KME quality dataset (paper §4.1): 16 isotropic clusters, float32."""
    rng = np.random.RandomState(seed)
    C = rng.uniform(center_box[0], center_box[1], size=(centers, n_features))
    y = rng.randint(0, centers, size=n_samples)
    X = C[y] + rng.normal(0, cluster_std, size=(n_samples, n_features))
    return X.astype(np.float32), y.astype(np.int32), C.astype(np.float32)


def make_recsys(n_samples: int = 16384, n_users: int = 512,
                n_items: int = 256, dim: int = 8, zipf_a: float = 1.2,
                noise: float = 0.02, seed: int = 0):
    """EMB dataset: (user, item, rating) triples.

    Ids draw from a truncated Zipf-like (Pareto) distribution, the
    power-law popularity skew of real recommender traffic: hot rows are
    touched many times per deferred-update window but ship once.
    Ratings come from a ground-truth low-rank model, so a dot-product
    embedding can drive the loss down.  Returns (pairs int32 [n, 2],
    y float32 [n]).
    """
    rng = np.random.RandomState(seed)
    U = (rng.randn(n_users, dim) * (0.5 / np.sqrt(dim))).astype(np.float32)
    I = (rng.randn(n_items, dim) * (0.5 / np.sqrt(dim))).astype(np.float32)
    u = np.minimum(rng.pareto(zipf_a, n_samples).astype(np.int64), n_users - 1)
    i = np.minimum(rng.pareto(zipf_a, n_samples).astype(np.int64), n_items - 1)
    y = np.sum(U[u] * I[i], axis=1)
    if noise:
        y = y + rng.normal(0.0, noise, size=n_samples)
    pairs = np.stack([u, i], axis=1).astype(np.int32)
    return pairs, y.astype(np.float32)
