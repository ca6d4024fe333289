"""The paper's scikit-learn estimator interface (§4) in action.

Four construction paths are shown: the workload registry
(``make_estimator``), the backend-portable ``system=`` parameter (the
same estimator on the host baseline target), the legacy class names
(deprecation shims over the same registry), and the job scheduler's
sweep surface, the multi-tenant way to fit a hyperparameter grid.  Every
estimator is handed a system on the chosen device (``system=`` or
``pim=``): one built by default would run on ``"cuda"``.

  PYTHONPATH=src python -m repro_torch.examples.pim_ml_sklearn [--device cpu]
"""
from __future__ import annotations

import numpy as np

from repro_torch.api import (PimConfig, PimSystem, get_workload,
                             make_estimator, make_system)
from repro_torch.core.estimators import PimDecisionTreeClassifier, PimKMeans
from repro_torch.data.synthetic import (make_blobs, make_classification,
                                        make_linear_dataset)
from repro_torch.examples import parse, parser, sections
from repro_torch.sched import PimScheduler


def _pim(device):
    return make_system("pim", n_cores=16, device=device)


def regression(device, *, n_samples=4096, n_features=16, n_iters=400):
    """LIN bui through the registry, then fp32 on the host target.
    Returns ``(X, y)`` for :func:`sweep`."""
    X, y, _ = make_linear_dataset(n_samples, n_features, task="regression",
                                  seed=0)
    reg = make_estimator("linreg", version="bui", n_iters=n_iters,
                         system=_pim(device)).fit(X, y)
    print(f"make_estimator('linreg', 'bui')  R^2 = {reg.score(X, y):.4f}")
    print(f"  get_params = {reg.get_params()}")

    # the same estimator on the processor-centric baseline target: pass
    # any System via system= and the fit runs there unmodified
    cpu = make_estimator("linreg", version="fp32", n_iters=n_iters,
                         system=make_system("host", device=device)).fit(X, y)
    print(f"  ... on HostSystem (fp32 CPU baseline) R^2 = "
          f"{cpu.score(X, y):.4f}, DRAM streamed "
          f"{cpu.system.stats.dram_bytes:,} B")
    return X, y


def classification(device, *, n_samples=4096, n_features=16, n_iters=400):
    """LOG bui_lut through the registry."""
    Xc, yc, _ = make_linear_dataset(n_samples, n_features, seed=1)
    clf = make_estimator("logreg", version="bui_lut", n_iters=n_iters,
                         system=_pim(device)).fit(Xc, yc)
    print(f"make_estimator('logreg','bui_lut') acc = {clf.score(Xc, yc):.4f}")
    print(f"  predict_proba[:2] = {np.round(clf.predict_proba(Xc[:2]), 3)}")


def legacy_tree(device, *, n_samples=20_000, n_features=16, max_depth=8):
    """The legacy DTR class (a thin shim over the registry)."""
    Xt, yt = make_classification(n_samples, n_features, seed=2,
                                 class_sep=1.5)
    tree = PimDecisionTreeClassifier(max_depth=max_depth,
                                     pim=_pim(device)).fit(Xt, yt)
    print(f"PimDecisionTreeClassifier        acc = {tree.score(Xt, yt):.4f}")


def legacy_kmeans(device, *, n_samples=10_000, n_features=8, k=8,
                  max_iter=300):
    """The legacy KME class."""
    Xb, _, _ = make_blobs(n_samples, n_features, centers=k, seed=3)
    km = PimKMeans(n_clusters=k, n_init=2, max_iter=max_iter,
                   pim=_pim(device)).fit(Xb)
    print(f"PimKMeans                        inertia = {km.inertia_:.3e}, "
          f"centers {km.cluster_centers_.shape}")


def sweep(device, X, y, *, n_iters=400):
    """The scheduler fits a whole grid concurrently: the GD points fuse
    into one batched kernel launch per step."""
    sched = PimScheduler(PimSystem(PimConfig(n_cores=16, device=device)),
                         rank_size=4)
    handles = sched.sweep("linreg", (X, y), {"lr": [0.05, 0.1, 0.2]},
                          version="bui", n_iters=n_iters, n_cores=8)
    sched.drain()
    lin = get_workload("linreg")
    for h in handles:
        print(f"sched.sweep('linreg','bui') lr={h.spec.params['lr']:<5}"
              f" R^2 = {lin.score(h.result, X, y):.4f}  "
              f"[{h.state.value}, fused={h.fused}]")


def run(device, **sizes):
    """The four construction paths on ``device``; ``sizes`` maps a
    section's name to its keyword arguments (the reference's sizes where
    absent)."""
    reg, clf, tree, km, grid = sections(
        sizes, "regression", "classification", "legacy_tree",
        "legacy_kmeans", "sweep")
    X, y = regression(device, **reg)
    classification(device, **clf)
    legacy_tree(device, **tree)
    legacy_kmeans(device, **km)
    sweep(device, X, y, **grid)


def main(argv=None):
    run(parse(parser(__doc__), argv).device)


if __name__ == "__main__":
    main()
